"""The node-batched engine at scale: rounds per second and state bytes
against the virtual-node count, with its correctness gates; the port of
``benchmarks/bench_megascale.py``.

One device simulates V virtual nodes by stacking model state ``[V, ...]``
and running a sampled C-node cohort per round
(``RoundExecutor(engine="batched", population=V)`` over a ring(C) cohort
topology, cohort ids drawn by ``repro_torch.faults.CohortSampler``). Per
population scale it measures:

  * **rounds/s**: sampled-cohort rounds dispatched K at a time after a
    warmup, a fresh cohort every round, host clock around the dispatches
    ended by a device sync;
  * **bytes**: the stacked state's exact byte count (parameters and
    optimizer state) and the peak device memory on the card
    (``torch.cuda.max_memory_allocated``), or the process's peak RSS on
    the CPU;
  * **builds**: no build of the round after the warmup, whatever the
    cohorts.

Before any scale runs, a gate at C = V = 8 holds the batched engine
bitwise against the dense executor on model state and metrics, plain and
C-DFL QSGD, with a full cohort and with a sampled node mask (``--check``
asserts it). The reference's loss draws its noise from its key; the port's
takes none, so the per-node jitter is drawn by numpy per global node id
and carried in the batches.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_megascale \\
        --smoke --check [--device cuda]

``--smoke`` runs the 10k-node scale only; the default also runs 100k.
Writes ``results/repro_torch/bench_megascale.json``.
"""
from __future__ import annotations

import argparse
import resource
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.benchmarks.common import save_result
from repro_torch.core import (DFLConfig, RoundExecutor, init_state,
                              make_compressor, ring)
from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.faults import CohortSampler
from repro_torch.optim import sgd

C = 8                  # cohort size == cohort topology nodes
DIM = 16
ETA = 0.05
TAU1, TAU2 = 2, 1
SUPERSTEP = 10
ROUNDS = 30            # sampled rounds measured per scale
SCALES = (10_000, 100_000)
SMOKE_SCALES = (10_000,)
JITTER = 0.02


def noisy_loss(p, b):
    return torch.mean((p["w"] + b["j"] - b["t"]) ** 2)


def batches_for(ids: np.ndarray, jitter: np.ndarray, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """Targets [K, TAU1, C, DIM] from ``seed`` and each slot's jitter, the
    row of its global id in ``jitter`` [V, TAU1, DIM]."""
    k = ids.shape[0]
    t = np.random.default_rng(seed).normal(size=(k, TAU1, C, DIM))
    j = jitter[ids].transpose(0, 2, 1, 3)
    return {"t": torch.from_numpy(t.astype(np.float32)).to(device),
            "j": torch.from_numpy(np.ascontiguousarray(j)).to(device)}


def tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def _run_small(engine: str, taus: np.ndarray, device, compression=None):
    opt = sgd(ETA)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=ring(C),
                    compression=compression, gamma=0.5)
    state = init_state({"w": torch.zeros(DIM, device=device)}, C, opt,
                       compressed=compression is not None, seed=1)
    kw = (dict(engine="batched", population=C) if engine == "batched"
          else dict(participation=True))
    ex = RoundExecutor(cfg, noisy_loss, opt, **kw)
    jitter = (JITTER * np.random.default_rng(1).normal(
        size=(C, TAU1, DIM))).astype(np.float32)
    ids = np.tile(np.arange(C), (taus.shape[0], 1))
    return ex.dispatch_trajectory(state, batches_for(ids, jitter, 7, device),
                                  taus)


def parity_gate(device) -> Dict[str, bool]:
    """The batched engine at C = V bitwise the dense executor on model
    state and metrics, full and sampled-as-masks, plain and QSGD."""
    k = 3
    plain = np.tile(np.array([[TAU1, TAU2]], np.int32), (k, 1))
    e = ring(C).num_edges
    nm = np.random.default_rng(0).integers(0, 2, (k, C)).astype(np.int32)
    nm[:, 0] = 1
    masked_dense = np.concatenate([plain, nm, np.ones((k, e), np.int32)], 1)
    ids = np.tile(np.arange(C, dtype=np.int32), (k, 1))
    masked_batch = np.concatenate([plain, ids, nm, np.ones((k, e),
                                                           np.int32)], 1)
    qsgd = make_compressor("qsgd", levels=4)
    out: Dict[str, bool] = {}
    for name, t_dense, t_batch, comp in (
            ("plain_full", plain, plain, None),
            ("plain_sampled_masks", masked_dense, masked_batch, None),
            ("choco_full", plain, plain, qsgd),
            ("choco_sampled_masks", masked_dense, masked_batch, qsgd)):
        sd, md = _run_small("dense", t_dense, device, comp)
        sb, mb = _run_small("batched", t_batch, device, comp)
        trees = [(x.params, x.opt_state, x.hat_params) for x in (sd, sb)]
        ok = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(trees[0]) + tree_leaves(md),
            tree_leaves(trees[1]) + tree_leaves(mb)))
        out[name] = ok
        print(f"parity[{name}]: {'BITWISE' if ok else 'DIVERGED'}")
    return out


def measure_scale(population: int, rounds: int, device) -> dict:
    opt = sgd(ETA)
    topo = ring(C)
    ex = RoundExecutor(DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo),
                       noisy_loss, opt, engine="batched",
                       population=population)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = init_state({"w": torch.zeros(DIM, device=device)}, population,
                       opt, seed=1)
    state_bytes = tree_bytes(state.params) + tree_bytes(state.opt_state)
    sampler = CohortSampler(population=population, cohort=C, seed=0)
    jitter = (JITTER * np.random.default_rng(1).normal(
        size=(population, TAU1, DIM))).astype(np.float32)
    # every chunk's rows and batches are built before the clock starts
    chunks = []
    for r in range(0, rounds, SUPERSTEP):
        k = min(SUPERSTEP, rounds - r)
        rows = sampler.cohort_trajectory(
            np.tile(np.array([[TAU1, TAU2]], np.int32), (k, 1)), r,
            num_edges=topo.num_edges)
        chunks.append((batches_for(rows[:, 2:2 + C], jitter, 3 + r, device),
                       rows))
    ex.warmup(state, chunks[0][0])
    warm_builds = ex.compile_count
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    losses: List[torch.Tensor] = []
    t0 = time.perf_counter()
    for b, rows in chunks:
        state, metrics = ex.dispatch_trajectory(state, b, rows)
        losses.append(metrics["loss"][-1])
    final_loss = float(losses[-1])  # waits for the device
    elapsed = time.perf_counter() - t0
    builds = ex.compile_count - warm_builds
    if builds:
        raise RuntimeError(f"{builds} builds across cohort draws at "
                           f"V={population}")
    moved = float(state.params["w"][torch.from_numpy(
        sampler.draw(0).astype(np.int64)).to(device)].abs().max())
    res = {"virtual_nodes": population, "cohort": C, "rounds": rounds,
           "rounds_per_s": rounds / elapsed, "elapsed_s": elapsed,
           "state_bytes": state_bytes, "state_mb": state_bytes / 1e6,
           "final_loss": final_loss, "trained": moved > 0.0,
           "builds_after_warmup": builds}
    if device.type == "cuda":
        res["peak_device_mb"] = torch.cuda.max_memory_allocated(device) / 1e6
    else:
        res["peak_rss_mb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0
    mem = (f"peak_device={res['peak_device_mb']:.1f} MB"
           if "peak_device_mb" in res
           else f"peak_rss={res['peak_rss_mb']:.0f} MB")
    print(f"V={population:>9,}: {res['rounds_per_s']:.1f} rounds/s  "
          f"state={res['state_mb']:.2f} MB ({state_bytes} bytes)  {mem}  "
          f"builds after warmup={builds}")
    return res


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the 10k-node scale only")
    ap.add_argument("--check", action="store_true",
                    help="assert the bitwise gate and trained scales")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="bench_megascale")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    parity = parity_gate(dev)
    scales = SMOKE_SCALES if args.smoke else SCALES
    results = [measure_scale(v, args.rounds, dev) for v in scales]
    payload = {
        "config": {"cohort": C, "dim": DIM, "eta": ETA, "tau1": TAU1,
                   "tau2": TAU2, "superstep": SUPERSTEP,
                   "rounds": args.rounds, "scales": list(scales),
                   "smoke": args.smoke, "device": str(dev),
                   "device_name": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu")},
        "parity": parity,
        "scales": results,
    }
    print(f"wrote {save_result(args.out, payload)}")
    if args.check:
        if not all(parity.values()):
            raise SystemExit(f"check failed: parity gate {parity}")
        if not all(r["trained"] for r in results):
            raise SystemExit("check failed: a scale did not train")
        print("check OK: batched bitwise == dense, sampled cohorts ride one "
              "build at every scale")
    return payload


if __name__ == "__main__":
    main()
