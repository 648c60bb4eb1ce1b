"""Train the paper's CNN with DFL / C-DFL: the port's ``run_dfl_cnn``.

Ported from ``benchmarks/common.py:run_dfl_cnn``, the harness behind the
paper figures: the same ``RunSpec``, the same numpy data and partitions,
the same history keys. Run it as::

    python -m repro_torch.launch.cnn_run --flavor cifar --compression top_k \\
        --frac 0.67 --gamma 0.6 --rounds 10

``--compression`` is one of top_k and rand_k (``--frac``), qsgd
(``--levels``) and rand_gossip (``--p``), or empty for plain DFL. The
random compressors draw from a generator seeded by ``--seed``.

The rounds run through ``core.executor.RoundExecutor`` at the spec's
(tau1, tau2): the rounds between two log points are one superstep (on
the card, replays of the executor's CUDA graphs), their host batches
built on a worker thread (``HostPrefetcher``), and the metrics stay on
the device until the log point (``MetricsBuffer``), as the reference
reads its jitted round only there. Nothing inside a dispatch reads the
device.

On the card it turns TF32 off for cuDNN convolutions and cuBLAS matmuls,
because the reference runs the CNN in f32, and by default holds cuDNN to
deterministic algorithms for the run, so two runs give the same history
(``--nondeterministic`` leaves cuDNN's defaults).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core.compression import make_compressor
from repro_torch.core.dfl import (DFLConfig, average_model, init_state,
                                  round_wire_bits)
from repro_torch.core.executor import (HostPrefetcher, MetricsBuffer,
                                       RoundExecutor, stack_round_batches)
from repro_torch.core.rng import Draws
from repro_torch.core.topology import (fully_connected, paper_quasi_ring,
                                       ring)
from repro_torch.core.tree import tree_map
from repro_torch.data.images import SyntheticImages, image_batches_for_dfl
from repro_torch.device import deterministic_algorithms, resolve_device
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
from repro_torch.optim import sgd

TF32_NOTE = ("TF32 off for cuDNN convolutions and cuBLAS matmuls: the "
             "reference runs the CNN in f32")


@functools.lru_cache(maxsize=2)
def get_data(flavor: str) -> SyntheticImages:
    """The reference harness's dataset for ``flavor`` (same seed, sizes)."""
    return SyntheticImages(flavor=flavor, train_size=3000, test_size=600,
                           seed=7)


@dataclasses.dataclass
class RunSpec:
    name: str
    tau1: int = 4
    tau2: int = 4
    topology: str = "ring"          # ring | quasi | full
    compression: str = ""
    comp_kwargs: Optional[dict] = None
    gamma: float = 1.0
    lr: float = 0.05
    flavor: str = "mnist"
    nodes: int = 10
    rounds: int = 40
    batch: int = 16
    partition: str = "dirichlet"
    seed: int = 0

    def topology_obj(self):
        if self.topology == "ring":
            return ring(self.nodes)
        if self.topology == "quasi":
            return paper_quasi_ring()
        if self.topology == "full":
            return fully_connected(self.nodes)
        raise ValueError(self.topology)


def log_points(rounds: int, log_every: int, log_first: int = 0
               ) -> List[int]:
    """The 0-based rounds after which the history is logged: the first
    ``log_first``, every ``log_every``-th and the last."""
    return [r for r in range(rounds)
            if r < log_first or (r + 1) % log_every == 0 or r == rounds - 1]


def run_dfl_cnn(spec: RunSpec, device="cuda", log_every: int = 5,
                draws: Optional[Draws] = None,
                deterministic: bool = True,
                telemetry=None, log_first: int = 0) -> Dict:
    """Train ``spec`` on ``device``; returns the reference's result dict
    plus ``round_ms``: per round, the wall time of its superstep (the
    rounds since the last log point, from before their dispatch to the log
    point's wait for the device) divided by its K, in ms. ``draws``
    replaces the RNG seam seeded by ``spec.seed`` (on the card it must be a
    ``GeneratorDraws``: the executor's graphs draw under a device key).
    ``deterministic``: cuDNN's deterministic algorithms for the run, so
    that two calls give the same history (the flags are restored after).
    ``telemetry``: a ``repro_torch.obs.Telemetry`` sink for the executor's,
    the prefetcher's and the metrics buffer's events. ``log_first``: the
    first rounds, each logged too (``log_points``)."""
    with deterministic_algorithms(deterministic):
        return _run(spec, resolve_device(device),
                    log_points(spec.rounds, log_every, log_first), draws,
                    deterministic, telemetry)


def _run(spec: RunSpec, dev: torch.device, ends: List[int],
         draws: Optional[Draws], deterministic: bool, telemetry) -> Dict:
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    data = get_data(spec.flavor)
    parts = data.partition(spec.nodes, scheme=spec.partition, seed=spec.seed)
    comp = (make_compressor(spec.compression, **(spec.comp_kwargs or {}))
            if spec.compression else None)
    cfg = DFLConfig(tau1=spec.tau1, tau2=spec.tau2,
                    topology=spec.topology_obj(), compression=comp,
                    gamma=spec.gamma)
    opt = sgd(spec.lr)

    def loss_fn(params, batch):
        return cnn_loss(params, batch, flavor=spec.flavor)

    params0 = init_cnn(torch.Generator().manual_seed(spec.seed), spec.flavor,
                       device=dev)
    state = init_state(params0, spec.nodes, opt, compressed=cfg.is_compressed,
                       seed=spec.seed, draws=draws)
    executor = RoundExecutor(cfg, loss_fn, opt, deterministic=deterministic,
                             telemetry=telemetry)
    bits_per_round = round_wire_bits(cfg, params0, engine="sparse")

    test_x = torch.from_numpy(data.test_x).to(dev)
    test_y = torch.from_numpy(data.test_y).to(dev)
    gtrain_x = torch.from_numpy(data.train_x[:1000]).to(dev)
    gtrain_y = torch.from_numpy(data.train_y[:1000]).to(dev)
    hist: Dict[str, List[float]] = {
        "round": [], "iteration": [], "loss": [], "global_loss": [],
        "consensus": [], "test_acc": [], "gbits": [],
    }
    round_ms: List[float] = []
    t0 = time.perf_counter()

    def host_rounds(r0: int, k: int):
        return [image_batches_for_dfl(data, parts, spec.tau1, spec.batch, r,
                                      seed=spec.seed)
                for r in range(r0, r0 + k)]

    windows = [(a + 1, b - a) for a, b in zip([-1] + ends, ends)]
    buffer = MetricsBuffer(telemetry=telemetry)
    prefetch = HostPrefetcher(telemetry=telemetry)
    try:
        if windows:
            prefetch.schedule(host_rounds, *windows[0])
        for i, (r0, k) in enumerate(windows):
            host, _ = prefetch.take()
            if i + 1 < len(windows):
                prefetch.schedule(host_rounds, *windows[i + 1])
            batches = stack_round_batches(host, spec.tau1, dev)
            if i == 0:      # the graphs, captured before the clock runs
                executor.warmup(state, tree_map(lambda b: b[:1], batches))
            t_dispatch = time.perf_counter()
            state, m = executor.dispatch(state, batches, spec.tau1,
                                         spec.tau2)
            buffer.push(r0, k, spec.tau1, spec.tau2, m,
                        dispatched_at=t_dispatch)
            rows = buffer.flush()               # the log point's one wait
            round_ms += [row["round_s"] * 1e3 for row in rows]
            r = r0 + k - 1
            loss, consensus = rows[-1]["loss"], rows[-1]["consensus_sq"]
            with torch.no_grad():
                avg = average_model(state.params)
                acc = float(cnn_accuracy(avg, test_x, test_y, spec.flavor))
                gloss = float(cnn_loss(avg, (gtrain_x, gtrain_y),
                                       spec.flavor))
            hist["round"].append(r + 1)
            hist["iteration"].append((r + 1) * (spec.tau1 + spec.tau2))
            hist["loss"].append(loss)
            hist["global_loss"].append(gloss)
            hist["consensus"].append(consensus)
            hist["test_acc"].append(acc)
            hist["gbits"].append((r + 1) * bits_per_round / 1e9)
    finally:
        prefetch.close()
    return {
        "spec": dataclasses.asdict(spec),
        "device": str(dev),
        "tf32": TF32_NOTE if dev.type == "cuda" else None,
        "bits_per_round": bits_per_round,
        "zeta": cfg.topology.zeta,
        "wall_s": time.perf_counter() - t0,
        "round_ms": round_ms,
        "history": hist,
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--flavor", default="cifar", choices=("mnist", "cifar"))
    p.add_argument("--compression", default="",
                   choices=("", "top_k", "qsgd", "rand_k", "rand_gossip"),
                   help="'' for plain DFL")
    p.add_argument("--frac", type=float, default=0.67,
                   help="top_k and rand_k: kept fraction")
    p.add_argument("--levels", type=int, default=16, help="qsgd: levels s")
    p.add_argument("--p", type=float, default=0.8,
                   help="rand_gossip: keep probability")
    p.add_argument("--gamma", type=float, default=0.6)
    p.add_argument("--topology", default="ring")
    p.add_argument("--nodes", type=int, default=10)
    p.add_argument("--tau1", type=int, default=4)
    p.add_argument("--tau2", type=int, default=4)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--nondeterministic", action="store_true",
                   help="leave cuDNN free to pick nondeterministic algorithms")
    a = p.parse_args(argv)
    kw = {"top_k": {"frac": a.frac}, "rand_k": {"frac": a.frac},
          "qsgd": {"levels": a.levels},
          "rand_gossip": {"p": a.p}}.get(a.compression, {})
    spec = RunSpec(name=f"cnn-{a.flavor}-{a.compression or 'dfl'}",
                   tau1=a.tau1, tau2=a.tau2, topology=a.topology,
                   compression=a.compression, comp_kwargs=kw,
                   gamma=a.gamma if a.compression else 1.0, lr=a.lr,
                   flavor=a.flavor, nodes=a.nodes, rounds=a.rounds,
                   batch=a.batch, seed=a.seed)
    out = run_dfl_cnn(spec, device=a.device, log_every=a.log_every,
                      deterministic=not a.nondeterministic)
    if out["tf32"]:
        print(out["tf32"])
    h = out["history"]
    for i, r in enumerate(h["round"]):
        print(json.dumps({"round": r, "loss": h["loss"][i],
                          "consensus": h["consensus"][i],
                          "global_loss": h["global_loss"][i],
                          "test_acc": h["test_acc"][i],
                          "round_ms": out["round_ms"][r - 1]}))
    return out


if __name__ == "__main__":
    main()
