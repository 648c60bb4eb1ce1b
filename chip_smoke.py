#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (five
   sources) with nvcc for sm_90a, in parallel, and print the build time.
2. Hold each of the seven kernels against its plain PyTorch version on the
   card, bitwise, at the CIFAR CNN's stacked leaf shapes [10, D] and the
   reference's parity sizes, in f32 and bf16, with ties, k = D, k = 1,
   all-zero rows (QSGD norm 0), -0.0 entries and QSGD levels 4 and 16;
   K1, K4 and K6 also over whole leaf lists in one call (the CIFAR leaves,
   the parity sizes), K4 and K6 also cut into small chunks, K1 also at
   N = 1024, K6 also on a leaf of 70,000 rows; the plan structs of K1, K4
   and K6 are held against the kernels' own (a ctypes layout check), and
   K6's registers and spill bytes a thread are printed.
   Then time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, at the main path's shapes
   (device time from CUDA-graph replay, CUDA events): K1, K4 and K6 one
   call over all 10 leaves of a gossip step (K6 also one launch per leaf,
   summed), and at the d1 leaf alone (K6 in bf16 too); the others one
   launch per leaf, summed over a step. The RNG seam's draws on the card
   bitwise the CPU's (``check_seam``).
3. The main path, through ``run_dfl_cnn``: the paper's CIFAR CNN at full
   width on a 10-node ring, tau1 = tau2 = 4, batch 16, gamma 0.6, for 3
   rounds each of C-DFL TopK (frac 0.67), plain DFL, C-DFL QSGD (16
   levels), C-DFL randomized gossip (p 0.8) and C-DFL RandK (frac 0.67),
   then TopK and QSGD through the substrate's ``compress`` hook on the
   stacked leaves (QSGD in one K6 launch for the tree). The
   launch counts are set to 0 before each and must rise by exactly what
   the round predicts. The first round of each run is repeated on the CPU
   (plain versions, the card's random draws replayed) and must agree
   within the stated tolerance. Then one round each of C-DFL TopK, plain
   DFL and C-DFL QSGD split into its local and gossip phases, and
   profiled for the device's busy time.
4. The round executor on the same CNN and ring, plain DFL and C-DFL TopK,
   maxima (4, 4): a warmup dispatch, the trajectory [[4,4],[2,1],[3,0]]
   and a uniform K = 3 dispatch at (4, 4), with exact launch counts, no
   build after the warmup, the state kept in place, the synchronizing CUDA
   calls inside each dispatch counted and named, and each held against 3
   sequential rounds on the card; then ms per round one round a dispatch
   against 3 a dispatch (``benchmarks/bench_round_overhead.py``). One
   plain-DFL round with ``mixing_impl="dense_power"`` against the iterated
   round. K1 at ``fully_connected(10)`` (9 shifts), bitwise and timed over
   the CIFAR leaves.
4b. The executor's rounds as CUDA graphs (``run_graph_phase``): replayed
   dispatches of plain DFL, C-DFL TopK, QSGD, randomized gossip and RandK,
   and masked rows, bitwise
   ``make_round_fn``'s eager rounds on the card with the same launch
   counts, no synchronizing call, no capture or build after the warmup
   across a re-plan and a new K; eager against replayed ms per round, the
   device busy share and peak memory; a capture forced to fail raises; the
   quadratic dispatch measurement with the reference's 2x bar applied.
4c. ``RoundExecutor(overlap="pipeline")`` (``run_pipeline_phase``):
   bitwise the eager pipelined superstep, the six pipelined CIFAR rounds
   against the CPU's (``PIPELINE_RUN_RTOL``, which a control with K1
   perturbed must break), ms per round against ``overlap="none"``, and
   how long kernels of the exchange's stream overlapped the local steps'.
5. The quickstart (``repro_torch.examples.quickstart``), 60 rounds of each
   variant on the card, held against a CPU run (C-DFL QSGD with the card's
   draws replayed, as a whole run within ``QSGD_RUN_RTOL``, which a
   control run with K2 perturbed must break, and round by round from the
   card's state); each paper-figure bench (``repro_torch.benchmarks``)
   at 2 rounds (Table I at its 8-round floor) on MNIST into a temporary
   directory, every row finite, Fig. 10's launches exact.
6. Sporadic participation at full width (``run_participation_phase``):
   the CIFAR CNN, 10-node ring, tau1 = tau2 = 4, 6 rounds of a fault plan
   (node 3 crashed over rounds 1-2, edges (0, 1) and (4, 5) out over
   rounds 2-4, sporadic participation over rounds 3-5) in two K = 3
   dispatches of ``RoundExecutor(participation=True)``, for plain DFL,
   C-DFL TopK and C-DFL QSGD: all-ones rows bitwise the unmasked
   executor, node 3's parameters and step bitwise frozen, exact launches
   (K1 once per gossip step), no synchronizing call in a dispatch; each
   round held against the CPU from the card's state, the 6 rounds against
   the CPU's run of the same rows (``CIFAR_RUN_RTOL``), both with the
   card's draws. 6b: the quickstart's convex problem under a 60-round
   fault plan, plain DFL, C-DFL TopK and QSGD, each whole run on the card
   against the CPU's (``MASKED_RUN_RTOL``), which a control run with K1
   perturbed must break.
7. The node-batched engine at full width (``run_batched_phase``): the
   CIFAR CNN over V = 1000 virtual nodes, sampled cohorts of 10, 3 rounds
   of plain DFL and C-DFL QSGD: rows outside the cohorts bitwise
   untouched, the population kept in place, peak device memory; an
   identity cohort at V = C = 10 bitwise the dense executor.
8. ``bench_faults --smoke --check`` and ``bench_megascale --smoke
   --check``.
9. ``run_dfl_cnn`` twice under ``deterministic=True``: bitwise equal
   histories; once more with ``deterministic=False`` for the switch's
   cost in round time.
10. The planner driving the executor (``run_planner_phase``):
   ``bench_trajectory --smoke --check`` on the card (no build or capture
   after the warmup, the trajectory beating every fixed grid point, K1
   exactly once a gossip step in every dispatch, the final losses against
   the CPU's); the adaptive controller driving the CIFAR CNN at full
   width from measured chunk times (``launch.planned_run``, plain DFL and
   C-DFL QSGD, executor maxima (16, 8), a 2 s budget): no build or
   capture after the warmup across every re-plan and probe, no
   synchronizing call in a dispatch, exact launches, finite losses, the
   spend within the budget plus one chunk; ``bench_balance`` on MNIST at
   10 rounds a grid point with exact launches, the measured winner and
   the planner's pick printed per ratio.
11. Print the kernels line, the build and total wall times, the card's
   name and power limit, and the final ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when ``torch.cuda.is_available()`` is
false or when the ``src`` tree is missing.

``python3 chip_smoke.py --calibrate-qsgd`` prints, after the build and the
seam check, the readings behind the whole-run limits of phases 5, 6 and
6b (``calibrate_qsgd``, ``run_masked_quickstart`` over seeds and
controls, ``cifar_sensitivity``, phase 6 with controls), holding none of
them, and exits. ``python3 chip_smoke.py --only NAME ...`` runs the named
phases after the build (``graphs``, ``pipeline``, ``pipeline_calibrate``:
phase 4c's readings and controls ungated, ...) and prints no result.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside tensor cores
RUN_ROUNDS = 3
CPU_LOSS_RTOL = 1e-4         # conv / matmul reduction order differs by device
CPU_CONSENSUS_RTOL = 1e-3    # and a TopK boundary or QSGD level may flip
PARITY_SIZES = (64, 1000, 32768, 32769, 300 * 70)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        bits(a), bits(b))


def max_abs_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def device_ms(fn, iters=20, reps=5):
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events (no host overhead;
    inputs stay warm in L2 where they fit, as between gossip steps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


class Kernel:
    """One kernel's record for the final ``kernels`` line."""

    def __init__(self, name, source, replaces, has_library):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = 0.0
        self.bytes_s = self.ops_s = 0.0
        self.library_ms = 0.0 if has_library else None
        self.launches = 0

    def add_bound(self, nbytes, nops):
        """One launch's work: bytes moved at the memory rate and f32
        operations at the peak rate; the launch takes at least the larger."""
        self.bytes_s += nbytes / HBM_BYTES_PER_S
        self.ops_s += nops / F32_OPS_PER_S

    def record(self):
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": self.launches,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms,
                "bound_ms": max(self.bytes_s, self.ops_s) * 1e3,
                "bound_by": ("bytes" if self.bytes_s >= self.ops_s
                             else "operations"),
                "library_ms": self.library_ms}


def qsgd_c(levels, d):
    from repro_torch.core.compression import QSGD
    return QSGD(levels=levels)._c(d)


def check_batched(K, gen, cifar_sizes):
    """Phase 2a, K1, K4 and K6 over leaf lists in one call: the CIFAR leaves
    and the parity sizes, f32 and bf16, normal data and ties with a zero and
    a -0.0 row, k = 1, 0.67 D and D; K4 and K6 also cut into chunks of 64,
    so that every row of more than 64 spans several blocks; K1 also on a
    1024-node ring, where the tile shrinks to fit the slab; K6 with a zero
    row, -0.0 entries and levels 4 and 16, and on a leaf of 70,000 rows."""
    from repro_torch.core.mixing import gossip_table
    from repro_torch.core.topology import ring
    from repro_torch.kernels import gossip_mix, ops, qsgd, topk

    def held(name, got, want, what):
        K[name].max_abs_err = max(K[name].max_abs_err, max_abs_err(got, want))
        require(same_bits(got, want), f"{name} differs: {what}")

    nbr, w = (torch.from_numpy(a).cuda() for a in gossip_table(ring(10)))
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for sizes in (cifar_sizes, PARITY_SIZES):
            xs = [torch.randn(10, d, generator=gen, device="cuda").to(dtype)
                  for d in sizes]
            ties = [(torch.round(x.float() * 4) / 4).to(dtype) for x in xs]
            for t in ties:
                t[2] = 0
                t[5] = -0.0
            for got, x in zip(ops.gossip_mix_many(xs, nbr, w), xs):
                held("gossip_mix", got, gossip_mix.plain(x, nbr, w),
                     f"list of {len(sizes)}, D {x.shape[1]} {dtype}")
            for data in (xs, ties):
                for frac in (0.0, 0.67, 1.0):
                    ks = [max(1, math.ceil(frac * d)) for d in sizes]
                    want = [topk.threshold_plain(x, k)
                            for x, k in zip(data, ks)]
                    got = ops.topk_threshold_many(data, ks)
                    small = [torch.empty_like(t) for t in want]
                    topk.launch_threshold_many(data, ks, small, chunk=64)
                    for g, sm, t, k in zip(got, small, want, ks):
                        what = f"list of {len(sizes)}, k {k} {dtype}"
                        held("topk_threshold", g, t, what)
                        held("topk_threshold", sm, t, what + ", chunk 64")
                    cases += 2
            cases += 1
            noises = [torch.rand(10, d, generator=gen, device="cuda")
                      for d in sizes]
            for x in xs:
                x[3] = 0
                x[:, ::5] = -0.0
            cases += check_quantize_many(K, xs, noises, held)
        tall = [torch.randn(70000, d, generator=gen, device="cuda").to(dtype)
                for d in (12, 10)]
        cases += check_quantize_many(
            K, tall, [torch.rand(x.shape, generator=gen, device="cuda")
                      for x in tall], held)
        nbr_big, w_big = (torch.from_numpy(a).cuda()
                          for a in gossip_table(ring(1024)))
        xs = [torch.randn(1024, d, generator=gen, device="cuda").to(dtype)
              for d in (10, 64, 1000, 4800)]
        for got, x in zip(ops.gossip_mix_many(xs, nbr_big, w_big), xs):
            held("gossip_mix", got, gossip_mix.plain(x, nbr_big, w_big),
                 f"N 1024, D {x.shape[1]} {dtype}")
        cases += 1
    torch.cuda.synchronize()
    print(f"batched K1 / K4 / K6 vs plain: {cases} list calls, all bitwise")
    plan, leaves, leaf = qsgd.checked_layout()
    print(f"K6 plan struct: {plan} bytes for {leaves} leaves ({leaf} a "
          "leaf), the kernel's and the wrapper's alike")
    print("K6 registers and local (spill) bytes a thread "
          + json.dumps(qsgd.kernel_attributes()))


def check_quantize_many(K, xs, noises, held):
    """K6 over the leaves ``xs`` in one call, and cut into chunks of 64,
    at levels 4 and 16, against the plain version leaf by leaf."""
    from repro_torch.kernels import ops, qsgd

    norms = [torch.linalg.vector_norm(x.float(), dim=1) for x in xs]
    for levels in (4, 16):
        cs = [qsgd_c(levels, x.shape[1]) for x in xs]
        scs = [qsgd.scale(levels, c) for c in cs]
        got = ops.qsgd_quantize_many(xs, noises, norms, levels, cs)
        small = [torch.empty_like(x) for x in xs]
        qsgd.launch_many(xs, noises, norms, float(levels), scs, small,
                         chunk=64)
        for g, sm, x, noise, norm, sc in zip(got, small, xs, noises, norms,
                                             scs):
            want = qsgd.plain(x, noise, norm, levels, sc)
            what = (f"list of {len(xs)}, {tuple(x.shape)} {x.dtype} levels "
                    f"{levels}")
            held("qsgd_quantize", g, want, what)
            held("qsgd_quantize", sm, want, what + ", chunk 64")
    return 4


def check_kernels(K, gen):
    """Phase 2a: every kernel bitwise against its plain version."""
    from repro_torch.core.mixing import gossip_table
    from repro_torch.core.topology import ring
    from repro_torch.kernels import (choco_fused, choco_update, gossip_mix,
                                     ops, qsgd, topk)
    from repro_torch.models.cnn import init_cnn

    leaves = init_cnn(torch.Generator().manual_seed(0), "cifar", "cuda")
    sizes = [v.numel() for v in leaves.values()] + list(PARITY_SIZES)
    nbr, w = (torch.from_numpy(a).cuda() for a in gossip_table(ring(10)))
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in sizes:
            x = torch.randn(10, d, generator=gen, device="cuda").to(dtype)
            ties = (torch.round(x.float() * 4) / 4).to(dtype)
            ties[2] = 0
            ties[5] = -0.0
            # K1
            got, want = ops.gossip_mix(x, nbr, w), gossip_mix.plain(x, nbr, w)
            K["gossip_mix"].max_abs_err = max(K["gossip_mix"].max_abs_err,
                                              max_abs_err(got, want))
            require(same_bits(got, want), f"gossip_mix differs at {d} {dtype}")
            # K4 and K5
            for data in (x, ties):
                for k in sorted({1, math.ceil(0.67 * d), d}):
                    t, t_plain = (ops.topk_threshold(data, k),
                                  topk.threshold_plain(data, k))
                    K["topk_threshold"].max_abs_err = max(
                        K["topk_threshold"].max_abs_err,
                        max_abs_err(t, t_plain))
                    require(same_bits(t, t_plain),
                            f"topk_threshold differs at {d} k={k} {dtype}")
                    m, m_plain = (ops.topk_mask(data, t_plain),
                                  topk.mask_plain(data, t_plain))
                    K["topk_mask"].max_abs_err = max(
                        K["topk_mask"].max_abs_err, max_abs_err(m, m_plain))
                    require(same_bits(m, m_plain),
                            f"topk_mask differs at {d} k={k} {dtype}")
                    cases += 2
            # K3
            y = torch.randn(10, d, generator=gen, device="cuda").to(dtype)
            my = torch.randn(10, d, generator=gen, device="cuda").to(dtype)
            for xx in (x, ties):
                gap = choco_fused.gap(xx, y, my, 0.6)
                t = topk.threshold_plain(gap, math.ceil(0.67 * d))
                got = ops.choco_topk(xx, y, my, gap, t, 0.6)
                want = choco_fused.plain(xx, y, my, gap, t, 0.6)
                for a, b in zip(got, want):
                    K["choco_topk"].max_abs_err = max(
                        K["choco_topk"].max_abs_err, max_abs_err(a, b))
                    require(same_bits(a, b),
                            f"choco_topk differs at {d} {dtype}")
            cases += 3
            # K7, K6 and K2: -0.0 entries, all-zero rows and a zero gap
            # (norm 0), levels 4 and 16
            noise = torch.rand(10, d, generator=gen, device="cuda")
            signed = x.clone()
            signed[:, ::5] = -0.0
            signed[3] = 0
            for xx in (x, ties, signed):
                got = ops.choco_move(xx, y, my, 0.6)
                want = choco_update.plain(xx, y, my, 0.6)
                for a, b in zip(got, want):
                    K["choco_move"].max_abs_err = max(
                        K["choco_move"].max_abs_err, max_abs_err(a, b))
                    require(same_bits(a, b),
                            f"choco_move differs at {d} {dtype}")
                xq, myq = xx.clone(), my.clone()
                xq[4], myq[4] = y[4], y[4]
                gap = choco_fused.gap(xq, y, myq, 0.6)
                gnorm = torch.linalg.vector_norm(gap.float(), dim=1)
                xnorm = torch.linalg.vector_norm(xx.float(), dim=1)
                require(float(gnorm[4]) == 0.0, "the zero-gap row has a norm")
                for levels in (4, 16):
                    c = qsgd_c(levels, d)
                    sc = qsgd.scale(levels, c)
                    got = ops.qsgd_quantize(xx, noise, xnorm, levels, c)
                    want = qsgd.plain(xx, noise, xnorm, levels, sc)
                    K["qsgd_quantize"].max_abs_err = max(
                        K["qsgd_quantize"].max_abs_err, max_abs_err(got, want))
                    require(same_bits(got, want),
                            f"qsgd_quantize differs at {d} {dtype} {levels}")
                    got = ops.choco_qsgd(xq, y, myq, noise, gnorm, 0.6,
                                         levels, c)
                    want = choco_fused.qsgd_plain(xq, y, myq, noise, gnorm,
                                                  0.6, levels, sc)
                    for a, b in zip(got, want):
                        K["choco_qsgd"].max_abs_err = max(
                            K["choco_qsgd"].max_abs_err, max_abs_err(a, b))
                        require(same_bits(a, b), f"choco_qsgd differs at "
                                f"{d} {dtype} levels {levels}")
                cases += 5
    torch.cuda.synchronize()
    print(f"kernels vs plain: {cases} cases over {len(sizes)} sizes x "
          "{f32, bf16}, all bitwise")
    check_batched(K, gen, [v.numel() for v in leaves.values()])


def time_kernels(K, gen):
    """Phase 2b: device times per gossip step over the CIFAR CNN's leaves
    (each leaf [10, D] f32): K1, K4 and K6 one call over all leaves, as the
    round and the ``compress`` hook make it (K6 also one launch per leaf,
    summed), the others one launch per leaf; and the bounds. K4's library
    time is the faster of ``torch.topk`` and ``torch.kthvalue``."""
    from repro_torch.core.mixing import gossip_table
    from repro_torch.core.topology import ring
    from repro_torch.kernels import (choco_fused, choco_update, gossip_mix,
                                     ops, qsgd, topk)
    from repro_torch.models.cnn import init_cnn

    leaves = init_cnn(torch.Generator().manual_seed(0), "cifar", "cuda")
    topo = ring(10)
    nbr, w = (torch.from_numpy(a).cuda() for a in gossip_table(topo))
    deg = nbr.shape[1]
    ct = torch.as_tensor(topo.mixing.T, dtype=torch.float32, device="cuda")
    per_leaf, step = [], {"x": [], "k": [], "noise": [], "xnorm": [],
                          "c": []}
    for name, leaf in leaves.items():
        n, d = 10, leaf.numel()
        x, y, my = (torch.randn(n, d, generator=gen, device="cuda")
                    for _ in range(3))
        k = math.ceil(0.67 * d)
        gap = choco_fused.gap(x, y, my, 0.6)
        t = topk.threshold_plain(gap, k)
        xa = x.abs()
        noise = torch.rand(n, d, generator=gen, device="cuda")
        gnorm = torch.linalg.vector_norm(gap, dim=1)
        xnorm = torch.linalg.vector_norm(x, dim=1)
        c = qsgd_c(16, d)
        sc = qsgd.scale(16, c)
        e = n * d
        K["gossip_mix"].add_bound(8 * e + 4 * nbr.numel() + 4 * w.numel(),
                                  (2 * deg + 1) * e)
        K["topk_threshold"].add_bound(4 * e + 4 * n, e)
        K["topk_mask"].add_bound(8 * e + 4 * n, e)
        K["choco_topk"].add_bound(24 * e + 4 * n, 5 * e)
        K["choco_qsgd"].add_bound(24 * e + 8 * n, 13 * e)
        K["qsgd_quantize"].add_bound(12 * e + 4 * n, 8 * e)
        K["choco_move"].add_bound(20 * e, 4 * e)
        for key, v in (("x", x), ("k", k), ("noise", noise), ("xnorm", xnorm),
                       ("c", c)):
            step[key].append(v)
        row = {"leaf": name, "D": d}
        if name == "d1":
            row["gossip_mix"] = {"ms": device_ms(
                lambda: ops.gossip_mix(x, nbr, w))}
            row["topk_threshold"] = {
                "ms": device_ms(lambda: ops.topk_threshold(x, k)),
                "topk_ms": device_ms(lambda: torch.topk(xa, k, dim=1)),
                "kthvalue_ms": device_ms(
                    lambda: torch.kthvalue(xa, d - k + 1, dim=1))}
            xb = x.bfloat16()
            xbnorm = torch.linalg.vector_norm(xb.float(), dim=1)
            row["qsgd_quantize_bf16"] = {
                "ms": device_ms(
                    lambda: ops.qsgd_quantize(xb, noise, xbnorm, 16, c)),
                "plain_ms": device_ms(
                    lambda: qsgd.plain(xb, noise, xbnorm, 16, sc)),
                "bound_ms": (8 * e + 4 * n) / HBM_BYTES_PER_S * 1e3}
        for kname, kern, plain, lib in (
                ("topk_mask", lambda: ops.topk_mask(x, t),
                 lambda: topk.mask_plain(x, t), None),
                ("choco_topk",
                 lambda: ops.choco_topk(x, y, my, gap, t, 0.6),
                 lambda: choco_fused.plain(x, y, my, gap, t, 0.6), None),
                ("choco_qsgd",
                 lambda: ops.choco_qsgd(x, y, my, noise, gnorm, 0.6, 16, c),
                 lambda: choco_fused.qsgd_plain(x, y, my, noise, gnorm, 0.6,
                                                16, sc), None),
                ("qsgd_quantize",
                 lambda: ops.qsgd_quantize(x, noise, xnorm, 16, c),
                 lambda: qsgd.plain(x, noise, xnorm, 16, sc), None),
                ("choco_move", lambda: ops.choco_move(x, y, my, 0.6),
                 lambda: choco_update.plain(x, y, my, 0.6), None)):
            kms, pms = device_ms(kern), device_ms(plain)
            K[kname].ms += kms
            K[kname].plain_ms += pms
            row[kname] = {"ms": kms, "plain_ms": pms}
            if lib is not None:
                row[kname]["library_ms"] = device_ms(lib)
                K[kname].library_ms += row[kname]["library_ms"]
        per_leaf.append(row)
    for row in per_leaf:
        print("leaf ms " + json.dumps(row))
    xs, ks = step["x"], step["k"]
    xas = [x.abs() for x in xs]
    noises, xnorms, cs = step["noise"], step["xnorm"], step["c"]
    per_leaf_sum = K["qsgd_quantize"].ms
    timed = {"gossip_mix": (
        lambda: ops.gossip_mix_many(xs, nbr, w),
        lambda: [gossip_mix.plain(x, nbr, w) for x in xs],
        {"C.T @ X": lambda: [ct @ x for x in xs]}), "topk_threshold": (
        lambda: ops.topk_threshold_many(xs, ks),
        lambda: [topk.threshold_plain(x, k) for x, k in zip(xs, ks)],
        {"torch.topk": lambda: [torch.topk(xa, k, dim=1)
                                for xa, k in zip(xas, ks)],
         "torch.kthvalue": lambda: [
             torch.kthvalue(xa, xa.shape[1] - k + 1, dim=1)
             for xa, k in zip(xas, ks)]}), "qsgd_quantize": (
        lambda: ops.qsgd_quantize_many(xs, noises, xnorms, 16, cs),
        lambda: [qsgd.plain(x, noise, xnorm, 16, qsgd.scale(16, c))
                 for x, noise, xnorm, c in zip(xs, noises, xnorms, cs)], {})}
    for kname, (kern, plain, libs) in timed.items():
        K[kname].ms, K[kname].plain_ms = device_ms(kern), device_ms(plain)
        lib_ms = {lname: device_ms(fn) for lname, fn in libs.items()}
        if lib_ms:
            K[kname].library_ms = min(lib_ms.values())
        line = {"kernel": kname, "leaves": len(xs), "ms": K[kname].ms,
                "plain_ms": K[kname].plain_ms, "library_ms": lib_ms}
        if kname == "qsgd_quantize":
            line["per_leaf_launches_ms"] = per_leaf_sum
        print("step ms " + json.dumps(line))


class RecordingDraws:
    """A run's RNG seam that keeps a host copy of its first round's draws
    (of every round's with ``every_round``), so that the CPU can replay
    them (``repro_torch.core.rng``)."""

    def __init__(self, inner, every_round=False):
        self.inner, self.table, self.every_round = inner, {}, every_round

    def uniform(self, round_idx, step, leaf, shape, node_ids=None):
        return self.uniform_many(round_idx, step, [leaf], [shape],
                                 node_ids)[0]

    def uniform_many(self, round_idx, step, leaves, shapes, node_ids=None):
        outs = self.inner.uniform_many(round_idx, step, leaves, shapes,
                                       node_ids)
        if node_ids is None and (round_idx == 0 or self.every_round):
            for leaf, out in zip(leaves, outs):
                self.table[(round_idx, step, leaf)] = out.cpu().numpy()
        return outs


def check_seam():
    """The RNG seam's draws on the card are bitwise the CPU's: every CIFAR
    leaf, for every node of a 10-node seam and for id sets of a
    1000-node population."""
    from repro_torch.core.rng import GeneratorDraws
    from repro_torch.models.cnn import init_cnn

    params = init_cnn(torch.Generator().manual_seed(0), "cifar", "cpu")
    for nodes, key, ids in ((10, (0, 0), None), (10, (3, 2), None),
                            (1000, (5, 3), [999, 3, 42]),
                            (1000, (2, 1), range(10))):
        card, host = (GeneratorDraws(7, nodes, params, dev)
                      for dev in ("cuda", "cpu"))
        for name, v in params.items():
            a = card.uniform(*key, name, tuple(v.shape), ids)
            b = host.uniform(*key, name, tuple(v.shape), ids)
            require(same_bits(a.cpu(), b), f"seam: {name} at {key}, ids "
                    f"{ids}: the card's draws differ from the CPU's")
    print("seam: the card's draws bitwise the CPU's (10 CIFAR leaves, 4 "
          "id sets)")


def select_launches(sizes):
    """K4 launches of one topk_threshold_many call over f32 leaves of
    ``sizes`` (at most 32): one per digit when a row spans several
    chunks, else one."""
    from repro_torch.kernels import topk
    passes = len(topk.DIGITS[torch.float32])
    return passes if max(sizes) > topk.CHUNK else 1


def step_launches(compression, sizes):
    """Kernel launches of one gossip step over the f32 leaves of ``sizes``:
    K1 once for the whole tree; TopK one K4 call for every leaf's gap, K3
    per leaf; QSGD K2 per leaf; randomized gossip K7 per leaf; RandK K7
    and one K4 call per leaf, on its scores."""
    per_leaf = len(sizes)
    each = {"": {},
            "top_k": {"topk_threshold": select_launches(sizes),
                      "choco_topk": per_leaf},
            "qsgd": {"choco_qsgd": per_leaf},
            "rand_gossip": {"choco_move": per_leaf},
            "rand_k": {"choco_move": per_leaf,
                       "topk_threshold": sum(select_launches([d])
                                             for d in sizes)}}[compression]
    return {"gossip_mix": 1, **each}


def run_main_path(K):
    """Phase 3: C-DFL (TopK, QSGD, randomized gossip, RandK) and plain DFL
    rounds of the CIFAR CNN on the card, with the launch counts each must
    produce, then the TopK and QSGD compressors."""
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.dfl import replicate
    from repro_torch.core.rng import GeneratorDraws, ReplayDraws
    from repro_torch.core.substrate import DenseSubstrate
    from repro_torch.core.topology import ring
    from repro_torch.kernels import ops, qsgd, topk
    from repro_torch.launch.cnn_run import RunSpec, run_dfl_cnn
    from repro_torch.models.cnn import init_cnn

    def make_spec(label, compression="", **kw):
        return RunSpec(name=f"smoke-{label}", tau1=4, tau2=4, topology="ring",
                       compression=compression, comp_kwargs=kw,
                       gamma=0.6 if compression else 1.0, flavor="cifar",
                       nodes=10, rounds=RUN_ROUNDS, batch=16)

    runs = {"cdfl_topk": make_spec("cdfl_topk", "top_k", frac=0.67),
            "dfl": make_spec("dfl"),
            "cdfl_qsgd": make_spec("cdfl_qsgd", "qsgd", levels=16),
            "cdfl_rand_gossip": make_spec("cdfl_rand_gossip", "rand_gossip",
                                          p=0.8),
            "cdfl_rand_k": make_spec("cdfl_rand_k", "rand_k", frac=0.67)}
    leaves = init_cnn(torch.Generator().manual_seed(1), "cifar", "cuda")
    sizes = [v.numel() for v in leaves.values()]
    totals = dict.fromkeys(K, 0)
    for label, spec in runs.items():
        steps = spec.tau2 * spec.rounds
        expect = dict.fromkeys(K, 0)
        for name, n in step_launches(spec.compression, sizes).items():
            expect[name] = steps * n
        draws = RecordingDraws(GeneratorDraws(spec.seed, spec.nodes, leaves,
                                              "cuda"))
        ops.reset_launches()
        out = run_dfl_cnn(spec, device="cuda", log_every=1, draws=draws)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        print(f"{label}: {out['tf32']}")
        h = out["history"]
        for i, r in enumerate(h["round"]):
            print(f"{label} " + json.dumps({
                "round": r, "loss": h["loss"][i],
                "consensus": h["consensus"][i],
                "global_loss": h["global_loss"][i],
                "test_acc": h["test_acc"][i], "ms": out["round_ms"][i]}))
        require(all(math.isfinite(v) for key in ("loss", "consensus",
                                                 "global_loss")
                    for v in h[key]), f"{label}: non-finite metrics")
        require(counts == expect,
                f"{label}: launches {counts}, expected {expect}")
        print(f"{label} launches " + json.dumps(counts))
        for key in totals:
            totals[key] += counts[key]
        # the first round again on the CPU, through the plain versions,
        # with the card's draws
        ref = run_dfl_cnn(dataclasses.replace(spec, rounds=1), device="cpu",
                          log_every=1,
                          draws=ReplayDraws(draws.table, device="cpu"))
        ref = ref["history"]
        for key, rtol in (("loss", CPU_LOSS_RTOL),
                          ("consensus", CPU_CONSENSUS_RTOL)):
            a, b = h[key][0], ref[key][0]
            require(abs(a - b) <= rtol * abs(b),
                    f"{label}: round-1 {key} {a} on the card vs {b} on the "
                    f"CPU, beyond rtol {rtol}")
        print(f"{label} round 1 card vs CPU: loss {h['loss'][0]} / "
              f"{ref['loss'][0]}, consensus {h['consensus'][0]} / "
              f"{ref['consensus'][0]} (rtol {CPU_LOSS_RTOL}, "
              f"{CPU_CONSENSUS_RTOL}), {len(draws.table)} draws replayed")

    # K5 and K6 on the main path: TopK and QSGD on every node's slice of
    # each stacked leaf, through the substrate's compress hook (TopK leaf by
    # leaf, QSGD in one K6 launch for the tree)
    params = {k: v + 0.01 * torch.randn_like(v)
              for k, v in replicate(leaves, 10).items()}
    draws = GeneratorDraws(0, 10, leaves, "cuda")
    sub = DenseSubstrate(ring(10))
    for name, kw, expect_launches in (
            ("top_k", {"frac": 0.67},
             {"topk_threshold": sum(select_launches([d]) for d in sizes),
              "topk_mask": len(leaves)}),
            ("qsgd", {"levels": 16}, {"qsgd_quantize": 1})):
        comp = make_compressor(name, **kw)
        noise = {k: comp.draw(draws, 0, 0, k, v[0].numel())
                 for k, v in params.items()}
        ops.reset_launches()
        compressed = sub.compress(comp, params, draws, 0, 0)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        expect = dict.fromkeys(K, 0)
        expect.update(expect_launches)
        require(counts == expect, f"{name} compressor: launches {counts}, "
                f"expected {expect}")
        for k, v in params.items():
            rows = v.reshape(10, -1)
            if name == "top_k":
                want = topk.mask_plain(rows, topk.threshold_plain(
                    rows, math.ceil(0.67 * rows.shape[1])))
            else:
                norm = torch.linalg.vector_norm(rows, dim=1)
                want = qsgd.plain(rows, noise[k], norm, 16, qsgd.scale(
                    16, qsgd_c(16, rows.shape[1])))
            require(same_bits(compressed[k].reshape(10, -1), want),
                    f"{name} compressor differs from its plain version on {k}")
        print(f"{name} compress launches " + json.dumps(counts))
        for key in totals:
            totals[key] += counts[key]
    for key, n in totals.items():
        K[key].launches = n
        require(n > 0, f"{key} was never launched on the main path")


def round_breakdown():
    """Phase 3b: where a main-path round's time goes. After one warm round,
    3 rounds split into the local phase and the gossip phase (host clock,
    each phase ended by a device sync), then one round under
    torch.profiler for the device's busy time and its largest kernels."""
    from repro_torch.core import dfl
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.substrate import DenseSubstrate
    from repro_torch.core.topology import ring
    from repro_torch.data.images import image_batches_for_dfl
    from repro_torch.launch.cnn_run import get_data
    from repro_torch.benchmarks.common import busy_ms, kernel_events
    from repro_torch.models.cnn import cnn_loss, init_cnn
    from repro_torch.optim import sgd
    from torch.profiler import ProfilerActivity, profile

    data = get_data("cifar")
    parts = data.partition(10, seed=0)
    opt = sgd(0.05)

    def loss_fn(p, b):
        return cnn_loss(p, b, "cifar")

    for label, comp, gamma in (
            ("cdfl_topk", make_compressor("top_k", frac=0.67), 0.6),
            ("dfl", None, 1.0),
            ("cdfl_qsgd", make_compressor("qsgd", levels=16), 0.6)):
        cfg = dfl.DFLConfig(4, 4, ring(10), compression=comp, gamma=gamma)
        sub = DenseSubstrate(cfg.topology)
        state = dfl.init_state(init_cnn(torch.Generator().manual_seed(0),
                                        "cifar", "cuda"), 10, opt,
                               compressed=cfg.is_compressed)
        params, opt_state, hat = (state.params, state.opt_state,
                                  state.hat_params)
        local, gossip = [], []
        for r in range(5):
            xs, ys = image_batches_for_dfl(data, parts, 4, 16, r)
            batches = (torch.from_numpy(xs).cuda(),
                       torch.from_numpy(ys).cuda())
            prof = None
            if r == 4:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, _ = dfl.local_phase(cfg, loss_fn, opt, sub,
                                                   params, opt_state, batches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, hat = dfl.gossip_phase(cfg, sub, params, hat,
                                           state.draws, r)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
            elif r > 0:
                local.append((t1 - t0) * 1e3)
                gossip.append((t2 - t1) * 1e3)
        # kernels only: an operator's self device time repeats its kernels'
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms_total = busy_ms(kernel_events(prof))
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        round_ms = sum(local) / len(local) + sum(gossip) / len(gossip)
        print("round breakdown " + json.dumps({
            "run": label, "local_ms": local, "gossip_ms": gossip,
            "round_ms_mean": round_ms,
            "profiled_round_ms": (t2 - t0) * 1e3,
            "device_busy_ms": device_ms_total,
            "device_busy_share": device_ms_total / round_ms,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}))


def add_launches(K, counts):
    for key, n in counts.items():
        K[key].launches += n


def expect_launches(K, **counts):
    expect = dict.fromkeys(K, 0)
    expect.update(counts)
    return expect


def check_full_mix(K, gen):
    """Phase 4, K1 on ``fully_connected(10)``: 9 shifts, a [10, 9] table
    and [10, 10] weights, every block a 10-row slab; bitwise against the
    plain version over the CIFAR leaves in f32 and bf16, then timed per
    step (one call over all 10 leaves) against its bound and ``C.T @ X``."""
    from repro_torch.core.mixing import gossip_table
    from repro_torch.core.topology import fully_connected
    from repro_torch.kernels import gossip_mix, ops
    from repro_torch.models.cnn import init_cnn

    topo = fully_connected(10)
    nbr, w = (torch.from_numpy(a).cuda() for a in gossip_table(topo))
    require(tuple(nbr.shape) == (10, 9) and tuple(w.shape) == (10, 10),
            f"full(10) table {tuple(nbr.shape)}, weights {tuple(w.shape)}")
    leaves = init_cnn(torch.Generator().manual_seed(0), "cifar", "cuda")
    xs = [torch.randn(10, v.numel(), generator=gen, device="cuda")
          for v in leaves.values()]
    for dtype in (torch.float32, torch.bfloat16):
        xd = [x.to(dtype) for x in xs]
        for got, x in zip(ops.gossip_mix_many(xd, nbr, w), xd):
            want = gossip_mix.plain(x, nbr, w)
            K["gossip_mix"].max_abs_err = max(K["gossip_mix"].max_abs_err,
                                              max_abs_err(got, want))
            require(same_bits(got, want),
                    f"gossip_mix differs on full(10), D {x.shape[1]} {dtype}")
    deg = nbr.shape[1]
    nbytes = sum(8 * x.numel() + 4 * nbr.numel() + 4 * w.numel() for x in xs)
    nops = (2 * deg + 1) * sum(x.numel() for x in xs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_OPS_PER_S * 1e3
    ct = torch.as_tensor(topo.mixing.T, dtype=torch.float32, device="cuda")
    print("step ms " + json.dumps({
        "kernel": "gossip_mix", "topology": "fully_connected(10)",
        "shifts": deg, "leaves": len(xs), "bitwise": "f32, bf16",
        "ms": device_ms(lambda: ops.gossip_mix_many(xs, nbr, w)),
        "plain_ms": device_ms(lambda: [gossip_mix.plain(x, nbr, w)
                                       for x in xs]),
        "library_ms": {"C.T @ X": device_ms(lambda: [ct @ x for x in xs])},
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}))


def close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def clone_state(state):
    from repro_torch.core.tree import tree_map
    return state._replace(params=tree_map(torch.clone, state.params),
                          opt_state=tree_map(torch.clone, state.opt_state),
                          hat_params=tree_map(torch.clone, state.hat_params))


def run_executor_phase(K):
    """Phase 4, the round executor on the CIFAR CNN at full width, 10-node
    ring, maxima (4, 4), plain DFL and C-DFL TopK (frac 0.67, gamma 0.6):
    one warmup dispatch at the default (1, 0), which gossips nothing, so
    that the first gossip step's set-up falls inside a measured dispatch,
    then the trajectory [[4,4],[2,1],[3,0]], then a uniform
    K = 3 dispatch at (4, 4), each with exact launch counts and its
    synchronizing CUDA calls counted; no build after the warmup; the state
    kept in place. Each dispatch is held against 3 sequential static rounds
    on the card from the same state and batches (loss rtol 1e-4, consensus
    1e-3), with cuDNN held to its deterministic algorithms, since its
    backward otherwise varies from run to run and early rounds amplify it.
    Then ms per round, one round a dispatch against three, over a
    re-planned 12-round schedule, with cuDNN's defaults."""
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import (RoundExecutor, consensus_distance,
                                  make_round_fn)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops

    traj = [(4, 4), (2, 1), (3, 0)]
    for label, compression in (("dfl", ""), ("cdfl_topk", "top_k")):
        s = bro.cnn_setup(compression, rounds=12, device="cuda")
        ex = RoundExecutor(s.cfg(4, 4), s.loss_fn, s.opt)
        state = s.fresh()
        sizes = [v[0].numel() for v in state.params.values()]

        def stacked(r0):
            return tuple(torch.stack([s.batches[r][j]
                                      for r in range(r0, r0 + 3)])
                         for j in (0, 1))

        torch.backends.cudnn.deterministic = True
        try:
            ex.warmup(state, stacked(0))
            builds = ex.compile_count
            ptrs = [t.data_ptr() for t in tree_leaves(state)
                    if torch.is_tensor(t)]
            worst = dict.fromkeys(("loss", "consensus_sq"), 0.0)
            for what, run, rows, r0 in (
                    ("trajectory", lambda st: ex.dispatch_trajectory(
                        st, stacked(0), traj), traj, 0),
                    ("uniform", lambda st: ex.dispatch(st, stacked(3), 4, 4),
                     [(4, 4)] * 3, 3)):
                ref = clone_state(state)
                torch.cuda.synchronize()
                ops.reset_launches()
                (state, m), syncs = bro.syncs_in_dispatch(lambda: run(state))
                torch.cuda.synchronize()
                counts = dict(ops.LAUNCHES)
                steps = sum(t2 for _, t2 in rows)
                expect = expect_launches(K, gossip_mix=steps)
                if compression:
                    expect.update(
                        topk_threshold=steps * select_launches(sizes),
                        choco_topk=steps * len(sizes))
                require(counts == expect, f"executor {label} {what}: "
                        f"launches {counts}, expected {expect}")
                add_launches(K, counts)
                require(m["tau1"].tolist() == [t1 for t1, _ in rows]
                        and m["tau2"].tolist() == [t2 for _, t2 in rows],
                        f"executor {label} {what}: realized taus "
                        f"{m['tau1'].tolist()} {m['tau2'].tolist()}")
                print(f"executor {label} {what} " + json.dumps({
                    "launches": {k: v for k, v in counts.items() if v},
                    "syncs_in_dispatch": len(syncs), "sync_sites": syncs,
                    "loss": m["loss"].tolist(),
                    "consensus": m["consensus_sq"].tolist()}))
                for k, (t1, t2) in enumerate(rows):
                    xs, ys = s.batches[r0 + k]
                    ref, mr = make_round_fn(s.cfg(t1, t2), s.loss_fn, s.opt)(
                        ref, (xs[:t1], ys[:t1]))
                    for key, rtol in (("loss", CPU_LOSS_RTOL),
                                      ("consensus_sq", CPU_CONSENSUS_RTOL)):
                        a, b = float(m[key][k]), float(mr[key])
                        worst[key] = max(worst[key], abs(a - b) / abs(b))
                        require(close(a, b, rtol), f"executor {label} "
                                f"{what} round {k}: {key} {a} vs {b} "
                                f"sequentially, beyond rtol {rtol}")
                a, b = (float(consensus_distance(x.params))
                        for x in (state, ref))
                require(close(a, b, CPU_CONSENSUS_RTOL), f"executor {label} "
                        f"{what}: final consensus {a} vs {b} sequentially")
        finally:
            torch.backends.cudnn.deterministic = False
        require(ex.compile_count == builds, f"executor {label}: "
                f"{ex.compile_count - builds} builds after the warmup")
        require([t.data_ptr() for t in tree_leaves(state)
                 if torch.is_tensor(t)] == ptrs,
                f"executor {label}: the state did not stay in place")
        print(f"executor {label}: both dispatches match 3 sequential rounds "
              f"each (loss rtol {CPU_LOSS_RTOL}, consensus "
              f"{CPU_CONSENSUS_RTOL}); largest relative differences "
              f"{json.dumps(worst)}; builds {ex.compile_count}")
        timing = bro.bench(s, bro.replan_schedule(12, 3), 3)
        print(f"executor {label} ms per round " + json.dumps({
            mode: {k: v for k, v in timing[mode].items()
                   if k in ("ms_per_round", "dispatches",
                            "builds_after_warmup", "builds")}
            for mode in ("legacy", "executor_round", "executor_superstep")}
            | {"superstep_vs_round": timing["superstep_vs_round"],
               "schedule": "(4,4) x6 then (2,1) x6"}))


def run_dense_power(K):
    """Phase 4, one plain-DFL CIFAR round with ``mixing_impl="dense_power"``
    (one C^4 product, no K1) against the iterated round (4 K1 launches)."""
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import make_round_fn
    from repro_torch.kernels import ops

    s = bro.cnn_setup("", rounds=1, device="cuda")
    out = {}
    for impl, k1 in (("dense_power", 0), ("dense", 4)):
        cfg = dataclasses.replace(s.cfg(4, 4), mixing_impl=impl)
        torch.cuda.synchronize()
        ops.reset_launches()
        _, m = make_round_fn(cfg, s.loss_fn, s.opt)(s.fresh(), s.batches[0])
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        require(counts == expect_launches(K, gossip_mix=k1),
                f"{impl} round: launches {counts}")
        add_launches(K, counts)
        out[impl] = {k: float(v) for k, v in m.items()}
    a, b = out["dense_power"]["consensus_sq"], out["dense"]["consensus_sq"]
    require(close(a, b, 1e-4), f"dense_power consensus {a} vs iterated {b}")
    print("dense_power round vs iterated " + json.dumps(out))


def replay_rounds(round_fn, cpu_round_fn, state, batches, extra, draws,
                  cpu_draws):
    """Rounds of ``round_fn`` on the card from ``state`` (``batches[r]`` and
    the host arguments ``extra[r]`` of round r), each repeated on the CPU
    by ``cpu_round_fn`` from a host copy of the card's state before it,
    with ``cpu_draws``: (final card state, card metrics, CPU metrics and
    outputs, round by round). The card's draws come from ``draws``."""
    from repro_torch.core.tree import tree_map

    card, cpu = [], []
    state = state._replace(draws=draws)
    for b, args in zip(batches, extra):
        host = to_cpu_state(state, cpu_draws)
        state, m = round_fn(state, b, *args)
        card.append({k: float(v) for k, v in m.items()})
        out, mc = cpu_round_fn(host, tree_map(lambda t: t.cpu(), b), *args)
        cpu.append(({k: float(v) for k, v in mc.items()}, out))
    return state, card, cpu


# C-DFL QSGD's 60-round quickstart, card against CPU with the same draws:
# a gap within an ulp of a level boundary quantizes to the next level on one
# device and not on the other, and those flips carry the two runs apart by
# parts in ten thousand whatever the draws. The limits sit between the
# largest difference over the seam's seeds and a control run whose K2 has
# ``x_new`` shifted by 1e-5 (QSGD_CONTROL), which must break them (readings:
# ``python3 chip_smoke.py --calibrate-qsgd``, PERF.md).
QSGD_RUN_RTOL = {"loss": 1e-3, "err": 1e-3, "largest_loss": 1e-3,
                 "consensus": 1e-2}
QSGD_CONTROL = ("choco_qsgd", "x_shift", 1e-5)


def whole_run_diffs(got, cpu):
    """Relative differences of a quickstart run on the card from one on the
    CPU: final loss, |w - w*|, final consensus, and the largest loss
    difference over the rounds."""
    def rel(a, b):
        return abs(a - b) / abs(b)
    return {"loss": rel(got["losses"][-1], cpu["losses"][-1]),
            "err": rel(got["err"], cpu["err"]),
            "consensus": rel(got["consensus"][-1], cpu["consensus"][-1]),
            "largest_loss": max(rel(a, b) for a, b in zip(got["losses"],
                                                         cpu["losses"]))}


def within_run_rtol(diffs):
    return all(math.isfinite(diffs[k]) and diffs[k] <= v
               for k, v in QSGD_RUN_RTOL.items())


class perturbed:
    """Inside the block, kernel ``op`` of ``ops`` is perturbed on the card:
    ``("x_scale", e)`` writes its ``x_new`` (K2: ``choco_qsgd``) or every
    output leaf (K1: ``gossip_mix_many``) times 1 + e, ``("x_shift", e)``
    adds e to it, ``("noise", e)`` shifts K2's noise up by e (clamped below
    1), a quantizer that rounds up too often. A small bias every gossip
    step: the controls that a whole-run check must catch. The CPU's plain
    version is left alone."""

    def __init__(self, op, kind, eps):
        self.op, self.kind, self.eps = op, kind, eps

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, getattr(ops, self.op)
        op, kind, eps, orig = self.op, self.kind, self.eps, self.orig

        def bias(t):
            return t * (1 + eps) if kind == "x_scale" else t + eps

        def wrapped(x, *args):
            on_card = (x[0] if op == "gossip_mix_many" else x).is_cuda
            if not on_card:
                return orig(x, *args)
            if kind == "noise":
                y, my, noise, *rest = args
                noise = (noise + eps).clamp_(max=1 - 2.0 ** -24)
                return orig(x, y, my, noise, *rest)
            out = orig(x, *args)
            if op == "gossip_mix_many":
                return [bias(t) for t in out]
            return (bias(out[0]), *out[1:])
        setattr(ops, op, wrapped)

    def __exit__(self, *exc):
        setattr(self.ops, self.op, self.orig)


def quickstart_qsgd_runs(cfg, label, seed, rounds=60):
    """C-DFL QSGD's quickstart on the card under seam seed ``seed`` and on
    the CPU with the card's draws replayed: (card history, CPU history,
    the card's draw table)."""
    from repro_torch.core.rng import GeneratorDraws, ReplayDraws
    from repro_torch.examples import quickstart as qs

    draws = RecordingDraws(GeneratorDraws(seed, qs.N, ["w"], "cuda"),
                           every_round=True)
    got = qs.train(cfg, rounds, label, "cuda", draws)
    cpu = qs.train(cfg, rounds, label, "cpu", ReplayDraws(draws.table, "cpu"))
    return got, cpu, draws.table


def quickstart_round_by_round(cfg, table, seed, rounds=60):
    """The card's C-DFL QSGD loop again under seam seed ``seed``, each round
    repeated on the CPU from the card's state before it with the draws of
    ``table``: (card metrics a round, the largest relative differences a
    round, |w - w*| on the card and on the CPU after the last round)."""
    import numpy as np

    from repro_torch.core import init_state, make_round_fn
    from repro_torch.core.rng import GeneratorDraws, ReplayDraws
    from repro_torch.device import deterministic_algorithms
    from repro_torch.examples import quickstart as qs
    from repro_torch.optim import sgd

    opt = sgd(qs.LR)
    rng = np.random.default_rng(qs.DATA_SEED)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in qs.make_batches(rng, cfg.tau1).items()}
               for _ in range(rounds)]
    start = init_state({"w": torch.zeros(qs.DIM, device="cuda")}, qs.N, opt,
                       compressed=True, seed=seed)
    with deterministic_algorithms():
        final, cm, cpu_rounds = replay_rounds(
            make_round_fn(cfg, qs.loss_fn, opt),
            make_round_fn(cfg, qs.loss_fn, opt), start, batches,
            [()] * rounds, GeneratorDraws(seed, qs.N, ["w"], "cuda"),
            ReplayDraws(table, "cpu"))
    w_star = torch.from_numpy(qs.TRUE_W)
    errs = [float(torch.linalg.norm(t.params["w"].float().mean(0).cpu()
                                    - w_star))
            for t in (final, cpu_rounds[-1][1])]
    per_round = [{key: abs(a[key] - b[key]) / abs(b[key])
                  for key in ("loss", "consensus_sq")}
                 for a, (b, _) in zip(cm, cpu_rounds)]
    return cm, per_round, errs


def run_quickstart(K):
    """Phase 5, the quickstart's three variants, 60 rounds each on the card
    (K1 every gossip step, K2 every C-DFL QSGD step). C-SGD and DFL are
    held against a CPU run of the 60 rounds: loss and |w - w*| rtol 1e-4,
    consensus 1e-3. C-DFL QSGD, with the card's draws replayed on the CPU,
    is held twice: its 60-round run against the CPU's within
    ``QSGD_RUN_RTOL`` (final loss, |w - w*|, the largest loss difference
    over the rounds, final consensus), and round by round, each round
    repeated on the CPU from the card's state before it (loss and |w - w*|
    rtol 1e-4, consensus 1e-2: the final consensus, about 5e-6, is a
    residual of nearly equal models). A control run with K2 perturbed by
    ``QSGD_CONTROL`` (``perturbed``) must break the whole-run limits."""
    from repro_torch.core.rng import GeneratorDraws, ReplayDraws
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops

    rounds = 60
    torch.cuda.synchronize()
    ops.reset_launches()
    card = []
    for label, cfg in qs.variants():
        draws = (RecordingDraws(GeneratorDraws(1, qs.N, ["w"], "cuda"),
                                every_round=True)
                 if cfg.is_compressed else None)
        card.append((qs.train(cfg, rounds, label, "cuda", draws), draws))
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    variants = qs.variants()
    expect = expect_launches(
        K, gossip_mix=rounds * sum(c.tau2 for _, c in variants),
        choco_qsgd=rounds * sum(c.tau2 for _, c in variants
                                if c.is_compressed))
    require(counts == expect, f"quickstart: launches {counts}, expected "
            f"{expect}")
    add_launches(K, counts)
    for (label, cfg), (got, draws) in zip(variants, card):
        name = " ".join(label.split())
        cpu = qs.train(cfg, rounds, label, "cpu",
                       ReplayDraws(draws.table, "cpu") if draws else None)
        if draws is None:
            pairs = {"loss": (got["losses"][-1], cpu["losses"][-1], 1e-4),
                     "err": (got["err"], cpu["err"], 1e-4),
                     "consensus": (got["consensus"][-1], cpu["consensus"][-1],
                                   CPU_CONSENSUS_RTOL)}
            for key, (a, b, rtol) in pairs.items():
                require(math.isfinite(a) and close(a, b, rtol),
                        f"quickstart {label}: {key} {a} on the card vs {b} "
                        f"on the CPU, beyond rtol {rtol}")
            worst = {key: max(abs(a - b) / abs(b) for a, b in zip(got[key],
                                                                 cpu[key]))
                     for key in ("losses", "consensus")}
            print(f"quickstart {name} card vs CPU "
                  + json.dumps({k: v for k, v in pairs.items()}
                               | {"largest_relative_difference": worst}))
            continue
        whole = whole_run_diffs(got, cpu)
        require(within_run_rtol(whole), f"quickstart {label}: the 60-round "
                f"run on the card vs the CPU's {whole}, beyond "
                f"{QSGD_RUN_RTOL}")
        cm, per_round, errs = quickstart_round_by_round(cfg, draws.table, 1,
                                                        rounds)
        require([m["loss"] for m in cm] == got["losses"]
                and [m["consensus_sq"] for m in cm] == got["consensus"],
                f"quickstart {label}: the card's rounds differ between two "
                "runs with the same draws")
        for r, (a, d) in enumerate(zip(cm, per_round)):
            for key, rtol in (("loss", 1e-4), ("consensus_sq", 1e-2)):
                require(math.isfinite(a[key]) and d[key] <= rtol,
                        f"quickstart {label} round {r}: {key} {a[key]} on "
                        f"the card, {d[key]} apart from the CPU from the "
                        f"same state, beyond rtol {rtol}")
        require(close(errs[0], errs[1], 1e-4), f"quickstart {label}: "
                f"|w - w*| {errs[0]} on the card vs {errs[1]} on the CPU")
        with perturbed(*QSGD_CONTROL):
            control = qs.train(cfg, rounds, label, "cuda",
                               GeneratorDraws(1, qs.N, ["w"], "cuda"))
        ctl = whole_run_diffs(control, cpu)
        require(not within_run_rtol(ctl), f"quickstart {label}: the control "
                f"({QSGD_CONTROL}) is within the whole-run "
                f"limits {QSGD_RUN_RTOL}: {ctl}")
        print(f"quickstart {name} card vs CPU " + json.dumps({
            "whole_run": whole, "whole_run_rtol": QSGD_RUN_RTOL,
            "round_by_round_largest_relative_difference": {
                k: max(d[k] for d in per_round)
                for k in ("loss", "consensus_sq")},
            "err": errs, "control": QSGD_CONTROL,
            "control_whole_run": ctl}))
    print("quickstart launches " + json.dumps(
        {k: v for k, v in counts.items() if v}))


def calibrate_qsgd(seeds=16, controls=(("noise", 1e-2), ("x_shift", 1e-5),
                                        ("x_scale", 1e-6))):
    """The readings behind ``QSGD_RUN_RTOL`` and ``QSGD_CONTROL``: the
    quickstart's C-DFL QSGD, card against CPU over the seam seeds
    ``range(seeds)``; the CPU's run of each seed against its run of seed 1
    (independent draws, where the two runs share nothing but the data);
    then K2 perturbed by each of ``controls`` (seam seed 1) against the
    CPU, as a whole run and round by round. One JSON line a run."""
    from repro_torch.core.rng import GeneratorDraws
    from repro_torch.examples import quickstart as qs

    label, cfg = next((lb, c) for lb, c in qs.variants() if c.is_compressed)
    runs = [quickstart_qsgd_runs(cfg, label, seed) for seed in range(seeds)]
    cpu, table = runs[1][1:]
    for seed, (got, cpu_s, _) in enumerate(runs):
        print("calibrate sound " + json.dumps(
            {"seed": seed, "card_vs_cpu": whole_run_diffs(got, cpu_s),
             "independent_draws": whole_run_diffs(cpu_s, cpu)}))
    for kind, eps in controls:
        with perturbed("choco_qsgd", kind, eps):
            got = qs.train(cfg, 60, label, "cuda",
                           GeneratorDraws(1, qs.N, ["w"], "cuda"))
            _, per_round, errs = quickstart_round_by_round(cfg, table, 1)
        print("calibrate control " + json.dumps({
            "control": [kind, eps], "whole_run": whole_run_diffs(got, cpu),
            "round_by_round_largest": {k: max(d[k] for d in per_round)
                                       for k in ("loss", "consensus_sq")},
            "round_by_round_err": abs(errs[0] - errs[1]) / abs(errs[1])}))


def run_figures(K):
    """Phase 5, every paper-figure bench on the card at 2 rounds (Table I
    at its 8-round floor), MNIST, results into a temporary directory: every
    row finite; Fig. 10's launches exact (its TopK runs: K4 and K3)."""
    import tempfile

    from repro_torch.benchmarks import (fig7_tau2, fig8_tau1, fig9_zeta,
                                        fig10_cdfl, table1_methods)
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import init_cnn

    sizes = [v.numel() for v in init_cnn(torch.Generator().manual_seed(0),
                                         "mnist", "cuda").values()]
    steps = 4 * 2  # tau2 x rounds of each Fig. 10 run
    n_topk = sum(c == "top_k" for _, c, _ in fig10_cdfl.VARIANTS)
    n_gossip = sum(c == "rand_gossip" for _, c, _ in fig10_cdfl.VARIANTS)
    fig10_expect = expect_launches(
        K, gossip_mix=steps * len(fig10_cdfl.VARIANTS),
        topk_threshold=steps * n_topk * select_launches(sizes),
        choco_topk=steps * n_topk * len(sizes),
        choco_move=steps * n_gossip * len(sizes))
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (
                ("fig7", lambda: fig7_tau2.run(rounds=2, device="cuda",
                                               results_dir=tmp)),
                ("fig8", lambda: fig8_tau1.run(rounds=2, device="cuda",
                                               results_dir=tmp)),
                ("fig9", lambda: fig9_zeta.run(rounds=2, device="cuda",
                                               results_dir=tmp)),
                ("fig10", lambda: fig10_cdfl.run(rounds=2, device="cuda",
                                                 results_dir=tmp)),
                ("table1", lambda: table1_methods.run(
                    budget_iters=16, device="cuda", results_dir=tmp))):
            files = len(os.listdir(tmp))
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            rows = run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(ops.LAUNCHES)
            for row in rows:
                for key, v in row.items():
                    if key == "consensus" or isinstance(v, float):
                        require(math.isfinite(float(v)),
                                f"{name}: {key} = {v} in {row}")
            if name == "fig10":
                require(counts == fig10_expect, f"fig10: launches {counts}, "
                        f"expected {fig10_expect}")
            require(len(os.listdir(tmp)) == files + 1,
                    f"{name}: wrote no result file")
            add_launches(K, counts)
            print(f"{name}: {len(rows)} rows in {dt:.2f} s, launches "
                  + json.dumps({k: v for k, v in counts.items() if v}))


FAULT_TAUS = (4, 4)
# The CNN's training amplifies any difference by about 10x a round from
# round 3 on (one ulp of the initial weights moves round 6's loss by 3e-3
# on the CPU), so the card's 6 masked rounds and the CPU's run of the same
# rows drift apart by a few percent whatever the code; the limits sit
# above the largest sound reading and below a control's
# (``python3 chip_smoke.py --calibrate-qsgd``, PERF.md). The tight check
# of a whole masked run is on the quickstart's convex problem (phase 6b).
CIFAR_RUN_RTOL = {"loss": 0.1, "consensus_sq": 0.15}
CIFAR_CONTROL = ("gossip_mix_many", "x_shift", 1e-3)
# C-DFL QSGD's consensus step in phases 6, 7 and 9: at 16 levels over the
# CIFAR leaves delta = 1/c is about 0.025, and gamma 0.6 (phase 3) does not
# contract, so its consensus overflows within 6 rounds; 0.1 stays finite
QSGD_GAMMA = 0.1


def fault_rows(topo, rounds=6):
    """The fault plan of phase 6 as [rounds, 2 + N + E] trajectory rows: a
    crash of node 3 over rounds 1-2, an outage of edges (0, 1) and (4, 5)
    over rounds 2-4, sporadic participation (p_node 0.8, p_edge 0.9) over
    rounds 3-5."""
    import numpy as np

    from repro_torch.faults import (FaultPlan, LinkOutage, NodeCrash,
                                    SporadicParticipation)
    plan = FaultPlan(topo, (
        NodeCrash(node=3, r_start=1, r_stop=3),
        LinkOutage(edges=((0, 1), (4, 5)), r_start=2, r_stop=5),
        SporadicParticipation(p_node=0.8, p_edge=0.9, r_start=3, r_stop=6)),
        seed=0)
    return plan.mask_trajectory(np.tile(np.array([FAULT_TAUS], np.int32),
                                        (rounds, 1)))


def to_cpu_state(state, draws):
    """A host copy of ``state`` (never sharing its storage) with ``draws``."""
    from repro_torch.core.tree import tree_map

    def host(t):
        return t.to("cpu", copy=True)

    return state._replace(params=tree_map(host, state.params),
                          opt_state=tree_map(host, state.opt_state),
                          hat_params=tree_map(host, state.hat_params),
                          draws=draws)


def same_state(a, b):
    from repro_torch.core.tree import tree_leaves
    la = tree_leaves((a.params, a.opt_state, a.hat_params))
    lb = tree_leaves((b.params, b.opt_state, b.hat_params))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def cifar_sensitivity():
    """How far the CNN's training carries a difference of one ulp: phase
    6's plain DFL and C-DFL TopK configurations unmasked, 6 rounds on the
    CPU from the initial weights and from the weights times 1 + 2**-23;
    prints the loss's relative difference a round."""
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import make_round_fn
    from repro_torch.core.tree import tree_map

    for label, compression in (("dfl", ""), ("cdfl_topk", "top_k")):
        s = bro.cnn_setup(compression, rounds=6, device="cpu")
        round_fn = make_round_fn(s.cfg(*FAULT_TAUS), s.loss_fn, s.opt)
        runs = []
        for scale in (1.0, 1.0 + 2.0 ** -23):
            st = s.fresh()
            st = st._replace(params=tree_map(lambda t: t * scale, st.params))
            losses = []
            for b in s.batches[:6]:
                st, m = round_fn(st, b)
                losses.append(float(m["loss"]))
            runs.append(losses)
        print("calibrate cifar_ulp " + json.dumps(
            {"run": label, "loss_relative_difference": [
                abs(a - b) / abs(b) for a, b in zip(*runs)]}))


def largest_differences(card, cpu):
    """The largest relative differences of loss and consensus, round by
    round, between two lists of per-round metrics."""
    return {key: max(abs(a[key] - b[key]) / abs(b[key])
                     for a, b in zip(card, cpu))
            for key in ("loss", "consensus_sq")}


def run_participation_phase(K, gate=True, controls=None):
    """Phase 6, sporadic participation at full width: the CIFAR CNN on a
    10-node ring, tau1 = tau2 = 4, batch 16, 6 rounds of the fault plan
    (``fault_rows``) in two K = 3 dispatches of
    ``RoundExecutor(participation=True)``, for plain DFL, C-DFL TopK (frac
    0.67, gamma 0.6) and C-DFL QSGD (16 levels, gamma ``QSGD_GAMMA``),
    cuDNN deterministic: exact launches, K1 once per gossip step, no
    synchronizing CUDA call inside a dispatch, no build after the warmup.
    All-ones rows are bitwise the unmasked executor. The same 6 rounds
    run again one by one on the card (``make_round_fn(...,
    participation=True)``) and must equal the dispatches bitwise; node 3's
    parameters and step count are bitwise the same before round 1 and
    after round 2; each round is held against the CPU from the card's
    state before it, with the card's draws, loss rtol 1e-4 and consensus
    1e-3; and the 6 rounds against the CPU's own run of the same rows
    within ``CIFAR_RUN_RTOL``, which the card's run with each of
    ``controls`` (``perturbed``'s arguments; default ``CIFAR_CONTROL``)
    must break. ``gate=False`` prints the differences without holding
    them."""
    import numpy as np

    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import RoundExecutor, make_round_fn
    from repro_torch.core.rng import GeneratorDraws, ReplayDraws
    from repro_torch.core.tree import tree_map
    from repro_torch.device import deterministic_algorithms
    from repro_torch.kernels import ops

    n = 10
    controls = (CIFAR_CONTROL,) if controls is None else controls
    for label, compression in (("dfl", ""), ("cdfl_topk", "top_k"),
                               ("cdfl_qsgd", "qsgd")):
        s = bro.cnn_setup(compression, rounds=6, device="cuda",
                          gamma=QSGD_GAMMA if compression == "qsgd" else 0.6)
        cfg = s.cfg(*FAULT_TAUS)
        rows = fault_rows(cfg.topology)
        sizes = [v[0].numel() for v in s.fresh().params.values()]

        def stacked(r0):
            return tuple(torch.stack([s.batches[r][j]
                                      for r in range(r0, r0 + 3)])
                         for j in (0, 1))

        ones = np.concatenate([rows[:3, :2], np.ones_like(rows[:3, 2:])], 1)
        plain, _ = RoundExecutor(cfg, s.loss_fn, s.opt).dispatch_trajectory(
            s.fresh(), stacked(0), rows[:3, :2])
        part, _ = RoundExecutor(cfg, s.loss_fn, s.opt, participation=True)\
            .dispatch_trajectory(s.fresh(), stacked(0), ones)
        require(same_state(plain, part), f"participation {label}: all-ones "
                "rows differ from the unmasked executor")
        state = s.fresh()
        ex = RoundExecutor(cfg, s.loss_fn, s.opt, participation=True)
        ex.warmup(state, stacked(0))
        builds = ex.compile_count
        steps = 3 * FAULT_TAUS[1]
        expect = expect_launches(K, gossip_mix=steps)
        if compression == "top_k":
            expect.update(topk_threshold=steps * select_launches(sizes),
                          choco_topk=steps * len(sizes))
        elif compression == "qsgd":
            expect.update(choco_qsgd=steps * len(sizes))
        metrics = []
        for d, r0 in enumerate((0, 3)):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            (state, m), syncs = bro.syncs_in_dispatch(
                lambda: ex.dispatch_trajectory(state, stacked(r0),
                                               rows[r0:r0 + 3]))
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            counts = dict(ops.LAUNCHES)
            require(counts == expect, f"participation {label} dispatch {d}: "
                    f"launches {counts}, expected {expect}")
            require(not syncs, f"participation {label} dispatch {d}: "
                    f"synchronizing calls {syncs}")
            add_launches(K, counts)
            metrics += [{k: float(v[i]) for k, v in m.items()}
                        for i in range(3)]
            print(f"participation {label} dispatch {d} " + json.dumps({
                "rounds": [r0, r0 + 1, r0 + 2],
                "active_nodes": m["active_nodes"].tolist(),
                "masked_edges": m["masked_edges"].tolist(),
                "loss": m["loss"].tolist(),
                "consensus": m["consensus_sq"].tolist(),
                "ms_per_round": dt / 3, "syncs_in_dispatch": len(syncs),
                "launches": {k: v for k, v in counts.items() if v}}))
        require(ex.compile_count == builds, f"participation {label}: "
                f"{ex.compile_count - builds} builds after the warmup")
        cpu_draws = None
        if compression == "qsgd":  # the card's draws, regenerated by index
            gd = GeneratorDraws(0, n, s.fresh().params, "cuda")
            cpu_draws = ReplayDraws(
                {(r, t, k): gd.uniform(r, t, k, (d,)).cpu().numpy()
                 for r in range(6) for t in range(FAULT_TAUS[1])
                 for k, d in zip(s.fresh().params, sizes)}, "cpu")
        round_fn = make_round_fn(cfg, s.loss_fn, s.opt, dynamic_taus=True,
                                 participation=True)
        extra = [(*FAULT_TAUS, row[2:2 + n], row[2 + n:]) for row in rows]
        start = s.fresh()
        hosts = []

        def card_round(st, b, *args):
            hosts.append(to_cpu_state(st, None))
            return round_fn(st, b, *args)

        with deterministic_algorithms():
            final, cm, cpu_rounds = replay_rounds(
                card_round, round_fn, start, s.batches, extra, start.draws,
                cpu_draws)
        require(same_state(final, state)
                and all(cm[r][k] == metrics[r][k] for r in range(6)
                        for k in ("loss", "consensus_sq")),
                f"participation {label}: the dispatches differ from the "
                "same rounds one by one on the card")
        require(all(torch.equal(hosts[1].params[k][3], hosts[3].params[k][3])
                    for k in hosts[1].params)
                and int(hosts[3].opt_state["step"][3]) == 4
                and hosts[3].opt_state["step"].tolist()
                == [12] * 3 + [4] + [12] * 6,
                f"participation {label}: node 3 moved while crashed (steps "
                f"{hosts[3].opt_state['step'].tolist()})")
        worst = {"loss": 0.0, "consensus_sq": 0.0}
        for r, (a, (b, _)) in enumerate(zip(cm, cpu_rounds)):
            for key, rtol in (("loss", CPU_LOSS_RTOL),
                              ("consensus_sq", CPU_CONSENSUS_RTOL)):
                worst[key] = max(worst[key], abs(a[key] - b[key]) / abs(b[key]))
                require(close(a[key], b[key], rtol), f"participation {label} "
                        f"round {r}: {key} {a[key]} on the card vs {b[key]} "
                        f"on the CPU from the same state, beyond rtol {rtol}")
        # the whole run on the CPU: the same start, rows and draws
        host, cpu_run = hosts[0]._replace(draws=cpu_draws), []
        for b, args in zip(s.batches, extra):
            host, mc = round_fn(host, tree_map(lambda t: t.cpu(), b), *args)
            cpu_run.append({k: float(v) for k, v in mc.items()})
        whole = largest_differences(cm, cpu_run)
        require(not gate or all(whole[k] <= v
                                for k, v in CIFAR_RUN_RTOL.items()),
                f"participation {label}: the 6 rounds on the card vs the "
                f"CPU's run of the same rows {whole}, beyond {CIFAR_RUN_RTOL}")
        for control in controls:
            st, ms = s.fresh(), []
            with perturbed(*control), deterministic_algorithms():
                for b, args in zip(s.batches, extra):
                    st, m = round_fn(st, b, *args)
                    ms.append({k: float(v) for k, v in m.items()})
            ctl = largest_differences(ms, cpu_run)
            require(not gate or any(ctl[k] > v
                                    for k, v in CIFAR_RUN_RTOL.items()),
                    f"participation {label}: the control {control} is within "
                    f"the whole-run limits {CIFAR_RUN_RTOL}: {ctl}")
            print(f"participation {label} control " + json.dumps(
                {"control": control, "whole_run": ctl}))
        print(f"participation {label}: all-ones bitwise the unmasked "
              "executor; the dispatches bitwise the same rounds one by one; "
              "node 3 frozen over rounds 1-2; card vs CPU, largest relative "
              "differences " + json.dumps({"round_by_round": worst,
                                            "whole_run": whole}))
        # round time without the sync check: the masked rows of rounds 3-5
        # against all-ones rows, in turns, from the state reached
        times = {"masked": [], "all_ones": []}
        for _ in range(2):
            for what, rr in (("masked", rows[3:6]), ("all_ones", ones)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = ex.dispatch_trajectory(state, stacked(3), rr)
                torch.cuda.synchronize()
                times[what].append((time.perf_counter() - t0) * 1e3 / 3)
        print(f"participation {label} ms per round " + json.dumps(times))


# Phase 6b: whole masked runs of the quickstart's convex problem, where a
# difference does not grow round after round as in the CNN: plain DFL held
# as the quickstart's DFL, TopK and QSGD as its C-DFL QSGD; a control with
# K1's output shifted by 1e-4 must break each (readings:
# ``python3 chip_smoke.py --calibrate-qsgd``, PERF.md).
MASKED_RUN_RTOL = {"dfl": {"loss": 1e-4, "err": 1e-4, "largest_loss": 1e-4,
                           "consensus": 1e-3},
                   "cdfl_topk": QSGD_RUN_RTOL, "cdfl_qsgd": QSGD_RUN_RTOL}
MASKED_CONTROL = ("gossip_mix_many", "x_shift", 1e-4)


def masked_quickstart_setup(rounds=60):
    """Phase 6b's variants (plain DFL, C-DFL TopK frac 0.5 and QSGD 16
    levels, gamma 0.5, the quickstart's ring(10) and tau (4, 4)) and its
    [rounds, 2 + N + E] rows: node 3 crashed over rounds 10-29, edges
    (0, 1) and (4, 5) out over rounds 20-49, sporadic participation
    (p_node 0.8, p_edge 0.9) over rounds 30-59."""
    import numpy as np

    from repro_torch.core import DFLConfig, make_compressor, ring
    from repro_torch.examples import quickstart as qs
    from repro_torch.faults import (FaultPlan, LinkOutage, NodeCrash,
                                    SporadicParticipation)
    topo = ring(qs.N)
    plan = FaultPlan(topo, (
        NodeCrash(node=3, r_start=10, r_stop=30),
        LinkOutage(edges=((0, 1), (4, 5)), r_start=20, r_stop=50),
        SporadicParticipation(p_node=0.8, p_edge=0.9, r_start=30,
                              r_stop=60)), seed=0)
    rows = plan.mask_trajectory(np.tile(np.array([[4, 4]], np.int32),
                                        (rounds, 1)))
    variants = [(label, DFLConfig(tau1=4, tau2=4, topology=topo,
                                  compression=comp, gamma=0.5 if comp else 1.0))
                for label, comp in (
                    ("dfl", None),
                    ("cdfl_topk", make_compressor("top_k", frac=0.5)),
                    ("cdfl_qsgd", make_compressor("qsgd", levels=16)))]
    return variants, rows


def masked_quickstart(cfg, rows, device, draws=None):
    """The quickstart's linear regression from w = 0 under the trajectory
    ``rows`` (one a round), round by round through ``make_round_fn(...,
    participation=True)`` on ``device``: a history as ``qs.train``'s."""
    import numpy as np

    from repro_torch.core import average_model, init_state, make_round_fn
    from repro_torch.device import deterministic_algorithms
    from repro_torch.examples import quickstart as qs
    from repro_torch.optim import sgd

    n, opt = qs.N, sgd(qs.LR)
    state = init_state({"w": torch.zeros(qs.DIM, device=device)}, n, opt,
                       compressed=cfg.is_compressed, seed=1, draws=draws)
    round_fn = make_round_fn(cfg, qs.loss_fn, opt, dynamic_taus=True,
                             participation=True)
    rng = np.random.default_rng(qs.DATA_SEED)
    history = []
    with deterministic_algorithms():
        for row in rows:
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in qs.make_batches(rng, cfg.tau1).items()}
            state, m = round_fn(state, b, int(row[0]), int(row[1]),
                                row[2:2 + n], row[2 + n:])
            history.append(m)
    w = average_model(state.params)["w"].cpu()
    return {"err": float(torch.linalg.norm(w - torch.from_numpy(qs.TRUE_W))),
            "losses": [float(m["loss"]) for m in history],
            "consensus": [float(m["consensus_sq"]) for m in history]}


def run_masked_quickstart(K, gate=True, seeds=(1,), controls=None):
    """Phase 6b: ``masked_quickstart_setup``'s 60 masked rounds of each
    variant on the card (exact launches: K1 once a gossip step, TopK one
    K4 and one K3, QSGD one K2) against the CPU's run of the same rows
    with the card's draws replayed, within ``MASKED_RUN_RTOL``; the card's
    run with each of ``controls`` (``perturbed``'s arguments; default
    ``MASKED_CONTROL``) must break those limits. ``seeds``: the seam's
    seeds for QSGD. ``gate=False`` prints the differences without holding
    them."""
    from repro_torch.core.rng import GeneratorDraws, ReplayDraws
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops

    controls = (MASKED_CONTROL,) if controls is None else controls
    variants, rows = masked_quickstart_setup()
    steps = int(rows[:, 1].sum())
    for label, cfg in variants:
        rtol = MASKED_RUN_RTOL[label]
        for seed in (seeds if cfg.is_compressed else (None,)):
            draws = (RecordingDraws(GeneratorDraws(seed, qs.N, ["w"], "cuda"),
                                    every_round=True)
                     if cfg.is_compressed else None)
            torch.cuda.synchronize()
            ops.reset_launches()
            got = masked_quickstart(cfg, rows, "cuda", draws)
            torch.cuda.synchronize()
            counts = dict(ops.LAUNCHES)
            expect = expect_launches(K, gossip_mix=steps, **{
                "dfl": {}, "cdfl_qsgd": {"choco_qsgd": steps},
                "cdfl_topk": {"topk_threshold": steps,
                              "choco_topk": steps}}[label])
            require(counts == expect, f"masked quickstart {label}: launches "
                    f"{counts}, expected {expect}")
            add_launches(K, counts)
            cpu = masked_quickstart(cfg, rows, "cpu", ReplayDraws(
                draws.table, "cpu") if draws else None)
            whole = whole_run_diffs(got, cpu)
            require(not gate or all(math.isfinite(whole[k]) and whole[k] <= v
                                    for k, v in rtol.items()),
                    f"masked quickstart {label}: the 60 rounds on the card vs "
                    f"the CPU's run of the same rows {whole}, beyond {rtol}")
            line = {"seed": seed, "whole_run": whole, "whole_run_rtol": rtol,
                    "final_loss": got["losses"][-1], "err": got["err"]}
            for control in controls:
                with perturbed(*control):
                    ctl = whole_run_diffs(masked_quickstart(
                        cfg, rows, "cuda", GeneratorDraws(seed, qs.N, ["w"],
                                                          "cuda")
                        if cfg.is_compressed else None), cpu)
                require(not gate or any(ctl[k] > v for k, v in rtol.items()),
                        f"masked quickstart {label}: the control {control} "
                        f"is within the whole-run limits {rtol}: {ctl}")
                line.setdefault("controls", []).append(
                    {"control": control, "whole_run": ctl})
            print(f"masked quickstart {label} card vs CPU " + json.dumps(line))


def run_batched_phase(K, pop=1000):
    """Phase 7, the node-batched engine at full width: the CIFAR CNN over a
    population of V = 1000 virtual nodes, cohorts of C = 10 on a 10-node
    ring drawn by ``CohortSampler(seed=0)``, 3 rounds in one dispatch of
    plain DFL and of C-DFL QSGD: rows outside the cohorts bitwise
    untouched, the state in place, exact launches, no synchronizing call in
    the dispatch, peak device memory; then an identity cohort at V = C = 10
    bitwise the dense executor."""
    import numpy as np

    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import (DFLConfig, RoundExecutor, init_state,
                                  make_compressor)
    from repro_torch.core.topology import ring
    from repro_torch.core.tree import tree_leaves
    from repro_torch.faults import CohortSampler
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import init_cnn

    c = 10
    s = bro.cnn_setup("", rounds=3, device="cuda")
    batches = tuple(torch.stack([s.batches[r][j] for r in range(3)])
                    for j in (0, 1))
    sampler = CohortSampler(population=pop, cohort=c, seed=0)
    taus = np.tile(np.array([FAULT_TAUS], np.int32), (3, 1))
    rows = sampler.cohort_trajectory(taus, num_edges=ring(c).num_edges)
    rows2 = sampler.cohort_trajectory(taus, 3, num_edges=ring(c).num_edges)
    cohort = np.unique(rows[:, 2:2 + c])
    others = torch.from_numpy(np.setdiff1d(np.arange(pop), cohort)).cuda()
    leaves = init_cnn(torch.Generator().manual_seed(0), "cifar", "cuda")
    sizes = [v.numel() for v in leaves.values()]
    for label, comp in (("dfl", None),
                        ("cdfl_qsgd", make_compressor("qsgd", levels=16))):
        cfg = DFLConfig(*FAULT_TAUS, ring(c), compression=comp,
                        gamma=QSGD_GAMMA if comp else 1.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(leaves, pop, s.opt, compressed=comp is not None)
        ex = RoundExecutor(cfg, s.loss_fn, s.opt, engine="batched",
                           population=pop)
        ex.warmup(state, batches)
        builds = ex.compile_count
        held = [t.index_select(0, others) for t in
                tree_leaves((state.params, state.opt_state,
                             state.hat_params))]
        ptrs = [t.data_ptr() for t in tree_leaves((state.params,
                                                   state.opt_state,
                                                   state.hat_params))]
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        (state, m), syncs = bro.syncs_in_dispatch(
            lambda: ex.dispatch_trajectory(state, batches, rows))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        steps = 3 * FAULT_TAUS[1]
        expect = expect_launches(K, gossip_mix=steps)
        if comp is not None:
            expect.update(choco_qsgd=steps * len(sizes))
        require(counts == expect, f"batched {label}: launches {counts}, "
                f"expected {expect}")
        require(not syncs, f"batched {label}: synchronizing calls {syncs}")
        require(ex.compile_count == builds, f"batched {label}: builds after "
                "the warmup")
        add_launches(K, counts)
        after = tree_leaves((state.params, state.opt_state, state.hat_params))
        require([t.data_ptr() for t in after] == ptrs,
                f"batched {label}: the population did not stay in place")
        require(all(torch.equal(t.index_select(0, others), h)
                    for t, h in zip(after, held)),
                f"batched {label}: a row outside the cohorts changed")
        steps_per_node = state.opt_state["step"]
        require(int(steps_per_node.sum()) == 3 * c * FAULT_TAUS[0]
                and all(math.isfinite(v) for v in m["loss"].tolist()),
                f"batched {label}: steps or loss off")
        print(f"batched {label} " + json.dumps({
            "population": pop, "cohort": c, "rounds": 3,
            "distinct_nodes": int(cohort.size),
            "loss": m["loss"].tolist(),
            "consensus": m["consensus_sq"].tolist(),
            "ms_per_round": dt / 3, "syncs_in_dispatch": len(syncs),
            "state_bytes": sum(t.numel() * t.element_size() for t in after),
            "peak_device_mb": torch.cuda.max_memory_allocated() / 1e6,
            "launches": {k: v for k, v in counts.items() if v}}))
        del held, after
        # the identity cohort at full population: the dense executor
        dense_ex = RoundExecutor(cfg, s.loss_fn, s.opt, participation=True)
        dense, md = dense_ex.dispatch_trajectory(
            init_state(leaves, c, s.opt, compressed=comp is not None),
            batches, rows[:, :2])
        ident, mi = RoundExecutor(cfg, s.loss_fn, s.opt, engine="batched",
                                  population=c).dispatch_trajectory(
            init_state(leaves, c, s.opt, compressed=comp is not None),
            batches, rows[:, :2])
        require(same_state(dense, ident)
                and all(torch.equal(md[k], mi[k]) for k in md),
                f"batched {label}: the identity cohort differs from the "
                "dense executor")
        # round time without the sync check: 3 more sampled rounds of the
        # population against 3 rounds of the dense executor, in turns
        times = {"batched": [], "dense": []}
        for _ in range(2):
            for what, run in (
                    ("batched", lambda: ex.dispatch_trajectory(
                        state, batches, rows2)),
                    ("dense", lambda: dense_ex.dispatch_trajectory(
                        dense, batches, rows[:, :2]))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _ = run()
                torch.cuda.synchronize()
                times[what].append((time.perf_counter() - t0) * 1e3 / 3)
                if what == "batched":
                    state = out
                else:
                    dense = out
        print(f"batched {label}: identity cohort at V = C = {c} bitwise the "
              "dense executor; ms per round " + json.dumps(times))
        del state, ex, dense, ident


def run_bench_phase(K):
    """Phase 8, the fault and population benches on the card:
    ``bench_faults --smoke --check`` (sporadic beats blocking at equal
    budget) and ``bench_megascale --smoke`` (rounds/s and bytes at 10k
    virtual nodes, no build after the warmup, the bitwise gate). The
    reference's dispatch measurement runs in phase 4b, its bar applied."""
    import tempfile

    from repro_torch.benchmarks import bench_faults, bench_megascale
    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (
                ("bench_faults", lambda: bench_faults.main(
                    ["--smoke", "--check", "--device", "cuda", "--out",
                     os.path.join(tmp, "bf")])),
                ("bench_megascale", lambda: bench_megascale.main(
                    ["--smoke", "--check", "--device", "cuda", "--out",
                     os.path.join(tmp, "bm")]))):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            add_launches(K, dict(ops.LAUNCHES))
            if name == "bench_faults":
                line = {k: out[k] for k in ("sporadic_beats_blocking",
                                            "margin_x", "builds_after_warmup")}
                line.update({p: {"rounds": out[p]["rounds"],
                                 "loss": out[p]["loss"]}
                             for p in ("blocking", "sporadic")})
            else:
                line = {"parity": out["parity"], "scales": out["scales"]}
            print(f"{name} ({time.perf_counter() - t0:.2f} s) "
                  + json.dumps(line))


def device_busy_ms(run):
    """``run()`` under torch.profiler, ended by a device sync: the time in
    ms during which at least one kernel ran (``common.busy_ms``: summed
    self times count a kernel that starts before its predecessor ends
    twice over), and the kernel events (``(stream, start_us, end_us,
    name)``)."""
    from repro_torch.benchmarks.common import busy_ms, kernel_events
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = kernel_events(prof)
    return busy_ms(kernels), kernels


def top_kernels(kernels, per, n=5):
    """The ``n`` kernels with the most device time, in ms per ``per``."""
    total = {}
    for _, a, b, name in kernels:
        total[name[:60]] = total.get(name[:60], 0.0) + (b - a) / 1e3 / per
    return dict(sorted(total.items(), key=lambda kv: -kv[1])[:n])


def peak_increment_mb(run):
    """``run()``'s peak device memory above what was allocated before it,
    in MB."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e6


def stream_overlap_ms(kernels):
    """Time in ms during which kernels of two different streams run at
    once, from ``device_busy_ms``'s kernel events."""
    by_stream = {}
    for stream, a, b, _ in kernels:
        by_stream.setdefault(stream, []).append((a, b))
    if len(by_stream) < 2:
        return 0.0, sorted(by_stream, key=str)
    from repro_torch.benchmarks.common import union
    spans = {s: union(iv) for s, iv in by_stream.items()}
    names = sorted(spans, key=lambda s: -sum(b - a for a, b in spans[s]))
    main = spans[names[0]]
    others = union([iv for s in names[1:] for iv in spans[s]])
    total, j = 0.0, 0
    for a, b in main:
        for c, d in others:
            total += max(0.0, min(b, d) - max(a, c))
    return total / 1e3, names


def run_graph_phase(K):
    """Phase 4b, the executor's rounds as CUDA graphs (``core.graphs``) on
    the CIFAR CNN at full width, 10-node ring, tau (4, 4): plain DFL,
    C-DFL TopK (frac 0.67, gamma 0.6), C-DFL QSGD (16 levels, gamma
    ``QSGD_GAMMA``), randomized gossip and RandK (gamma 0.6) on the
    trajectory [[4,4],[2,1],[3,0]], and plain DFL and
    QSGD on rounds 1-3 of phase 6's fault rows (masked). Each: a warmup,
    then one dispatch from a fresh state held bitwise (state and metrics)
    against ``make_round_fn(..., dynamic_taus=True)``'s eager rounds on the
    card, with the same launch counts (replays add their captured counts)
    and no synchronizing CUDA call; a re-plan and a K = 2 dispatch capture
    and build nothing. Then ms per round, eager rounds against replayed
    (two turns each, host clock ended by a sync), the device busy share of
    each (torch.profiler), and the peak device memory of each. A capture
    forced to fail (a loss that raises while the stream captures) must
    raise, and so must the next dispatch: nothing runs eagerly. Last, the
    quadratic dispatch measurement with the reference's 2x bar applied
    (``bench_round_overhead --measure dispatch --check``)."""
    import tempfile

    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import RoundExecutor, make_round_fn
    from repro_torch.core.tree import tree_map
    from repro_torch.device import deterministic_algorithms
    from repro_torch.kernels import ops

    traj = np.array([(4, 4), (2, 1), (3, 0)], np.int32)
    for label, compression, masked in (
            ("dfl", "", False), ("cdfl_topk", "top_k", False),
            ("cdfl_qsgd", "qsgd", False),
            ("cdfl_rand_gossip", "rand_gossip", False),
            ("cdfl_rand_k", "rand_k", False), ("dfl_masked", "", True),
            ("cdfl_qsgd_masked", "qsgd", True)):
        s = bro.cnn_setup(compression, rounds=6, device="cuda",
                          gamma=QSGD_GAMMA if compression == "qsgd" else 0.6)
        cfg = s.cfg(*FAULT_TAUS)
        n = cfg.topology.num_nodes
        rows = fault_rows(cfg.topology)[1:4] if masked else traj
        k = rows.shape[0]

        def stacked(r0, kk=3):
            return tuple(torch.stack([s.batches[r][j]
                                      for r in range(r0, r0 + kk)])
                         for j in (0, 1))

        round_fn = make_round_fn(cfg, s.loss_fn, s.opt, dynamic_taus=True,
                                 participation=masked)

        def eager(st, r0, rr):
            ms = []
            for i, row in enumerate(rr):
                args = (row[2:2 + n], row[2 + n:]) if masked else ()
                st, m = round_fn(st, s.batches[r0 + i], int(row[0]),
                                 int(row[1]), *args)
                ms.append(m)
            return st, {key: torch.stack([m[key] for m in ms])
                        for key in ms[0]}

        with deterministic_algorithms():
            ops.reset_launches()
            (ref, mref), eager_peak = peak_increment_mb(
                lambda: eager(s.fresh(), 0, rows))
            eager_counts = dict(ops.LAUNCHES)
        ex = RoundExecutor(cfg, s.loss_fn, s.opt, participation=masked)
        state = s.fresh()

        def first():
            ex.warmup(state, stacked(0))
            ops.reset_launches()
            return bro.syncs_in_dispatch(
                lambda: ex.dispatch_trajectory(state, stacked(0), rows))

        ((state, m), syncs), graph_peak = peak_increment_mb(first)
        captures, builds = ex.capture_count, ex.compile_count
        counts = dict(ops.LAUNCHES)
        require(same_state(state, ref)
                and all(same_bits(m[key], mref[key]) for key in mref),
                f"graphs {label}: the replayed dispatch differs from the "
                f"eager rounds: loss {m['loss'].tolist()} vs "
                f"{mref['loss'].tolist()}")
        require(counts == eager_counts, f"graphs {label}: launches "
                f"{counts} after replay, {eager_counts} eagerly")
        require(not syncs, f"graphs {label}: synchronizing calls {syncs}")
        add_launches(K, counts)
        # a re-plan and a new K capture and build nothing
        state, _ = ex.dispatch_trajectory(state, stacked(3), rows[::-1].copy())
        state, _ = ex.dispatch_trajectory(state, stacked(3, 2), rows[1:])
        torch.cuda.synchronize()
        require((ex.capture_count, ex.compile_count) == (captures, builds),
                f"graphs {label}: {ex.capture_count - captures} captures and "
                f"{ex.compile_count - builds} builds after the warmup")
        times = {"eager": [], "replayed": []}
        for what in ("eager", "replayed", "replayed", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "eager":
                with deterministic_algorithms():
                    eager(s.fresh(), 3, rows)
            else:
                ex.dispatch_trajectory(s.fresh(), stacked(3), rows)
            torch.cuda.synchronize()
            times[what].append((time.perf_counter() - t0) * 1e3 / k)
        busy, top = {}, {}
        for what, run in (
                ("eager", lambda: eager(s.fresh(), 3, rows)),
                ("replayed", lambda: ex.dispatch_trajectory(
                    s.fresh(), stacked(3), rows))):
            with deterministic_algorithms():
                ms, kernels = device_busy_ms(run)
            busy[what] = ms / k
            top[what] = top_kernels(kernels, k)
        print(f"graphs {label} " + json.dumps({
            "rows": rows[:, :2].tolist(), "masked": masked,
            "bitwise_eager": True, "launches": {
                key: v for key, v in counts.items() if v},
            "syncs_in_dispatch": len(syncs), "captures": captures,
            "captures_after_warmup": 0, "builds": builds,
            "ms_per_round": times,
            "device_busy_ms_per_round": busy,
            "device_busy_share": {
                w: busy[w] / min(times[w]) for w in busy},
            "top_device_ms_per_round": top,
            "peak_device_mb_above_start": {"eager": eager_peak,
                                           "replayed": graph_peak}}))
        del ex, state, ref

    # a capture that fails raises, and nothing runs eagerly after it
    s = bro.cnn_setup("", rounds=3, device="cuda")

    def failing_loss(p, b):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("forced capture failure")
        return s.loss_fn(p, b)

    ex = RoundExecutor(s.cfg(*FAULT_TAUS), failing_loss, s.opt)
    state = s.fresh()
    before = tree_map(torch.clone, state.params)
    batches = tuple(torch.stack([s.batches[r][j] for r in range(3)])
                    for j in (0, 1))
    for attempt in range(2):
        try:
            ex.dispatch(state, batches, 4, 4)
        except RuntimeError as e:
            require("forced capture failure" in str(e),
                    f"graphs: the failed capture raised {e!r}")
        else:
            raise RuntimeError(f"graphs: dispatch {attempt} ran although "
                               "its capture failed")
    torch.cuda.synchronize()
    require(all(torch.equal(state.params[key], before[key])
                for key in before) and state.round_idx == 0,
            "graphs: a failed capture changed the state")
    print("graphs: a capture forced to fail raises, twice; the state is "
          "untouched")
    del ex, state
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = bro.main(["--measure", "dispatch", "--check", "--repeats", "3",
                        "--device", "cuda", "--out",
                        os.path.join(tmp, "bro")])
        torch.cuda.synchronize()
        add_launches(K, dict(ops.LAUNCHES))
    print(f"dispatch ({time.perf_counter() - t0:.2f} s) " + json.dumps({
        "rounds_per_s": out["median_rounds_per_s"],
        "speedup_superstep_vs_legacy": out["speedup_superstep_vs_legacy"],
        "bar_2x_met": out["speedup_superstep_vs_legacy"] >= 2.0}))


# The pipelined CIFAR run on the card against the CPU's run of the same
# rows: one round stale, the CNN amplifies a difference as in phase 6, so
# the limits sit above the largest sound reading and below a control's
# (K1 perturbed, ``PIPELINE_CONTROL``), as phase 6's.
PIPELINE_RUN_RTOL = {"loss": 0.1, "consensus_sq": 0.15}
PIPELINE_CONTROL = ("gossip_mix_many", "x_shift", 1e-3)
# The stale fold lets consensus errors grow: at the harness's SGD step 0.05
# the pipelined CIFAR run of these rows diverges by its fourth round, in
# the reference's pipelined executor too (same config on the CPU); 0.02
# stays finite over the six rounds.
PIPELINE_LR = 0.02


def run_pipeline_phase(K, gate=True, controls=None):
    """Phase 4c, ``RoundExecutor(overlap="pipeline", participation=True)``
    on the CIFAR CNN at full width, 10-node ring, tau (4, 4), SGD step
    ``PIPELINE_LR``, phase 6's six fault rows in two K = 3 dispatches,
    plain DFL and C-DFL QSGD (gamma ``QSGD_GAMMA``): bitwise (state and metrics) the eager pipelined
    superstep (``make_pipeline_superstep`` over ``make_pipeline_fns``) on
    the card, with its launch counts and no synchronizing call in a
    dispatch; the six rounds against the CPU's eager pipelined run of the
    same rows (the same seam, whose bits are the card's) within
    ``PIPELINE_RUN_RTOL``, which a pipelined executor captured with each of
    ``controls`` (``perturbed``'s arguments) must break. Then ms per
    round, pipelined against ``overlap="none"`` (two turns), and one
    dispatch of each under torch.profiler: the busy time, the number of
    streams its kernels were reported on and how long kernels of the
    busiest stream overlapped kernels of the others (a replayed graph's
    kernels may be reported on several streams; one chain of them never
    overlaps itself, so ``overlap="none"`` reads near 0).
    ``gate=False`` prints the differences without holding them."""
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import RoundExecutor
    from repro_torch.core.dfl import make_pipeline_fns
    from repro_torch.core.executor import make_pipeline_superstep
    from repro_torch.core.tree import tree_map
    from repro_torch.device import deterministic_algorithms
    from repro_torch.kernels import ops
    from repro_torch.optim import sgd

    controls = (PIPELINE_CONTROL,) if controls is None else controls
    for label, compression in (("dfl", ""), ("cdfl_qsgd", "qsgd")):
        s = dataclasses.replace(bro.cnn_setup(
            compression, rounds=6, device="cuda",
            gamma=QSGD_GAMMA if compression == "qsgd" else 0.6),
            opt=sgd(PIPELINE_LR))
        cfg = s.cfg(*FAULT_TAUS)
        topo = cfg.topology
        rows = fault_rows(topo)
        kw = dict(participation=True, num_nodes=topo.num_nodes,
                  num_edges=topo.num_edges)

        def stacked(r0, dev="cuda"):
            return tuple(torch.stack([s.batches[r][j]
                                      for r in range(r0, r0 + 3)]).to(dev)
                         for j in (0, 1))

        def eager_run(st, dev):
            sup = make_pipeline_superstep(*make_pipeline_fns(
                cfg, s.loss_fn, s.opt, participation=True), **kw)
            ms = []
            for r0 in (0, 3):
                st, m = sup(st, stacked(r0, dev), rows[r0:r0 + 3])
                ms += [{key: float(v[i]) for key, v in m.items()}
                       for i in range(3)]
            return st, ms

        with deterministic_algorithms():
            torch.cuda.synchronize()
            ops.reset_launches()
            ref, mref = eager_run(s.fresh(), "cuda")
            torch.cuda.synchronize()
            eager_counts = dict(ops.LAUNCHES)
        ex = RoundExecutor(cfg, s.loss_fn, s.opt, participation=True,
                           overlap="pipeline")
        ex.warmup(s.fresh(), stacked(0))
        captures = ex.capture_count
        state, ms = s.fresh(), []
        torch.cuda.synchronize()
        ops.reset_launches()
        syncs = []
        for r0 in (0, 3):
            (state, m), sy = bro.syncs_in_dispatch(
                lambda: ex.dispatch_trajectory(state, stacked(r0),
                                               rows[r0:r0 + 3]))
            syncs += sy
            ms += [{key: float(v[i]) for key, v in m.items()}
                   for i in range(3)]
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        require(same_state(state, ref) and ms == mref,
                f"pipeline {label}: the executor differs from the eager "
                f"pipelined superstep: {ms} vs {mref}")
        require(counts == eager_counts, f"pipeline {label}: launches "
                f"{counts} after replay, {eager_counts} eagerly")
        require(not syncs, f"pipeline {label}: synchronizing calls {syncs}")
        require(ex.capture_count == captures,
                f"pipeline {label}: captures after the warmup")
        add_launches(K, counts)
        # the whole run on the CPU: the same start, rows and seam
        start = s.fresh()
        host = to_cpu_state(start, None)._replace(
            draws=type(start.draws)(start.draws.seed, start.draws.num_nodes,
                                    start.draws.leaves, "cpu"))
        _, cpu = eager_run(host, "cpu")
        whole = largest_differences(ms, cpu)
        require(not gate or all(whole[key] <= v
                                for key, v in PIPELINE_RUN_RTOL.items()),
                f"pipeline {label}: the 6 rounds on the card vs the CPU's "
                f"{whole}, beyond {PIPELINE_RUN_RTOL}")
        for control in controls:
            with perturbed(*control):
                cex = RoundExecutor(cfg, s.loss_fn, s.opt,
                                    participation=True, overlap="pipeline")
                st, cms = s.fresh(), []
                for r0 in (0, 3):
                    st, m = cex.dispatch_trajectory(st, stacked(r0),
                                                    rows[r0:r0 + 3])
                    cms += [{key: float(v[i]) for key, v in m.items()}
                            for i in range(3)]
            del cex
            ctl = largest_differences(cms, cpu)
            require(not gate or any(ctl[key] > v
                                    for key, v in PIPELINE_RUN_RTOL.items()),
                    f"pipeline {label}: the control {control} is within "
                    f"the whole-run limits {PIPELINE_RUN_RTOL}: {ctl}")
            print(f"pipeline {label} control " + json.dumps(
                {"control": control, "whole_run": ctl}))
        none = RoundExecutor(cfg, s.loss_fn, s.opt, participation=True)
        none.warmup(s.fresh(), stacked(0))
        times = {"pipeline": [], "none": []}
        for what in ("none", "pipeline", "pipeline", "none"):
            run = ex if what == "pipeline" else none
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.dispatch_trajectory(s.fresh(), stacked(3), rows[3:6])
            torch.cuda.synchronize()
            times[what].append((time.perf_counter() - t0) * 1e3 / 3)
        busy, kernels = device_busy_ms(lambda: ex.dispatch_trajectory(
            s.fresh(), stacked(3), rows[3:6]))
        overlap, streams = stream_overlap_ms(kernels)
        none_overlap, _ = stream_overlap_ms(device_busy_ms(
            lambda: none.dispatch_trajectory(s.fresh(), stacked(3),
                                             rows[3:6]))[1])
        print(f"pipeline {label} " + json.dumps({
            "bitwise_eager_pipeline": True, "launches": {
                key: v for key, v in counts.items() if v},
            "syncs_in_dispatch": len(syncs), "captures": captures,
            "loss": [m_["loss"] for m_ in ms],
            "whole_run_vs_cpu": whole, "ms_per_round": times,
            "device_busy_ms_per_round": busy / 3,
            "kernel_streams": len(streams),
            "stream_overlap_ms_per_round": overlap / 3,
            "stream_overlap_ms_per_round_overlap_none": none_overlap / 3}))
        del ex, none, state, ref



def run_determinism_phase():
    """Phase 9, ``run_dfl_cnn`` twice under its default
    ``deterministic=True`` (C-DFL QSGD on the CIFAR CNN, 10-node ring, 6
    rounds): the two histories are bitwise equal; then the same run with
    ``deterministic=False``, for what the switch costs in round time
    (mean of rounds 2-6 of each run)."""
    from repro_torch.launch.cnn_run import RunSpec, run_dfl_cnn

    spec = RunSpec(name="smoke-determinism", tau1=4, tau2=4,
                   topology="ring", compression="qsgd",
                   comp_kwargs={"levels": 16}, gamma=QSGD_GAMMA,
                   flavor="cifar",
                   nodes=10, rounds=6, batch=16)
    runs = [run_dfl_cnn(spec, device="cuda", log_every=1,
                        deterministic=det) for det in (True, True, False)]
    require(runs[0]["history"] == runs[1]["history"],
            "run_dfl_cnn: two deterministic runs differ: "
            f"{runs[0]['history']['loss']} vs {runs[1]['history']['loss']}")
    ms = [sum(r["round_ms"][1:]) / (len(r["round_ms"]) - 1) for r in runs]
    print("determinism " + json.dumps({
        "bitwise_equal_histories": True,
        "loss": runs[0]["history"]["loss"],
        "nondeterministic_loss": runs[2]["history"]["loss"],
        "round_ms_deterministic": [ms[0], ms[1]],
        "round_ms_nondeterministic": ms[2]}))


# Phase 10's adaptive sessions: a wall-clock budget of the training loop
# (seconds), supersteps of 4 rounds, and the CPU's rtol on bench_trajectory's
# final losses (elementwise f32 updates and a bitwise K1 on the card).
PLANNER_BUDGET_S = 2.0
PLANNER_SUPERSTEP = 4
TRAJECTORY_RTOL = 1e-5


def launch_delta(before):
    from repro_torch.kernels import ops
    return {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()}


def checked_dispatch(K, per_step, log):
    """A ``dispatch(executor, state, batches, taus)`` hook: each dispatch
    must make no synchronizing CUDA call and launch exactly ``per_step``
    (kernel -> launches a gossip step) times the rows' sum of tau2; its
    launches are added to the kernels line and the dispatch is logged."""
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.kernels import ops

    def dispatch(ex, state, batches, taus):
        rows = np.asarray(taus)
        before = dict(ops.LAUNCHES)
        out, syncs = bro.syncs_in_dispatch(
            lambda: ex.dispatch_trajectory(state, batches, taus))
        counts = launch_delta(before)
        steps = int(rows[:, 1].sum())
        expect = expect_launches(K, **{k: v * steps
                                       for k, v in per_step.items()})
        require(counts == expect, f"dispatch of {rows[:, :2].tolist()}: "
                f"launches {counts}, expected {expect}")
        require(not syncs, f"dispatch of {rows[:, :2].tolist()}: "
                f"synchronizing calls {syncs}")
        add_launches(K, counts)
        log.append(steps)
        return out

    return dispatch


def run_planner_phase(K):
    """Phase 10, the planner (``repro_torch.planner``) driving the executor
    on the card. (a) ``bench_trajectory --smoke --check``: every schedule
    and seed through one graph-replaying executor at the grid's maxima, no
    build or capture after the warmup, the per-round trajectory beating
    every fixed grid point at budget, each dispatch's launches exactly one
    K1 a gossip step and no synchronizing call in it; the final losses held
    against the same schedules on the CPU (``TRAJECTORY_RTOL``). (b) The
    adaptive controller driving the CIFAR CNN at full width
    (``launch.planned_run.cnn_planned_run``): a 10-node ring, batch 16, the
    executor at ``DEFAULT_GRID``'s maxima (16, 8), the reference's neutral
    prior, a ``PLANNER_BUDGET_S`` budget in supersteps of 4, plain DFL and
    C-DFL QSGD (16 levels, gamma ``QSGD_GAMMA``): no build or capture after
    the warmup across every re-plan and probe, no synchronizing call in a
    dispatch, exact launches, finite losses, the spend within the budget
    plus one chunk, and the rank-deficient probe once. (c)
    ``bench_balance`` on MNIST at 10 rounds a grid point: every row
    finite, the result file written, K1 exactly tau2 x rounds for each
    grid point; the measured winner and the planner's pick per ratio."""
    import tempfile

    from repro_torch.benchmarks import bench_balance
    from repro_torch.benchmarks import bench_trajectory as bt
    from repro_torch.kernels import ops
    from repro_torch.launch.planned_run import cnn_planned_run
    from repro_torch.models.cnn import init_cnn

    # (a) the trajectory bench on the card, then on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        steps = []
        t0 = time.perf_counter()
        card = bt.main(["--smoke", "--check", "--device", "cuda", "--out",
                        os.path.join(tmp, "card.json")],
                       dispatch=checked_dispatch(K, {"gossip_mix": 1}, steps))
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = bt.main(["--smoke", "--device", "cpu", "--out",
                       os.path.join(tmp, "cpu.json")])
        t_cpu = time.perf_counter() - t0
    require(card["builds_after_warmup"] == 0
            and card["captures_after_warmup"] == 0,
            "bench_trajectory: builds or captures after the warmup")
    require(card["trajectory_beats_best_fixed"],
            "bench_trajectory: the trajectory does not beat the best fixed")
    worst = 0.0
    for name in list(card["fixed"]) + ["trajectory"]:
        got = (card["trajectory"] if name == "trajectory"
               else card["fixed"][name])["loss_per_seed"]
        want = (cpu["trajectory"] if name == "trajectory"
                else cpu["fixed"][name])["loss_per_seed"]
        for a, b in zip(got, want):
            worst = max(worst, abs(a - b) / abs(b))
            require(close(a, b, TRAJECTORY_RTOL), f"bench_trajectory {name}: "
                    f"card {a} vs CPU {b}, beyond rtol {TRAJECTORY_RTOL}")
    print("planner trajectory " + json.dumps({
        "margin_x": card["margin_x"], "best_fixed": card["best_fixed"],
        "trajectory_loss": card["trajectory"]["loss"],
        "schedule_counts": card["trajectory"]["schedule_counts"],
        "dispatches": len(steps), "gossip_mix_launches": sum(steps),
        "builds_after_warmup": card["builds_after_warmup"],
        "captures_after_warmup": card["captures_after_warmup"],
        "largest_rel_diff_vs_cpu": worst, "rtol": TRAJECTORY_RTOL,
        "card_s": t_card, "cpu_s": t_cpu}))

    # (b) the adaptive controller driving the CIFAR CNN
    sizes = [v.numel() for v in init_cnn(torch.Generator().manual_seed(0),
                                         "cifar", "cuda").values()]
    for label, compression in (("dfl", ""), ("cdfl_qsgd", "qsgd")):
        steps = []
        t0 = time.perf_counter()
        _, rec = cnn_planned_run(
            "cifar", compression, gamma=QSGD_GAMMA,
            budget_s=PLANNER_BUDGET_S, superstep=PLANNER_SUPERSTEP,
            device="cuda", dispatch=checked_dispatch(
                K, step_launches(compression, sizes), steps))
        wall = time.perf_counter() - t0
        chunks = rec["chunks"]
        require(chunks, f"planner {label}: no round ran")
        require(rec["builds_after_warmup"] == 0
                and rec["captures_after_warmup"] == 0,
                f"planner {label}: {rec['builds_after_warmup']} builds and "
                f"{rec['captures_after_warmup']} captures after the warmup")
        require(all(math.isfinite(v) for ch in chunks
                    for v in ch["loss"] + ch["consensus_sq"]),
                f"planner {label}: a loss is not finite")
        largest = max(ch["seconds"] + ch["overhead_s"] for ch in chunks)
        require(rec["spent_s"] <= PLANNER_BUDGET_S + largest,
                f"planner {label}: spent {rec['spent_s']} s of "
                f"{PLANNER_BUDGET_S} plus one chunk ({largest} s)")
        probes = [p["probe"] for p in rec["plans"]
                  if p.get("probe") is not None]
        require(len(probes) == 1, f"planner {label}: probes {probes}, "
                "expected one")
        print(f"planner {label} " + json.dumps({
            "plans": [{k: p.get(k) for k in (
                "round", "cause", "schedule", "probe", "t_compute_step",
                "t_gossip_step", "rounds_planned")} for p in rec["plans"]],
            "fitted": rec["fitted"], "fit_rank": rec["fit_rank"],
            "rounds": rec["rounds"], "gossip_steps": sum(steps),
            "dispatches": len(chunks), "spent_s": rec["spent_s"],
            "budget_s": rec["budget_s"], "warmup_s": rec["warmup_s"],
            "dispatch_s": sum(ch["seconds"] for ch in chunks),
            "overhead_s": sum(ch["overhead_s"] for ch in chunks),
            "final_loss": chunks[-1]["loss"][-1],
            "builds_after_warmup": 0, "captures_after_warmup": 0,
            "syncs_in_dispatch": 0, "prefetch": rec["prefetch"],
            "wall_s": wall}))

    # (c) bench_balance on MNIST, launches per grid point
    orig = bench_balance.run_dfl_cnn

    def counted(spec, device):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out = orig(spec, device=device)
        torch.cuda.synchronize()
        counts = launch_delta(before)
        expect = expect_launches(K, gossip_mix=spec.tau2 * spec.rounds)
        require(counts == expect, f"bench_balance ({spec.tau1}, "
                f"{spec.tau2}): launches {counts}, expected {expect}")
        add_launches(K, counts)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        bench_balance.run_dfl_cnn = counted
        t0 = time.perf_counter()
        try:
            rows = bench_balance.run("mnist", 10, device="cuda",
                                     results_dir=tmp)
        finally:
            bench_balance.run_dfl_cnn = orig
        dt = time.perf_counter() - t0
        path = os.path.join(tmp, "balance_mnist.json")
        require(os.path.exists(path), "bench_balance: wrote no result file")
        with open(path) as f:
            out = json.load(f)
    require(all(math.isfinite(float(r["loss_at_budget"])) for r in rows),
            "bench_balance: a loss at budget is not finite")
    print(f"planner balance ({dt:.2f} s) " + json.dumps({
        ratio: {"measured_winner": out["winners"][ratio][1:],
                "winner_loss": out["winners"][ratio][0],
                "planned": [out["planned"][ratio]["tau1"],
                            out["planned"][ratio]["tau2"]]}
        for ratio in out["planned"]}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    libs = build.build_all()
    t_build = time.perf_counter() - t0
    print(f"build: {len(libs)} libraries in {t_build:.2f} s -> "
          f"{build.BUILD_DIR}")

    K = {k.name: k for k in (
        Kernel("gossip_mix", "src/repro_torch/kernels/csrc/gossip_mix.cu",
               "src/repro/kernels/gossip_mix.py:34", True),
        Kernel("choco_qsgd", "src/repro_torch/kernels/csrc/choco_fused.cu",
               "src/repro/kernels/choco_fused.py:65", False),
        Kernel("choco_topk", "src/repro_torch/kernels/csrc/choco_fused.cu",
               "src/repro/kernels/choco_fused.py:108", False),
        Kernel("topk_threshold", "src/repro_torch/kernels/csrc/topk.cu",
               "src/repro/kernels/topk.py:51", True),
        Kernel("topk_mask", "src/repro_torch/kernels/csrc/topk.cu",
               "src/repro/kernels/topk.py:79", False),
        Kernel("qsgd_quantize", "src/repro_torch/kernels/csrc/qsgd.cu",
               "src/repro/kernels/qsgd.py:44", False),
        Kernel("choco_move", "src/repro_torch/kernels/csrc/choco_update.cu",
               "src/repro/kernels/choco_update.py:38", False))}
    if sys.argv[1:] == ["--calibrate-qsgd"]:
        check_seam()
        calibrate_qsgd()
        run_masked_quickstart(K, gate=False, seeds=range(8), controls=(
            ("gossip_mix_many", "x_shift", 1e-6),
            ("gossip_mix_many", "x_shift", 1e-5),
            ("gossip_mix_many", "x_shift", 1e-4),
            ("gossip_mix_many", "x_scale", 1e-6),
            ("choco_qsgd", "x_shift", 1e-5)))
        cifar_sensitivity()
        run_participation_phase(K, gate=False, controls=(
            ("gossip_mix_many", "x_shift", 1e-4),
            ("gossip_mix_many", "x_shift", 1e-3),
            ("gossip_mix_many", "x_scale", 1e-4)))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    phases = {
        "kernels": lambda: check_kernels(K, gen),
        "kernel_times": lambda: time_kernels(K, gen), "seam": check_seam,
        "main_path": lambda: run_main_path(K), "breakdown": round_breakdown,
        "executor": lambda: run_executor_phase(K),
        "graphs": lambda: run_graph_phase(K),
        "pipeline": lambda: run_pipeline_phase(K),
        "dense_power": lambda: run_dense_power(K),
        "full_mix": lambda: check_full_mix(K, gen),
        "quickstart": lambda: run_quickstart(K),
        "figures": lambda: run_figures(K),
        "participation": lambda: run_participation_phase(K),
        "masked_quickstart": lambda: run_masked_quickstart(K),
        "batched": lambda: run_batched_phase(K),
        "benches": lambda: run_bench_phase(K),
        "determinism": run_determinism_phase,
        "planner": lambda: run_planner_phase(K)}
    phases["pipeline_calibrate"] = lambda: run_pipeline_phase(
        K, gate=False, controls=(("gossip_mix_many", "x_shift", 1e-4),
                                 ("gossip_mix_many", "x_shift", 1e-3),
                                 ("gossip_mix_many", "x_scale", 1e-4)))
    if sys.argv[1:2] == ["--only"]:
        # a subset of the phases, for work on the card; no result line
        print(card_line())
        for name in sys.argv[2:]:
            t0 = time.perf_counter()
            phases[name]()
            print(f"phase {name} time: {time.perf_counter() - t0:.1f} s")
        return 0
    for name, phase in phases.items():
        if name == "pipeline_calibrate":
            continue
        t0 = time.perf_counter()
        phase()
        print(f"phase {name} time: {time.perf_counter() - t0:.1f} s")
    print(f"wall: {time.perf_counter() - t_start:.1f} s from the build on "
          f"({t_build:.2f} s of it the build)")
    card = card_line()
    print(json.dumps({"kernels": [k.record() for k in K.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
