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
   launch per leaf, summed over a step.
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
5. The quickstart (``repro_torch.examples.quickstart``), 60 rounds of each
   variant on the card, held against a CPU run (C-DFL QSGD with the card's
   draws replayed); each paper-figure bench (``repro_torch.benchmarks``)
   at 2 rounds (Table I at its 8-round floor) on MNIST into a temporary
   directory, every row finite, Fig. 10's launches exact.
6. Print the kernels line, the build and total wall times, the card's name
   and power limit, and the final ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when ``torch.cuda.is_available()`` is
false or when the ``src`` tree is missing.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

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

    def uniform(self, round_idx, step, leaf, shape):
        out = self.inner.uniform(round_idx, step, leaf, shape)
        if round_idx == 0 or self.every_round:
            self.table[(round_idx, step, leaf)] = out.cpu().numpy()
        return out


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
        device_ms_total = sum(e.self_device_time_total for e in kernels) / 1e3
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


def run_quickstart(K):
    """Phase 5, the quickstart's three variants, 60 rounds each on the card
    (K1 every gossip step, K2 every C-DFL QSGD step), each held against a
    CPU run: loss and |w - w*| rtol 1e-4, consensus 1e-3; C-DFL QSGD with
    the card's draws replayed, its consensus to rtol 1e-2: a gap within an
    ulp of a level boundary can quantize to the next level on one device
    and not on the other, and the final consensus (about 5e-6) is a
    residual of nearly equal models, which one such flip moves by parts in
    a thousand."""
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
        cpu = qs.train(cfg, rounds, label, "cpu",
                       ReplayDraws(draws.table, "cpu") if draws else None)
        pairs = {"loss": (got["losses"][-1], cpu["losses"][-1], 1e-4),
                 "err": (got["err"], cpu["err"], 1e-4),
                 "consensus": (got["consensus"][-1], cpu["consensus"][-1],
                               1e-2 if draws else CPU_CONSENSUS_RTOL)}
        for key, (a, b, rtol) in pairs.items():
            require(math.isfinite(a) and close(a, b, rtol),
                    f"quickstart {label}: {key} {a} on the card vs {b} on "
                    f"the CPU, beyond rtol {rtol}")
        worst = {key: max(abs(a - b) / abs(b) for a, b in zip(got[key],
                                                             cpu[key]))
                 for key in ("losses", "consensus")}
        print(f"quickstart {' '.join(label.split())} card vs CPU "
              + json.dumps({k: v for k, v in pairs.items()}
                           | {"largest_relative_difference": worst}))
    print("quickstart launches " + json.dumps(
        {k: v for k, v in counts.items() if v}))


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
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_kernels(K, gen)
    time_kernels(K, gen)
    run_main_path(K)
    round_breakdown()
    run_executor_phase(K)
    run_dense_power(K)
    check_full_mix(K, gen)
    run_quickstart(K)
    run_figures(K)
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
