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
   K1, K4, K5 and K6 also over whole leaf lists in one call (the CIFAR
   leaves, the parity sizes; K5 also with NaN entries and on views at
   storage offset 1), K4, K5 and K6 also cut into small chunks, K1 also at
   N = 1024, K6 also on a leaf of 70,000 rows; the plan structs of K1, K4
   and K6 are held against the kernels' own (a ctypes layout check), and
   K6's registers and spill bytes a thread are printed.
   Then time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, at the main path's shapes
   (device time from CUDA-graph replay, CUDA events): K1, K4, K5 and K6
   one call over all 10 leaves of a gossip step (K5 and K6 also one launch
   per leaf, summed), and at the d1 leaf alone (K6 in bf16 too); the others one
   launch per leaf, summed over a step. The RNG seam's draws on the card
   bitwise the CPU's (``check_seam``).
3. The main path, through ``run_dfl_cnn`` (the executor's replayed
   graphs): the paper's CIFAR CNN at full
   width on a 10-node ring, tau1 = tau2 = 4, batch 16, gamma 0.6, for 3
   rounds each of C-DFL TopK (frac 0.67), plain DFL, C-DFL QSGD (16
   levels), C-DFL randomized gossip (p 0.8) and C-DFL RandK (frac 0.67),
   then TopK and QSGD through the substrate's ``compress`` hook on the
   stacked leaves (TopK one K4 call and one K5 launch for the tree, QSGD
   one K6 launch). The
   launch counts are set to 0 before each and must rise by exactly what
   the rounds predict, plus one gossip step's for the warm call before
   the gossip graph's capture. The first round of each run is repeated on
   the CPU (plain versions, the same seam, whose draws are the card's
   bits) and must agree within the stated tolerance. Then one round each of C-DFL TopK, plain
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
   round. The static fallback (``RoundExecutor(dynamic=False)``) replayed:
   plain DFL under ``dense_power`` and C-DFL TopK over [[4,4],[2,1],[4,4]],
   bitwise the eager static rounds, one build and one graph set per
   (tau1, tau2), none for a key seen before, 0 syncs, replayed against
   eager ms per round. K1 at ``fully_connected(10)`` (9 shifts), bitwise
   and timed over the CIFAR leaves.
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
   at a quarter of ``benchmarks/run.py``'s reduced length (10 rounds,
   Table I at 120 iterations) on MNIST through ``run_dfl_cnn``, then the
   same specs on the CPU: the first 3 rounds of every run, each run's
   final global loss and test accuracy (``FIG_RTOL``) and each figure's
   order of its variants held, a control with K1 shifted must break the limits; every
   row finite, Fig. 10's launches exact, each bench's wall time and
   launches printed.
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
   of plain DFL and C-DFL QSGD, replayed from the executor's graphs:
   bitwise the eager batched rounds, rows outside the cohorts bitwise
   untouched, the population kept in place, 0 syncs, no capture for new
   cohorts, peak device memory, replayed against eager ms per round; an
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
11. The LM stack and the train CLI (``run_lm_phase``): (a) the CLI's
   body (``launch.train.run``) on every architecture's reduced config, 4
   nodes on ring(4), tau (2, 2), 2 rounds in one K = 2 dispatch, C-DFL
   TopK (and QSGD on the reduced Qwen3): finite losses, exact launches,
   no build or capture after the warmup, no synchronizing call in a
   dispatch; the reduced Qwen3's two rounds against the port's CPU run of
   the same arguments (``LM_CPU_RTOL``, which a control with K1's output
   scaled must break). (b) Qwen3-1.7B at its published widths, 2 of 28
   layers (``LM_FULL_LAYERS``), 4 nodes, batch 2, seq 1024, one K = 3
   dispatch each of plain DFL, C-DFL TopK and QSGD: the dispatch bitwise
   the eager rounds on the card, exact launches, 0 syncs, 0 builds and
   captures after the warmup, finite losses, the loss of the first
   trained batch lower at the end, the consensus distance lower after
   every plain gossip step; ms a round, a local step and a gossip step,
   the busy share and the peak memory. (c) K1, K4 + K3 and K2 over that
   tree bitwise their plain versions, timed against them and their
   bounds, and K6, K5 and K7 over the same leaves, bitwise.
   ``--only lm_calibrate`` prints (a)'s readings and controls
   ungated and (d) the full-width QSGD run with the RNG seam drawing one
   cached block (the path before large trees were drawn in chunks).
12. Serving (``run_serve_phase``, ``repro_torch.serving``): (a) every
   architecture's reduced config in f32, prefill and ``SERVE_STEPS``
   greedy decode steps replayed from the engine's CUDA graph bitwise the
   same steps run eagerly, one capture; the card's logits against the
   port's CPU run fed the same tokens (``SERVE_CPU_RTOL``, which a control
   with ``final_norm`` shifted must break). (b) Qwen3-1.7B and (c)
   Gemma3-4B at their published widths and depth (``SERVE_FULL``: 8
   prompts of one bucket, 64 new tokens; Gemma3's prompts of 1536 outrun
   its window of 1024, so its ring buffers wrap): a second flight of the
   same signature captures nothing, stops the request given an EOS, and
   makes one synchronizing call a decode step plus the first token's
   read; graphed steps bitwise eager; every cache holds exactly the
   positions it should; prefill and the decode steps against ``forward``
   (``SERVE_FULL_RTOL``, its control beyond it); prefill ms and tokens/s
   (the prompt tokens sent, not the bucket's padding),
   decode ms a step (graph replay, CUDA events) and tokens/s against the
   bound (weights plus the KV read at ``HBM_BYTES_PER_S``), the busy share
   of a profiled flight and the peak memory. (d) The serve CLI's body on
   Qwen3-1.7B at full width, depth cut to ``LM_FULL_LAYERS``, and the
   serving example on the reduced Gemma3, one capture each. ``--only serve_calibrate``
   prints the readings and several controls ungated.
13. Telemetry (``run_telemetry_phase``, ``repro_torch.obs``): a dispatch
   with a live sink bitwise the same dispatch without one (CIFAR plain and
   QSGD), 0 syncs, no build or capture after the warmup;
   ``bench_round_overhead --measure telemetry --check`` (the sink under 2%
   of superstep throughput); the train CLI's ``--telemetry-out``,
   ``--history-out`` and ``--profile-dir`` on the reduced Qwen3, each file
   written and valid, the counters' kernel launches those of the run.
14. The sparse engine, one node per process (``run_sparse_phase``,
   ``repro_torch.core.sharded``): (a) K1's received-buffer form bitwise
   its plain version and the dense K1 at the same weights (one CIFAR
   node's leaves and the parity sizes, deg 1, 2, 7, f32 and bf16), timed
   against its plain version, one ``torch.addmm`` a leaf and its bound on
   the CIFAR node (deg 2 and 7) and one node of the full-width Qwen3 tree;
   (b) 8 gloo ranks on the one card, the CIFAR CNN at full width on
   ring(8) and fully_connected(8): one gossip step bitwise the dense
   port's, 3 rounds of plain, TopK and QSGD held to it
   (``SPARSE_RUN_RTOL``, which a control with K1-received shifted must
   break), their final parameters bitwise the dense port's run with
   per-node convolutions (plain, TopK: the witness that the rest of the
   gap is the grouped convolutions' rounding), exact launches on every
   rank, ms a round and the exchange's share; (c) the executor on the
   sparse engine with a re-plan and masks, no build or capture after the
   warmup; (d) the train CLI with
   ``--engine sparse`` on the same 8 ranks against the dense CLI on the
   card.
   ``--only sparse_calibrate`` prints (b)'s readings ungated.
15. The planner's measured cost inputs (``run_roofline_phase``,
   ``repro_torch.launch.roofline`` / ``launch.steps``) on Qwen3-1.7B at
   its published widths, 2 of 28 layers, 4 nodes, batch 2, seq 1024: (a)
   ``roofline_cost_inputs`` (FLOPs against 6 P T, the compute and memory
   terms against the local step run on the card and its busy time) and the
   analytic and measured plans, the measured plan the same in a process
   that sees no card; (b) ``build_planned_round`` from it, 3 rounds: no
   build or capture after the warmup, exact K1 launches, finite losses;
   (c) ``bench_overlap --smoke --check`` on 8 gloo ranks sharing the card;
   (d) ``bench_round_overhead --measure reduced_arch --check``; (e)
   ``examples/train_lm.py`` at its widths, ``TRAIN_LM_ROUNDS`` rounds:
   tokens/s, the loss by round, its fall at least ``TRAIN_LM_FALL``, which
   a control with K1 perturbed must miss. ``--only roofline_calibrate``
   prints (e) with several controls, ungated.
16. ``bench_kernels --check --device cuda`` (``run_bench_kernels_phase``,
   ``repro_torch.benchmarks.bench_kernels``) into a temporary file: the
   registry's parity of the seven ops against their oracles over
   ``PARITY_SHAPES`` x {f32, bf16} (TopK's select and mask bitwise), the
   TopK compressor bitwise its oracle at four fractions, the fused CHOCO
   chains launching fewer kernels than the unfused ones with the same
   bits, and every kernel at the CIFAR rows bitwise its plain version and
   timed warm and from DRAM beside its bound. Its gates are deterministic;
   its times are printed, not gated.
17. ``repro_torch.analysis`` (``run_analysis_phase``): the nine audits
   of ``run_production_audits(device="cuda")`` under the reference's
   names (ring(8), dim 33; the dense, pipelined and batched executors, and
   8 sparse gloo ranks spawned once), all ``ok``, K1 launched in every
   dense audit and K1-received on every rank, the ranks' sends ring(8)'s
   shift pairs; the five dense audits again on the CIFAR CNN at full
   width, ring(10), C-DFL TopK, maxima (4, 4), with K1, K4 and K3
   launched; two controls that must fail (``audit_donation`` on a
   ``donate=False`` executor, the sends against ``fully_connected(8)``);
   ``python -m repro_torch.analysis lint`` exits 0. Gates deterministic
   only; the times are printed.
18. The gossip-fsdp mesh (``run_mesh_phase``, ``--only mesh``):
   DeepSeek-Coder-33B at its published widths in bf16 (d_model 7168, 56 /
   8 heads of 128, d_ff 19200, vocab 32256), depth cut 62 -> 1, 4
   replicated nodes on ring(4), 4 gloo ranks sharing the card as a data
   2 x model 2 mesh, each node's batch of 2 at seq 256 split over data,
   tau (1, 2), each round built by ``steps.build_train_round`` on the
   mesh (the local step one node at a time) and dispatched by its
   executor: (a) K4's sharded-row form on the TopK run's first gossip
   step's gaps of every leaf, bitwise its plain version and the unsharded
   K4 on the gathered rows; (b) one round each of plain DFL, TopK and
   QSGD held to the dense port's round on one process (this one, before
   any mesh round, while the ranks start) from the same weights and
   batches, the whole tree, the loss and the consensus within
   ``MESH.rtol``, every limit of which the plain round with node 0's
   copy of one rank's block of one leaf scaled first must break, exact
   launches of K1, K3, K2 and K4's sharded form on every rank; (c) the
   phase's seconds (within ``MESH.budget_s``), each rank's peak memory,
   the bytes gathered and reduced a local step, the collectives' share of
   a round; K4-sharded's count and pick kernels timed on the device.
   ``--only mesh_calibrate`` prints (b) ungated.
19. Gossip-dp on a mesh (``run_mesh_phase(cell=MESH_DP)``, ``--only
   mesh_dp``): Qwen3-1.7B at its published widths in bf16 (d_model 2048,
   16 / 8 heads of 128, d_ff 6144, vocab 151,936, tied embeddings), depth
   cut 28 -> 2, 4 nodes on ring(4), a node on each data coordinate of a
   data 4 x model 2 mesh of 8 gloo ranks sharing the card, its weights
   split over model, each node's batch of 2 at seq 256 whole on its two
   model ranks, tau (1, 2), each round built by ``steps.build_train_round``
   on the mesh and dispatched by its executor (``NodeMeshSubstrate``: the
   blocks exchanged along data a gossip step): (a) as phase 18's, and K1's
   received form on each rank's first plain gossip step bitwise its plain
   version; (b) as phase 18's against the dense port's round, within
   ``MESH_DP.rtol``, with exact launches of K1-received, K4-sharded, K3
   and K2; (c) as phase 18's, with the bytes exchanged a gossip step and
   the exchange's share of a round, within ``MESH_DP.budget_s``. The same
   8 ranks also run the plain, TopK and QSGD rounds on a pod 2 x data 2 x
   model 2 mesh (a node a (pod, data) pair: rank r keeps node r // 2 and
   model coordinate r % 2), whose every block of the parameters and
   estimates must be bitwise the single-pod run's, its loss and consensus
   equal or within ``MESH_TWIN_RTOL``, its launches exact. ``--only
   mesh_dp_calibrate`` prints (b) ungated.
20. The multi-pod mesh, gossip-fsdp on pods (``run_mesh_phase(cell=
   MESH_POD)``, ``--only mesh_pod``): DeepSeek-Coder-33B as phase 18
   (1 of 62 layers, bf16), 2 nodes, the pods, on ring(2), a pod 2 x data
   2 x model 2 mesh of 8 gloo ranks sharing the card, each pod's node
   split over its data 2 x model 2 ranks, its batch of 2 at seq 256 split
   over data, tau (1, 2), each round built by ``steps.build_train_round``
   on the mesh (``NodeMeshSubstrate``, the blocks exchanged along pod a
   gossip step, deg 1): (a) K4-sharded over (data, model) bitwise its
   plain version and the unsharded K4 on the gathered rows, K1-received
   at deg 1 bitwise its plain version; (b) against the dense port's 2-node
   rounds within ``MESH_POD.rtol``, which the control (the TopK round
   with one block scaled: ring(2)'s plain gossip step leaves the nodes
   equal, so its consensus is 0 whatever the weights) must break, exact
   launches of K1-received, K4-sharded, K3 and K2; (c) as phase 19's,
   within ``MESH_POD.budget_s``. ``--only mesh_pod_calibrate`` prints (b)
   ungated.
21. Print the kernels line, the build and total wall times, the card's
   name and power limit, and the final ``{"ok": true, ...}`` line.

A phase that raises prints ``phase NAME failed: <type>: <message>`` on
stdout and the exception propagates, so the exit code is non-zero. Exits
non-zero, printing no result, when ``torch.cuda.is_available()`` is false
or when the ``src`` tree is missing.

``python3 chip_smoke.py --calibrate-qsgd`` prints, after the build and the
seam check, the readings behind the whole-run limits of phases 5, 6 and
6b (``calibrate_qsgd``, ``run_masked_quickstart`` over seeds and
controls, ``cifar_sensitivity``, phase 6 with controls), holding none of
them, and exits. ``python3 chip_smoke.py --only NAME ...`` runs the named
phases after the build (``graphs``, ``pipeline``, ``pipeline_calibrate``:
phase 4c's readings and controls ungated, ``figures``,
``figures_calibrate``: phase 5's figure readings and three controls
ungated, ``telemetry``, ``lm``, ``lm_calibrate``, ``lm_kernels``: phase
11 (c) alone, K1-K7 on the full-width tree, ``serve``,
``serve_calibrate``, ``sparse``, ``sparse_calibrate``,
``sparse_kernels``: phase 14 (a) alone, K1-received checked and timed,
``roofline``, ``roofline_calibrate``, ``bench_kernels``: phase 16, every
kernel's CIFAR reading warm and from DRAM, ``analysis``: phase 17,
``mesh``, ``mesh_calibrate``: phase 18, ``mesh_dp``,
``mesh_dp_calibrate``: phase 19, ``mesh_pod``, ``mesh_pod_calibrate``:
phase 20, ...) and prints no result.
"""
import contextlib
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

from repro_torch.benchmarks.timing import (  # noqa: E402
    card_line, cold_device_ms, device_ms)

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
    """Phase 2a, K1, K4, K5 and K6 over leaf lists in one call: the CIFAR
    leaves and the parity sizes, f32 and bf16, normal data and ties with a
    zero and a -0.0 row, k = 1, 0.67 D and D (K5 at K4's thresholds, also
    with NaN entries and on views at storage offset 1); K4, K5 and K6 also
    cut into chunks of 64, so that every row of more than 64 spans several
    blocks; K1 also on a
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
                    cases += 2 + check_mask_many(data, want, held)
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
    print(f"batched K1 / K4 / K5 / K6 vs plain: {cases} list calls, all "
          "bitwise")
    plan, leaves, leaf = qsgd.checked_layout()
    print(f"K6 plan struct: {plan} bytes for {leaves} leaves ({leaf} a "
          "leaf), the kernel's and the wrapper's alike")
    print("K6 registers and local (spill) bytes a thread "
          + json.dumps(qsgd.kernel_attributes()))


def check_mask_many(xs, threshs, held):
    """K5 over the leaves ``xs`` in one call and cut into chunks of 64
    (heads and tails at every chunk of rows not 16-byte aligned), on the
    leaves as given, with NaN in a third of row 1, and as views at storage
    offset 1 (x and out not congruent: the scalar path), against the plain
    version leaf by leaf at the thresholds ``threshs``, and at negative
    thresholds (-0.5 and -inf by turns of rows, compared with their sign:
    every value but NaN kept)."""
    from repro_torch.kernels import ops, topk

    nans = [x.clone() for x in xs]
    for x in nans:
        x[1, ::3] = float("nan")
    shifted = []
    for x in xs:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:] = x.reshape(-1)
        shifted.append(buf[1:].view(x.shape))
    negative = [torch.where(
        torch.arange(t.numel(), device=t.device) % 2 == 0,
        torch.tensor(-0.5, dtype=t.dtype, device=t.device),
        torch.tensor(float("-inf"), dtype=t.dtype, device=t.device))
        for t in threshs]
    cases = (("", xs, threshs), (", NaN", nans, threshs),
             (", offset 1", shifted, threshs), (", t < 0", nans, negative))
    for label, data, ts in cases:
        got = ops.topk_mask_many(data, ts)
        small = [torch.empty_like(x) for x in data]
        topk.launch_mask_many(data, ts, small, chunk=64)
        for g, sm, x, t in zip(got, small, data, ts):
            want = topk.mask_plain(x, t)
            what = f"list of {len(xs)}, D {x.shape[1]} {x.dtype}{label}"
            held("topk_mask", g, want, what)
            held("topk_mask", sm, want, what + ", chunk 64")
    return 2 * len(cases)


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
    (each leaf [10, D] f32): K1, K4, K5 and K6 one call over all leaves, as
    the round and the ``compress`` hook make it (K5 and K6 also one launch
    per leaf, summed), the others one launch per leaf; and the bounds. K4's library
    time is the faster of ``torch.topk`` and ``torch.kthvalue``. K5's
    record is read with its operands from DRAM (``k5_tree_times``), the
    others' with them warm in L2 where they fit (``device_ms``)."""
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
    per_leaf, step = [], {"x": [], "k": [], "t": [], "noise": [],
                          "xnorm": [], "c": []}
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
        for key, v in (("x", x), ("k", k), ("t", t), ("noise", noise),
                       ("xnorm", xnorm), ("c", c)):
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
    xs, ks, ts = step["x"], step["k"], step["t"]
    xas = [x.abs() for x in xs]
    noises, xnorms, cs = step["noise"], step["xnorm"], step["c"]
    per_leaf_sum = {"qsgd_quantize": K["qsgd_quantize"].ms}
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
        if kname in per_leaf_sum:
            line["per_leaf_launches_ms"] = per_leaf_sum[kname]
        print("step ms " + json.dumps(line))
    line = k5_tree_times(xs, ts)
    K["topk_mask"].ms, K["topk_mask"].plain_ms = line["ms"], line["plain_ms"]
    print("step ms " + json.dumps(line))


def k5_tree_times(xs, ts):
    """K5 over the leaves ``xs`` (the CIFAR tree, 23 MB in f32) at the
    thresholds ``ts``, its operands read from DRAM (``cold_device_ms``, as
    the bound assumes): one call (``ops.topk_mask_many``), one launch a
    leaf, the plain version; and the one call with the operands warm in L2
    (``device_ms``)."""
    from repro_torch.kernels import ops, topk

    nbytes = sum(8 * x.numel() + 4 * x.shape[0] for x in xs)

    def on_copies(fn):
        def make():
            copies = [x.clone() for x in xs]
            return lambda: fn(copies)
        return make

    per_leaf = lambda cs: [ops.topk_mask(x, t)  # noqa: E731
                           for x, t in zip(cs, ts)]
    line = {"kernel": "topk_mask", "leaves": len(xs), "from": "DRAM",
            "per_leaf_launches_ms": cold_device_ms(on_copies(per_leaf),
                                                   nbytes),
            "plain_ms": cold_device_ms(on_copies(
                lambda cs: [topk.mask_plain(x, t) for x, t in zip(cs, ts)]),
                nbytes),
            "ms": cold_device_ms(on_copies(
                lambda cs: ops.topk_mask_many(cs, ts)), nbytes),
            "warm_ms": device_ms(lambda: ops.topk_mask_many(xs, ts))}
    return line


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


def warm_steps(tau2):
    """Gossip steps the executor runs once before capturing its gossip
    step's graph (``core.graphs.warm``), counted as launches: one when the
    round gossips, none at tau2 = 0 (no gossip graph is captured)."""
    return 1 if tau2 > 0 else 0


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
    from repro_torch.core.rng import GeneratorDraws
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
        # the rounds' gossip steps and the executor's warm call of the
        # gossip step before its capture
        steps = spec.tau2 * spec.rounds + warm_steps(spec.tau2)
        expect = dict.fromkeys(K, 0)
        for name, n in step_launches(spec.compression, sizes).items():
            expect[name] = steps * n
        # the harness's executor replays graphs that draw under a device
        # key: the seam is its default GeneratorDraws, whose bits the CPU's
        # equal (``check_seam``)
        ops.reset_launches()
        out = run_dfl_cnn(spec, device="cuda", log_every=1)
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
        # with the same draws
        ref = run_dfl_cnn(dataclasses.replace(spec, rounds=1), device="cpu",
                          log_every=1)
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
              f"{CPU_CONSENSUS_RTOL}), the seam's draws on both")

    # K5 and K6 on the main path: TopK and QSGD on every node's slice of
    # each stacked leaf, through the substrate's compress hook (TopK one K4
    # call and one K5 launch for the tree, QSGD one K6 launch)
    params = {k: v + 0.01 * torch.randn_like(v)
              for k, v in replicate(leaves, 10).items()}
    draws = GeneratorDraws(0, 10, leaves, "cuda")
    sub = DenseSubstrate(ring(10))
    for name, kw, expect_launches in (
            ("top_k", {"frac": 0.67},
             {"topk_threshold": select_launches(sizes), "topk_mask": 1}),
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
        # the sparse engine's (phase 14) and the meshes' (phases 18, 19)
        if key in ("gossip_mix_received", "topk_threshold_sharded"):
            continue
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
    """Phase 4, the static fallback: one plain-DFL CIFAR round with
    ``mixing_impl="dense_power"`` (one C^4 product, no K1) against the
    iterated round (4 K1 launches); then ``RoundExecutor(dynamic=False)``
    replaying its graph sets, plain DFL under ``dense_power`` and C-DFL
    TopK under iterated mixing, over the trajectory [[4,4],[2,1],[4,4]]:
    each dispatch bitwise the eager static rounds on the card, exact
    launches, one build and one graph set per distinct (tau1, tau2) and
    none for a key seen before, no synchronizing call in a dispatch once
    its keys are captured; replayed against eager ms per round."""
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import RoundExecutor, make_round_fn
    from repro_torch.device import deterministic_algorithms
    from repro_torch.kernels import ops

    s = bro.cnn_setup("", rounds=3, device="cuda")
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

    traj = [(4, 4), (2, 1), (4, 4)]
    batches = tuple(torch.stack([s.batches[r][j] for r in range(3)])
                    for j in (0, 1))
    for label, compression, impl in (("dfl_dense_power", "", "dense_power"),
                                     ("cdfl_topk", "top_k", "dense")):
        t = bro.cnn_setup(compression, rounds=3, device="cuda")
        cfg = dataclasses.replace(t.cfg(4, 4), mixing_impl=impl)
        ex = RoundExecutor(cfg, t.loss_fn, t.opt, dynamic=False)
        for t1, t2 in dict.fromkeys(traj):
            ex.warmup(t.fresh(), batches, t1, t2)
        builds, captures = ex.compile_count, ex.capture_count
        require((builds, captures) == (2, 2), f"static {label}: {builds} "
                f"builds and {captures} graph sets for 2 keys")
        state = t.fresh()
        ref = clone_state(state)
        torch.cuda.synchronize()
        ops.reset_launches()
        (state, m), syncs = bro.syncs_in_dispatch(
            lambda: ex.dispatch_trajectory(state, batches, traj))
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        sizes = [v[0].numel() for v in state.params.values()]
        steps = sum(t2 for _, t2 in traj)
        expect = expect_launches(
            K, gossip_mix=0 if impl == "dense_power" else steps)
        if compression:
            expect.update(topk_threshold=steps * select_launches(sizes),
                          choco_topk=steps * len(sizes))
        require(counts == expect, f"static {label}: launches {counts}, "
                f"expected {expect}")
        add_launches(K, counts)
        require(not syncs, f"static {label}: synchronizing calls {syncs}")
        require((ex.compile_count, ex.capture_count) == (builds, captures),
                f"static {label}: built or captured for a key seen before")
        eager = []
        with deterministic_algorithms():
            for r, (t1, t2) in enumerate(traj):
                xs, ys = s.batches[r]
                ref, mr = make_round_fn(dataclasses.replace(
                    cfg, tau1=t1, tau2=t2), t.loss_fn, t.opt)(
                        ref, (xs[:t1], ys[:t1]))
                eager.append(mr)
        require(same_state(state, ref)
                and all(torch.equal(m[k][r], eager[r][k])
                        for r in range(3) for k in eager[r]),
                f"static {label}: the replayed dispatch differs from the "
                "eager static rounds")
        times = {"replayed": [], "eager": []}
        fns = {(t1, t2): make_round_fn(dataclasses.replace(
            cfg, tau1=t1, tau2=t2), t.loss_fn, t.opt) for t1, t2 in traj}
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = ex.dispatch_trajectory(state, batches, traj)
            torch.cuda.synchronize()
            times["replayed"].append((time.perf_counter() - t0) * 1e3 / 3)
            t0 = time.perf_counter()
            with deterministic_algorithms():
                for r, (t1, t2) in enumerate(traj):
                    xs, ys = s.batches[r]
                    ref, _ = fns[(t1, t2)](ref, (xs[:t1], ys[:t1]))
            torch.cuda.synchronize()
            times["eager"].append((time.perf_counter() - t0) * 1e3 / 3)
        print(f"static {label}: replayed dispatch bitwise the eager static "
              f"rounds; {builds} builds, {captures} graph sets, 0 after; "
              f"syncs in a dispatch {len(syncs)}; launches "
              + json.dumps({k: v for k, v in counts.items() if v})
              + "; ms per round " + json.dumps(times))


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
            many = op in ("gossip_mix_many", "gossip_mix_received_many")
            on_card = (x[0] if many else x).is_cuda
            if not on_card:
                return orig(x, *args)
            if kind == "noise":
                y, my, noise, *rest = args
                noise = (noise + eps).clamp_(max=1 - 2.0 ** -24)
                return orig(x, y, my, noise, *rest)
            out = orig(x, *args)
            if many:
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


# Phase 5's figures: every paper-figure bench at a quarter of
# ``benchmarks/run.py``'s reduced length on the card and on the CPU (the
# port's plain versions, the same specs and the same seam), the first
# ``FIG_PREFIX`` rounds of every run logged one by one. The CNN amplifies a
# one-ulp difference about 10x a round from round 3 on, so no
# round-by-round limit holds 10 rounds; held
# instead: (a) the first rounds' loss and consensus, (b) each run's final
# global loss and test accuracy, (c) each figure's order of its variants by
# final global loss wherever the CPU's gap between neighbours exceeds (b)'s
# limit. Relative differences; a consensus below ``FIG_CONSENSUS_FLOOR``
# (a fully connected run averages exactly, its consensus is rounding) is
# taken relative to the floor. The limits sit above the largest sound
# reading and below a control with K1's output shifted by 1e-3 on the card
# (``--only figures_calibrate``, PERF.md §6, at 10 rounds and Table I at
# 120 iterations: sound prefix readings up to 1.6e-4, the gated control's
# 0.108 to 9.03; sound final readings 7.3e-4 to 9.5e-3 but Fig. 8's
# 0.0439, whose tau1 = 10 run on label shards is far from settled, the
# gated control's 0.119 to 0.930), so (b)'s limit is a figure's own. The
# limits held at 20 rounds (240 iterations) and at 40 (480) too (PERF.md
# §6), the lengths before the smoke's mesh phases needed their time.
FIG_ROUNDS = 10
FIG_TABLE1_ITERS = 120
FIG_PREFIX = 3
FIG_CONSENSUS_FLOOR = 1e-7
FIG_RTOL = {"prefix": 1e-3, "final": {"fig7": 5e-2, "fig8": 0.2,
                                      "fig9": 5e-2, "fig10": 5e-2,
                                      "table1": 5e-2}}
FIG_CONTROL = ("gossip_mix_many", "x_shift", 1e-3)
FIG_CONTROLS = (("gossip_mix_many", "x_shift", 1e-4),
                ("gossip_mix_many", "x_shift", 1e-3),
                ("gossip_mix_many", "x_scale", 1e-3))


def figure_runs(device, control=None):
    """Every figure bench on ``device`` (``control``: a ``perturbed`` K1
    on the card), results into a temporary directory, the benches' CSV
    swallowed: per bench its rows, its ``run_dfl_cnn`` outputs by spec
    name (logged every 5 rounds and each of the first ``FIG_PREFIX``), its
    wall seconds and its launches."""
    import contextlib
    import io
    import tempfile

    from repro_torch.benchmarks import (fig7_tau2, fig8_tau1, fig9_zeta,
                                        fig10_cdfl, table1_methods)
    from repro_torch.kernels import ops

    benches = {
        "fig7": (fig7_tau2, lambda m, d, tmp: m.run(
            rounds=FIG_ROUNDS, device=d, results_dir=tmp)),
        "fig8": (fig8_tau1, lambda m, d, tmp: m.run(
            rounds=FIG_ROUNDS, device=d, results_dir=tmp)),
        "fig9": (fig9_zeta, lambda m, d, tmp: m.run(
            rounds=FIG_ROUNDS, device=d, results_dir=tmp)),
        "fig10": (fig10_cdfl, lambda m, d, tmp: m.run(
            rounds=FIG_ROUNDS, device=d, results_dir=tmp)),
        "table1": (table1_methods, lambda m, d, tmp: m.run(
            budget_iters=FIG_TABLE1_ITERS, device=d, results_dir=tmp))}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (mod, call) in benches.items():
            runs, real = {}, mod.run_dfl_cnn

            def recorded(spec, device="cuda", **kw):
                runs[spec.name] = real(spec, device=device,
                                       log_first=FIG_PREFIX, **kw)
                return runs[spec.name]

            files = len(os.listdir(tmp))
            mod.run_dfl_cnn = recorded
            try:
                if device == "cuda":
                    torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                with (perturbed(*control) if control
                      else contextlib.nullcontext()), \
                        contextlib.redirect_stdout(io.StringIO()):
                    rows = call(mod, device, tmp)
                if device == "cuda":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                mod.run_dfl_cnn = real
            require(len(os.listdir(tmp)) == files + 1,
                    f"{name}: wrote no result file")
            out[name] = {"rows": rows, "runs": runs, "s": dt,
                         "launches": dict(ops.LAUNCHES)}
    return out


def figure_diffs(card, cpu):
    """Per bench, the largest relative differences over its runs: (a)
    ``prefix``, the first ``FIG_PREFIX`` logged rounds' loss and consensus;
    (b) ``final``, the final global loss and test accuracy."""
    def rel(key, a, b):
        floor = FIG_CONSENSUS_FLOOR if key == "consensus" else 0.0
        return abs(a - b) / max(abs(b), floor)

    out = {}
    for bench, got in card.items():
        pre = fin = 0.0
        for name, run in got["runs"].items():
            h, c = run["history"], cpu[bench]["runs"][name]["history"]
            require(h["round"] == c["round"], f"{bench} {name}: logged "
                    f"rounds {h['round']} vs {c['round']} on the CPU")
            for key in ("loss", "consensus"):
                for a, b in zip(h[key][:FIG_PREFIX], c[key][:FIG_PREFIX]):
                    pre = max(pre, rel(key, a, b))
            for key in ("global_loss", "test_acc"):
                fin = max(fin, rel(key, h[key][-1], c[key][-1]))
        out[bench] = {"prefix": pre, "final": fin}
    return out


def fig_limits(bench):
    """(a)'s and (b)'s limits of ``bench``."""
    return {"prefix": FIG_RTOL["prefix"],
            "final": FIG_RTOL["final"][bench]}


def order_flips(card, cpu):
    """Per bench, the neighbouring variants (in the CPU's order by final
    global loss, where their gap exceeds the bench's (b) limit relative)
    that the card orders the other way."""
    flips = {}
    for bench, got in cpu.items():
        final = {n: r["history"]["global_loss"][-1]
                 for n, r in got["runs"].items()}
        names = sorted(final, key=final.get)
        on_card = {n: r["history"]["global_loss"][-1]
                   for n, r in card[bench]["runs"].items()}
        limit = FIG_RTOL["final"][bench]
        flips[bench] = [(a, b) for a, b in zip(names, names[1:])
                        if (final[b] - final[a]) / abs(final[a]) > limit
                        and not on_card[a] < on_card[b]]
    return flips


def run_figures(K, gate=True, controls=(FIG_CONTROL,)):
    """Phase 5's figures: Figs. 7-10 and Table I at the reduced length
    (``FIG_ROUNDS``, Table I at ``FIG_TABLE1_ITERS``), MNIST, through
    ``run_dfl_cnn`` (the executor's replayed graphs) on the card, then on
    the CPU; every value finite, Fig. 10's launches exact (K1 every gossip
    step, K4 and K3 in its TopK runs, K7 in its randomized gossip), each
    bench's wall time and launches printed; (a), (b) and (c) held within
    ``FIG_RTOL``, and each control run on the card must break (a) or (b) in
    every figure. ``gate=False`` (``--only figures_calibrate``) prints the
    readings and the controls' ungated."""
    from repro_torch.benchmarks import fig10_cdfl
    from repro_torch.models.cnn import init_cnn

    sizes = [v.numel() for v in init_cnn(torch.Generator().manual_seed(0),
                                         "mnist", "cuda").values()]
    # tau2 x rounds of each Fig. 10 run, and the gossip step's warm call
    steps = 4 * FIG_ROUNDS + warm_steps(4)
    n_topk = sum(c == "top_k" for _, c, _ in fig10_cdfl.VARIANTS)
    n_gossip = sum(c == "rand_gossip" for _, c, _ in fig10_cdfl.VARIANTS)
    fig10_expect = expect_launches(
        K, gossip_mix=steps * len(fig10_cdfl.VARIANTS),
        topk_threshold=steps * n_topk * select_launches(sizes),
        choco_topk=steps * n_topk * len(sizes),
        choco_move=steps * n_gossip * len(sizes))
    card = figure_runs("cuda")
    for name, got in card.items():
        for row in got["rows"]:
            for key, v in row.items():
                if key == "consensus" or isinstance(v, float):
                    require(math.isfinite(float(v)),
                            f"{name}: {key} = {v} in {row}")
        for run in got["runs"].values():
            require(all(math.isfinite(v) for key in ("loss", "consensus",
                                                     "global_loss")
                        for v in run["history"][key]),
                    f"{name}: non-finite history")
        if name == "fig10":
            require(got["launches"] == fig10_expect, f"fig10: launches "
                    f"{got['launches']}, expected {fig10_expect}")
        add_launches(K, got["launches"])
    t0 = time.perf_counter()
    cpu = figure_runs("cpu")
    cpu_s = time.perf_counter() - t0
    diffs = figure_diffs(card, cpu)
    flips = order_flips(card, cpu)
    for name, got in card.items():
        rounds = sum(len(r["round_ms"]) for r in got["runs"].values())
        print(f"{name}: {len(got['runs'])} runs, {rounds} rounds in "
              f"{got['s']:.2f} s on the card ({cpu[name]['s']:.2f} s on the "
              f"CPU), launches "
              + json.dumps({k: v for k, v in got["launches"].items() if v}))
        print(f"{name} card vs CPU " + json.dumps({
            "largest": diffs[name], "order_flips": flips[name],
            "final_global_loss": {
                n: [r["history"]["global_loss"][-1],
                    cpu[name]["runs"][n]["history"]["global_loss"][-1]]
                for n, r in got["runs"].items()}}))
        require(not gate or all(diffs[name][k] <= v
                                for k, v in fig_limits(name).items()),
                f"{name}: card vs CPU {diffs[name]}, beyond "
                f"{fig_limits(name)}")
        require(not gate or not flips[name], f"{name}: the card orders "
                f"{flips[name]} the other way from the CPU")
    print(f"figures: card vs CPU held (limits {FIG_RTOL}); the CPU's runs "
          f"took {cpu_s:.1f} s")
    for control in controls:
        ctl = figure_diffs(figure_runs("cuda", control), cpu)
        print("figures control " + json.dumps({"control": control,
                                               "largest": ctl}))
        for name, d in ctl.items():
            require(not gate or any(d[k] > v
                                    for k, v in fig_limits(name).items()),
                    f"{name}: the control {control} is within the limits "
                    f"{fig_limits(name)}: {d}")


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
    plain DFL and of C-DFL QSGD, replayed from the executor's graphs: the
    dispatch bitwise the eager batched rounds (``make_round_fn(engine=
    "batched")``) on the card, rows outside the cohorts bitwise untouched,
    the state in place, exact launches, no synchronizing call in the
    dispatch, no capture after the warmup for new cohorts, peak device
    memory; then an identity cohort at V = C = 10 bitwise the dense
    executor; replayed against eager ms per round."""
    import numpy as np

    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import (DFLConfig, RoundExecutor, init_state,
                                  make_compressor, make_round_fn)
    from repro_torch.core.topology import ring
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.device import deterministic_algorithms
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
        builds, captures = ex.compile_count, ex.capture_count
        ref = clone_state(state)
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
        eager_fn = make_round_fn(cfg, s.loss_fn, s.opt, dynamic_taus=True,
                                 engine="batched", population=pop)

        def eager(st, rr):
            ms = []
            with deterministic_algorithms():
                for i, row in enumerate(rr):
                    st, mr = eager_fn(st, tree_map(lambda b: b[i], batches),
                                      int(row[0]), int(row[1]),
                                      row[2:2 + c], row[2 + c:2 + 2 * c],
                                      row[2 + 2 * c:])
                    ms.append(mr)
            return st, ms

        ref, em = eager(ref, rows)
        require(same_state(state, ref)
                and all(torch.equal(m[k][i], em[i][k])
                        for i in range(3) for k in em[i]),
                f"batched {label}: the replayed dispatch differs from the "
                "eager batched rounds")
        del ref
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
        # population replayed, the same rounds eagerly on a copy, and 3
        # rounds of the dense executor, in turns
        times = {"batched": [], "batched_eager": [], "dense": []}
        copy = clone_state(state)
        for _ in range(2):
            for what, run in (
                    ("batched", lambda: ex.dispatch_trajectory(
                        state, batches, rows2)),
                    ("batched_eager", lambda: eager(copy, rows2)),
                    ("dense", lambda: dense_ex.dispatch_trajectory(
                        dense, batches, rows[:, :2]))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _ = run()
                torch.cuda.synchronize()
                times[what].append((time.perf_counter() - t0) * 1e3 / 3)
                if what == "batched":
                    state = out
                elif what == "dense":
                    dense = out
        require(ex.capture_count == captures, f"batched {label}: captured "
                "after the warmup for new cohorts")
        print(f"batched {label}: the replayed dispatch bitwise the eager "
              f"batched rounds; identity cohort at V = C = {c} bitwise the "
              f"dense executor; {captures} graphs, 0 after the warmup; ms "
              "per round " + json.dumps(times))
        del state, ex, dense, ident, copy


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


def top_kernels(kernels, per, n=5, width=60):
    """The ``n`` kernels with the most device time, in ms per ``per``, by
    the first ``width`` characters of their names."""
    total = {}
    for _, a, b, name in kernels:
        total[name[:width]] = total.get(name[:width], 0.0) + (b - a) / 1e3 / per
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


def run_telemetry_phase(K):
    """Phase 13, telemetry on the card (``repro_torch.obs``): (a) the sink's
    neutrality on the CIFAR CNN, 10-node ring, one K = 3 dispatch at (4, 4)
    of plain DFL and of C-DFL QSGD (gamma ``QSGD_GAMMA``) through an
    executor with a live sink and one without: the state and metrics
    bitwise equal, the same launches, no synchronizing call in the sink's
    dispatch, no build or capture after the warmup, the stream valid, the
    sink's host time a dispatch; (b) ``bench_round_overhead --measure
    telemetry --check`` (the sink under 2% of superstep throughput); (c) the
    train CLI on the reduced Qwen3 (``lm_argv``, C-DFL TopK) with
    ``--telemetry-out``, ``--history-out`` and ``--profile-dir``: each file
    written and valid, the history the stream's view, the counters events'
    kernel launches summing to the run's, the profile holding the card's
    kernels."""
    import tempfile

    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import MetricsBuffer, RoundExecutor
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs import (Telemetry, history_view, read_events,
                                 run_report, validate_stream)

    for label, compression in (("dfl", ""), ("cdfl_qsgd", "qsgd")):
        s = bro.cnn_setup(compression, rounds=3, gamma=QSGD_GAMMA,
                          device="cuda")
        batches = tuple(torch.stack([s.batches[r][j] for r in range(3)])
                        for j in (0, 1))
        tel = Telemetry(meta={"phase": "telemetry", "run": label})
        exes = {"off": RoundExecutor(s.cfg(4, 4), s.loss_fn, s.opt),
                "on": RoundExecutor(s.cfg(4, 4), s.loss_fn, s.opt,
                                    telemetry=tel)}
        states, out = {}, {}
        for mode, ex in exes.items():
            states[mode] = s.fresh()
            ex.warmup(states[mode], batches)
        warm = {mode: (ex.compile_count, ex.capture_count)
                for mode, ex in exes.items()}
        for mode, ex in exes.items():
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            (states[mode], m), syncs = bro.syncs_in_dispatch(
                lambda: ex.dispatch(states[mode], batches, 4, 4))
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            out[mode] = (m, syncs, dict(ops.LAUNCHES), host_ms)
        (m_off, _, l_off, ms_off), (m_on, syncs, l_on, ms_on) = (
            out["off"], out["on"])
        steps = 3 * 4
        expect = expect_launches(K, gossip_mix=steps)
        if compression:
            expect.update(choco_qsgd=steps * len(states["on"].params))
        require(l_on == l_off == expect, f"telemetry {label}: launches "
                f"{l_on} with a sink, {l_off} without, expected {expect}")
        add_launches(K, l_on)
        add_launches(K, l_off)
        require(same_state(states["on"], states["off"])
                and all(torch.equal(m_on[k], m_off[k]) for k in m_off),
                f"telemetry {label}: the dispatch with a sink differs from "
                "the dispatch without one")
        require(not syncs, f"telemetry {label}: synchronizing calls in the "
                f"sink's dispatch {syncs}")
        require(all((ex.compile_count, ex.capture_count) == warm[mode]
                    for mode, ex in exes.items()),
                f"telemetry {label}: a build or a capture after the warmup")
        buf = MetricsBuffer(telemetry=tel)
        buf.push(0, 3, None, None, m_on)
        rows = buf.flush()
        require(validate_stream(tel.events) == [], f"telemetry {label}: "
                f"the stream does not validate: {validate_stream(tel.events)}")
        kinds = [e["type"] for e in tel.events]
        print(f"telemetry {label}: the dispatch with a sink bitwise the "
              "dispatch without one, 0 syncs, no build or capture after the "
              "warmup " + json.dumps({
                  "events": {k: kinds.count(k) for k in sorted(set(kinds))},
                  "host_ms_dispatch": {"with_sink": ms_on,
                                       "without": ms_off},
                  "losses": [r["loss"] for r in rows],
                  "launches": {k: v for k, v in l_on.items() if v}}))
    with tempfile.TemporaryDirectory() as tmp:
        out = bro.main(["--measure", "telemetry", "--check", "--device",
                        "cuda", "--out", os.path.join(tmp, "bt")])
        print("telemetry bench " + json.dumps(
            {k: out[k] for k in ("rounds_per_s_off", "rounds_per_s_on",
                                 "overhead_pct", "events_per_run",
                                 "dispatch_pairs")}))
        ev_path = os.path.join(tmp, "events.jsonl")
        hist_path = os.path.join(tmp, "history.json")
        prof_dir = os.path.join(tmp, "profile")
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = train.run(train.parse_args(
            lm_argv("qwen3-1.7b", "top_k", "cuda", rounds=4, superstep=2)
            + ["--telemetry-out", ev_path, "--history-out", hist_path,
               "--profile-dir", prof_dir]), log=lambda _: None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        add_launches(K, launches)
        events = read_events(ev_path)
        problems = validate_stream(events)
        require(not problems, f"telemetry CLI: the stream does not "
                f"validate: {problems}")
        with open(hist_path) as f:
            hist = json.load(f)
        require(hist == history_view(events) and hist["round"] == [1, 2, 3, 4]
                and hist["compile_count"] == hist["compile_count_warmup"],
                f"telemetry CLI: the history is not the stream's view: "
                f"{hist}")
        summed = run_report(events)["counters"]
        dispatched = {k: sum(e["data"].get(f"kernel_{k}", 0) for e in events
                             if e["type"] == "counters"
                             and e["name"] == "superstep-counters")
                      for k in launches}
        # the warmup dispatch at (1, 0) gossips nothing: the run's
        # launches are its 8 gossip steps', counted in their supersteps'
        # counters, and one step's more, the gossip graph's warm call
        require(launches["gossip_mix"] > 0 and all(
            8 * (launches[k] - dispatched[k]) == dispatched[k]
            for k in launches), f"telemetry CLI: counters {dispatched} "
                f"against the run's launches {launches}")
        with open(os.path.join(prof_dir, "trace.json")) as f:
            trace = json.load(f)
        kernels = sum(e.get("cat") == "kernel"
                      for e in trace.get("traceEvents", []))
        require(kernels > 0, "telemetry CLI: the profile holds no kernel")
        kinds = [e["type"] for e in events]
        print("telemetry CLI " + json.dumps({
            "s": dt, "events": {k: kinds.count(k) for k in sorted(set(kinds))},
            "history_rounds": hist["round"],
            "builds_after_warmup": res["builds_after_warmup"],
            "captures_after_warmup": res["captures_after_warmup"],
            "dispatched_launches": {k: v for k, v in dispatched.items() if v},
            "compiles_seen": run_report(events)["compiles_seen"],
            "kernel_counter_totals": {k: v for k, v in summed.items()
                                      if k.startswith("kernel_") and v},
            "profile_kernel_events": kernels}))


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
        expect = expect_launches(K, gossip_mix=spec.tau2 * spec.rounds
                                 + warm_steps(spec.tau2))
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


# ---------------------------------------------------------------------------
# Phase 11: the LM stack and the train CLI
# ---------------------------------------------------------------------------

LM_NODES = 4
LM_FULL_ARCH = "qwen3-1.7b"
LM_FULL_LAYERS = 2          # the one cut of the published config: 28 -> 2
LM_FULL_BATCH, LM_FULL_SEQ, LM_FULL_ROUNDS = 2, 1024, 3
LM_TOPK_GAMMA = 0.6         # the CLI's default CHOCO step
# round-by-round card vs CPU of the reduced Qwen3 through the CLI (2
# rounds, the same weights and draws), relative: limits between the
# largest sound reading and a control run with K1's output scaled by 1.01
# on the card only (``--only lm_calibrate``, PERF.md §6): TopK loss
# 8.0e-6, consensus 4.5e-3 (a TopK boundary flips with the bf16 matmuls'
# rounding), control 0.20; QSGD loss 8.0e-6, consensus 2.0e-6, control
# 4.1e-3. K1 runs after round 1's loss is taken, so the control shows in
# the consensus.
LM_CPU_RTOL = {"top_k": {"loss": 1e-4, "consensus_sq": 1e-2},
               "qsgd": {"loss": 1e-4, "consensus_sq": 1e-4}}
LM_CONTROL = ("gossip_mix_many", "x_scale", 1e-2)


def lm_argv(arch, compression, device, rounds=2, superstep=2, batch=2,
            seq=64, nodes=LM_NODES):
    """The train CLI's arguments of the phase: ``nodes`` nodes on a ring,
    tau (2, 2), SGD at the CLI's step; C-DFL QSGD at gamma ``QSGD_GAMMA``,
    TopK at the CLI's 0.6 (frac 0.5, 16 QSGD levels: its defaults)."""
    return ["--arch", arch, "--nodes", str(nodes), "--tau1", "2",
            "--tau2", "2", "--rounds", str(rounds), "--superstep",
            str(superstep), "--batch", str(batch), "--seq", str(seq),
            "--compression", compression, "--gamma",
            str(QSGD_GAMMA if compression == "qsgd" else LM_TOPK_GAMMA),
            "--log-every", "1", "--device", device]


def lm_step_launches(compression, params):
    """Kernel launches of one gossip step over the stacked LM tree
    ``params``: one K1 call per dtype (one launch per 32 leaves); TopK one
    K4 call per dtype (per group of 32 leaves one launch per digit of the
    dtype when a row spans several chunks, else one) and K3 per leaf;
    QSGD K2 per leaf."""
    from repro_torch.kernels import gossip_mix, topk

    groups = {}
    for p in params.values():
        groups.setdefault(p.dtype, []).append(p[0].numel())
    out = {"gossip_mix": sum(-(-len(g) // gossip_mix.MAX_LEAVES)
                             for g in groups.values())}
    if compression == "top_k":
        k4 = 0
        for dt, g in groups.items():
            for i in range(0, len(g), topk.MAX_LEAVES):
                k4 += (len(topk.DIGITS[dt])
                       if max(g[i:i + topk.MAX_LEAVES]) > topk.CHUNK else 1)
        out.update(topk_threshold=k4, choco_topk=len(params))
    elif compression == "qsgd":
        out["choco_qsgd"] = len(params)
    return out


def lm_hook(K, per_step, log):
    """A ``dispatch(executor, state, batches, rows)`` hook for the train
    CLI: no synchronizing CUDA call inside, exactly ``per_step`` launches
    a gossip step (added to the kernels line), the dispatch timed on the
    host clock ended by a sync and kept with its batches and rows."""
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.kernels import ops

    def dispatch(ex, state, batches, rows):
        rows = np.asarray(rows)
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        out, syncs = bro.syncs_in_dispatch(
            lambda: ex.dispatch_trajectory(state, batches, rows))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_delta(before)
        steps = int(rows[:, 1].sum())
        expect = expect_launches(K, **{k: v * steps
                                       for k, v in per_step.items()})
        require(counts == expect, f"dispatch of {rows[:, :2].tolist()}: "
                f"launches {counts}, expected {expect}")
        require(not syncs, f"dispatch of {rows[:, :2].tolist()}: "
                f"synchronizing calls {syncs}")
        add_launches(K, counts)
        log.append({"seconds": dt, "rows": rows, "batches": batches,
                    "launches": counts})
        return out

    return dispatch


def lm_cli_runs(K, gate):
    """(a) ``train.run`` (the CLI's body) on every reduced architecture,
    C-DFL TopK, and on the reduced Qwen3 also C-DFL QSGD: finite losses,
    exact launches, no build or capture after the warmup, no synchronizing
    call in a dispatch; the reduced Qwen3's rounds against the port's CPU
    run of the same arguments (weights and draws alike), within
    ``LM_CPU_RTOL``, and the control (``LM_CONTROL``) beyond it."""
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.launch import train
    from repro_torch.models import init_params

    def card_run(arch, compression, dispatch=None):
        args = train.parse_args(lm_argv(arch, compression, "cuda"))
        return train.run(args, dispatch=dispatch, log=lambda s: None)

    for arch in list_archs():
        for compression in (("top_k", "qsgd") if arch == LM_FULL_ARCH
                            else ("top_k",)):
            log = []
            t0 = time.perf_counter()
            probe = init_params(get_arch(arch).reduced, None, "cpu",
                                abstract=True)[0]
            per_step = lm_step_launches(compression, {
                k: v.expand((LM_NODES,) + tuple(v.shape))
                for k, v in probe.items()})
            rec = card_run(arch, compression, lm_hook(K, per_step, log))
            wall = time.perf_counter() - t0
            losses = [r["loss"] for r in rec["rows"]]
            require(all(math.isfinite(v) for v in losses)
                    and len(losses) == 2, f"lm cli {arch}: losses {losses}")
            require(rec["builds_after_warmup"] == 0
                    and rec["captures_after_warmup"] == 0,
                    f"lm cli {arch}: {rec['builds_after_warmup']} builds and "
                    f"{rec['captures_after_warmup']} captures after the "
                    "warmup")
            line = {"arch": arch, "compression": compression,
                    "losses": losses,
                    "consensus_sq": [r["consensus_sq"] for r in rec["rows"]],
                    "leaves": len(rec["state"].params),
                    "dtypes": sorted({str(p.dtype).split(".")[1] for p in
                                      rec["state"].params.values()}),
                    "launches_per_gossip_step": per_step,
                    "dispatch_s": [e["seconds"] for e in log],
                    "captures": rec["capture_count"], "wall_s": wall}
            if arch == LM_FULL_ARCH:
                args = train.parse_args(lm_argv(arch, compression, "cpu"))
                cpu = train.run(args, log=lambda s: None)
                with perturbed(*LM_CONTROL):
                    ctl = card_run(arch, compression)
                rtol = LM_CPU_RTOL[compression]
                for name, run in (("card", rec), ("control", ctl)):
                    line[f"{name}_vs_cpu"] = {
                        key: [abs(a[key] - b[key]) / abs(b[key]) for a, b in
                              zip(run["rows"], cpu["rows"])]
                        for key in rtol}
                line["rtol"] = rtol
                within = lambda d: all(  # noqa: E731
                    max(d[k]) <= v for k, v in rtol.items())
                if gate:
                    require(within(line["card_vs_cpu"]),
                            f"lm cli {arch} {compression}: card vs CPU "
                            f"{line['card_vs_cpu']} beyond {rtol}")
                    require(not within(line["control_vs_cpu"]),
                            f"lm cli {arch} {compression}: the control "
                            f"{LM_CONTROL} stays within {rtol}")
            print("lm cli " + json.dumps(line))


def lm_eager_reference(cfg, args, comp):
    """The full-width run's rounds eagerly on the card, as ``round_body``
    runs them, with the consensus distance after the local phase and after
    each gossip step, from the CLI's initial state and batches; returns
    them, the final params and estimates, and the node-mean loss of round
    0's first batch at the initial weights."""
    from repro_torch.core import dfl
    from repro_torch.core.substrate import DenseSubstrate
    from repro_torch.core.topology import ring
    from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
    from repro_torch.launch import train
    from repro_torch.models import init_params, train_loss

    def loss_fn(p, b):
        return train_loss(p, b, cfg)

    n, tau1, tau2 = LM_NODES, args.tau1, args.tau2
    opt = train.make_optimizer(args.optimizer, args.lr)
    params0, _ = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    state = dfl.init_state(params0, n, opt, compressed=comp is not None,
                           seed=1)
    del params0
    dcfg = dfl.DFLConfig(tau1=tau1, tau2=tau2, topology=ring(n),
                         compression=comp, gamma=args.gamma)
    sub = DenseSubstrate(dcfg.topology)
    corpus = SyntheticLM(vocab_size=cfg.vocab_size, num_nodes=n,
                         noniid_alpha=args.noniid)
    params, opt_state, hat = state.params, state.opt_state, state.hat_params
    out = {"loss": [], "consensus": []}
    for r in range(args.rounds):
        b = {k: torch.from_numpy(v).cuda() for k, v in lm_batches_for_dfl(
            corpus, tau1, n, args.batch, args.seq, r).items()}
        if r == 0:
            out["batch0"] = {k: v[0] for k, v in b.items()}
            with torch.no_grad():
                out["trained_loss_before"] = float(torch.func.vmap(loss_fn)(
                    params, out["batch0"]).mean())
        params, opt_state, loss = dfl.local_phase(
            dcfg, loss_fn, opt, sub, params, opt_state, b, tau1)
        cons = [float(sub.consensus_sq(params))]
        for t in range(tau2):
            if comp is None:
                params = sub.mix(params)
            else:
                params, hat = sub.choco_step(comp, params, hat,
                                             sub.mix(hat), args.gamma,
                                             state.draws, r, t)
            cons.append(float(sub.consensus_sq(params)))
        out["loss"].append(loss)
        out["consensus"].append(cons)
    out["params"], out["hat"] = params, hat
    return out


def event_ms(fn, reps=2):
    """Device time of one ``fn()`` call between CUDA events, after a warm
    call, for calls long enough that the host's launch time does not
    count (the plain versions at LM leaf shapes), outside any graph."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def replay_ms(replay, reps=3):
    """Device time of one replay of a captured step, CUDA events."""
    replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lm_full_runs(K, gate, cfg, seq=LM_FULL_SEQ):
    """(b) Qwen3-1.7B at its published widths, depth cut to
    ``LM_FULL_LAYERS``: 4 nodes on ring(4), tau (2, 2), batch 2 a node,
    ``seq`` tokens, ``LM_FULL_ROUNDS`` rounds in one K = 3 dispatch of the
    train CLI's body, plain DFL, C-DFL TopK and C-DFL QSGD. The dispatch
    bitwise the eager rounds on the card (state, estimates, losses), no
    synchronizing call in it, exact launches, no build or capture after
    the warmup; under plain DFL the consensus distance lower after every
    gossip step (printed for C-DFL); every loss finite, and the node-mean
    loss of round 0's first batch lower at the final weights than at the
    initial ones. Prints ms a round, ms a local step and a gossip step
    (graph replays), the busy share of a dispatch and the peak memory."""
    import gc

    from repro_torch.core import make_compressor
    from repro_torch.launch import train
    from repro_torch.models import train_loss

    for label, compression in (("dfl", ""), ("cdfl_topk", "top_k"),
                               ("cdfl_qsgd", "qsgd")):
        t0 = time.perf_counter()
        args = train.parse_args(lm_argv(
            LM_FULL_ARCH, compression, "cuda", rounds=LM_FULL_ROUNDS,
            superstep=LM_FULL_ROUNDS, batch=LM_FULL_BATCH, seq=seq))
        comp = make_compressor(compression) if compression else None
        ref = lm_eager_reference(cfg, args, comp)
        for key in ("params", "hat"):   # on the host during the CLI's run
            if ref[key] is not None:
                ref[key] = {k: v.cpu() for k, v in ref[key].items()}
        t_ref = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        per_step = lm_step_launches(compression, ref["params"])
        log = []
        held_gb = torch.cuda.memory_allocated() / 1e9  # round 0's batch
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        rec = train.run(args, cfg,
                        generator=torch.Generator("cuda").manual_seed(0),
                        dispatch=lm_hook(K, per_step, log),
                        log=lambda s: None)
        t_run = time.perf_counter() - t1
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
        state, ex = rec["state"], rec["executor"]
        require(rec["builds_after_warmup"] == 0
                and rec["captures_after_warmup"] == 0,
                f"lm full {label}: builds or captures after the warmup")
        same = all(same_bits(state.params[k], ref["params"][k].cuda())
                   for k in state.params)
        if comp is not None:
            same = same and all(same_bits(state.hat_params[k],
                                          ref["hat"][k].cuda())
                                for k in state.hat_params)
        losses = [r["loss"] for r in rec["rows"]]
        same_loss = losses == [float(v) for v in ref["loss"]]
        with torch.no_grad():
            after = float(torch.func.vmap(
                lambda p, b: train_loss(p, b, cfg))(
                    state.params, ref["batch0"]).mean())
        # plain DFL: every gossip step lowers the consensus distance;
        # CHOCO starts from zero estimates, and under QSGD the reference's
        # own CLI grows it over the first rounds too (printed, not held)
        falls = [all(b < a for a, b in zip(c, c[1:]))
                 for c in ref["consensus"]] if comp is None else [True]
        line = {"run": label, "losses": losses,
                "consensus_sq": [r["consensus_sq"] for r in rec["rows"]],
                "consensus_after_local_and_each_gossip_step":
                    ref["consensus"],
                "trained_batch_loss_before": ref["trained_loss_before"],
                "trained_batch_loss_after": after,
                "replay_bitwise_eager": same, "losses_bitwise": same_loss,
                "launches_per_gossip_step": per_step,
                "dispatch_launches": log[0]["launches"],
                "ms_per_round": log[0]["seconds"] * 1e3 / LM_FULL_ROUNDS,
                "peak_gb": peak_gb,
                "captures": rec["capture_count"],
                "warmup_s": rec["warmup_s"], "eager_s": t_ref,
                "run_s": t_run}
        rp = ex._graph._replays
        line["local_step_ms"] = replay_ms(rp["local_next"].replay)
        line["gossip_step_ms"] = replay_ms(rp["gossip"].replay)
        del rp
        t2 = time.perf_counter()
        busy, kernels = device_busy_ms(lambda: ex.dispatch_trajectory(
            state, log[0]["batches"], log[0]["rows"]))
        profiled_ms = (time.perf_counter() - t2) * 1e3
        line["busy_ms_per_round"] = busy / LM_FULL_ROUNDS
        line["profiled_ms_per_round"] = profiled_ms / LM_FULL_ROUNDS
        # busy time of the profiled dispatch over the unprofiled one's wall
        line["busy_share"] = busy / (log[0]["seconds"] * 1e3)
        line["top_kernels_ms_per_round"] = top_kernels(
            kernels, LM_FULL_ROUNDS, n=12, width=240)
        print(f"lm full {label} " + json.dumps(line))
        checks = {"replay bitwise the eager rounds": same and same_loss,
                  "finite losses": all(math.isfinite(v) for v in losses),
                  "consensus falls at every gossip step": all(falls),
                  "trained-batch loss falls": after < ref[
                      "trained_loss_before"]}
        failed = [k for k, ok in checks.items() if not ok]
        if gate:
            require(not failed, f"lm full {label}: {failed}")
        elif failed:
            print(f"lm full {label}: NOT MET {failed}")
        del rec, state, ex, ref, log, kernels
        gc.collect()
        torch.cuda.empty_cache()


def lm_kernel_times(cfg, gate):
    """(c) K1, K4 + K3 and K2 on the full-width tree (every leaf ``[4, D]``
    bf16 of the run's model, random data), each one call or one launch per
    leaf as the round makes it, then K6 and K5 (one call each, K5 also one
    launch a leaf) and K7 over the same leaves,
    bitwise against its plain version, timed (CUDA-graph replay between
    CUDA events) against the plain version, one PyTorch call where there
    is one, and the bound: bytes at the card's memory rate (bf16: K1 4 B
    an element, K4 2, K3 12, K2 14, K6 8, K5 4, K7 10)."""
    import gc

    from repro_torch.core.compression import QSGD, TopK
    from repro_torch.core.mixing import gossip_table
    from repro_torch.core.topology import ring
    from repro_torch.kernels import (choco_fused, choco_update, gossip_mix,
                                     ops, qsgd, topk)
    from repro_torch.models import init_params

    shapes = [tuple(v.shape) for v in init_params(
        cfg, None, "cpu", abstract=True)[0].values()]
    dims = [int(np.prod(s)) for s in shapes]
    gen = torch.Generator("cuda").manual_seed(3)
    n, gamma = LM_NODES, 0.6
    topo = ring(n)
    nbr, w = (torch.from_numpy(a).cuda() for a in gossip_table(topo))
    ct = torch.as_tensor(topo.mixing.T, dtype=torch.bfloat16, device="cuda")

    def rand(d):
        return torch.randn(n, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    xs = [rand(d) for d in dims]
    ys = [rand(d) for d in dims]
    mys = [rand(d) for d in dims]
    elems = n * sum(dims)
    out, bad = {"leaves": len(dims), "elements": elems}, []

    def held(name, got, want):
        if not all(same_bits(g, t) for g, t in zip(got, want)):
            bad.append(name)

    def timed(name, kern, plain, lib, nbytes):
        out[name] = {"ms": device_ms(kern, iters=2, reps=3),
                     "plain_ms": event_ms(plain),
                     "library_ms": event_ms(lib) if lib else None,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    held("gossip_mix", ops.gossip_mix_many(xs, nbr, w),
         [gossip_mix.plain(x, nbr, w) for x in xs])
    timed("gossip_mix", lambda: ops.gossip_mix_many(xs, nbr, w),
          lambda: [gossip_mix.plain(x, nbr, w) for x in xs],
          lambda: [ct @ x for x in xs], 4 * elems)
    gc.collect()
    torch.cuda.empty_cache()
    comp = TopK()                       # the CLI's frac, 0.5
    gaps = [choco_fused.gap(x, y, my, gamma) for x, y, my in
            zip(xs, ys, mys)]
    ks = [comp._k(d) for d in dims]
    threshs = ops.topk_threshold_many(gaps, ks)
    held("topk_threshold", threshs,
         [topk.threshold_plain(g, k) for g, k in zip(gaps, ks)])
    # the plain version is one torch.topk a leaf, the library call
    timed("topk_threshold", lambda: ops.topk_threshold_many(gaps, ks),
          lambda: [topk.threshold_plain(g, k) for g, k in zip(gaps, ks)],
          None, 2 * elems)
    for x, y, my, g, t in zip(xs, ys, mys, gaps, threshs):
        held("choco_topk", ops.choco_topk(x, y, my, g, t, gamma),
             choco_fused.plain(x, y, my, g, t, gamma))
    timed("choco_topk",
          lambda: [ops.choco_topk(x, y, my, g, t, gamma) for x, y, my, g, t
                   in zip(xs, ys, mys, gaps, threshs)],
          lambda: [choco_fused.plain(x, y, my, g, t, gamma) for x, y, my, g,
                   t in zip(xs, ys, mys, gaps, threshs)], None, 12 * elems)
    del threshs
    gc.collect()
    torch.cuda.empty_cache()
    comp = QSGD()
    noises = [torch.rand(n, d, generator=gen, device="cuda") for d in dims]
    norms = [torch.linalg.vector_norm(g.float(), dim=1) for g in gaps]
    del gaps
    cs = [comp._c(d) for d in dims]
    for x, y, my, z, nm, c in zip(xs, ys, mys, noises, norms, cs):
        held("choco_qsgd", ops.choco_qsgd(x, y, my, z, nm, gamma, 16, c),
             choco_fused.qsgd_plain(x, y, my, z, nm, gamma, 16,
                                    qsgd.scale(16, c)))
    timed("choco_qsgd",
          lambda: [ops.choco_qsgd(x, y, my, z, nm, gamma, 16, c) for
                   x, y, my, z, nm, c in zip(xs, ys, mys, noises, norms, cs)],
          lambda: [choco_fused.qsgd_plain(x, y, my, z, nm, gamma, 16,
                                          qsgd.scale(16, c)) for
                   x, y, my, z, nm, c in zip(xs, ys, mys, noises, norms, cs)],
          None, 14 * elems)
    # the kernels off the round's path, over the same leaves: K6 (QSGD's
    # ``compress``, one call for the tree), K5 (TopK's ``compress``) and
    # K7 (RandK's and randomized gossip's move), each index computed at
    # 1.24 G elements a leaf
    norms = [torch.linalg.vector_norm(x.float(), dim=1) for x in xs]
    held("qsgd_quantize", ops.qsgd_quantize_many(xs, noises, norms, 16, cs),
         [qsgd.plain(x, z, nm, 16, qsgd.scale(16, c))
          for x, z, nm, c in zip(xs, noises, norms, cs)])
    timed("qsgd_quantize",
          lambda: ops.qsgd_quantize_many(xs, noises, norms, 16, cs),
          lambda: [qsgd.plain(x, z, nm, 16, qsgd.scale(16, c))
                   for x, z, nm, c in zip(xs, noises, norms, cs)],
          None, 8 * elems)
    del noises, norms
    gc.collect()
    torch.cuda.empty_cache()
    threshs = ops.topk_threshold_many(xs, ks)
    held("topk_mask", ops.topk_mask_many(xs, threshs),
         [topk.mask_plain(x, t) for x, t in zip(xs, threshs)])
    timed("topk_mask", lambda: ops.topk_mask_many(xs, threshs),
          lambda: [topk.mask_plain(x, t) for x, t in zip(xs, threshs)],
          None, 4 * elems)
    # the one call and one launch a leaf read by turns, three of each, so
    # that a drift of the card within the phase shows in both
    turns = [[device_ms(fn, iters=2, reps=3) for fn in (
        lambda: ops.topk_mask_many(xs, threshs),
        lambda: [ops.topk_mask(x, t) for x, t in zip(xs, threshs)])]
        for _ in range(3)]
    out["topk_mask"]["per_leaf_launches_ms"] = turns[0][1]
    out["topk_mask"]["by_turns"] = {"one_call": [a for a, _ in turns],
                                    "per_leaf": [b for _, b in turns]}
    for x, y, my in zip(xs, ys, mys):
        held("choco_move", ops.choco_move(x, y, my, gamma),
             choco_update.plain(x, y, my, gamma))
    timed("choco_move",
          lambda: [ops.choco_move(x, y, my, gamma)
                   for x, y, my in zip(xs, ys, mys)],
          lambda: [choco_update.plain(x, y, my, gamma)
                   for x, y, my in zip(xs, ys, mys)], None, 10 * elems)
    out["not_bitwise"] = bad
    print("lm kernels " + json.dumps(out))
    if gate:
        require(not bad, f"lm kernels: not bitwise their plain versions: "
                f"{bad}")


def lm_seam_probe(cfg, seq=LM_FULL_SEQ):
    """The full-width C-DFL QSGD run once more with the RNG seam's step
    drawn as one cached block (``GeneratorDraws.BLOCK_MAX`` lifted), as
    before the seam drew large trees chunk by chunk: its peak memory and
    gossip step, or the allocation that failed."""
    from repro_torch.core.rng import GeneratorDraws
    from repro_torch.launch import train

    args = train.parse_args(lm_argv(
        LM_FULL_ARCH, "qsgd", "cuda", rounds=LM_FULL_ROUNDS,
        superstep=LM_FULL_ROUNDS, batch=LM_FULL_BATCH, seq=seq))
    saved = GeneratorDraws.BLOCK_MAX
    GeneratorDraws.BLOCK_MAX = 1 << 62
    torch.cuda.reset_peak_memory_stats()
    try:
        rec = train.run(args, cfg,
                        generator=torch.Generator("cuda").manual_seed(0),
                        log=lambda s: None)
        line = {"ran": True, "peak_gb": torch.cuda.max_memory_allocated()
                / 1e9, "gossip_step_ms": replay_ms(
                    rec["executor"]._graph._replays["gossip"].replay)}
        del rec
    except torch.OutOfMemoryError as e:
        line = {"ran": False, "error": str(e).splitlines()[0],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        GeneratorDraws.BLOCK_MAX = saved
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print("lm seam one block " + json.dumps(line))


def run_lm_phase(K, gate=True):
    """Phase 11, the LM stack and the train CLI (``repro_torch.launch.
    train``): (a) ``lm_cli_runs``, (b) ``lm_full_runs``, (c)
    ``lm_kernel_times``. ``gate=False`` (``--only lm_calibrate``) prints
    the readings and the controls and holds none of the limits."""
    from repro_torch.configs import REGISTRY

    cfg = dataclasses.replace(REGISTRY[LM_FULL_ARCH].model,
                              num_layers=LM_FULL_LAYERS)
    parts = [("cli", lambda: lm_cli_runs(K, gate)),
             ("full width", lambda: lm_full_runs(K, gate, cfg)),
             ("kernels", lambda: lm_kernel_times(cfg, gate))]
    if not gate:
        parts.append(("seam one block", lambda: lm_seam_probe(cfg)))
    times = {}
    for name, part in parts:
        t0 = time.perf_counter()
        if gate:
            part()
        else:       # calibration: every part, whatever failed before
            import traceback
            try:
                part()
            except Exception:
                traceback.print_exc(file=sys.stdout)
        times[name] = round(time.perf_counter() - t0, 1)
    print("lm phase seconds " + json.dumps(times))


SERVE_STEPS = 8             # decode steps held graphed vs eager
# (a) the reduced archs in f32, card vs CPU under teacher forcing: the
# largest relative logit difference over prefill and the 8 steps. The
# control adds SERVE_CONTROL to ``final_norm`` on the card only (every
# logit scaled by 1 + delta), which must break the limit. Readings
# (``--only serve_calibrate``, PERF.md §6): sound 7.8e-7 to 2.04e-6
# (granite's MoE), control 1.04e-5 to 1.08e-5.
SERVE_CPU_RTOL = 5e-6
SERVE_CONTROL = 1e-5
SERVE_CONTROLS = (1e-6, 1e-5, 1e-4)
# (b), (c) full width in bf16: prefill and the 8 eager decode steps
# against ``forward`` over the prompt and the same tokens, relative to the
# largest logit; the control adds SERVE_FULL_CONTROL to ``final_norm``.
# Readings: sound 6.2e-3 to 7.8e-3 (about one bf16 ulp of the largest
# logit), control 1e-2 -> 1.39e-2 to 1.55e-2, 5e-2 -> 5.6e-2.
SERVE_FULL_RTOL = 1.2e-2
SERVE_FULL_CONTROL = 2e-2
SERVE_FULL_CONTROLS = (1e-2, 2e-2, 5e-2)
SERVE_FULL = {
    # 8 prompts of 900-1024 tokens: one bucket of 1024
    "qwen3-1.7b": {"max_batch": 8, "bucket": 128, "max_len": 1152,
                   "prompt": (900, 1024), "gen": 64},
    # 8 prompts of 1536, past the local layers' window of 1024
    "gemma3-4b": {"max_batch": 8, "bucket": 128, "max_len": 1664,
                  "prompt": (1536, 1536), "gen": 64},
}


def rel_err(a, b):
    """max |a - b| over max |b|, in f32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def with_final_norm(params, delta):
    """``params`` with ``final_norm`` shifted by ``delta`` (every logit
    scaled by 1 + delta): the serve phase's control."""
    return dict(params, final_norm=params["final_norm"] + delta)


def teacher_forced(params, cfg, batch, max_len, toks):
    """Eager prefill, then one decode step per token of ``toks`` (each
    [B, 1]); the logits of prefill and of each step."""
    from repro_torch.models import decode_step, prefill

    with torch.no_grad():
        logits, state = prefill(params, batch, cfg, max_len)
        out = [logits]
        for t in toks:
            logits, state = decode_step(params, state, t, cfg)
            out.append(logits)
    return out


def graphed_and_eager(engine, params, cfg, batch, steps=SERVE_STEPS):
    """One prefill of ``batch``; then ``steps`` decode steps through the
    engine's decode step (a replayed graph on the card) and the same steps
    eagerly (``decode_step``, greedy) from the prefill's own state. Returns
    the prefill logits, the graphed and the eager (logits, token) pairs,
    the token each step consumed, the decode step and the eager state."""
    from repro_torch.models import decode_step, prefill

    with torch.no_grad():
        logits, state = prefill(params, batch, cfg, engine.max_len)
        dec = engine.decoder(logits, state)
        fed = [dec.tok.clone()]
        graphed = []
        for _ in range(steps):
            dec.step()
            graphed.append((dec.logits.clone(), dec.tok.clone()))
            fed.append(dec.tok.clone())
        tok, eager = engine.greedy(logits), []
        for _ in range(steps):
            lg, state = decode_step(params, state, tok, cfg)
            tok = engine.greedy(lg)
            eager.append((lg, tok))
    return logits, graphed, eager, fed[:steps], dec, state


def same_steps(graphed, eager):
    return all(same_bits(a, c) and torch.equal(b, d)
               for (a, b), (c, d) in zip(graphed, eager))


def serve_reduced_runs(gate):
    """(a) Every architecture's reduced config in f32 on the card: prefill
    of 2 prompts of 16 tokens, ``SERVE_STEPS`` greedy decode steps replayed
    from the engine's graph (one capture) bitwise the same steps run
    eagerly, finite logits; the card's logits against the port's CPU run
    fed the same tokens, within ``SERVE_CPU_RTOL``, and the control
    (``SERVE_CONTROL``) beyond it."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    for arch in sorted(REGISTRY):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(REGISTRY[arch].reduced, dtype=torch.float32)
        host, _ = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        params = {k: v.cuda() for k, v in host.items()}
        rng = np.random.default_rng(0)
        cpu_batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32))}
        if cfg.has_memory_input:
            cpu_batch["memory"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.memory_tokens or 16, cfg.memory_dim or cfg.d_model)
            ).astype(np.float32))
        batch = {k: v.cuda() for k, v in cpu_batch.items()}
        engine = ServingEngine(cfg, params, max_batch=2,
                               max_len=16 + SERVE_STEPS, device="cuda")
        logits, graphed, eager, fed, _, _ = graphed_and_eager(
            engine, params, cfg, batch)
        card = [logits] + [lg for lg, _ in graphed]
        cpu = teacher_forced(host, cfg, cpu_batch, engine.max_len,
                             [t.cpu() for t in fed])
        controls = {}
        for delta in ((SERVE_CONTROL,) if gate else SERVE_CONTROLS):
            ctl = teacher_forced(with_final_norm(params, delta), cfg, batch,
                                 engine.max_len, fed)
            controls[delta] = max(rel_err(a, b.cuda())
                                  for a, b in zip(ctl, cpu))
        line = {"arch": arch, "captures": engine.capture_count,
                "graphed_bitwise_eager": same_steps(graphed, eager),
                "finite": all(bool(torch.isfinite(t).all()) for t in card),
                "card_vs_cpu": max(rel_err(a, b.cuda())
                                   for a, b in zip(card, cpu)),
                "control_vs_cpu": controls, "rtol": SERVE_CPU_RTOL,
                "tokens": [t[:, 0].tolist() for t in fed],
                "wall_s": time.perf_counter() - t0}
        print("serve reduced " + json.dumps(line))
        checks = {"one capture": line["captures"] == 1,
                  "graphed bitwise eager": line["graphed_bitwise_eager"],
                  "finite logits": line["finite"],
                  "card vs CPU": line["card_vs_cpu"] <= SERVE_CPU_RTOL,
                  "control breaks the limit":
                      controls[SERVE_CONTROL] > SERVE_CPU_RTOL}
        failed = [k for k, ok in checks.items() if not ok]
        if gate:
            require(not failed, f"serve reduced {arch}: {failed}")
        elif failed:
            print(f"serve reduced {arch}: NOT MET {failed}")


def kv_bytes_read(cfg, batch, position):
    """Bytes of K and V a decode step at ``position`` must read: the
    filled slots of every attention layer's cache (a window's ring buffer
    holds at most its size)."""
    elt = torch.empty((), dtype=cfg.dtype).element_size()
    total = 0
    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            slots = min(spec.window, position) if spec.window else position
            total += 2 * batch * slots * cfg.num_kv_heads * cfg.head_dim * elt
    return total


def caches_hold_last_positions(cfg, state):
    """Every attention cache of ``state`` holds exactly the positions it
    should at ``state.position``: all of them up to it, or a window's
    ring buffer the last ``size`` (wrapped at ``p % size``)."""
    n = int(state.position)
    for spec, cache in zip(cfg.pattern, state.caches):
        if spec.mixer != "attn":
            continue
        pos = cache["pos"]                      # [num_periods, size]
        size = pos.shape[1]
        first = max(n - size, 0)
        want = torch.full((size,), -1, dtype=torch.int32, device=pos.device)
        kept = torch.arange(first, n, dtype=torch.int32, device=pos.device)
        want[(kept % size).long() if spec.window else kept.long()] = kept
        if not bool((pos == want).all()):
            return False
    return True


def serve_full(arch, gate, cfg=None, spec=None):
    """(b) / (c) ``arch`` at its published widths and depth (``cfg``, for a
    rehearsal, and ``spec`` override ``REGISTRY[arch].model`` and
    ``SERVE_FULL[arch]``): random weights from a seed, a ``ServingEngine``
    over 8 prompts of one bucket, 64 new tokens each. Flight 1 captures
    the decode graph; flight 2 (the same signature, one request given as
    EOS the flight-1 token whose first appearance came latest) captures
    nothing, stops that request there, repeats every other completion
    and makes one synchronizing
    call per decode step plus the first token's read; flight 3 is
    profiled (busy share over flight 4's wall). Then on the flight's
    batch: prefill timed, ``SERVE_STEPS`` graphed decode steps bitwise
    eager, prefill's and the eager steps' logits against ``forward`` over
    the prompt and the same tokens (``SERVE_FULL_RTOL``; the control
    ``SERVE_FULL_CONTROL`` must break it), and one replayed step timed
    between CUDA events against its bound (weight bytes plus the KV bytes
    read, at ``HBM_BYTES_PER_S``)."""
    import gc

    from repro_torch.benchmarks.bench_round_overhead import syncs_in_dispatch
    from repro_torch.configs import REGISTRY
    from repro_torch.models import forward, init_params, prefill
    from repro_torch.models.transformer import _unembed
    from repro_torch.serving import Request, ServingEngine

    cfg = cfg or REGISTRY[arch].model
    spec = spec or SERVE_FULL[arch]
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, _ = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    rng = np.random.default_rng(1)
    lo, hi = spec["prompt"]
    b, gen = spec["max_batch"], spec["gen"]
    lens = [hi] + rng.integers(lo, hi + 1, b - 1).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    engine = ServingEngine(cfg, params, max_batch=b, bucket=spec["bucket"],
                           max_len=spec["max_len"], device="cuda")

    def submit(eos_uid=-1, eos=-1):
        reqs = [Request(uid=i, tokens=p, max_new_tokens=gen,
                        eos_id=eos if i == eos_uid else -1)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        return reqs

    line = {"arch": arch, "params_b": sum(t.numel() for t in
                                          params.values()) / 1e9,
            "weight_gb": weight_bytes / 1e9, "batch": b,
            "prompt_lens": lens, "gen": gen, "max_len": engine.max_len}
    parts = {"setup": time.perf_counter() - t0}
    t_part = time.perf_counter()
    reqs = submit()
    t1 = time.perf_counter()
    first = engine.run_until_drained()
    line["flight1_s"] = time.perf_counter() - t1
    captures = engine.capture_count
    # the EOS: the token whose first appearance in one completion comes
    # latest (random weights repeat a few tokens)
    stop, eos_uid, eos = max(
        (i + 1, uid, t) for uid, c in first.items()
        for i, t in enumerate(c.tokens[:gen - 1]) if c.tokens.index(t) == i)
    submit(eos_uid, eos)
    steps0 = engine.decode_steps
    second, syncs = syncs_in_dispatch(engine.run_until_drained)
    steps = engine.decode_steps - steps0
    line.update({"captures_flight1": captures,
                 "captures_flight2": engine.capture_count - captures,
                 "eos_uid": eos_uid, "eos_stop": stop,
                 "decode_steps_flight2": steps,
                 "syncs_flight2": len(syncs), "sync_sites": syncs[:3]})
    same_rest = all(second[i].tokens == first[i].tokens[
        :stop if i == eos_uid else gen] for i in range(b))
    parts["flights_1_2"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    submit()
    busy, kernels = device_busy_ms(engine.run_until_drained)
    parts["flight_3_profiled"] = time.perf_counter() - t_part
    submit()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine.run_until_drained()
    wall = (time.perf_counter() - t1) * 1e3
    line.update({"flight_ms": wall, "busy_ms": busy,
                 "busy_share": busy / wall,
                 "top_kernels_ms_per_flight": top_kernels(kernels, 1, n=6,
                                                          width=80)})
    del kernels

    t_part = time.perf_counter()
    batch = engine.flight_batch(reqs)
    plen = batch["tokens"].shape[1]
    prefill_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            out = prefill(params, batch, cfg, engine.max_len)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t1) * 1e3)
        del out
    # the rate counts the prompt tokens sent, not the bucket's left padding
    sent = sum(lens)
    line.update({"prompt_tokens": sent, "padded_tokens": b * plen,
                 "prefill_ms": prefill_ms,
                 "prefill_tok_s": sent / (min(prefill_ms) / 1e3)})
    logits, graphed, eager, fed, dec, state = graphed_and_eager(
        engine, params, cfg, batch)
    line["graphed_bitwise_eager"] = same_steps(graphed, eager)
    line["caches_hold_last_positions"] = caches_hold_last_positions(
        cfg, state)
    del state
    step_ms = replay_ms(dec.step, reps=20)
    step_busy, kernels = device_busy_ms(lambda: [dec.step()
                                                 for _ in range(4)])
    line.update({"step_busy_ms": step_busy / 4,
                 "step_top_kernels_ms": top_kernels(kernels, 4, n=8,
                                                    width=80)})
    del kernels
    position = plen + SERVE_STEPS + 1
    kv = kv_bytes_read(cfg, b, position)
    line.update({"decode_ms_per_step": step_ms,
                 "decode_tok_s": b / (step_ms / 1e3),
                 "kv_gb_read": kv / 1e9,
                 "bound_ms": (weight_bytes + kv) / HBM_BYTES_PER_S * 1e3})
    line["bound_share"] = line["bound_ms"] / step_ms
    parts["flight_4_prefill_steps"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    got = [logits] + [lg for lg, _ in eager]
    del graphed, dec
    with torch.no_grad():
        h, _ = forward(params, torch.cat([batch["tokens"]] + fed, 1), cfg)
        ref = [_unembed(params, h[:, plen - 1 + k], cfg)
               for k in range(SERVE_STEPS + 1)]
        del h
    controls = {}
    for delta in ((SERVE_FULL_CONTROL,) if gate else SERVE_FULL_CONTROLS):
        ctl = teacher_forced(with_final_norm(params, delta), cfg, batch,
                             engine.max_len, fed)
        controls[delta] = max(rel_err(a, r) for a, r in zip(ctl, ref))
        del ctl
    parts["forward_control"] = time.perf_counter() - t_part
    line.update({
        "vs_forward": [rel_err(a, r) for a, r in zip(got, ref)],
        "control_vs_forward": controls, "rtol": SERVE_FULL_RTOL,
        "finite": all(bool(torch.isfinite(t).all()) for t in got),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "wall_s": time.perf_counter() - t0, "parts_s": parts})
    print(f"serve full {arch} " + json.dumps(line))
    checks = {
        "one capture in flight 1": captures == 1,
        "no capture in flight 2": line["captures_flight2"] == 0,
        "EOS stops its request early":
            len(second[eos_uid].tokens) == stop < gen,
        "flight 2 repeats flight 1": same_rest,
        "one sync per decode step and the first token's":
            line["syncs_flight2"] == steps + 1,
        "graphed bitwise eager": line["graphed_bitwise_eager"],
        "caches hold the last positions":
            line["caches_hold_last_positions"],
        "finite logits": line["finite"],
        "prefill and decode vs forward":
            max(line["vs_forward"]) <= SERVE_FULL_RTOL,
        "control breaks the limit":
            controls[SERVE_FULL_CONTROL] > SERVE_FULL_RTOL}
    failed = [k for k, ok in checks.items() if not ok]
    if gate:
        require(not failed, f"serve full {arch}: {failed}")
    elif failed:
        print(f"serve full {arch}: NOT MET {failed}")
    del params, engine, ref, got, eager, logits
    gc.collect()
    torch.cuda.empty_cache()


def serve_cli_runs(cfg=None):
    """(d) The serve CLI's body (``launch.serve.run``) on the card with
    Qwen3-1.7B at its published widths, its depth cut to
    ``LM_FULL_LAYERS`` (``cfg`` overrides it, for a rehearsal; (b) already
    serves the full depth), 8 prompts of 1024, 16 tokens, and the serving
    example (``examples.serve_decode``) on the reduced Gemma3: one
    capture each, finite logits, every token in the vocabulary."""
    import gc

    from repro_torch.configs import REGISTRY
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve

    cfg = cfg or dataclasses.replace(REGISTRY["qwen3-1.7b"].model,
                                     num_layers=LM_FULL_LAYERS)
    for label, vocab, call in (
            ("serve.run " + cfg.name, cfg.vocab_size, lambda: serve.run(
                serve.parse_args(["--arch", "qwen3-1.7b", "--batch", "8",
                                  "--prompt-len", "1024", "--gen", "16",
                                  "--device", "cuda"]), cfg)),
            ("serve_decode gemma3-4b", REGISTRY["gemma3-4b"].reduced
             .vocab_size, lambda: serve_decode.main(["--device", "cuda"]))):
        rec = call()
        toks = rec["tokens"]
        line = {"run": label, "tokens_shape": list(toks.shape),
                "captures": rec["capture_count"],
                "prefill_s": rec["prefill_s"], "capture_s": rec["capture_s"],
                "decode_s": rec["decode_s"]}
        print("serve cli " + json.dumps(line))
        require(rec["capture_count"] == 1
                and bool(torch.isfinite(rec["logits"].float()).all())
                and int(toks.min()) >= 0 and int(toks.max()) < vocab,
                f"serve cli {label}: {line}")
        del rec
        gc.collect()
        torch.cuda.empty_cache()


def run_serve_phase(gate=True):
    """Phase 12, serving (``repro_torch.serving``): (a)
    ``serve_reduced_runs``, (b) ``serve_full`` on Qwen3-1.7B, (c) on
    Gemma3-4B, (d) ``serve_cli_runs``. ``gate=False`` (``--only
    serve_calibrate``) prints the readings and the controls and holds none
    of the limits."""
    parts = [("reduced", lambda: serve_reduced_runs(gate))] + [
        (arch, lambda arch=arch: serve_full(arch, gate))
        for arch in SERVE_FULL] + [("cli", serve_cli_runs)]
    times = {}
    for name, part in parts:
        t0 = time.perf_counter()
        if gate:
            part()
        else:       # calibration: every part, whatever failed before
            import traceback
            try:
                part()
            except Exception:
                traceback.print_exc(file=sys.stdout)
        times[name] = round(time.perf_counter() - t0, 1)
    print("serve phase seconds " + json.dumps(times))


SPARSE_NODES = 8
SPARSE_TAUS = (4, 4)
SPARSE_BATCH = 16
SPARSE_LR = 0.05
SPARSE_RUNS = (("dfl", "", {}), ("cdfl_topk", "top_k", {"frac": 0.67}),
               ("cdfl_qsgd", "qsgd", {"levels": 16}))
SPARSE_TOPOS = ("ring", "full")
SPARSE_TIMEOUT_S = 300.0
# the sparse engine's 3 CIFAR rounds against the dense port's on the card,
# relative, per round: the limits sit between the largest sound reading
# and a control run with K1-received's output shifted by 1e-3 on every
# rank (``--only sparse_calibrate``, PERF.md §6): sound loss 9.1e-3 (ring,
# plain: the local steps' convolutions round differently at one node
# than grouped over 8; the dense port with per-node convolutions reads
# the same gap, and the sparse run's parameters are bitwise its),
# consensus 0.51 (fully_connected(8), TopK, whose consensus is 6e-4 and
# moves with every flipped selection); controls
# loss 0.25 (QSGD) to 1.2e3 (plain), consensus 0.035 (QSGD) to 7.2e6. The
# loss limit is the one the controls break; the consensus limit only
# catches a run that drifts by more than its own size.
SPARSE_RUN_RTOL = {"loss": 5e-2, "consensus_sq": 1.0}
SPARSE_CONTROL = ("gossip_mix_received_many", "x_shift", 1e-3)
SPARSE_ULPS = 8.0           # K2's y_new contract (test_torch_choco_fused)


def sparse_topology(name):
    from repro_torch.core.topology import fully_connected, ring
    return (ring if name == "ring" else fully_connected)(SPARSE_NODES)


def sparse_inputs():
    """The CIFAR CNN's initial weights (CPU, seed 1) and 3 rounds of
    batches ``[tau1, 8, 16, 32, 32, 3]`` (numpy), made alike in every
    process."""
    from repro_torch.data.images import SyntheticImages, image_batches_for_dfl
    from repro_torch.models.cnn import init_cnn

    data = SyntheticImages(flavor="cifar", train_size=2000, test_size=8,
                           seed=3)
    parts = data.partition(SPARSE_NODES, seed=0)
    p0 = init_cnn(torch.Generator().manual_seed(1), "cifar", "cpu")
    return p0, [image_batches_for_dfl(data, parts, SPARSE_TAUS[0],
                                      SPARSE_BATCH, r)
                for r in range(RUN_ROUNDS)]


def sparse_cfg(topo, compression, kw):
    """The run's config: TopK at gamma 0.6, QSGD at ``QSGD_GAMMA`` (at 0.6
    its CIFAR rounds diverge, on both engines, within 3 rounds: the
    consensus distance reaches 1e3, and a comparison of diverging runs
    reads their chaos)."""
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.dfl import DFLConfig
    comp = make_compressor(compression, **kw) if compression else None
    gamma = (QSGD_GAMMA if compression == "qsgd" else 0.6) if comp else 1.0
    return DFLConfig(tau1=SPARSE_TAUS[0], tau2=SPARSE_TAUS[1],
                     topology=sparse_topology(topo), compression=comp,
                     gamma=gamma)


def sparse_state(p0, cfg, rows):
    """The run's start on the card: ``rows`` copies of the weights, the
    seam the dense engine's (GeneratorDraws, seed 0, all 8 nodes)."""
    from repro_torch.core.dfl import init_state, replicate
    from repro_torch.core.rng import GeneratorDraws
    from repro_torch.optim import sgd
    params = {k: v.cuda() for k, v in replicate(p0, rows).items()}
    return init_state(params, rows, sgd(SPARSE_LR), stacked=True,
                      compressed=cfg.is_compressed,
                      draws=GeneratorDraws(0, SPARSE_NODES, p0, "cuda"))


def sparse_step_state(p0):
    """A per-node state for one gossip step: x and y the weights with
    node-wise noise, [8, ...] on the CPU."""
    gen = torch.Generator().manual_seed(7)
    x = {k: v + 0.01 * torch.randn((SPARSE_NODES,) + v.shape, generator=gen)
         for k, v in p0.items()}
    y = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
         for k, v in x.items()}
    return x, y


def sparse_one_step(sub, x, y, draws):
    """One plain gossip step of x, and one TopK and one QSGD CHOCO step
    from (x, y), on the substrate ``sub``."""
    from repro_torch.core.compression import make_compressor
    out = {"plain": (sub.mix(x),)}
    for label, compression, kw in SPARSE_RUNS[1:]:
        out[label] = sub.choco_step(make_compressor(compression, **kw), x,
                                    y, sub.mix(y), 0.6, draws, 0, 0)
    return out


def sparse_rounds(cfg, state, batches, round_fn, sync_group=None):
    """3 rounds; per round the metrics, the host ms (synchronised) and the
    share of it in the exchanges (``NodeGroup.exchange_s``)."""
    rows = []
    for b in batches:
        torch.cuda.synchronize()
        ex0 = sync_group.exchange_s if sync_group is not None else 0.0
        t0 = time.perf_counter()
        state, m = round_fn(state, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ex = (sync_group.exchange_s - ex0) if sync_group is not None else 0.0
        rows.append({"loss": float(m["loss"]),
                     "consensus_sq": float(m["consensus_sq"]),
                     "ms": dt * 1e3, "exchange_share": ex / dt})
    return state, rows


def sparse_rank(group, out_dir, control, cli_argv):
    """One rank of phase ``sparse`` (b, c): one gossip step from a given
    state, the 3-round runs (each with its launch counts, set to 0 just
    before it), the control runs, and the executor with a re-plan and
    masks; writes ``rank<r>.pt``. Then (d), ``sparse_cli_rank`` with
    ``cli_argv`` on the same ranks."""
    from repro_torch.core.dfl import make_round_fn
    from repro_torch.core.executor import RoundExecutor
    from repro_torch.core.rng import GeneratorDraws
    from repro_torch.core.sharded import local_rows
    from repro_torch.core.substrate import ShardedSubstrate
    from repro_torch.device import deterministic_algorithms
    from repro_torch.kernels import ops
    from repro_torch.optim import sgd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p0, rounds = sparse_inputs()
    res = {"steps": {}, "runs": {}, "controls": {}, "backend": group.backend}
    mine = lambda t: local_rows(t, group)  # noqa: E731
    with deterministic_algorithms(True):
        x, y = sparse_step_state(p0)
        draws = GeneratorDraws(0, SPARSE_NODES, p0, "cuda")
        for topo in SPARSE_TOPOS:
            sub = ShardedSubstrate(sparse_topology(topo), group)
            out = sparse_one_step(sub, {k: v.cuda() for k, v in
                                        mine(x).items()},
                                  {k: v.cuda() for k, v in mine(y).items()},
                                  draws)
            res["steps"][topo] = {k: [{n: t.cpu() for n, t in tree.items()}
                                      for tree in v]
                                  for k, v in out.items()}
        batches = [tuple(torch.from_numpy(a[:, group.rank:group.rank + 1])
                         .cuda() for a in b) for b in rounds]
        runs = [(topo, label, c, kw, None) for topo in SPARSE_TOPOS
                for label, c, kw in SPARSE_RUNS]
        runs += [("ring", label, c, kw, control)
                 for label, c, kw in SPARSE_RUNS]
        for topo, label, compression, kw, ctl in runs:
            cfg = sparse_cfg(topo, compression, kw)
            round_fn = make_round_fn(cfg, _cnn_loss, sgd(SPARSE_LR),
                                     engine="sparse", group=group)
            state = sparse_state(p0, cfg, 1)
            ops.reset_launches()
            with (perturbed(*ctl) if ctl else contextlib.nullcontext()):
                state, rows = sparse_rounds(cfg, state, batches, round_fn,
                                            group)
            torch.cuda.synchronize()
            rec = {"rows": rows, "launches": dict(ops.LAUNCHES),
                   "params": {k: v.cpu() for k, v in state.params.items()}}
            (res["controls"] if ctl else res["runs"])[(topo, label)] = rec
        # the executor: plain DFL with participation masks, warmed, then a
        # trajectory and a re-plan with other taus and masks
        cfg = sparse_cfg("ring", "", {})
        ex = RoundExecutor(cfg, _cnn_loss, sgd(SPARSE_LR), engine="sparse",
                           group=group, participation=True)
        state = sparse_state(p0, cfg, 1)
        stacked = tuple(torch.stack([b[i] for b in batches[:2]])
                        for i in (0, 1))
        ex.warmup(state, stacked)
        builds = ex.compile_count
        e = cfg.topology.num_edges
        traj = []
        for taus, down in (([[4, 4], [2, 1]], (0, 5)), ([[1, 2], [3, 3]],
                                                         (2, 7))):
            rows = np.ones((2, 2 + SPARSE_NODES + e), np.int32)
            rows[:, :2] = taus
            rows[0, 2 + 3] = 0                       # node 3 out
            rows[1, 2 + SPARSE_NODES + np.asarray(down)] = 0
            traj.append(rows)
        ops.reset_launches()
        ms = []
        for rows in traj:
            state, m = ex.dispatch_trajectory(state, stacked, rows)
            ms.append({k: v.cpu() for k, v in m.items()})
        torch.cuda.synchronize()
        res["executor"] = {"builds_after_warmup": ex.compile_count - builds,
                           "captures": ex.capture_count,
                           "launches": dict(ops.LAUNCHES),
                           "gossip_steps": int(sum(r[:, 1].sum()
                                                   for r in traj)),
                           "metrics": ms}
    torch.save(res, os.path.join(out_dir, f"rank{group.rank}.pt"))
    sparse_cli_rank(group, out_dir, cli_argv)


def _cnn_loss(p, b):
    from repro_torch.models.cnn import cnn_loss
    return cnn_loss(p, b, "cifar")


def sparse_cli_rank(group, out_dir, argv):
    """One rank of phase ``sparse`` (d): the train CLI's body with
    ``--engine sparse``."""
    from repro_torch.launch import train

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    got = train.run(train.parse_args(argv), group=group, log=lambda _m: None)
    torch.save({"rows": [{k: row[k] for k in ("loss", "consensus_sq")}
                         for row in got["rows"]], "engine": got["engine"],
                "builds_after_warmup": got["builds_after_warmup"]},
               os.path.join(out_dir, f"cli{group.rank}.pt"))


RECV_EDGES = (1023, 1024, 1025, 2047, 2048, 2049, 4097, 8191, 8192, 8193,
              16385)      # leaves at the received form's chunk edges


def received_kernel_checks(K, gen):
    """(a) K1-received on the card, bitwise its plain version and the dense
    K1 at the same weights (over [x; recv] with node 0 reading rows 1..deg)
    at one CIFAR node's 10 leaves plus the parity sizes, and at leaves on
    the chunk edges (``RECV_EDGES``, whose own call takes the smallest
    chunk), deg 1-9 (1-8 with deg fixed at compile time, 9 the run-time
    loop), f32 and bf16, the received rows at the packed exchange's strides
    (16-byte aligned: the vector path) and at an odd stride (the scalar
    path)."""
    from repro_torch.kernels import gossip_mix, ops
    from repro_torch.models.cnn import init_cnn

    cifar = [v.numel() for v in init_cnn(torch.Generator().manual_seed(1),
                                         "cifar", "cpu").values()]
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for deg in range(1, 10):
            for sizes in (cifar + list(PARITY_SIZES), list(RECV_EDGES)):
                for aligned in (True, False):
                    xs, recvs, w = received_operands(sizes, deg, dtype, gen,
                                                     aligned)
                    got = ops.gossip_mix_received_many(xs, recvs, w)
                    nbr = torch.arange(1, deg + 1, dtype=torch.int32,
                                       device="cuda")[None].repeat(deg + 1, 1)
                    wt = w[None].repeat(deg + 1, 1).contiguous()
                    for x, r, g in zip(xs, recvs, got):
                        what = (f"K1-received {dtype} deg {deg} D {x.numel()}"
                                f" aligned {aligned}")
                        want = gossip_mix.plain_received(x, r, w)
                        require(same_bits(g, want),
                                f"{what}: differs from its plain version")
                        dense = ops.gossip_mix(torch.cat([x[None], r]), nbr,
                                               wt)[0]
                        require(same_bits(g, dense),
                                f"{what}: differs from the dense K1")
                        K["gossip_mix_received"].max_abs_err = max(
                            K["gossip_mix_received"].max_abs_err,
                            max_abs_err(g, want))
                    cases += len(xs)
    torch.cuda.synchronize()
    print(f"K1-received: bitwise its plain version and the dense K1 over "
          f"{cases} leaves: deg 1-9 x (f32, bf16) x (aligned, odd stride)")


def received_operands(sizes, deg, dtype, gen, aligned=True):
    """Leaves ``[D]`` and their ``[deg, D]`` received rows, views of one
    packed buffer as the exchange returns them (16-byte aligned leaves;
    with ``aligned`` False, packed at an odd row stride, which no leaf can
    read 16 bytes at a time), and normalised weights [deg + 1] on the
    card."""
    item = torch.tensor([], dtype=dtype).element_size()
    offsets, total = [], 0
    for d in sizes:
        offsets.append(total)
        total += -(-d * item // 16) * 16 // item if aligned else d
    total += 0 if aligned or total % 2 else 1
    buf = torch.randn(deg, total, generator=gen, device="cuda").to(dtype)
    xs = [torch.randn(d, generator=gen, device="cuda").to(dtype)
          for d in sizes]
    recvs = [buf[:, at:at + d] for at, d in zip(offsets, sizes)]
    w = torch.rand(deg + 1, generator=gen, device="cuda") + 0.1
    return xs, recvs, (w / w.sum()).contiguous()


def received_times(sizes, deg, dtype, gen, big=False):
    """K1-received over leaves of ``sizes`` in one call: device ms, the
    plain version's, one ``torch.addmm`` a leaf (w0 x + w[1:] @ recv, the
    same function), and the bound (deg + 2) D bytes at the memory rate.
    A node that fits in L2 is timed with its operands read from DRAM
    (``cold_device_ms``, as the bound assumes; ``warm_ms`` the kernel's
    reading with them warm in L2); a ``big`` one, far larger than L2,
    reads from DRAM in any case."""
    from repro_torch.kernels import gossip_mix, ops

    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (deg + 2) * sum(sizes) * item
    out = {"elements": sum(sizes), "deg": deg,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    def calls(xs, recvs, w):
        w0, wr = float(w[0]), w[1:][None].to(dtype)
        return {"ms": lambda: ops.gossip_mix_received_many(xs, recvs, w),
                "plain_ms": lambda: [gossip_mix.plain_received(x, r, w)
                                     for x, r in zip(xs, recvs)],
                "library_ms": lambda: [torch.addmm(x[None], wr, r, beta=w0)
                                       for x, r in zip(xs, recvs)]}

    if not big:
        for key in ("ms", "plain_ms", "library_ms"):
            out[key] = cold_device_ms(lambda: calls(*received_operands(
                sizes, deg, dtype, gen))[key], nbytes)
        out["warm_ms"] = device_ms(calls(*received_operands(
            sizes, deg, dtype, gen))["ms"])
        return out
    fns = calls(*received_operands(sizes, deg, dtype, gen))
    require(all(same_bits(g, p) for g, p in zip(fns["ms"](),
                                                fns["plain_ms"]())),
            f"K1-received differs from its plain version at {dtype} "
            f"deg {deg} over {sum(sizes)} elements")
    out.update(ms=device_ms(fns["ms"], iters=2, reps=3),
               plain_ms=event_ms(fns["plain_ms"]),
               library_ms=event_ms(fns["library_ms"]))
    return out


def received_kernel_phase(K):
    """Phase 14 (a) (alone: ``--only sparse_kernels``): K1-received checked
    (``received_kernel_checks``) and timed on one CIFAR node at deg 2 and
    7 (operands read from DRAM) and one node of the full-width Qwen3 tree
    at deg 2; the CIFAR deg 2 reading is the kernel's record."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import init_params
    from repro_torch.models.cnn import init_cnn

    gen = torch.Generator(device="cuda").manual_seed(11)
    received_kernel_checks(K, gen)
    cifar = [v.numel() for v in init_cnn(torch.Generator().manual_seed(1),
                                         "cifar", "cpu").values()]
    times = {"cifar_deg2": received_times(cifar, 2, torch.float32, gen),
             "cifar_deg7": received_times(cifar, 7, torch.float32, gen)}
    lm = dataclasses.replace(REGISTRY[LM_FULL_ARCH].model,
                             num_layers=LM_FULL_LAYERS)
    lm_sizes = [int(np.prod(v.shape)) for v in init_params(
        lm, None, "cpu", abstract=True)[0].values()]
    times["lm_deg2"] = received_times(lm_sizes, 2, torch.bfloat16, gen,
                                      big=True)
    torch.cuda.empty_cache()
    for name, t in times.items():
        print(f"K1-received {name} " + json.dumps(t))
    rec = K["gossip_mix_received"]
    main = times["cifar_deg2"]
    rec.ms, rec.plain_ms, rec.library_ms = (main["ms"], main["plain_ms"],
                                            main["library_ms"])
    rec.bytes_s = rec.ops_s = 0.0
    rec.add_bound(main["bound_ms"] * 1e-3 * HBM_BYTES_PER_S,
                  (2 * main["deg"] + 1) * main["elements"])


def run_sparse_phase(K, gate=True):
    """Phase 14, the sparse engine (``core.sharded``), one node per process:
    (a) K1-received bitwise and timed; (b) 8 gloo ranks on the one card
    (``sparse_rank``): the CIFAR CNN at full width on ring(8) and
    fully_connected(8), tau (4, 4), batch 16: one gossip step from a given
    state bitwise the dense port on the card (plain, TopK; QSGD ``x_new``
    bitwise and ``y_new`` within K2's 8 ulps), 3 rounds of plain, TopK and
    QSGD held to the dense port's within ``SPARSE_RUN_RTOL``, which a
    control with K1-received shifted must break, plain and TopK bitwise
    the dense port with per-node convolutions, exact launches on every
    rank, ms a round and the exchange's share; (c) the executor on the
    sparse engine, a trajectory and a re-plan with masks after the warmup:
    no build, no capture, one K1-received launch a gossip step; (d) the
    train CLI with ``--engine sparse`` on the reduced Qwen3, on the same 8
    ranks after (b, c), against the dense CLI on the card within
    ``LM_CPU_RTOL``. ``gate=False``
    (``--only sparse_calibrate``) prints (b)'s readings and controls and
    holds none of the run limits."""
    import functools
    import tempfile
    from unittest import mock

    from repro_torch.core import dfl
    from repro_torch.core.dfl import make_round_fn
    from repro_torch.core.rng import GeneratorDraws
    from repro_torch.core.sharded import spawn
    from repro_torch.core.substrate import DenseSubstrate
    from repro_torch.device import deterministic_algorithms
    from repro_torch.launch import train
    from repro_torch.optim import sgd

    t0 = time.perf_counter()
    received_kernel_phase(K)
    print(f"sparse (a) {time.perf_counter() - t0:.1f} s")

    # (b, c), then (d): 8 ranks on the card
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="sparse_phase_")
    argv = lm_argv("qwen3-1.7b", "top_k", "cuda", nodes=SPARSE_NODES)
    spawn(sparse_rank, SPARSE_NODES,
          (out, SPARSE_CONTROL, argv + ["--engine", "sparse"]),
          device="cuda", timeout_s=SPARSE_TIMEOUT_S)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                        weights_only=False) for r in range(SPARSE_NODES)]
    print(f"sparse (b, c) ranks {time.perf_counter() - t0:.1f} s, backend "
          f"{ranks[0]['backend']}")
    p0, rounds = sparse_inputs()
    x, y = sparse_step_state(p0)
    stack = lambda get: {k: torch.cat([get(r)[k] for r in ranks])  # noqa
                         for k in get(ranks[0])}
    with deterministic_algorithms(True):
        for topo in SPARSE_TOPOS:
            want = sparse_one_step(
                DenseSubstrate(sparse_topology(topo)),
                {k: v.cuda() for k, v in x.items()},
                {k: v.cuda() for k, v in y.items()},
                GeneratorDraws(0, SPARSE_NODES, p0, "cuda"))
            for label, trees in want.items():
                for i, tree in enumerate(trees):
                    got = stack(lambda r: r["steps"][topo][label][i])
                    for k, v in tree.items():
                        g, w = got[k], v.cpu()
                        if label == "cdfl_qsgd" and i == 1:
                            ulps = y_new_ulps(g, w, y[k])
                            print(f"sparse (b) {topo} QSGD step y_new {k}: "
                                  f"{ulps} ulps (K2's contract "
                                  f"{SPARSE_ULPS})")
                            require(not gate or ulps <= SPARSE_ULPS,
                                    f"{topo} {label} y_new {k}: {ulps} ulps")
                        else:
                            require(same_bits(g, w), f"{topo} {label} step "
                                    f"output {i} leaf {k}: not bitwise the "
                                    "dense port")
        print("sparse (b) one gossip step bitwise the dense port on the card "
              "(plain, TopK; QSGD x_new, y_new within 8 ulps), ring(8) and "
              "fully_connected(8)")
        batches = [tuple(torch.from_numpy(a).cuda() for a in b)
                   for b in rounds]
        sizes = [v.numel() for v in p0.values()]
        total, readings, controls = 0, {}, {}
        for topo in SPARSE_TOPOS:
            for label, compression, kw in SPARSE_RUNS:
                cfg = sparse_cfg(topo, compression, kw)
                _, dense = sparse_rounds(cfg, sparse_state(p0, cfg,
                                                           SPARSE_NODES),
                                         batches, make_round_fn(
                                             cfg, _cnn_loss,
                                             sgd(SPARSE_LR)))
                # the witness: the dense port with per-node convolutions
                # (its vmap in chunks of one node, each a rank's own call)
                with mock.patch.object(dfl, "vmap", functools.partial(
                        torch.func.vmap, chunk_size=1)):
                    wstate, witness = sparse_rounds(
                        cfg, sparse_state(p0, cfg, SPARSE_NODES), batches,
                        make_round_fn(cfg, _cnn_loss, sgd(SPARSE_LR)))
                params = stack(lambda r: r["runs"][(topo, label)]["params"])
                bitwise = all(same_bits(params[k], v.cpu())
                              for k, v in wstate.params.items())
                print(f"sparse (b) {topo} {label} witness, rel diffs a "
                      "round: sparse vs dense " + json.dumps(round_diffs(
                          ranks[0]["runs"][(topo, label)]["rows"], dense))
                      + ", dense vs dense with per-node convolutions "
                      + json.dumps(round_diffs(dense, witness))
                      + ", sparse vs it " + json.dumps(round_diffs(
                          ranks[0]["runs"][(topo, label)]["rows"], witness))
                      + "; final parameters bitwise it: "
                      + json.dumps(bitwise) + ", max abs diff " + json.dumps(
                          max(max_abs_err(params[k], v.cpu())
                              for k, v in wstate.params.items())))
                # QSGD's row norm at [1, D] may differ in the last bit
                require(not gate or bitwise or compression == "qsgd",
                        f"{topo} {label}: the sparse run's parameters are "
                        "not bitwise the dense port's with per-node "
                        "convolutions")
                per = step_launches(compression, sizes)
                per["gossip_mix_received"] = per.pop("gossip_mix")
                expect = expect_launches(K, **{
                    k: v * SPARSE_TAUS[1] * RUN_ROUNDS
                    for k, v in per.items()})
                for r in ranks:
                    got = r["runs"][(topo, label)]["launches"]
                    require(got == expect, f"{topo} {label}: launches {got},"
                            f" expected {expect}")
                    total += got["gossip_mix_received"]
                diffs = sparse_diffs(ranks, "runs", (topo, label), dense)
                for k, v in diffs.items():
                    readings[k] = max(readings.get(k, 0.0), v)
                ms = [r["runs"][(topo, label)]["rows"] for r in ranks]
                print(f"sparse (b) {topo} {label}: dense "
                      + json.dumps([{k: d[k] for k in ("loss",
                                                       "consensus_sq")}
                                    for d in dense])
                      + " sparse " + json.dumps(
                          [{k: row[k] for k in ("loss", "consensus_sq")}
                           for row in ms[0]])
                      + " rel diffs " + json.dumps(diffs)
                      + " ms a round (rank max, per round) " + json.dumps(
                          [max(m[i]["ms"] for m in ms)
                           for i in range(RUN_ROUNDS)])
                      + " exchange share (rank mean) " + json.dumps(
                          [float(np.mean([m[i]["exchange_share"]
                                          for m in ms]))
                           for i in range(RUN_ROUNDS)])
                      + " dense ms " + json.dumps([d["ms"] for d in dense])
                      + " launches a rank " + json.dumps(
                          ranks[0]["runs"][(topo, label)]["launches"]))
                if gate:
                    for key, lim in SPARSE_RUN_RTOL.items():
                        require(diffs[key] <= lim, f"{topo} {label}: {key} "
                                f"rel diff {diffs[key]} beyond {lim}")
                if topo == "ring":
                    ctl = sparse_diffs(ranks, "controls", (topo, label),
                                       dense)
                    print(f"sparse (b) control {SPARSE_CONTROL} {label}: "
                          f"rel diffs " + json.dumps(ctl))
                    for k, v in ctl.items():
                        controls[k] = min(controls.get(k, math.inf), v)
                    if gate:
                        require(any(ctl[k] > lim for k, lim in
                                    SPARSE_RUN_RTOL.items()),
                                f"control {label} within the limits {ctl}")
        K["gossip_mix_received"].launches = total
        print("sparse (b) largest readings " + json.dumps(readings)
              + " smallest control " + json.dumps(controls))
        ex = [r["executor"] for r in ranks]
        steps = ex[0]["gossip_steps"]
        for r in ex:
            require(r["builds_after_warmup"] == 0 and r["captures"] == 0,
                    f"executor: builds {r['builds_after_warmup']} captures "
                    f"{r['captures']} after the warmup")
            require(r["launches"] == expect_launches(
                K, gossip_mix_received=steps), f"executor launches "
                f"{r['launches']}, expected {steps} K1-received")
            require(all(torch.isfinite(v.float()).all() for m in r["metrics"]
                        for v in m.values()), "executor: non-finite metrics")
        print(f"sparse (c) executor: trajectory and re-plan with masks, 0 "
              f"builds and 0 captures after the warmup, {steps} K1-received "
              "launches a rank, metrics " + json.dumps(
                  [{k: v.tolist() for k, v in m.items()}
                   for m in ex[0]["metrics"]]))
    print(f"sparse (b, c) {time.perf_counter() - t0:.1f} s")

    # (d): the CLI the ranks ran after (b, c) against the dense CLI, both
    # on the card
    t0 = time.perf_counter()
    cli = [torch.load(os.path.join(out, f"cli{r}.pt"), weights_only=False)
           for r in range(SPARSE_NODES)]
    dense = train.run(train.parse_args(argv + ["--engine", "dense"]),
                      log=lambda _m: None)
    require(all(c["engine"] == "sparse" and c["builds_after_warmup"] == 0
                for c in cli), "CLI ranks: not the sparse engine, or a "
            "build after the warmup")
    lim = LM_CPU_RTOL["top_k"]
    for c in cli:
        for a, b in zip(c["rows"], dense["rows"]):
            for key, rtol in lim.items():
                require(not gate or abs(a[key] - b[key]) <= rtol * abs(
                    b[key]), f"CLI --engine sparse {key} {a[key]} vs dense "
                        f"{b[key]}, beyond rtol {rtol}")
    print(f"sparse (d) CLI --engine sparse, {SPARSE_NODES} ranks, reduced "
          "Qwen3, TopK: "
          + json.dumps(cli[0]["rows"]) + " dense " + json.dumps(
              [{k: row[k] for k in ("loss", "consensus_sq")}
               for row in dense["rows"]]) + f" (rtol {lim}) "
          f"{time.perf_counter() - t0:.1f} s")


def y_new_ulps(got, want, y):
    """Largest |got - want| of a CHOCO step's ``y_new`` in f32 ulps at the
    larger of |y|, |q| = |want - y| and |y_new|, K2's contract's scale
    (``tests/test_torch_choco_fused.py``)."""
    g, w, y = (t.float().numpy() for t in (got, want, y))
    scale = np.max([np.abs(y), np.abs(w - y), np.abs(w), np.abs(g)], axis=0)
    return float(np.max(np.abs(g - w) / np.spacing(scale.astype(np.float32)),
                        initial=0.0))


def round_diffs(rows, want):
    """Per round, the relative difference of ``rows``' loss and consensus
    from ``want``'s (the consensus relative to at least
    ``FIG_CONSENSUS_FLOOR``)."""
    return {m: [abs(r[m] - w[m]) / max(abs(w[m]), FIG_CONSENSUS_FLOOR
                                      if m == "consensus_sq" else 0.0)
                for r, w in zip(rows, want)]
            for m in ("loss", "consensus_sq")}


def sparse_diffs(ranks, kind, key, dense):
    """Largest ``round_diffs`` per metric, over rounds and ranks, of the
    sparse runs against the dense port's rows (the consensus floor:
    fully_connected(8) averages exactly, its consensus is rounding
    noise)."""
    per = [round_diffs(r[kind][key]["rows"], dense) for r in ranks]
    return {m: max(max(p[m]) for p in per) for m in ("loss", "consensus_sq")}


# ---------------------------------------------------------------------------
# Phase 15: the planner's measured cost inputs, the planned round, the
# launch benches and the LM example
# ---------------------------------------------------------------------------

ROOF_BUDGET_S = 3600.0
ROOF_ROUNDS = 3
TRAIN_LM_ROUNDS = 10
# (e): the LM example's loss must fall from round 1 to round 10 by at least
# this many nats; the limit sits between the sound reading and controls
# with K1's output perturbed on the card (``--only roofline_calibrate``,
# PERF.md §6): sound 0.0155; K1 x 1.01 a step -0.042 (the loss rises),
# x 1.05 -0.628, + 0.01 -0.127. (At 20 rounds, with 0.02: sound 0.0465,
# the controls -0.081, -4.91 and -0.285.)
TRAIN_LM_FALL = 0.005
TRAIN_LM_CONTROL = ("gossip_mix_many", "x_scale", 1e-2)
TRAIN_LM_CONTROLS = (("gossip_mix_many", "x_scale", 1e-2),
                     ("gossip_mix_many", "x_scale", 5e-2),
                     ("gossip_mix_many", "x_shift", 1e-2))


def plan_fields(p):
    """A planner ``Plan``'s knobs and prediction, for comparing two."""
    return {"tau1": p.tau1, "tau2": p.tau2, "eta": p.eta,
            "compressor": p.compressor_name, "rounds": p.rounds,
            "predicted_bound": p.predicted_bound,
            "round_time_s": p.round_cost.time_s,
            "round_wire_bits": p.round_cost.wire_bits}


ROOF_PLAN_SCRIPT = r"""
import dataclasses, json, sys
import torch
from chip_smoke import LM_FULL_ARCH, plan_fields
from repro_torch.configs import REGISTRY
from repro_torch.launch import steps
layers, batch, seq, nodes, budget = map(float, sys.argv[1:])
arch = REGISTRY[LM_FULL_ARCH]
cfg = dataclasses.replace(arch.model, num_layers=int(layers))
p = steps.plan_train_schedule(arch, "train_4k", int(nodes), budget_s=budget,
                              cfg=cfg, batch=int(batch), seq=int(seq),
                              use_roofline=True)
print(json.dumps({"cuda": torch.cuda.is_available(), **plan_fields(p)}))
"""


def cpu_process_plan(cfg, batch, seq):
    """Start the process that computes the measured plan of ``cfg`` seeing
    no card (``CUDA_VISIBLE_DEVICES`` empty): the counts come from ``meta``
    tensors, so it must equal the card's. It runs on the host while (a)
    runs on the card; ``cpu_process_plan_result`` waits for it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join((ROOT, os.path.join(ROOT, "src"))))
    return subprocess.Popen(
        [sys.executable, "-c", ROOF_PLAN_SCRIPT, str(cfg.num_layers),
         str(batch), str(seq), str(LM_NODES), str(ROOF_BUDGET_S)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cpu_process_plan_result(proc):
    """The plan ``cpu_process_plan``'s process printed; the process is
    ended whatever happens."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    require(proc.returncode == 0, f"the CPU process's plan failed: "
            f"{err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    require(got.pop("cuda") is False, "the CPU process saw a card")
    return got


def roofline_inputs(cfg, batch=LM_FULL_BATCH, seq=LM_FULL_SEQ,
                    device="cuda"):
    """(a) ``roofline_cost_inputs`` and the analytic and measured plans of
    ``cfg`` (Qwen3-1.7B at its published widths, depth cut to
    ``LM_FULL_LAYERS``), 4 nodes, ``batch`` x ``seq`` tokens a node: the
    counted FLOPs against 6 P T, the roofline's compute and memory terms
    for the 4 nodes on one card against the local step run on the card
    (host clock ended by a sync, eager, the median of 3 after one warm
    call) and its busy time (``torch.profiler``). Returns the measured
    plan's fields; the CPU process's plan must equal them."""
    from repro_torch.configs import REGISTRY
    from repro_torch.launch import roofline as roof
    from repro_torch.launch import steps

    arch = REGISTRY[LM_FULL_ARCH]
    kw = dict(cfg=cfg, batch=batch, seq=seq)
    t0 = time.perf_counter()
    m = steps.roofline_cost_inputs(arch, "train_4k", LM_NODES, **kw)
    count_s = time.perf_counter() - t0
    params = cfg.param_count()
    six_pt = roof.model_flops_train(params, batch * seq)
    line = {"params_a_node": params, "tokens_a_node": batch * seq,
            **m, "six_p_t": six_pt, "flops_over_six_p_t": m["step_flops"]
            / six_pt, "count_s": count_s,
            "compute_ms": m["step_flops"] * LM_NODES / roof.PEAK_FLOPS_BF16
            * 1e3, "memory_ms": m["step_hbm_bytes"] / roof.HBM_BYTES_PER_S
            * 1e3}
    require(m["gossip_collective_bytes"] == 0.0 and m["step_flops"] > 0,
            f"roofline inputs {m}")
    dev = torch.device(device)
    local = steps.build_local_step(
        arch, "train_4k", LM_NODES, device=device,
        generator=torch.Generator(device).manual_seed(0), **kw)

    def step():
        out = local.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    step()
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        loss = float(step()[2])
        times.append((time.perf_counter() - t1) * 1e3)
    require(math.isfinite(loss), f"local step loss {loss}")
    line["local_step_ms"] = float(np.median(times))
    line["local_step_ms_runs"] = times
    if dev.type == "cuda":
        busy, kernels = device_busy_ms(step)
        line["local_step_busy_ms"] = busy
        line["top_kernels_ms"] = top_kernels(kernels, 1, n=6, width=120)
    line["roofline_over_measured"] = (
        max(line["compute_ms"], line["memory_ms"]) / line["local_step_ms"])
    del local
    plans = {}
    for name, use in (("analytic", False), ("measured", True)):
        p = steps.plan_train_schedule(arch, "train_4k", LM_NODES,
                                      budget_s=ROOF_BUDGET_S,
                                      use_roofline=use, **kw)
        plans[name] = plan_fields(p)
    line["plans"] = plans
    print("roofline inputs " + json.dumps(line))
    return plans["measured"]


def planned_round(K, cfg, want_plan, batch=LM_FULL_BATCH, seq=LM_FULL_SEQ,
                  device="cuda"):
    """(b) ``build_planned_round`` from the measured plan: ``ROOF_ROUNDS``
    rounds in one dispatch on the executor after its warmup: no build or
    capture after it, exactly K1's launches (one call a dtype a gossip
    step), finite losses, the plan the same as (a)'s; ms a round against
    the plan's predicted round time."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    built = steps.build_planned_round(
        REGISTRY[LM_FULL_ARCH], "train_4k", LM_NODES,
        budget_s=ROOF_BUDGET_S, cfg=cfg, batch=batch, seq=seq,
        rounds=ROOF_ROUNDS, device=device,
        generator=torch.Generator(device).manual_seed(0), use_roofline=True)
    plan = built.meta["plan"]
    require({k: plan[k] for k in want_plan} == want_plan,
            f"planned round: plan {plan} is not (a)'s {want_plan}")
    ex = built.executor
    t0 = time.perf_counter()
    built.warmup()
    warmup_s = time.perf_counter() - t0
    warm = (ex.compile_count, ex.capture_count)
    per_step = lm_step_launches("", built.args[0].params)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    ops.reset_launches()
    t1 = time.perf_counter()
    _, m = built.run()
    losses = [float(v) for v in m["loss"]]
    sync()
    ms = (time.perf_counter() - t1) * 1e3 / ROOF_ROUNDS
    counts = dict(ops.LAUNCHES)
    expect = expect_launches(K, gossip_mix=per_step["gossip_mix"]
                             * plan["tau2"] * ROOF_ROUNDS)
    require(counts == expect, f"planned round: launches {counts}, expected "
            f"{expect}")
    add_launches(K, counts)
    require((ex.compile_count, ex.capture_count) == warm,
            f"planned round: {warm} builds and captures after the warmup "
            f"became {(ex.compile_count, ex.capture_count)}")
    require(all(math.isfinite(v) for v in losses),
            f"planned round: losses {losses}")
    print("planned round " + json.dumps({
        "plan": plan, "losses": losses, "ms_per_round": ms,
        "predicted_round_ms": plan["round_time_s"] * 1e3,
        "launches": counts, "builds_captures": warm,
        "warmup_s": warmup_s}))


def launch_benches(K, gate=True):
    """(c) ``bench_overlap --smoke --check`` on 8 gloo ranks sharing the
    card (one node a rank); (d) ``bench_round_overhead --measure
    reduced_arch --check``, its launches added to the kernels line.
    ``gate=False``: (c) without ``--check``."""
    from repro_torch.benchmarks import bench_overlap as bo
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    out = bo.main(["--smoke", "--check"] if gate else ["--smoke"])
    print(f"bench_overlap ({time.perf_counter() - t0:.2f} s) " + json.dumps(
        {k: out[k] for k in ("measured", "deployment", "planner",
                             "none_overhead", "pipeline_wall",
                             "builds_captures")}))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = bro.main(["--measure", "reduced_arch", "--check"])
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    require(counts["gossip_mix"] > 0, f"reduced_arch: launches {counts}")
    add_launches(K, counts)
    ra = out["reduced_arch"]
    print(f"reduced_arch ({time.perf_counter() - t0:.2f} s) " + json.dumps({
        "rounds_per_s": out["rounds_per_s"],
        "ms_per_round": {k: ra[k]["ms_per_round"] for k in
                         ("legacy", "executor_round", "executor_superstep")},
        "legacy_build_round_ms": ra["legacy"]["build_round_ms"],
        "builds_after_warmup": [ra[k]["builds_after_warmup"] for k in
                                ("executor_round", "executor_superstep")],
        "launches": counts}))


def train_lm_runs(K, gate=True, controls=(TRAIN_LM_CONTROL,), cfg=None,
                  argv=(), device="cuda"):
    """(e) ``examples/train_lm.py`` at its own widths (the ~100M qwen3-style
    LM, f32, 4 nodes), ``TRAIN_LM_ROUNDS`` rounds: tokens/s and the loss by
    round; every loss finite, exactly K1's launches (one call a dtype a
    gossip step), and the loss falling from round 1 by at least
    ``TRAIN_LM_FALL``, which each control (K1 perturbed on the card) must
    miss."""
    from repro_torch.examples import train_lm
    from repro_torch.kernels import ops

    args = ["--rounds", str(TRAIN_LM_ROUNDS), *argv]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    ops.reset_launches()
    rec = train_lm.main(args, cfg, device=device, log=lambda s: None)
    sync()
    counts = dict(ops.LAUNCHES)
    a = train_lm.parse_args(args)
    per_step = lm_step_launches("", rec["state"].params)
    expect = expect_launches(K, gossip_mix=per_step["gossip_mix"] * a.tau2
                             * a.rounds)
    require(counts == expect, f"train_lm: launches {counts}, expected "
            f"{expect}")
    add_launches(K, counts)
    losses = rec["losses"]
    fall = losses[0] - losses[-1]
    line = {"params": rec["params"], "tokens_per_s": rec["tokens_per_s"],
            "seconds": rec["seconds"], "losses": losses,
            "consensus_sq": rec["consensus_sq"], "fall": fall,
            "limit": TRAIN_LM_FALL, "launches": counts}
    del rec
    ok = all(math.isfinite(v) for v in losses)
    for control in controls:
        with perturbed(*control):
            ctl = train_lm.main(args, cfg, device=device, log=lambda s: None)
        c = ctl["losses"]
        line[f"control {control}"] = {"losses": c, "fall": c[0] - c[-1]}
        del ctl
        if gate:
            require(not (all(math.isfinite(v) for v in c)
                         and c[0] - c[-1] >= TRAIN_LM_FALL),
                    f"train_lm: the control {control} falls by "
                    f"{c[0] - c[-1]} >= {TRAIN_LM_FALL}")
    print("train_lm " + json.dumps(line))
    if gate:
        require(ok and fall >= TRAIN_LM_FALL,
                f"train_lm: losses {losses} fall by {fall} < {TRAIN_LM_FALL}")


def run_roofline_phase(K, gate=True):
    """Phase 15: (a) ``roofline_inputs`` and the same measured plan from a
    process that sees no card, (b) ``planned_round``, (c) and (d)
    ``launch_benches``, (e) ``train_lm_runs``. ``gate=False`` (``--only
    roofline_calibrate``) runs (c) without ``--check`` and (e) with
    ``TRAIN_LM_CONTROLS``, and holds no limit of (c) or (e)."""
    import gc

    from repro_torch.configs import REGISTRY

    cfg = dataclasses.replace(REGISTRY[LM_FULL_ARCH].model,
                              num_layers=LM_FULL_LAYERS)
    times = {}
    t0 = time.perf_counter()
    proc = cpu_process_plan(cfg, LM_FULL_BATCH, LM_FULL_SEQ)
    try:
        plan = roofline_inputs(cfg)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    cpu_plan = cpu_process_plan_result(proc)
    require(cpu_plan == plan, f"the CPU process's plan {cpu_plan} is not "
            f"the card's {plan}")
    times["inputs"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    planned_round(K, cfg, plan)
    times["planned_round"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch_benches(K, gate)
    times["benches"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_lm_runs(K, gate, (TRAIN_LM_CONTROL,) if gate else TRAIN_LM_CONTROLS)
    times["train_lm"] = time.perf_counter() - t0
    print("roofline phase seconds " + json.dumps(times))


def run_bench_kernels_phase():
    """Phase 16: ``bench_kernels --check --device cuda`` into a temporary
    file, its sections printed. Every gate is the bench's own and
    deterministic (parity, bitwise, launch counts, TopK's equality with its
    oracle); the times are printed, not gated."""
    import tempfile

    from repro_torch.benchmarks import bench_kernels

    with tempfile.TemporaryDirectory() as tmp:
        out = bench_kernels.main(["--check", "--device", "cuda", "--out",
                                  os.path.join(tmp, "BENCH_kernels.json")])
    for name in ("parity", "topk_vs_reference", "buffer_passes"):
        print(f"bench_kernels {name} " + json.dumps(out[name]))
    for row in out["throughput"]["rows"]:
        print("bench_kernels row " + json.dumps(row))


def run_analysis_phase(K):
    """Phase 17, ``repro_torch.analysis`` on the card, every gate
    deterministic: (a) ``run_production_audits(device="cuda")``, the nine
    audits under the reference's names on ring(8), dim 33 (the dense,
    pipelined and batched executors here, 8 sparse gloo ranks spawned once):
    all ``ok``, K1 launched in every dense audit's dispatches and
    K1-received on every rank, the ranks' sends ring(8)'s shift pairs; (b)
    the five dense audits (``dense_audits``) on the main path, the CIFAR
    CNN at full width, ring(10), C-DFL TopK (frac 0.67), tau maxima (4, 4):
    all ``ok``, with K1, K4 and K3 launched in each; (c) two controls that
    must fail: ``audit_donation`` on an executor built with
    ``donate=False``, and the ranks' sends against ``fully_connected(8)``'s
    pairs; (d) ``python -m repro_torch.analysis lint`` exits 0. The parts'
    times are printed, not gated."""
    from repro_torch.analysis import audits
    from repro_torch.benchmarks import bench_round_overhead as bro
    from repro_torch.core import RoundExecutor
    from repro_torch.core.topology import fully_connected
    from repro_torch.kernels import ops

    times = {}
    t0 = time.perf_counter()
    ops.reset_launches()
    results = audits.run_production_audits(num_nodes=8, device="cuda")
    torch.cuda.synchronize()
    add_launches(K, dict(ops.LAUNCHES))
    times["production"] = time.perf_counter() - t0
    by = {r.name: r for r in results}
    require([r.name for r in results] == list(audits.AUDIT_NAMES),
            f"analysis: audits {[r.name for r in results]}")
    for r in results:
        print(f"analysis [{'PASS' if r.ok else 'FAIL'}] {r.name}: "
              f"{r.detail} " + json.dumps(
                  {"launches": r.data.get("launches"),
                   "counts": r.data.get("counts")}))
    require(all(r.ok for r in results), "analysis: failed audits "
            f"{[(r.name, r.detail) for r in results if not r.ok]}")
    sparse = ("collective-matching", "participation-collectives",
              "overlap-collectives")
    for name in audits.AUDIT_NAMES:
        launched = by[name].data["launches"]
        if name in sparse:
            require(len(launched) == 8 and all(
                counts.get("gossip_mix_received", 0) > 0
                for counts in launched.values()),
                f"analysis {name}: K1-received launches by rank {launched}")
            add_launches(K, {"gossip_mix_received": sum(
                counts["gossip_mix_received"]
                for counts in launched.values())})
        else:
            require(launched.get("gossip_mix", 0) > 0,
                    f"analysis {name}: K1 launches {launched}")
    for name in sparse:
        require(by[name].data["observed"] == by[name].data["expected"],
                f"analysis {name}: the ranks' sends are not ring(8)'s pairs")

    t0 = time.perf_counter()
    s = bro.cnn_setup("top_k", rounds=2, device="cuda")
    cfg = s.cfg(4, 4)
    batches = tuple(torch.stack([s.batches[r][j] for r in range(2)])
                    for j in (0, 1))

    def build(**kw):
        return (RoundExecutor(cfg, s.loss_fn, s.opt, **kw), s.fresh(),
                batches, cfg.topology)

    ops.reset_launches()
    cifar = audits.dense_audits(build)
    torch.cuda.synchronize()
    add_launches(K, dict(ops.LAUNCHES))
    times["cifar_topk"] = time.perf_counter() - t0
    for r in cifar:
        print(f"analysis cifar_topk [{'PASS' if r.ok else 'FAIL'}] {r.name}: "
              f"{r.detail} " + json.dumps({"launches": r.data["launches"]}))
    require(all(r.ok for r in cifar), "analysis cifar_topk: failed audits "
            f"{[(r.name, r.detail) for r in cifar if not r.ok]}")
    for r in cifar:
        launched = r.data["launches"]
        require(all(launched.get(k, 0) > 0 for k in (
            "gossip_mix", "topk_threshold", "choco_topk")),
            f"analysis cifar_topk {r.name}: K1 / K4 / K3 launches {launched}")

    t0 = time.perf_counter()
    ex, state, small, _ = audits.build_audit_executor(8, device="cuda",
                                                      donate=False)
    ex.warmup(state, small)
    before = audits.state_pointers(state)
    ops.reset_launches()
    out, _ = ex.dispatch_trajectory(state, small, audits.TAUS_A)
    torch.cuda.synchronize()
    add_launches(K, dict(ops.LAUNCHES))
    controls = {
        "donation(donate=False)": audits.audit_donation(
            before, audits.state_pointers(out)),
        "collective-matching(fully_connected(8))":
            audits.audit_collective_matching(
                {(s, d): c for s, d, c in
                 by["collective-matching"].data["sends"]},
                fully_connected(8))}
    for label, r in controls.items():
        print(f"analysis control {label}: ok={r.ok}: {r.detail[:200]}")
        require(not r.ok, f"analysis: the control {label} passed")

    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "lint"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=120)
    print("analysis lint: " + lint.stdout.strip().splitlines()[-1])
    require(lint.returncode == 0, f"analysis: the lint exited "
            f"{lint.returncode}: {lint.stdout[-2000:]}")
    times["controls_lint"] = time.perf_counter() - t0
    print("analysis phase seconds " + json.dumps(times))


# ---------------------------------------------------------------------------
# Phases 18, 19 and 20: the gossip-fsdp mesh, gossip-dp on a mesh, and the
# multi-pod mesh
# ---------------------------------------------------------------------------


# The mesh phases: a node's batch at seq, taus, SGD at lr, the weights
# from the seed; the runs (label, compressor, its arguments, the dense
# round it is held to), the control among them a round with a cell's
# ``control`` = (leaf, rank, factor) applied first (that rank's block of
# node 0's copy of the leaf scaled; ``MESH_CONTROL`` by default): the
# plain round, or on ring(2), whose plain gossip step leaves two equal
# nodes and so a consensus of 0 whatever the weights, the TopK round; the
# ranks' time limit
MESH_BATCH, MESH_SEQ, MESH_TAUS, MESH_LR, MESH_SEED = 2, 256, (1, 2), 0.01, 5
MESH_RUNS = (("dfl", "", {}, "dfl"),
             ("control", "", {}, "dfl"),
             ("cdfl_topk", "top_k", {"frac": 0.5}, "cdfl_topk"),
             ("cdfl_qsgd", "qsgd", {"levels": 16}, "cdfl_qsgd"))
MESH_TOPK_CONTROL_RUNS = (
    ("dfl", "", {}, "dfl"),
    ("control", "top_k", {"frac": 0.5}, "cdfl_topk"),
    ("cdfl_topk", "top_k", {"frac": 0.5}, "cdfl_topk"),
    ("cdfl_qsgd", "qsgd", {"levels": 16}, "cdfl_qsgd"))
MESH_CONTROL = ("blocks/0/ffn/w_gate", 1, 1.0 + 2.0 ** -4)
MESH_TIMEOUT_S = 600.0
MESH_TWIN_RTOL = 1e-6       # the twin mesh's loss and consensus, if not equal


@dataclasses.dataclass(frozen=True)
class MeshCell:
    """One mesh phase: ``arch`` at its published widths, depth cut to
    ``layers``, on a data x model mesh of gloo ranks sharing the card
    (``grid``), or a pod x data x model one with ``pod`` given, ``chunk``
    nodes a single-pod gossip-fsdp local step gathers (None elsewhere);
    the phase's budget, the run limits (``rtol``), its ``runs`` and its
    ``control``.
    ``twin``: a pod count, the ranks' rounds run again on a pod x (data /
    pod) x model mesh of the same ranks, which must be bitwise the cell's
    own (gossip-dp: each rank keeps its node and ``model`` coordinate)."""
    name: str
    arch: str
    layers: int
    grid: tuple
    chunk: object
    budget_s: float
    rtol: dict
    pod: object = None
    twin: object = None
    runs: tuple = MESH_RUNS
    control: tuple = MESH_CONTROL

    @property
    def world(self):
        return self.grid[0] * self.grid[1] * (self.pod or 1)

    @property
    def shape(self):
        """The mesh's axes and sizes, in the mesh's order."""
        lead = {} if self.pod is None else {"pod": self.pod}
        return {**lead, "data": self.grid[0], "model": self.grid[1]}

    def mesh(self):
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh(*self.grid, pod=self.pod)

    def twin_mesh(self):
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh(self.grid[0] // self.twin, self.grid[1],
                              pod=self.twin)


# Phase 18: DeepSeek-Coder-33B, depth 62 -> 1, 4 replicated nodes, a data
# 2 x model 2 mesh, each node's batch split over data, a local step one
# node at a time. Its limits: the mesh's round against the dense port's on
# the card, the whole tree's relative Frobenius difference, the loss and
# the consensus relative; each limit between the largest sound reading and
# the control's (``--only mesh_calibrate``, PERF.md §6): sound params
# 4.4e-5 (TopK), loss 3.5e-7, consensus 7.3e-4 (TopK); control params
# 1.08e-3, loss 7.7e-6, consensus 230
MESH = MeshCell(
    name="mesh", arch="deepseek-coder-33b", layers=1, grid=(2, 2), chunk=1,
    budget_s=200.0,
    rtol={"params": 2e-4, "loss": 2e-6, "consensus_sq": 5e-3})
# Phase 19: Qwen3-1.7B, depth 28 -> 2, 4 nodes on ring(4), one a data
# coordinate of a data 4 x model 2 mesh, each node's batch whole on its
# two model ranks. Its limits, as phase 18's, each between the largest
# sound reading and the control's (``--only mesh_dp_calibrate``, PERF.md
# §6): sound params 2.4e-5 (TopK), loss 0 (every run), consensus 2.2e-3
# (TopK); control params 1.54e-3, loss 7.0e-7, consensus 2682
# Its rounds again on a pod 2 x data 2 x model 2 mesh of the same ranks,
# bitwise (the twin)
MESH_DP = MeshCell(
    name="mesh_dp", arch="qwen3-1.7b", layers=2, grid=(4, 2), chunk=None,
    budget_s=220.0,
    rtol={"params": 2e-4, "loss": 2e-7, "consensus_sq": 2e-2}, twin=2)
# Phase 20: DeepSeek-Coder-33B, depth 62 -> 1, gossip-fsdp on pods
# (hierarchical DFL): 2 nodes, the pods, on ring(2), each pod's node split
# over a data 2 x model 2 block of a pod 2 x data 2 x model 2 mesh, its
# batch split over data; the control the TopK round (ring(2)) with rank 1's
# block of node 0's ``lm_head`` scaled by 1 + 2^-4: the sound loss reading,
# 1.3e-5, is the card's bf16 GEMMs at the mesh's one sequence a rank
# against the dense round's two, and phase 18's control (a block of
# ``w_gate``) moved the loss by as much (1.5e-5); a block of ``lm_head``
# moves it 7.7 times as far in the reduced model on the CPU. Its limits,
# as phase 18's, each between the largest sound reading and the
# control's (``--only mesh_pod_calibrate``, PERF.md §6): sound params
# 3.7e-5 (TopK), loss 1.31e-5, consensus 5.9e-4 (TopK); control params
# 5.8e-3, loss 8.2e-4, consensus 169
MESH_POD = MeshCell(
    name="mesh_pod", arch="deepseek-coder-33b", layers=1, grid=(2, 2),
    chunk=None, budget_s=200.0,
    rtol={"params": 2e-4, "loss": 3.5e-5, "consensus_sq": 5e-3}, pod=2,
    runs=MESH_TOPK_CONTROL_RUNS,
    control=("lm_head", 1, 1.0 + 2.0 ** -4))


def mesh_model(cell=MESH):
    from repro_torch.configs import REGISTRY
    return dataclasses.replace(REGISTRY[cell.arch].model,
                               num_layers=cell.layers)


def mesh_nodes(cell):
    """The cell's node count (``sharding.num_nodes_for``): the node axes'
    size, or gossip-fsdp's replicated nodes on one pod."""
    from repro_torch.configs import REGISTRY
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import num_nodes_for
    arch = REGISTRY[cell.arch]
    return num_nodes_for(arch.sharding_mode, Mesh(cell.shape),
                         arch.fsdp_nodes)


def mesh_cfg(cell, compression, kw):
    """The round's ``DFLConfig``, as ``steps.build_train_round`` makes it
    on the mesh (ring over the nodes, the default gamma)."""
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.dfl import DFLConfig
    from repro_torch.core.topology import ring
    return DFLConfig(tau1=MESH_TAUS[0], tau2=MESH_TAUS[1],
                     topology=ring(mesh_nodes(cell)),
                     compression=(make_compressor(compression, **kw)
                                  if compression else None))


def mesh_generator(cell, dev):
    """The weights' generator, as the dense round and the mesh's builder
    both take it."""
    return torch.Generator(device=dev).manual_seed(MESH_SEED)


def mesh_weights(cell, cfg, dev):
    """One model's whole weights on the card, from the cell's seed, and
    their logical axes."""
    from repro_torch.models import init_params
    return init_params(cfg, mesh_generator(cell, dev), dev)


def mesh_batches(cell, cfg, n):
    """The round's host batches ``[tau1, N, B, S]`` of the synthetic
    corpus (``steps.build_train_round``'s first round)."""
    from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
    return lm_batches_for_dfl(SyntheticLM(vocab_size=cfg.vocab_size,
                                          num_nodes=n),
                              MESH_TAUS[0], n, MESH_BATCH, MESH_SEQ, 0)


def dense_round_by_leaf(dcfg, loss_fn, opt, state, batch):
    """The dense port's round (``core.dfl.round_body`` on a
    ``DenseSubstrate``) with its gossip phase run one leaf at a time:
    gossip never mixes leaves (K1, K4's rows, K3 and K2 are per leaf, and
    the seam's draws of a leaf do not depend on the others asked for), so
    the parameters and metrics are bitwise the whole round's
    (``tests/test_torch_mesh.py``), while the card holds one leaf's
    C-DFL temporaries at a time instead of the tree's: four full-width
    DeepSeek-Coder nodes' whole-tree TopK step needs more than the card's
    80 GB beside the mesh's ranks. Returns (params, metrics)."""
    from repro_torch.core.dfl import gossip_phase, local_phase
    from repro_torch.core.substrate import DenseSubstrate
    from repro_torch.core.tree import leaf_order

    sub = DenseSubstrate(dcfg.topology)
    params, _, loss = local_phase(dcfg, loss_fn, opt, sub, state.params,
                                  state.opt_state, batch)
    hat = state.hat_params
    out = {}
    for name in leaf_order(params):
        x, _ = gossip_phase(dcfg, sub, {name: params.pop(name)},
                            None if hat is None else {name: hat.pop(name)},
                            state.draws, state.round_idx)
        out[name] = x[name]
    return out, {"loss": loss, "consensus_sq": sub.consensus_sq(out)}


def mesh_dense_round(cell, cfg, dcfg, dev):
    """The dense port's round on one process, every node stacked on the
    card (``dense_round_by_leaf``); (whole parameters on the host,
    metrics, peak bytes, seconds)."""
    from repro_torch.core.dfl import init_state
    from repro_torch.core.rng import GeneratorDraws
    from repro_torch.models import train_loss
    from repro_torch.optim import sgd

    n = dcfg.topology.num_nodes
    torch.cuda.reset_peak_memory_stats(dev)
    p0, _ = mesh_weights(cell, cfg, dev)
    state = init_state(p0, n, sgd(MESH_LR), compressed=dcfg.is_compressed,
                       draws=GeneratorDraws(1, n, p0, dev))
    del p0
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in mesh_batches(cell, cfg, n).items()}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    params, m = dense_round_by_leaf(dcfg, lambda p, b: train_loss(p, b, cfg),
                                    sgd(MESH_LR), state, batch)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    del state, batch
    host = {k: params.pop(k).cpu() for k in list(params)}
    metrics = {k: float(v) for k, v in m.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    return host, metrics, peak, secs


def mesh_dense_rounds(cell, out_dir):
    """The dense port's round of each configuration that a mesh run is held
    to, one after another in this process, every node's whole leaves
    written to ``out_dir/dense_<label>.pt``; then the card's cache is
    emptied and ``dense_ready`` written, which the ranks wait for
    (``dense_failed`` if a round raised). Returns each round's metrics,
    peak bytes, seconds and file seconds."""
    dev = torch.device("cuda")
    cfg = mesh_model(cell)
    out = {}
    try:
        for label, compression, kw, ref in cell.runs:
            if ref != label:
                continue
            host, metrics, peak, secs = mesh_dense_round(
                cell, cfg, mesh_cfg(cell, compression, kw), dev)
            t0 = time.perf_counter()
            torch.save(host, os.path.join(out_dir, f"dense_{label}.pt"))
            del host
            out[label] = {"metrics": metrics, "peak": peak, "s": secs,
                          "save_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    except BaseException:
        open(os.path.join(out_dir, "dense_failed"), "w").close()
        raise
    open(os.path.join(out_dir, "dense_ready"), "w").close()
    return out


def mesh_warmup(cell, cfg, dev, batch, loss):
    """One node's whole-weight forward and backward at the mesh's local
    step's shapes, on every rank while the phase's own process runs the
    dense rounds: a process's first step pays its one-time CUDA set-up
    (module loads, library handles; about 10 s on the card), which is no
    part of a mesh round."""
    from torch.func import grad_and_value, vmap
    whole, _ = mesh_weights(cell, cfg, dev)
    one = {k: v.unsqueeze(0) for k, v in whole.items()}
    del whole
    vmap(grad_and_value(loss))(one, {k: v[0, :1] for k, v in batch.items()})
    torch.cuda.synchronize(dev)
    del one
    torch.cuda.empty_cache()


def mesh_step_launches(sub, compression):
    """One gossip step's launches on a rank: K1 once a 32 leaves of a
    dtype (its received form where the nodes enumerate mesh axes, whose
    ranks exchange their blocks over them);
    TopK K3 a leaf and K4's sharded form, a count and a pick launch a
    digit, for the leaves of each (dtype, row axes); QSGD K2 a leaf."""
    import collections

    from repro_torch.core.substrate import NodeMeshSubstrate
    from repro_torch.kernels import topk
    leaves = len(sub.specs)
    mix = ("gossip_mix_received" if isinstance(sub, NodeMeshSubstrate)
           else "gossip_mix")
    out = {mix: -(-leaves // 32)}
    if compression == "top_k":
        groups = collections.Counter(sub.row_axes.values())
        out["choco_topk"] = leaves
        out["topk_threshold_sharded"] = sum(
            2 * len(topk.DIGITS[torch.bfloat16]) * -(-c // topk.MAX_LEAVES)
            for c in groups.values())
    elif compression == "qsgd":
        out["choco_qsgd"] = leaves
    return out


def mesh_round(cell, arch, mesh, cfg, dev, compression, kw):
    """The cell's round on ``mesh``, built by ``steps.build_train_round``:
    this rank's part of the nodes' weights and batches."""
    from repro_torch.core.compression import make_compressor
    from repro_torch.launch import steps
    return steps.build_train_round(
        arch, "train_4k", mesh, tau1=MESH_TAUS[0], tau2=MESH_TAUS[1],
        compression=(make_compressor(compression, **kw)
                     if compression else None),
        lr=MESH_LR, cfg=cfg, batch=MESH_BATCH, seq=MESH_SEQ, device=dev,
        generator=mesh_generator(cell, dev), node_chunk=cell.chunk)


def mesh_twin_run(cell, arch, twin, cfg, dev, compression, kw, state,
                  metrics):
    """The run again on the twin mesh (``cell.twin``): its launches, the
    round's seconds, builds and captures, and whether every block of its
    state (parameters, estimates) is bitwise ``state``'s and its metrics
    ``metrics`` (or within ``MESH_TWIN_RTOL``, printed)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops

    built = mesh_round(cell, arch, twin, cfg, dev, compression, kw)
    dist.barrier()
    ops.reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got, m = built.run()
    torch.cuda.synchronize(dev)
    out = {"s": time.perf_counter() - t0, "launches": dict(ops.LAUNCHES),
           "expect": {k: v * MESH_TAUS[1] for k, v in mesh_step_launches(
               built.substrate, compression).items()},
           "builds": built.executor.compile_count,
           "captures": built.executor.capture_count,
           "metrics": {k: float(v[-1]) for k, v in m.items()}}
    trees = [(got.params, state.params)]
    if state.hat_params is not None:
        trees.append((got.hat_params, state.hat_params))
    out["bitwise"] = all(
        g.keys() == w.keys() and all(same_bits(g[k], w[k]) for k in w)
        for g, w in trees)
    out["metrics_rel"] = {k: abs(v - metrics[k]) / max(abs(metrics[k]),
                                                       FIG_CONSENSUS_FLOOR)
                          for k, v in out["metrics"].items()}
    del built, got, m, trees
    return out


def mesh_rank(group, cell, out_dir):
    """One rank of a mesh phase: a warm-up step, then, once the phase's
    process has written the dense rounds' leaves to ``out_dir``
    (``mesh_dense_rounds``), per run the mesh's round, built by
    ``steps.build_train_round`` on the mesh and dispatched by its executor
    (launches set to 0 just before), and this rank's blocks held to the
    dense leaves, read from their file; with ``cell.twin`` each run but
    the control again on the twin mesh (``mesh_twin_run``); (a) K4's
    sharded form on the TopK run's first gossip step's gaps, and where the
    nodes enumerate mesh axes K1's received form on the plain run's first
    gossip step. Writes ``mesh<r>.pt``."""
    import torch.distributed as dist
    from unittest import mock

    from repro_torch.configs import REGISTRY
    from repro_torch.core.substrate import MeshSubstrate, NodeMeshSubstrate
    from repro_torch.device import deterministic_algorithms
    from repro_torch.kernels import gossip_mix, ops, topk
    from repro_torch.launch import sharding
    from repro_torch.models import init_params, train_loss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_rank = time.perf_counter()
    dev = group.device
    mesh = cell.mesh()
    twin = cell.twin_mesh() if cell.twin else None
    cfg = mesh_model(cell)
    arch = REGISTRY[cell.arch]
    mode = arch.sharding_mode
    n = mesh_nodes(cell)
    node_axes = sharding.node_axes_for(mode, mesh)
    sub_cls = NodeMeshSubstrate if node_axes else MeshSubstrate
    meta, axes = init_params(cfg, None, "meta", abstract=True)
    specs = {k: sharding.spec_for_param(axes[k], (n,) + tuple(v.shape),
                                        mode, mesh, node_dim=True)
             for k, v in meta.items()}
    bspec = sharding.batch_spec(mesh, mode, has_tau_dim=True)
    batch = {k: sharding.shard_leaf(torch.from_numpy(v), bspec, mesh).to(dev)
             for k, v in mesh_batches(cell, cfg, n).items()}
    loss = lambda p, b: train_loss(p, b, cfg)  # noqa: E731
    # the ranks that hold the same rows: every axis but the node axes
    same_rows = tuple(a for a in mesh.axis_names if a not in node_axes)
    res = {"rank": mesh.rank, "coords": mesh.coords, "runs": {}}
    real_grads = sub_cls.node_grads
    real_k4 = ops.topk_threshold_sharded_many
    real_k1 = ops.gossip_mix_received_many
    with deterministic_algorithms(True):
        mesh_warmup(cell, cfg, dev, batch, loss)
        t0 = time.perf_counter()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while not os.path.exists(os.path.join(out_dir, "dense_ready")):
            require(not os.path.exists(os.path.join(out_dir, "dense_failed")),
                    f"{cell.name}: the dense rounds failed")
            require(time.monotonic() < deadline,
                    f"{cell.name}: no dense rounds in time")
            time.sleep(0.05)
        dist.barrier()
        res["wait_s"] = time.perf_counter() - t0
        for i, (label, compression, kw, ref) in enumerate(cell.runs):
            path = os.path.join(out_dir, f"dense_{ref}.pt")
            t0 = time.perf_counter()
            built = mesh_round(cell, arch, mesh, cfg, dev, compression, kw)
            require(built.meta["engine"] == "dense" and all(
                torch.equal(built.args[1][k][0], batch[k]) for k in batch),
                f"{cell.name} (b) {label}: the builder's engine or batches "
                "differ")
            if label == "control" and mesh.rank == cell.control[1]:
                built.args[0].params[cell.control[0]][0].mul_(cell.control[2])
            build_s = time.perf_counter() - t0
            # the bytes and seconds of each local step's collectives, and
            # the round's substrate (its group's counters, its leaves)
            local = []
            sg = built.substrate.group
            before_round = (sg.collective_s, sg.exchange_s, sg.exchange_bytes)

            def counted(sub, *a):
                before = (sg.gathered_bytes, sg.reduced_bytes,
                          sg.collective_s)
                out = real_grads(sub, *a)
                local.append([after - b0 for after, b0 in zip(
                    (sg.gathered_bytes, sg.reduced_bytes, sg.collective_s),
                    before)])
                return out
            # (a)'s inputs: the TopK run's first gossip step's gaps, or the
            # plain run's leaves and received copies where the nodes
            # enumerate mesh axes, copied to the host (the card holds every
            # rank's state); the copies' time is taken out of the round's
            captured, k1_captured, copy_s = [], [], [0.0]

            def capture(xs, ks, span):
                if label == "cdfl_topk" and len(captured) < len(
                        set(built.substrate.row_axes.values())):
                    t0 = time.perf_counter()
                    captured.append(([x.cpu() for x in xs], list(ks), span))
                    copy_s[0] += time.perf_counter() - t0
                return real_k4(xs, ks, span)

            def capture_k1(xs, recvs, w):
                if label == "dfl" and not k1_captured:
                    t0 = time.perf_counter()
                    k1_captured.append(([x.cpu() for x in xs],
                                        [r.cpu() for r in recvs], w.cpu()))
                    copy_s[0] += time.perf_counter() - t0
                return real_k1(xs, recvs, w)
            torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            ops.reset_launches()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with mock.patch.object(sub_cls, "node_grads", counted), \
                    mock.patch.object(ops, "topk_threshold_sharded_many",
                                      capture), \
                    mock.patch.object(ops, "gossip_mix_received_many",
                                      capture_k1):
                state, m = built.run()
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0 - copy_s[0]
            after_round = (sg.collective_s, sg.exchange_s, sg.exchange_bytes)
            c_s, x_s, x_bytes = (a - b for a, b in zip(after_round,
                                                       before_round))
            run = {"metrics": {k: float(v[-1]) for k, v in m.items()},
                   "s": secs, "collective_s": c_s, "exchange_s": x_s,
                   "exchange_bytes_step": x_bytes / MESH_TAUS[1],
                   "local": local, "launches": dict(ops.LAUNCHES),
                   "expect": {k: v * MESH_TAUS[1] for k, v in
                              mesh_step_launches(built.substrate,
                                                 compression).items()},
                   "peak": torch.cuda.max_memory_allocated(dev),
                   "build_s": build_s,
                   "builds": built.executor.compile_count,
                   "captures": built.executor.capture_count}
            res["backend"] = sg.backend
            del built, m
            # every rank's blocks against the dense leaves (the phase's
            # file, mapped, so each rank reads its blocks only)
            t0 = time.perf_counter()
            want_all = torch.load(path, mmap=True, weights_only=True)
            diffs = {}
            for k in sorted(state.params):
                want = sharding.shard_leaf(want_all[k], specs[k],
                                           mesh).to(dev)
                d = state.params[k].float() - want.float()
                diffs[k] = [float((d * d).sum()),
                            float(want.float().pow(2).sum()),
                            float(d.abs().max())]
                del d, want
            del want_all
            run["diffs"] = diffs
            run["compare_s"] = time.perf_counter() - t0
            if twin is not None and label != "control":
                run["twin"] = mesh_twin_run(cell, arch, twin, cfg, dev,
                                            compression, kw, state,
                                            run["metrics"])
            del state
            if captured:
                t0 = time.perf_counter()
                run["k4"] = mesh_k4_check(captured, sg, same_rows, topk,
                                          ops, dev)
                run["k4_s"] = time.perf_counter() - t0
                captured.clear()
            if k1_captured:
                run["k1"] = mesh_k1_check(k1_captured[0], gossip_mix, ops,
                                          dev)
                k1_captured.clear()
            res["runs"][label] = run
            del sg
            torch.cuda.empty_cache()
            dist.barrier()
            if mesh.rank == 0 and all(r[3] != ref for r in cell.runs[i + 1:]):
                os.remove(path)      # no later run is held to it
    res["s"] = time.perf_counter() - t_rank
    torch.save(res, os.path.join(out_dir, f"mesh{mesh.rank}.pt"))


def mesh_k1_check(captured, gossip_mix, ops, dev):
    """Phase 19 / 20 (a): K1's received form again on this rank's leaves
    and received copies of the plain run's first gossip step (deg 2 on
    ring(4), 1 on ring(2)), bitwise its plain version (``plain_received``)
    on the card; on rank 0 both timed, and one ``torch.addmm`` a leaf (w0
    x + w[1:] @ recv, the same function), CUDA events over replays, beside
    the bound (each operand read once, each output written once). A rank's
    operands are over 1 GB, twenty times the L2 cache and more, so every
    replay reads them from DRAM."""
    import torch.distributed as dist
    xs, recvs, w = ([t.to(dev) for t in captured[0]],
                    [t.to(dev) for t in captured[1]], captured[2].to(dev))
    got = ops.gossip_mix_received_many(xs, recvs, w)
    plain = [gossip_mix.plain_received(x, r, w) for x, r in zip(xs, recvs)]
    out = {"bitwise": all(same_bits(g, p) for g, p in zip(got, plain)),
           "max_abs_err": max(max_abs_err(g, p) for g, p in zip(got, plain)),
           "bytes": sum(2 * x.numel() * x.element_size()
                        + r.numel() * r.element_size()
                        for x, r in zip(xs, recvs))}
    del got, plain
    dist.barrier()
    if dist.get_rank() == 0:
        w0, wr = float(w[0]), w[1:][None].to(xs[0].dtype)
        out["deg"] = int(w.numel()) - 1
        out["ms"] = device_ms(lambda: ops.gossip_mix_received_many(
            xs, recvs, w), iters=5, reps=3)
        out["plain_ms"] = device_ms(lambda: [
            gossip_mix.plain_received(x, r, w) for x, r in zip(xs, recvs)],
            iters=2, reps=2)
        out["library_ms"] = device_ms(lambda: [
            torch.addmm(x.reshape(1, -1), wr, r, beta=w0)
            for x, r in zip(xs, recvs)], iters=2, reps=2)
    dist.barrier()
    del xs, recvs
    torch.cuda.empty_cache()
    return out


def mesh_k4_check(captured, sg, same_rows, topk, ops, dev):
    """Phase 18 / 19 (a): K4's sharded form again on the captured gaps of
    the TopK run's first gossip step (every leaf): every rank that holds
    the same rows (the axes ``same_rows``) finds bitwise the same
    thresholds, and the first rank of each row's span bitwise its plain
    version (``threshold_sharded_plain``: the rows gathered, to that rank
    alone, ``threshold_plain``) and the unsharded K4 on the gathered rows.
    The sharded call's time (host clock, synced, its collectives included)
    and its collectives' part; on rank 0 the count and pick kernels alone
    (the histogram sum replaced by the identity: the same launches over
    the same keys, with no collective between them) on the device clock
    (CUDA events over replays, warm); rank 0's plain version's time (the
    gather and the select) and the library's, one ``torch.topk`` of the
    gathered rows' magnitudes a leaf on the device clock (CUDA events, the
    gather not counted), and the bytes of this rank's keys."""
    import torch.distributed as dist
    rank = dist.get_rank()
    out = {"bitwise": True, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "library_ms": 0.0, "collective_ms": 0.0, "device_ms": 0.0,
           "key_bytes": 0, "rows": 0, "launches": 0}
    for host, ks, span in captured:
        xs = [x.to(dev) for x in host]
        dist.barrier()
        torch.cuda.synchronize(dev)
        before = ops.LAUNCHES["topk_threshold_sharded"]
        c0 = sg.collective_s
        t0 = time.perf_counter()
        got = ops.topk_threshold_sharded_many(xs, ks, span)
        torch.cuda.synchronize(dev)
        out["ms"] += (time.perf_counter() - t0) * 1e3
        out["collective_ms"] += (sg.collective_s - c0) * 1e3
        out["launches"] += ops.LAUNCHES["topk_threshold_sharded"] - before
        out["key_bytes"] += sum(x.numel() * x.element_size() for x in xs)
        out["rows"] += sum(x.shape[0] for x in xs)
        if rank == 0:
            outs = [torch.empty_like(g) for g in got]
            out["device_ms"] += device_ms(
                lambda: topk.launch_threshold_sharded_many(
                    xs, ks, outs, lambda h: h), iters=5, reps=3)
            del outs
        bits_of = torch.cat([bits(g).to(torch.int32) for g in got])
        every = sg.all_gather(bits_of, same_rows)
        out["bitwise"] &= all(torch.equal(e, every[0]) for e in every)
        pg, size = sg.mesh.group_of(span.axes)
        members = sg.mesh.members(span.axes)
        root = sg.mesh.global_ranks[members[0]]
        first = sg.mesh.coords_of(members[0])
        if any(first[a] for a in same_rows if a not in span.axes):
            del xs, got
            continue    # a span that holds these rows at 0 checks them
        for x, k, g in zip(xs, ks, got):
            if size > 1:
                dist.barrier(group=pg)
            t0 = time.perf_counter()
            # the rows' parts to the span's first rank only (the plain
            # version's gather, without every rank receiving every row)
            part = x.cpu()
            parts = ([torch.empty_like(part) for _ in range(size)]
                     if rank == root else None)
            if size > 1:
                dist.gather(part, parts, dst=root, group=pg)
            if rank == root:
                rows = torch.cat(parts if size > 1 else [part], dim=1).to(dev)
                plain = topk.threshold_sharded_plain(x, k, lambda _: rows)
                torch.cuda.synchronize(dev)
                if rank == 0:
                    out["plain_ms"] += (time.perf_counter() - t0) * 1e3
                    xa = rows.abs()
                    out["library_ms"] += event_ms(
                        lambda: torch.topk(xa, k, dim=1), reps=1)
                    del xa
                whole = ops.topk_threshold(rows, k)
                out["bitwise"] &= same_bits(g, plain) and same_bits(g, whole)
                out["max_abs_err"] = max(out["max_abs_err"],
                                         max_abs_err(g, plain))
                del plain, whole, rows
            del part, parts
            torch.cuda.empty_cache()
        del xs, got
    return out


def mesh_k4_alone():
    """Phase 18 (a0), in this process: K4's sharded form over a span of one
    rank (the sum the identity), every row through every count and pick
    pass, bitwise the unsharded K4 at the parity sizes, f32 and bf16,
    normal rows, ties and a -0.0 row, k = 1, a third and all."""
    from repro_torch.core.sharded import ShardGroup
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    span = ShardGroup(make_host_mesh(1, 1), "cuda").span(())
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        xs, ks = [], []
        for i, d in enumerate(PARITY_SIZES):
            x = torch.randn((3, d), generator=gen, device="cuda").to(dt)
            x[1, ::3] = 0.5
            x[2, : d // 2] = -0.0
            xs.append(x)
            ks.append((1, max(1, d // 3), d)[i % 3])
        got = ops.topk_threshold_sharded_many(xs, ks, span)
        want = ops.topk_threshold_many(xs, ks)
        for g, w, d in zip(got, want, PARITY_SIZES):
            require(same_bits(g, w), f"mesh (a0): K4's sharded form over one "
                    f"rank differs from K4 at D = {d}, {dt}")
    print("mesh (a0) K4-sharded over one rank bitwise K4 at the parity "
          "sizes, f32 and bf16")


def run_mesh_phase(K, gate=True, cell=MESH):
    """Phase 18 (``cell=MESH``), the gossip-fsdp mesh (``launch.mesh``,
    ``launch.sharding``, ``core.substrate.MeshSubstrate``): DeepSeek-Coder-33B
    at its published widths in bf16, depth cut 62 -> 1, 4 replicated
    nodes on ring(4), 4 gloo ranks sharing the card as a data 2 x model 2
    mesh, each node's batch of 2 at seq 256 split over ``data``, the local
    step one node at a time. Phase 19 (``cell=MESH_DP``), gossip-dp on a
    mesh (``core.substrate.NodeMeshSubstrate``): Qwen3-1.7B at its
    published widths in bf16, depth cut 28 -> 2, 4 nodes on ring(4), one a
    data coordinate of a data 4 x model 2 mesh of 8 gloo ranks sharing the
    card, each node's batch of 2 at seq 256 whole on its two model ranks,
    a gossip step exchanging the blocks along data; each run but the
    control again on a pod 2 x data 2 x model 2 mesh of the same ranks (a
    node a (pod, data) pair), bitwise. Phase 20 (``cell=MESH_POD``),
    gossip-fsdp on pods (``NodeMeshSubstrate`` with ``pod`` the node axis):
    DeepSeek-Coder-33B as phase 18, 2 nodes, the pods, on ring(2), a pod 2
    x data 2 x model 2 mesh of 8 gloo ranks, each pod's node split over
    its data 2 x model 2 ranks, its batch of 2 split over data, a gossip
    step exchanging the blocks along pod. All: tau (1, 2), each round
    built by ``steps.build_train_round`` on the mesh and dispatched by its
    executor. (a) K4's sharded-row form on the TopK run's first gossip
    step's gaps of every leaf: bitwise its plain version and the unsharded
    K4 on the gathered rows, its count and pick kernels timed on the
    device beside ``torch.topk`` on the gathered rows; where the nodes
    enumerate mesh axes also K1's received form on each rank's first plain
    gossip step, bitwise its plain version. (b) One round each of plain
    DFL, TopK (frac 0.5) and QSGD (16 levels) from the same weights and
    batches as the dense port on one process (this one, before any mesh
    round, while the ranks start and take a warm-up step;
    ``mesh_dense_rounds``): the whole leaves within ``cell.rtol`` (the
    tree's relative Frobenius difference), the loss and consensus too; the
    control, the plain round (phase 20: the TopK round) with node 0's copy
    of rank 1's block of one leaf scaled first (``cell.control``), must
    break every limit; exact launches of K1 (its received form where the
    nodes enumerate mesh axes), K3, K2 and K4's sharded form on every
    rank, 1 build and no capture. (c) The phase's seconds, each rank's
    peak memory, the bytes gathered and reduced a local step and exchanged
    a gossip step, the collectives' and the exchange's share of a round
    (host clock). The phase must end within ``cell.budget_s``.
    ``gate=False`` (``--only mesh_calibrate``, ``mesh_dp_calibrate``,
    ``mesh_pod_calibrate``) prints the readings and holds none of the run
    limits; the twin's bits, the launches and the kernel checks are held
    in any case."""
    import shutil
    import tempfile
    import threading

    from repro_torch.core.sharded import spawn

    t_phase = time.perf_counter()
    tag = cell.name
    if cell is MESH:
        mesh_k4_alone()
    out = tempfile.mkdtemp(prefix=f"{tag}_phase_")
    free = shutil.disk_usage(out).free
    torch.cuda.empty_cache()
    # the ranks start and warm up while this process runs the dense rounds
    # (``mesh_dense_rounds``); they wait for its files. The ranks' C-DFL
    # state share the card: their allocators grow segments instead of
    # caching blocks of every size
    failed = []

    def ranks_main():
        try:
            spawn(mesh_rank, cell.world, (cell, out), device="cuda",
                  timeout_s=MESH_TIMEOUT_S)
        except BaseException as e:      # re-raised below
            failed.append(e)
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    ranks_thread = threading.Thread(target=ranks_main)
    try:
        ranks_thread.start()
        dense = mesh_dense_rounds(cell, out)
    finally:
        ranks_thread.join()
        if env is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    if failed:
        raise failed[0]
    ranks = [torch.load(os.path.join(out, f"mesh{r}.pt"), weights_only=False)
             for r in range(cell.world)]
    shutil.rmtree(out, ignore_errors=True)
    readings, control = {}, {}
    k4 = [r["runs"]["cdfl_topk"]["k4"] for r in ranks]
    require(all(x["bitwise"] for x in k4), f"{tag} (a): K4's sharded form is "
            "not bitwise its plain version and the unsharded K4")
    key_bytes = k4[0]["key_bytes"] + 2 * k4[0]["rows"]
    k4_bound_ms = key_bytes / HBM_BYTES_PER_S * 1e3
    print(f"{tag} (a) K4-sharded on the first gossip step's gaps of every "
          "leaf, bitwise its plain version and the unsharded K4 on the "
          "gathered rows, every rank: " + json.dumps(
              [{k: x[k] for k in ("ms", "collective_ms", "plain_ms",
                                  "key_bytes", "rows", "launches")}
               for x in k4])
          + f"; rank 0's count and pick kernels {k4[0]['device_ms']} ms on "
          f"the device, bound {k4_bound_ms} ms (share "
          f"{k4_bound_ms / k4[0]['device_ms']})")
    k1 = [r["runs"]["dfl"].get("k1") for r in ranks]
    if all(x is not None for x in k1):
        require(all(x["bitwise"] for x in k1), f"{tag} (a): K1's received "
                "form is not bitwise its plain version")
        k1_bound_ms = k1[0]["bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"{tag} (a) K1-received on each rank's first plain gossip "
              "step, bitwise its plain version; rank 0 " + json.dumps(
                  {k: k1[0][k] for k in ("deg", "ms", "plain_ms",
                                         "library_ms", "bytes")})
              + f", bound {k1_bound_ms} ms (share "
              f"{k1_bound_ms / k1[0]['ms']}), from DRAM")
        K["gossip_mix_received"].max_abs_err = max(
            K["gossip_mix_received"].max_abs_err,
            max(x["max_abs_err"] for x in k1))

    def tree_rel(runs):
        """The whole tree's relative Frobenius difference, every rank's
        blocks summed (a block held twice, as a leaf replicated along an
        axis is, counts twice in both sums)."""
        num = sum(v[0] for r in runs for v in r["diffs"].values())
        den = sum(v[1] for r in runs for v in r["diffs"].values())
        return math.sqrt(num / den)

    for label, compression, _, ref in cell.runs:
        runs = [r["runs"][label] for r in ranks]
        want = dense[ref]["metrics"]
        for r in runs:
            require(r["launches"] == expect_launches(K, **r["expect"]),
                    f"{tag} (b) {label}: launches {r['launches']}, expected "
                    f"{r['expect']}")
            require((r["builds"], r["captures"]) == (1, 0),
                    f"{tag} (b) {label}: {r['builds']} builds, "
                    f"{r['captures']} captures; expected 1 and 0")
            require(all(math.isfinite(v) for v in r["metrics"].values()),
                    f"{tag} (b) {label}: non-finite metrics {r['metrics']}")
        # per leaf, the largest absolute difference is printed (the norms
        # are initialised to 0, so a leaf's own relative reading is no
        # scale)
        worst = {k: max(r["diffs"][k][2] for r in runs)
                 for k in runs[0]["diffs"]}
        got = {"params": tree_rel(runs),
               "loss": abs(runs[0]["metrics"]["loss"] - want["loss"])
               / abs(want["loss"]),
               "consensus_sq": abs(runs[0]["metrics"]["consensus_sq"]
                                   - want["consensus_sq"])
               / max(abs(want["consensus_sq"]), FIG_CONSENSUS_FLOOR)}
        print(f"{tag} (b) {label}: mesh {json.dumps(runs[0]['metrics'])} "
              f"dense {json.dumps(want)} rel diffs {json.dumps(got)} "
              f"max abs diff a leaf {json.dumps(worst)} launches a rank "
              f"{json.dumps(runs[0]['launches'])}")
        if label == "control":
            control = got
            if gate:
                require(all(control[k] > lim for k, lim in cell.rtol.items()),
                        f"{tag} control {cell.control} within a limit "
                        f"{control}, limits {cell.rtol}")
        else:
            for k, v in got.items():
                readings[k] = max(readings.get(k, 0.0), v)
            if gate:
                for k, lim in cell.rtol.items():
                    require(got[k] <= lim, f"{tag} (b) {label}: {k} rel "
                            f"diff {got[k]} beyond {lim}")
        if label != "control":
            add_launches(K, {k: sum(r["launches"][k] for r in runs)
                             for k in ("gossip_mix_received",)
                             if k in runs[0]["expect"]})
        if cell.twin and label != "control":
            twins = [r["twin"] for r in runs]
            for r, tw in zip(runs, twins):
                require(tw["launches"] == expect_launches(K, **tw["expect"]),
                        f"{tag} twin {label}: launches {tw['launches']}, "
                        f"expected {tw['expect']}")
                require((tw["builds"], tw["captures"]) == (1, 0),
                        f"{tag} twin {label}: {tw['builds']} builds, "
                        f"{tw['captures']} captures; expected 1 and 0")
            require(all(tw["bitwise"] for tw in twins),
                    f"{tag} twin {label}: a rank's blocks on the pod "
                    f"{cell.twin} mesh differ from the single-pod run's")
            worst_twin = {k: max(tw["metrics_rel"][k] for tw in twins)
                          for k in twins[0]["metrics_rel"]}
            require(all(v <= MESH_TWIN_RTOL for v in worst_twin.values()),
                    f"{tag} twin {label}: metrics rel diffs {worst_twin} "
                    f"beyond {MESH_TWIN_RTOL}")
            add_launches(K, {k: sum(tw["launches"][k] for tw in twins)
                             for k in ("gossip_mix_received",)})
            print(f"{tag} twin {label}: pod {cell.twin} x data "
                  f"{cell.grid[0] // cell.twin} x model {cell.grid[1]}, "
                  "every rank's parameters and estimates bitwise the "
                  "single-pod run's; metrics " + json.dumps(
                      twins[0]["metrics"]) + " rel diffs "
                  + json.dumps(worst_twin) + " round s a rank "
                  + json.dumps([tw["s"] for tw in twins]))
        # (c): the round's costs on each rank
        print(f"{tag} (c) {label}: round s a rank " + json.dumps(
            [r["s"] for r in runs]) + " collectives' share " + json.dumps(
            [r["collective_s"] / r["s"] for r in runs])
            + " exchange's share " + json.dumps(
                [r["exchange_s"] / r["s"] for r in runs])
            + " bytes exchanged a gossip step a rank " + json.dumps(
                [r["exchange_bytes_step"] for r in runs])
            + " gathered / reduced bytes and collective s a local step "
            "(rank 0) " + json.dumps(runs[0]["local"])
            + " peak bytes a rank " + json.dumps([r["peak"] for r in runs])
            + " build s a rank " + json.dumps([r["build_s"] for r in runs])
            + " compare s a rank " + json.dumps([r["compare_s"] for r in runs])
            + (" dense round s " + json.dumps(dense[label]["s"])
               + " its file s " + json.dumps(dense[label]["save_s"])
               + " dense peak bytes " + json.dumps(dense[label]["peak"])
               if label in dense else ""))
    print(f"{tag} (b) largest sound readings " + json.dumps(readings)
          + " control " + json.dumps(control) + " limits "
          + json.dumps(cell.rtol))
    k = K["topk_threshold_sharded"]
    k.launches += sum(r["runs"]["cdfl_topk"]["launches"][
        "topk_threshold_sharded"] for r in ranks)
    k.max_abs_err = max([k.max_abs_err] + [x["max_abs_err"] for x in k4])
    print(f"{tag} (a) K4-sharded rank 0: count and pick "
          f"{k4[0]['device_ms']} ms, torch.topk on the gathered rows "
          f"{k4[0]['library_ms']} ms, bound {k4_bound_ms} ms over "
          f"{k4[0]['rows']} rows")
    if cell is MESH:
        # the record's time: rank 0's count and pick kernels on the device
        # over its keys, read once, and its thresholds written once (bf16)
        k.ms, k.plain_ms = k4[0]["device_ms"], k4[0]["plain_ms"]
        k.library_ms = k4[0]["library_ms"]
        k.add_bound(key_bytes, 0)
    secs = time.perf_counter() - t_phase
    print(f"{tag} (c) phase {secs:.1f} s (budget {cell.budget_s} s), ranks "
          + json.dumps([r["s"] for r in ranks]) + " of them waiting for "
          "the dense rounds " + json.dumps([r["wait_s"] for r in ranks])
          + " (a) s "
          + json.dumps(ranks[0]["runs"]["cdfl_topk"]["k4_s"]) + ", backend "
          + ranks[0]["backend"] + ", mesh " + json.dumps(cell.shape)
          + f", {free} bytes free for the dense "
          "rounds' files; " + card_line())
    require(not gate or secs <= cell.budget_s,
            f"{tag} phase took {secs:.1f} s, over its {cell.budget_s} s")


def run_phase(name, phase):
    """Run one phase and print its time; a phase that raises prints
    ``phase NAME failed: <type>: <message>`` and the exception goes on."""
    t0 = time.perf_counter()
    try:
        phase()
    except BaseException as e:
        print(f"phase {name} failed: {type(e).__name__}: {e}", flush=True)
        raise
    print(f"phase {name} time: {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import build

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    libs = []
    run_phase("build", lambda: libs.extend(build.build_all()))
    t_build = time.perf_counter() - t0
    print(f"build: {len(libs)} libraries in {t_build:.2f} s -> "
          f"{build.BUILD_DIR}")

    K = {k.name: k for k in (
        Kernel("gossip_mix", "src/repro_torch/kernels/csrc/gossip_mix.cu",
               "src/repro/kernels/gossip_mix.py:34", True),
        Kernel("gossip_mix_received",
               "src/repro_torch/kernels/csrc/gossip_mix.cu",
               "src/repro/kernels/gossip_mix.py:34", True),
        Kernel("choco_qsgd", "src/repro_torch/kernels/csrc/choco_fused.cu",
               "src/repro/kernels/choco_fused.py:65", False),
        Kernel("choco_topk", "src/repro_torch/kernels/csrc/choco_fused.cu",
               "src/repro/kernels/choco_fused.py:108", False),
        Kernel("topk_threshold", "src/repro_torch/kernels/csrc/topk.cu",
               "src/repro/kernels/topk.py:51", True),
        Kernel("topk_threshold_sharded",
               "src/repro_torch/kernels/csrc/topk.cu",
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
        "planner": lambda: run_planner_phase(K),
        "lm": lambda: run_lm_phase(K),
        "serve": run_serve_phase,
        "telemetry": lambda: run_telemetry_phase(K),
        "sparse": lambda: run_sparse_phase(K),
        "roofline": lambda: run_roofline_phase(K),
        "bench_kernels": run_bench_kernels_phase,
        "analysis": lambda: run_analysis_phase(K),
        "mesh": lambda: run_mesh_phase(K),
        "mesh_dp": lambda: run_mesh_phase(K, cell=MESH_DP),
        "mesh_pod": lambda: run_mesh_phase(K, cell=MESH_POD)}
    # phases run only when named after --only: readings ungated, or a part
    # of a phase above alone
    only = {
        "lm_calibrate": lambda: run_lm_phase(K, gate=False),
        "sparse_calibrate": lambda: run_sparse_phase(K, gate=False),
        "roofline_calibrate": lambda: run_roofline_phase(K, gate=False),
        "serve_calibrate": lambda: run_serve_phase(gate=False),
        "figures_calibrate": lambda: run_figures(
            K, gate=False, controls=FIG_CONTROLS),
        "pipeline_calibrate": lambda: run_pipeline_phase(
            K, gate=False, controls=(("gossip_mix_many", "x_shift", 1e-4),
                                     ("gossip_mix_many", "x_shift", 1e-3),
                                     ("gossip_mix_many", "x_scale", 1e-4))),
        "lm_kernels": lambda: lm_kernel_times(dataclasses.replace(
            REGISTRY[LM_FULL_ARCH].model, num_layers=LM_FULL_LAYERS), True),
        "sparse_kernels": lambda: received_kernel_phase(K),
        "mesh_calibrate": lambda: run_mesh_phase(K, gate=False),
        "mesh_dp_calibrate": lambda: run_mesh_phase(K, gate=False,
                                                    cell=MESH_DP),
        "mesh_pod_calibrate": lambda: run_mesh_phase(K, gate=False,
                                                     cell=MESH_POD)}
    if sys.argv[1:2] == ["--only"]:
        # a subset of the phases, for work on the card; no result line
        print(card_line())
        for name in sys.argv[2:]:
            run_phase(name, {**phases, **only}[name])
        return 0
    for name, phase in phases.items():
        run_phase(name, phase)
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
