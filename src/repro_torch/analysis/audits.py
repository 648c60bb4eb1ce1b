"""Audits of the port's dispatch artifacts: what the lint cannot see.

Ported from ``repro.analysis.audits``. The reference reads its invariants
off the lowered and optimized HLO of the production superstep; the port
has no HLO, so each invariant is read off what a dispatch leaves behind,
and each ``audit_*`` function is a pure function over those records,
testable on synthetic records and deliberately broken fixtures:

* **donation** — every ``DFLState`` leaf keeps its ``data_ptr()`` across
  a dispatch with ``donate=True`` (``state_pointers`` before and after).
  A leaf that moved is a copy of the state the caller thought was kept in
  place: twice the state's memory, and a graph's buffers out of step.
* **recompile** — ``RoundExecutor.compile_count`` and ``capture_count``
  do not move after the warmup across dispatches of other schedule values
  (trajectories, masks, cohorts): a schedule value that reached a build
  or a capture would cost one on every re-plan.
* **telemetry-neutrality** — a dispatch with a live
  ``repro_torch.obs.Telemetry`` sink is bitwise the same dispatch without
  one (``dispatch_record``: a digest of the state's and the metrics'
  bytes), with the same builds and captures. The sink must have seen a
  ``compile`` event, or its hooks never ran and the audit fails as
  vacuous.
* **collective-matching** — the (src, dst) pairs of the sends that
  ``core.sharded.NodeGroup.shift_exchange`` made (``NodeGroup.sends``,
  a count for each pair) are exactly ``expected_shift_pairs(topology)``:
  no shift missing (a node not gossiping), no pair extra (traffic the
  wire accounting never priced), each pair once a gossip step, and each
  rank's bytes the packed size times the shifts times the gossip steps
  (``NodeGroup.exchange_bytes``).

``run_production_audits()`` builds the small real artifact of the
reference (ring(N), tau maxima (3, 2), 2 rounds, a quadratic loss on ``w``
of dim 33, ``sgd(0.1)``) on ``device`` and runs the nine audits under the
reference's names: the four above on the dense executor and the sparse
ranks, plus **participation-recompile** (all-ones, crash and sporadic
mask rows build and capture nothing), **participation-collectives**
(masked rows still send every shift: masks gate weights, not sends),
**overlap-recompile** and **overlap-collectives** (``overlap="pipeline"``,
the drain's exchange included) and **cohort-recompile** (the batched
engine's identity cohort and two ``CohortSampler`` draws). The sparse
ranks are spawned once (``core.sharded.spawn``) for the three collective
audits together. ``dense_audits(build)`` runs the five dense audits on
any executor ``build`` makes, such as the full-width CIFAR one that
``chip_smoke.py`` feeds it.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import tempfile
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.dfl import DFLConfig, DFLState, init_state
from repro_torch.core.executor import RoundExecutor
from repro_torch.core.sharded import local_rows, pack_layout, spawn
from repro_torch.core.topology import ring
from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.optim import sgd

__all__ = [
    "AUDIT_NAMES",
    "AuditResult",
    "state_pointers",
    "audit_donation",
    "audit_recompile",
    "tensor_digest",
    "dispatch_record",
    "audit_telemetry_neutrality",
    "expected_shift_pairs",
    "audit_collective_matching",
    "build_audit_executor",
    "build_cohort_audit_executor",
    "dense_audits",
    "sparse_audit_records",
    "run_production_audits",
]

# the reference's nine results, in its order (repro.analysis.audits)
AUDIT_NAMES = ("donation", "recompile", "collective-matching",
               "telemetry-neutrality", "participation-recompile",
               "participation-collectives", "overlap-recompile",
               "overlap-collectives", "cohort-recompile")
TAUS_A = [[1, 1], [1, 1]]
TAUS_B = [[3, 0], [2, 2]]
MASK_TAUS = [[1, 1], [2, 1]]
_TAU_LABELS = ["taus=[[1,1],[1,1]]", "taus=[[3,0],[2,2]]"]


@dataclasses.dataclass
class AuditResult:
    name: str
    ok: bool
    detail: str
    data: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "detail": self.detail,
                "data": self.data}


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------


def state_pointers(state: DFLState) -> Dict[str, int]:
    """``{leaf path: data_ptr()}`` over every tensor of the state's
    ``params``, ``opt_state`` and ``hat_params``."""
    out: Dict[str, int] = {}

    def walk(path: str, tree: Any) -> None:
        if torch.is_tensor(tree):
            out[path] = tree.data_ptr()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{path}/{k}", v)
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(f"{path}/{i}", v)

    for field in ("params", "opt_state", "hat_params"):
        walk(field, getattr(state, field))
    return out


def audit_donation(before: Mapping[str, int], after: Mapping[str, int],
                   name: str = "donation") -> AuditResult:
    """Every leaf of ``before`` (``state_pointers`` of the state passed to
    a ``donate=True`` dispatch) must have the same ``data_ptr()`` in
    ``after`` (the returned state's)."""
    moved = [k for k in before if after.get(k) != before[k]]
    data = {"leaves": len(before), "moved": moved}
    if not before:
        return AuditResult(name, False, "no state leaves recorded — the "
                           "audit would be vacuous", data)
    if moved:
        return AuditResult(name, False,
                           f"state leaves NOT kept in place: {moved} — the "
                           "dispatch returned copies (check donate=True)",
                           data)
    return AuditResult(name, True,
                       f"all {len(before)} state leaves kept in place", data)


# ---------------------------------------------------------------------------
# recompile
# ---------------------------------------------------------------------------


def audit_recompile(counts: Sequence[Tuple[int, int]],
                    labels: Optional[Sequence[str]] = None,
                    name: str = "recompile") -> AuditResult:
    """``counts``: ``(compile_count, capture_count)`` after the warmup,
    then after each dispatch of another schedule value (same shapes). They
    must all be equal: a build or a capture after the warmup means a
    schedule value reached one, and every re-plan pays it."""
    labels = list(labels or range(len(counts)))
    rows = [(int(b), int(c)) for b, c in counts]
    data = {"counts": {str(lab): {"builds": b, "captures": c}
                       for lab, (b, c) in zip(labels, rows)}}
    if len(rows) < 2:
        return AuditResult(name, False, "needs the warmup's counts and at "
                           "least one dispatch's", data)
    if len(set(rows)) != 1:
        return AuditResult(
            name, False,
            f"builds or captures moved after the warmup {data['counts']} — "
            "a schedule value reached a build or a capture", data)
    b, c = rows[0]
    return AuditResult(
        name, True,
        f"{len(rows) - 1} dispatches after the warmup: builds {b} and "
        f"captures {c} unchanged", data)


# ---------------------------------------------------------------------------
# telemetry neutrality
# ---------------------------------------------------------------------------


def tensor_digest(tensors: Iterable[torch.Tensor]) -> str:
    """A content hash of the tensors' dtypes, shapes and bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).contiguous().view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def dispatch_record(executor: RoundExecutor, state: DFLState,
                    metrics: Mapping[str, torch.Tensor]) -> dict:
    """What a dispatch left: the digest of the state's tensors and the
    metrics (by name), its round index, and the executor's builds and
    captures. Reads the device (call it after the dispatch)."""
    tensors = ([t for t in tree_leaves((state.params, state.opt_state,
                                        state.hat_params))
                if torch.is_tensor(t)]
               + [metrics[k] for k in sorted(metrics)])
    return {"digest": tensor_digest(tensors), "round_idx": state.round_idx,
            "builds": executor.compile_count,
            "captures": executor.capture_count}


def audit_telemetry_neutrality(bare: Mapping[str, Any],
                               instrumented: Mapping[str, Any],
                               events: Sequence[Mapping[str, Any]],
                               name: str = "telemetry-neutrality"
                               ) -> AuditResult:
    """``bare`` and ``instrumented``: ``dispatch_record`` of the same
    dispatch without and with a live sink; ``events``: the sink's. The two
    must be bitwise equal with the same builds and captures, and the sink
    must hold a ``compile`` event (else its hooks never ran and the
    comparison is vacuous)."""
    compiles = sum(1 for e in events if e.get("type") == "compile")
    keys = ("digest", "round_idx", "builds", "captures")
    data = {"bare": {k: bare[k] for k in keys},
            "instrumented": {k: instrumented[k] for k in keys},
            "compile_events": compiles}
    if not compiles:
        return AuditResult(name, False, "the sink saw no compile event — its "
                           "hooks never ran, so the comparison is vacuous",
                           data)
    moved = [k for k in keys if bare[k] != instrumented[k]]
    if moved:
        return AuditResult(
            name, False,
            f"telemetry CHANGED the dispatch ({moved} differ: "
            f"{data['bare']} != {data['instrumented']}) — a hook touched a "
            "device value, a build or a capture", data)
    return AuditResult(
        name, True,
        f"the dispatch with a live sink is bitwise the bare one "
        f"({bare['digest']}), builds and captures equal", data)


# ---------------------------------------------------------------------------
# collective matching
# ---------------------------------------------------------------------------


def expected_shift_pairs(topology) -> Dict[int, frozenset]:
    """shift s -> the pair set {(src, (src+s) % N)} its sends make (see
    mixing.mix_shifts / NodeGroup.shift_exchange)."""
    n = topology.num_nodes
    return {
        int(s): frozenset((src, (src + int(s)) % n) for src in range(n))
        for s, _ in topology.shifts()
    }


def _pairs(ps) -> List[List[int]]:
    return sorted(list(p) for p in ps)


def audit_collective_matching(sends: Mapping[Tuple[int, int], int],
                              topology, *,
                              gossip_steps: Optional[int] = None,
                              bytes_sent: Optional[Mapping[int, int]] = None,
                              packed_bytes: Optional[int] = None,
                              name: str = "collective-matching"
                              ) -> AuditResult:
    """``sends``: how many sends the ranks made to each (src, dst) (their
    ``NodeGroup.sends``). Grouped by shift ``(dst - src) mod N``, the pair
    sets must be exactly the topology's: no missing shift, no extra or
    wrong pair. With ``gossip_steps``, each expected pair is sent once a
    gossip step; with ``bytes_sent`` (rank -> bytes) and ``packed_bytes``
    (the packed buffer of one send), each of the N ranks sent
    ``packed_bytes x shifts x gossip_steps``."""
    n = topology.num_nodes
    counts = {(int(s), int(d)): int(c) for (s, d), c in sends.items() if c}
    by_shift: Dict[int, set] = collections.defaultdict(set)
    for src, dst in counts:
        by_shift[(dst - src) % n].add((src, dst))
    observed = {frozenset(p) for p in by_shift.values()}
    expected_by_shift = expected_shift_pairs(topology)
    expected = set(expected_by_shift.values())
    data = {"num_sends": sum(counts.values()),
            "sends": [[s, d, c] for (s, d), c in sorted(counts.items())],
            "observed": sorted(_pairs(p) for p in observed),
            "expected": sorted(_pairs(p) for p in expected)}
    if not expected:
        return AuditResult(name, not counts,
                           "topology has no shifts; the ranks must send "
                           "nothing", data)
    missing, extra = expected - observed, observed - expected
    if missing or extra:
        return AuditResult(
            name, False,
            f"send pairs != Topology.shifts(): missing shifts "
            f"{sorted(_pairs(p) for p in missing)}, unexpected "
            f"{sorted(_pairs(p) for p in extra)}", data)
    problems = []
    if gossip_steps is not None:
        uneven = {f"{s}->{d}": c for (s, d), c in sorted(counts.items())
                  if c != gossip_steps}
        data["uneven"] = uneven
        if uneven:
            problems.append(f"pairs not sent once a gossip step "
                            f"({gossip_steps}): {uneven}")
    if bytes_sent is not None and packed_bytes is not None:
        want = packed_bytes * len(expected_by_shift) * (gossip_steps or 0)
        wrong = {int(r): int(b) for r, b in bytes_sent.items() if b != want}
        absent = sorted(set(range(n)) - {int(r) for r in bytes_sent})
        data.update(bytes_per_rank=want, wrong_bytes=wrong,
                    ranks_missing=absent)
        if wrong or absent:
            problems.append(f"bytes sent {wrong} (ranks missing {absent}) "
                            f"!= {packed_bytes} x {len(expected_by_shift)} "
                            f"shifts x {gossip_steps} steps = {want}")
    if problems:
        return AuditResult(name, False, "; ".join(problems), data)
    return AuditResult(
        name, True,
        f"{data['num_sends']} sends, pair sets == shifts({topology.name})",
        data)


# ---------------------------------------------------------------------------
# the production artifact
# ---------------------------------------------------------------------------


def _quad_loss(params, b):
    return torch.mean((params["w"][None] - b[0]) ** 2)


def _quad_batches(rounds: int, tau1_max: int, nodes: int, dim: int,
                  device: torch.device):
    x = np.random.default_rng(1).normal(
        size=(rounds, tau1_max, nodes, 4, dim)).astype(np.float32)
    return (torch.from_numpy(x).to(device),)


def build_audit_executor(num_nodes: int = 8, *, tau1_max: int = 3,
                         tau2_max: int = 2, rounds: int = 2, dim: int = 33,
                         device="cuda", group=None, **executor_kw):
    """A small but REAL executor: ring(N), dynamic taus, donated state —
    the dense engine on ``device``, or with ``group`` (a
    ``core.sharded.NodeGroup`` of N ranks) this rank's sparse engine on the
    group's device. ``executor_kw`` go to ``RoundExecutor`` (``telemetry``,
    ``participation``, ``overlap``, ``donate``). Returns ``(executor,
    state, batches, topology)``; batch leaves ``[rounds, tau1_max, ...]``."""
    dev = group.device if group is not None else resolve_device(device)
    topo = ring(num_nodes)
    cfg = DFLConfig(tau1=tau1_max, tau2=tau2_max, topology=topo)
    opt = sgd(0.1)
    engine = {} if group is None else {"engine": "sparse", "group": group}
    ex = RoundExecutor(cfg, _quad_loss, opt, **engine, **executor_kw)
    rows = num_nodes if group is None else 1
    state = init_state({"w": torch.zeros(rows, dim, device=dev)}, rows, opt,
                       stacked=True)
    batches = _quad_batches(rounds, tau1_max, num_nodes, dim, dev)
    if group is not None:
        batches = local_rows(batches, group, 2)
    return ex, state, batches, topo


def build_cohort_audit_executor(population: int = 32, cohort: int = 8, *,
                                tau1_max: int = 3, tau2_max: int = 2,
                                rounds: int = 2, dim: int = 33,
                                device="cuda"):
    """The batched engine's small real executor: ring(C) over a
    ``population``-node state, dynamic taus, cohort ids as schedule data.
    Returns ``(executor, state, batches, topology)``."""
    dev = resolve_device(device)
    topo = ring(cohort)
    cfg = DFLConfig(tau1=tau1_max, tau2=tau2_max, topology=topo)
    opt = sgd(0.1)
    ex = RoundExecutor(cfg, _quad_loss, opt, engine="batched",
                       population=population)
    state = init_state({"w": torch.zeros(population, dim, device=dev)},
                       population, opt, stacked=True)
    return ex, state, _quad_batches(rounds, tau1_max, cohort, dim, dev), topo


def _counts(ex: RoundExecutor) -> Tuple[int, int]:
    return ex.compile_count, ex.capture_count


def _launched(before: Mapping[str, int]) -> Dict[str, int]:
    """Kernel launches since ``before`` (a copy of ``ops.LAUNCHES``)."""
    return {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()
            if v != before.get(k, 0)}


def _recompile_across(ex: RoundExecutor, state: DFLState, batches: Any,
                      trajectories: Mapping[str, Any],
                      name: str) -> AuditResult:
    """``audit_recompile`` over ``ex``'s warmup and one dispatch of each
    trajectory (by label); ``data["launches"]`` those dispatches'."""
    ex.warmup(state, batches)
    counts = [_counts(ex)]
    before = dict(ops.LAUNCHES)
    for rows in trajectories.values():
        state, _ = ex.dispatch_trajectory(state, batches, rows)
        counts.append(_counts(ex))
    result = audit_recompile(counts, ["warmup", *trajectories], name=name)
    result.data["launches"] = _launched(before)
    return result


def dense_audits(build: Callable[..., Tuple[RoundExecutor, DFLState, Any,
                                            Any]]) -> List[AuditResult]:
    """donation, recompile, telemetry-neutrality, participation-recompile
    and overlap-recompile on the executors ``build(**executor_kw)`` makes
    (it returns ``(executor, state, batches, topology)``, a fresh state
    each call, batch leaves ``[2, tau1_max, ...]`` with tau maxima of at
    least (3, 2)). Each result's ``data["launches"]`` holds the kernel
    launches of the dispatches it audited (none on the CPU)."""
    from repro_torch.faults import FaultPlan, NodeCrash, SporadicParticipation
    from repro_torch.obs import Telemetry

    ex, state, batches, topo = build()
    ex.warmup(state, batches)
    counts = [_counts(ex)]
    ptrs = state_pointers(state)
    before = dict(ops.LAUNCHES)
    state, m = ex.dispatch_trajectory(state, batches, TAUS_A)
    first = _launched(before)
    donation = audit_donation(ptrs, state_pointers(state))
    bare = dispatch_record(ex, state, m)
    counts.append(_counts(ex))
    state, _ = ex.dispatch_trajectory(state, batches, TAUS_B)
    counts.append(_counts(ex))
    recompile = audit_recompile(counts, ["warmup", *_TAU_LABELS])
    donation.data["launches"] = first
    recompile.data["launches"] = _launched(before)

    # the same first dispatch through an executor with a live sink: its
    # warmup's build and captures emit the compile events
    tel = Telemetry(meta={"audit": "telemetry-neutrality"})
    ex_t, state_t, batches_t, _ = build(telemetry=tel)
    ex_t.warmup(state_t, batches_t)
    before = dict(ops.LAUNCHES)
    state_t, m_t = ex_t.dispatch_trajectory(state_t, batches_t, TAUS_A)
    neutral = audit_telemetry_neutrality(
        bare, dispatch_record(ex_t, state_t, m_t), tel.events)
    neutral.data["launches"] = _launched(before)

    # participation: masks are schedule data on the [K, 2 + N + E] rows
    ex_p, state_p, batches_p, _ = build(participation=True)
    taus = np.asarray(MASK_TAUS, np.int32)
    crash = FaultPlan(topo, (NodeCrash(3, 0, 8),), seed=0)
    sporadic = FaultPlan(topo, (SporadicParticipation(0.6, 0.5, 0, 8),),
                         seed=7)
    participation = _recompile_across(ex_p, state_p, batches_p, {
        "all-ones": np.concatenate(
            [taus, np.ones((len(taus), ex_p.row_width - 2), np.int32)],
            axis=1),
        "crash(node=3)": crash.mask_trajectory(taus),
        "sporadic(p=0.6/0.5)": sporadic.mask_trajectory(taus)},
        "participation-recompile")

    # overlap: the pipelined superstep keeps the schedule as data too
    ex_o, state_o, batches_o, _ = build(overlap="pipeline")
    overlap = _recompile_across(ex_o, state_o, batches_o,
                                dict(zip(_TAU_LABELS, (TAUS_A, TAUS_B))),
                                "overlap-recompile")
    return [donation, recompile, neutral, participation, overlap]


def _cohort_recompile(device) -> AuditResult:
    """cohort-recompile: the identity cohort and CohortSampler seeds 3 and
    11 (at round 0 and round 5) on the batched engine."""
    from repro_torch.faults import CohortSampler

    ex, state, batches, topo = build_cohort_audit_executor(device=device)
    identity = np.asarray(MASK_TAUS, np.int32)
    c, e = topo.num_nodes, topo.num_edges
    return _recompile_across(ex, state, batches, {
        "identity-cohort": identity,
        "sampler(seed=3)@r0": CohortSampler(
            population=ex.population, cohort=c, seed=3).cohort_trajectory(
                identity, num_edges=e),
        "sampler(seed=11)@r5": CohortSampler(
            population=ex.population, cohort=c, seed=11).cohort_trajectory(
                identity, round0=5, num_edges=e)}, "cohort-recompile")


# the sparse ranks' three cases and their executor keywords
_SPARSE_CASES = {"collective-matching": {},
                 "participation-collectives": {"participation": True},
                 "overlap-collectives": {"overlap": "pipeline"}}


def _sparse_rows(case: str, topo) -> np.ndarray:
    if case == "participation-collectives":
        from repro_torch.faults import FaultPlan, NodeCrash

        return FaultPlan(topo, (NodeCrash(3, 0, 8),), seed=0
                         ).mask_trajectory(np.asarray(MASK_TAUS, np.int32))
    return np.asarray(TAUS_B if case == "collective-matching" else TAUS_A,
                      np.int32)


def _sparse_audit_rank(group, out_dir: str, num_nodes: int) -> None:
    """One rank of the sparse audits: for each case, a warmup, then one
    dispatch whose sends (the rise of ``group.sends``, as (src, dst, count)
    triples), bytes and launches are written to ``out_dir/rank<r>.json``."""
    out = {}
    for case, kw in _SPARSE_CASES.items():
        ex, state, batches, topo = build_audit_executor(
            num_nodes, group=group, **kw)
        rows = _sparse_rows(case, topo)
        ex.warmup(state, batches)
        s0, b0 = collections.Counter(group.sends), group.exchange_bytes
        before = dict(ops.LAUNCHES)
        state, _ = ex.dispatch_trajectory(state, batches, rows)
        out[case] = {
            "sends": [[s, d, c] for (s, d), c in
                      (group.sends - s0).items()],
            "bytes": group.exchange_bytes - b0,
            "packed_bytes": pack_layout(
                [x.reshape(-1) for x in tree_leaves(state.params)])[1],
            "gossip_steps": int(rows[:, 1].sum()),
            "launches": _launched(before)}
    with open(os.path.join(out_dir, f"rank{group.rank}.json"), "w") as f:
        json.dump(out, f)


def sparse_audit_records(num_nodes: int = 8, device="cuda",
                         timeout_s: float = 180.0) -> Dict[str, dict]:
    """Spawn ``num_nodes`` ranks once (``core.sharded.spawn``) and gather,
    for each collective audit, the sends of all ranks (``sends``: (src,
    dst) -> count), bytes (``bytes``: rank -> bytes), the packed size and
    gossip steps (rank 0's) and kernel launches (``launches``: rank ->
    counts)."""
    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="repro_torch_audit_")
    try:
        spawn(_sparse_audit_rank, num_nodes, (tmp, num_nodes),
              device=dev.type, timeout_s=timeout_s)
        ranks = []
        for r in range(num_nodes):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {case: {
        "sends": collections.Counter({(s, d): c for rk in ranks
                                      for s, d, c in rk[case]["sends"]}),
        "bytes": {r: rk[case]["bytes"] for r, rk in enumerate(ranks)},
        "packed_bytes": ranks[0][case]["packed_bytes"],
        "gossip_steps": ranks[0][case]["gossip_steps"],
        "launches": {r: rk[case]["launches"] for r, rk in enumerate(ranks)}}
        for case in _SPARSE_CASES}


def run_production_audits(num_nodes: int = 8, device="cuda"
                          ) -> List[AuditResult]:
    """The nine audits, under the reference's names and in its order, on
    ``device`` (the card unless asked for the CPU): the dense ones on
    ``build_audit_executor``, cohort-recompile on
    ``build_cohort_audit_executor``, the collective ones on ``num_nodes``
    spawned sparse ranks."""
    dev = resolve_device(device)
    results = {r.name: r for r in dense_audits(
        functools.partial(build_audit_executor, num_nodes, device=dev))}
    results["cohort-recompile"] = _cohort_recompile(dev)
    topo = ring(num_nodes)
    for case, rec in sparse_audit_records(num_nodes, dev).items():
        res = audit_collective_matching(
            rec["sends"], topo, gossip_steps=rec["gossip_steps"],
            bytes_sent=rec["bytes"], packed_bytes=rec["packed_bytes"],
            name=case)
        res.data["launches"] = rec["launches"]
        results[case] = res
    return [results[name] for name in AUDIT_NAMES]
