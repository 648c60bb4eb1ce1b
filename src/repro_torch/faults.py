"""Deterministic fault injection for sporadic DFL rounds.

One spec, two consumers: a ``FaultPlan`` turns a list of declarative fault
windows into (a) per-round participation masks — the ``[node_mask,
edge_mask]`` columns of the sporadic trajectory scanned by
``core.executor.RoundExecutor(participation=True)`` — and (b) priced
``planner.cost.Episode`` tariffs for the SAME windows, so the planner's
blocking baseline pays for exactly the outages the sporadic engine routes
around. That single-source-of-truth coupling is the point: a benchmark
(``benchmarks.bench_faults``) that injects faults from one object and
prices them from another can silently drift; here both derive from the
same ``FaultPlan``.

Semantics (matching ``core.dfl.round_body``):

- node_mask[i] = 0  — node i skips its local SGD steps this round (its
  params/opt state carry over); it STILL gossips. A crashed node that
  can neither compute nor talk is ``NodeCrash``: node mask + every
  incident edge masked.
- edge_mask[e] = 0  — edge e (canonical ``Topology.edges()`` order)
  gossips identity: its weight folds onto both endpoints' diagonals, so
  the effective mixing matrix stays symmetric doubly stochastic
  (``core.mixing.masked_mixing_matrix``).

Everything is deterministic: windowed faults are pure functions of the
round index; ``SporadicParticipation`` draws its Bernoulli masks from
``np.random.SeedSequence([seed, round_idx])`` so round r's masks never
depend on which rounds were evaluated before it (resume-safe, and
identical across the dense and sparse engines, which consume the same
trajectory rows).

Numpy only: fault plans are host-side schedule producers. This is a copy
of ``repro.faults`` with its imports pointed at the port
(``repro_torch.core.topology``, ``repro_torch.planner.cost``); its masks
and cohorts are the reference's, bitwise, and the port's executor reads
them as rows of ``RoundExecutor(participation=True)`` and
``RoundExecutor(engine="batched")`` trajectories.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple, Union

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.planner.cost import (
    CostModel,
    CostProcess,
    Episode,
    edge_outage,
)

__all__ = [
    "NodeCrash",
    "LinkOutage",
    "StragglerDelay",
    "LinkFlap",
    "SporadicParticipation",
    "FaultPlan",
    "CohortSampler",
    "load_fault_spec",
]


def _check_window(r_start: int, r_stop: int) -> None:
    if not (0 <= r_start < r_stop):
        raise ValueError(
            f"empty or negative fault window [{r_start}, {r_stop})")


@dataclasses.dataclass(frozen=True)
class NodeCrash:
    """Node ``node`` is down for rounds [r_start, r_stop): no local steps,
    and every incident edge is severed (the crashed node can't talk)."""

    node: int
    r_start: int
    r_stop: int

    def __post_init__(self):
        _check_window(self.r_start, self.r_stop)

    def active(self, r: int) -> bool:
        return self.r_start <= r < self.r_stop


@dataclasses.dataclass(frozen=True)
class LinkOutage:
    """The listed undirected edges are down for rounds [r_start, r_stop).
    Endpoints keep computing and keep gossiping over surviving edges."""

    edges: Tuple[Tuple[int, int], ...]
    r_start: int
    r_stop: int

    def __post_init__(self):
        _check_window(self.r_start, self.r_stop)
        object.__setattr__(
            self, "edges",
            tuple((min(i, j), max(i, j)) for (i, j) in self.edges))

    def active(self, r: int) -> bool:
        return self.r_start <= r < self.r_stop


@dataclasses.dataclass(frozen=True)
class StragglerDelay:
    """Node ``node`` runs ``slowdown``x slower for rounds [r_start,
    r_stop): it completes its local epoch only every ``slowdown``-th
    round (duty-cycle mask), but keeps gossiping its (stale) model.

    The duty cycle is phase-locked to the window: within it, node ``node``
    is unmasked on rounds where ``(r - r_start) % slowdown ==
    slowdown - 1`` — i.e. after each ``slowdown``-round stretch it has
    finally finished one epoch.
    """

    node: int
    slowdown: int
    r_start: int
    r_stop: int

    def __post_init__(self):
        _check_window(self.r_start, self.r_stop)
        if self.slowdown < 1:
            raise ValueError(f"slowdown must be >= 1, got {self.slowdown}")

    def active(self, r: int) -> bool:
        return self.r_start <= r < self.r_stop

    def computes(self, r: int) -> bool:
        return (r - self.r_start) % self.slowdown == self.slowdown - 1


@dataclasses.dataclass(frozen=True)
class LinkFlap:
    """Edge ``edge`` oscillates for rounds [r_start, r_stop): up for the
    first ``up_rounds`` of every ``period``-round cycle, down for the
    rest (an intermittently-associating wireless link)."""

    edge: Tuple[int, int]
    period: int
    up_rounds: int
    r_start: int
    r_stop: int

    def __post_init__(self):
        _check_window(self.r_start, self.r_stop)
        if not (1 <= self.up_rounds < self.period):
            raise ValueError(
                f"need 1 <= up_rounds < period, got up_rounds="
                f"{self.up_rounds} period={self.period}")
        i, j = self.edge
        object.__setattr__(self, "edge", (min(i, j), max(i, j)))

    def active(self, r: int) -> bool:
        return self.r_start <= r < self.r_stop

    def is_up(self, r: int) -> bool:
        return (r - self.r_start) % self.period < self.up_rounds


@dataclasses.dataclass(frozen=True)
class SporadicParticipation:
    """I.i.d. Bernoulli participation for rounds [r_start, r_stop): each
    node is up w.p. ``p_node``, each edge w.p. ``p_edge``, drawn from a
    per-round seed stream (see module docstring). This is the paper's
    sporadic-availability regime; the expected mixing matrix it induces
    is ``planner.bounds.expected_mixing``."""

    p_node: float
    p_edge: float
    r_start: int
    r_stop: int

    def __post_init__(self):
        _check_window(self.r_start, self.r_stop)
        for name in ("p_node", "p_edge"):
            p = getattr(self, name)
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {p}")

    def active(self, r: int) -> bool:
        return self.r_start <= r < self.r_stop


Fault = Union[NodeCrash, LinkOutage, StragglerDelay, LinkFlap,
              SporadicParticipation]

_KINDS = {
    "crash": NodeCrash,
    "outage": LinkOutage,
    "straggler": StragglerDelay,
    "flap": LinkFlap,
    "sporadic": SporadicParticipation,
}
_KIND_OF = {v: k for k, v in _KINDS.items()}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered set of fault windows over a fixed topology.

    ``masks(r)`` is the AND-composition of every active fault's masks at
    round ``r`` (a node masked by any fault is masked; an edge masked by
    any fault — or incident to a crashed node — is masked).
    """

    topology: Topology
    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        eidx = self.topology.edge_index()
        for f in self.faults:
            if isinstance(f, NodeCrash) or isinstance(f, StragglerDelay):
                if not (0 <= f.node < self.topology.num_nodes):
                    raise ValueError(
                        f"fault names node {f.node} but "
                        f"{self.topology.name} has "
                        f"{self.topology.num_nodes} nodes")
            elif isinstance(f, LinkOutage):
                for e in f.edges:
                    if e not in eidx:
                        raise ValueError(
                            f"fault names edge {e} absent from "
                            f"{self.topology.name}")
            elif isinstance(f, LinkFlap):
                if f.edge not in eidx:
                    raise ValueError(
                        f"fault names edge {f.edge} absent from "
                        f"{self.topology.name}")

    # -- mask production ----------------------------------------------------

    def masks(self, round_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(node_mask [N], edge_mask [E]) int32 at ``round_idx``."""
        topo = self.topology
        eidx = topo.edge_index()
        node_mask = np.ones(topo.num_nodes, dtype=np.int32)
        edge_mask = np.ones(topo.num_edges, dtype=np.int32)
        for f in self.faults:
            if not f.active(round_idx):
                continue
            if isinstance(f, NodeCrash):
                node_mask[f.node] = 0
                for e, k in eidx.items():
                    if f.node in e:
                        edge_mask[k] = 0
            elif isinstance(f, LinkOutage):
                for e in f.edges:
                    edge_mask[eidx[e]] = 0
            elif isinstance(f, StragglerDelay):
                if not f.computes(round_idx):
                    node_mask[f.node] = 0
            elif isinstance(f, LinkFlap):
                if not f.is_up(round_idx):
                    edge_mask[eidx[f.edge]] = 0
            elif isinstance(f, SporadicParticipation):
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, round_idx]))
                up_n = rng.random(topo.num_nodes) < f.p_node
                up_e = rng.random(topo.num_edges) < f.p_edge
                node_mask &= up_n.astype(np.int32)
                edge_mask &= up_e.astype(np.int32)
        return node_mask, edge_mask

    def mask_trajectory(
        self, taus: np.ndarray, round0: int = 0
    ) -> np.ndarray:
        """Widen a ``[K, 2]`` tau trajectory to the ``[K, 2 + N + E]``
        participation rows ``RoundExecutor(participation=True)`` scans
        (row k carries the masks of absolute round ``round0 + k``)."""
        taus = np.asarray(taus, dtype=np.int32)
        if taus.ndim != 2 or taus.shape[1] != 2:
            raise ValueError(
                f"expected a [K, 2] tau trajectory, got {taus.shape}")
        rows = []
        for k in range(taus.shape[0]):
            nm, em = self.masks(round0 + k)
            rows.append(np.concatenate([taus[k], nm, em]))
        return np.stack(rows).astype(np.int32) if rows else np.zeros(
            (0, 2 + self.topology.num_nodes + self.topology.num_edges),
            dtype=np.int32)

    def events(self, round_idx: int) -> List[Dict[str, Any]]:
        """Telemetry payloads for faults whose window STARTS or STOPS at
        ``round_idx`` (emitted as ``fault`` events by ``train.py``)."""
        out = []
        for f in self.faults:
            if round_idx == f.r_start:
                out.append(dict(self._spec_of(f), phase="start"))
            if round_idx == f.r_stop:
                out.append(dict(self._spec_of(f), phase="stop"))
        return out

    # -- pricing ------------------------------------------------------------

    def episodes(self, seconds_per_round: float, base_link=None,
                 residual: float = 1e-3) -> Tuple[Episode, ...]:
        """The same fault windows as deployment-clock ``Episode`` tariffs,
        for pricing the BLOCKING baseline: a run that refuses to skip
        work waits out every outage at the residual link rate, and waits
        for every straggler's slow epoch. ``base_link`` is the healthy
        LinkModel/WirelessLinks table tariffs derate from (unit LinkModel
        when omitted).

        ``SporadicParticipation`` contributes no tariff; its cost story
        lives in the masks (skipped work), not in a degraded link.
        """
        spr = float(seconds_per_round)
        if spr <= 0.0:
            raise ValueError(f"seconds_per_round must be > 0, got {spr}")
        link0 = base_link if base_link is not None else _unit_link()
        eps: List[Episode] = []
        # Compute stragglers compose natively (Episode compute scales
        # multiply), so each gets its own episode.
        for f in self.faults:
            if isinstance(f, StragglerDelay):
                eps.append(Episode(
                    t_start=f.r_start * spr, t_stop=f.r_stop * spr,
                    compute_scale=float(f.slowdown),
                    label=f"straggler@r{f.r_start}-{f.r_stop}"))
        # Link tariffs do NOT compose across episodes (a later episode's
        # link table replaces the earlier one's), so overlapping link
        # faults are flattened here into piecewise-constant windows, each
        # carrying the FULL composed table of every fault active in it.
        linky = [f for f in self.faults
                 if isinstance(f, (NodeCrash, LinkOutage, LinkFlap))]
        bounds = sorted({f.r_start for f in linky}
                        | {f.r_stop for f in linky})
        for a, b in zip(bounds, bounds[1:]):
            active = [f for f in linky
                      if f.r_start <= a and b <= f.r_stop]
            if not active:
                continue
            link = link0
            for f in active:
                if isinstance(f, NodeCrash):
                    down = [e for e in self.topology.edges() if f.node in e]
                    link = edge_outage(link, down, residual=residual)
                elif isinstance(f, LinkOutage):
                    link = edge_outage(link, list(f.edges),
                                       residual=residual)
                else:  # LinkFlap: time-averaged tariff — full rate for
                    # the up fraction of the cycle, residual for the rest
                    frac_down = 1.0 - f.up_rounds / f.period
                    res = (1.0 - frac_down) + frac_down * residual
                    link = edge_outage(link, [f.edge], residual=res)
            eps.append(Episode(
                t_start=a * spr, t_stop=b * spr, link=link,
                label="degraded@r{}-{}:{}".format(
                    a, b, "+".join(_KIND_OF[type(f)] for f in active))))
        return tuple(eps)

    def cost_process(self, base: CostModel, seconds_per_round: float,
                     residual: float = 1e-3) -> CostProcess:
        """Attach this plan's tariffs to ``base`` (episode link tables
        derate ``base.link``, so per-edge overrides survive)."""
        return CostProcess(base=base, episodes=self.episodes(
            seconds_per_round, base_link=base.link, residual=residual))

    # -- (de)serialization --------------------------------------------------

    @staticmethod
    def _spec_of(f: Fault) -> Dict[str, Any]:
        d = dataclasses.asdict(f)
        if "edges" in d:
            d["edges"] = [list(e) for e in d["edges"]]
        if "edge" in d:
            d["edge"] = list(d["edge"])
        d["kind"] = _KIND_OF[type(f)]
        return d

    def to_spec(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "faults": [self._spec_of(f) for f in self.faults]}

    @classmethod
    def from_spec(cls, topology: Topology,
                  spec: Dict[str, Any]) -> "FaultPlan":
        faults = []
        for fd in spec.get("faults", ()):
            fd = dict(fd)
            kind = fd.pop("kind")
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; "
                    f"expected one of {sorted(_KINDS)}")
            if "edges" in fd:
                fd["edges"] = tuple(tuple(e) for e in fd["edges"])
            if "edge" in fd:
                fd["edge"] = tuple(fd["edge"])
            faults.append(_KINDS[kind](**fd))
        return cls(topology=topology, faults=tuple(faults),
                   seed=int(spec.get("seed", 0)))


@dataclasses.dataclass(frozen=True)
class CohortSampler:
    """Uniform-without-replacement cohort sampling over a virtual
    population (the DFedAvg client-sampling regime, arXiv:2104.11375).

    Each round draws ``cohort`` distinct node ids from ``[0, population)``
    via ``np.random.SeedSequence([seed, round_idx])`` — the SAME per-round
    seed-stream discipline as ``SporadicParticipation``, so round r's
    cohort never depends on which rounds were evaluated before it
    (resume-safe: a checkpoint restart at round r redraws r's cohort
    bit-identically from (seed, r), with no sampler state to persist
    beyond ``DFLState.round_idx``).

    Draws are SORTED so that at full participation (``cohort ==
    population``) the draw is exactly ``arange(population)`` — the
    batched engine's identity cohort, which makes the sampled trajectory
    row degenerate bitwise to the legacy participation row
    (tests/test_cohort_sampling.py).

    ``cohort_trajectory`` composes with ``FaultPlan.mask_trajectory``:
    feed it the chaos plan's ``[K, 2 + C + E]`` rows and it splices the
    cohort ids in front of the masks, yielding the ``[K, 2 + 2C + E]``
    rows ``RoundExecutor(engine="batched")`` scans. Mask semantics are
    then *within-cohort*: ``node_mask[j]`` gates cohort slot j (i.e.
    virtual node ``ids[j]``), so a chaos plan built over the C-node
    cohort topology applies to whichever nodes were drawn this round.
    """

    population: int
    cohort: int
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.cohort <= self.population):
            raise ValueError(
                f"need 1 <= cohort <= population, got cohort={self.cohort} "
                f"population={self.population}")

    @property
    def rate(self) -> float:
        """Sampling rate C/V — the participation rate the planner prices
        via ``planner.bounds.sampling_availability``."""
        return self.cohort / self.population

    def draw(self, round_idx: int) -> np.ndarray:
        """Sorted int32 cohort ids for absolute round ``round_idx``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, round_idx]))
        ids = rng.choice(self.population, size=self.cohort, replace=False)
        return np.sort(ids).astype(np.int32)

    def cohort_trajectory(self, taus: np.ndarray, round0: int = 0,
                          num_edges: int = 0) -> np.ndarray:
        """Widen a trajectory with per-round cohort ids.

        Accepts ``[K, 2]`` rows (tau1, tau2) — padded with all-ones
        masks — or ``[K, 2 + C + E]`` participation rows (e.g. from
        ``FaultPlan.mask_trajectory`` over the cohort topology), and
        returns the ``[K, 2 + 2C + E]`` cohort rows of the batched
        engine (row k carries the draw of absolute round ``round0 + k``).
        ``num_edges`` (E) is required to disambiguate the input layout.
        """
        taus = np.asarray(taus, dtype=np.int32)
        c, e = self.cohort, int(num_edges)
        if taus.ndim != 2 or taus.shape[1] not in (2, 2 + c + e):
            raise ValueError(
                f"expected [K, 2] or [K, {2 + c + e}] rows "
                f"(tau1, tau2, node mask [{c}], edge mask [{e}]), "
                f"got shape {taus.shape}")
        if taus.shape[1] == 2:
            taus = np.concatenate(
                [taus, np.ones((taus.shape[0], c + e), np.int32)], axis=1)
        rows = [np.concatenate([taus[k, :2], self.draw(round0 + k),
                                taus[k, 2:]])
                for k in range(taus.shape[0])]
        return (np.stack(rows).astype(np.int32) if rows
                else np.zeros((0, 2 + 2 * c + e), dtype=np.int32))

    # -- (de)serialization ---------------------------------------------------

    def to_spec(self) -> Dict[str, Any]:
        return {"population": self.population, "cohort": self.cohort,
                "seed": self.seed}

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "CohortSampler":
        return cls(population=int(spec["population"]),
                   cohort=int(spec["cohort"]),
                   seed=int(spec.get("seed", 0)))


def _unit_link():
    from repro_torch.planner.cost import LinkModel
    return LinkModel(bytes_per_s=1.0)


def load_fault_spec(arg: str) -> Dict[str, Any]:
    """Parse ``train.py --faults``: inline JSON, or ``@path`` to a JSON
    file."""
    text = arg
    if arg.startswith("@"):
        with open(arg[1:], "r", encoding="utf-8") as fh:
            text = fh.read()
    spec = json.loads(text)
    if not isinstance(spec, dict) or "faults" not in spec:
        raise ValueError(
            'fault spec must be an object with a "faults" list, e.g. '
            '{"seed": 0, "faults": [{"kind": "crash", "node": 3, '
            '"r_start": 2, "r_stop": 6}]}')
    return spec
