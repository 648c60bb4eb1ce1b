"""Composable per-round cost models for DFL schedules.

A DFL round is ``tau1`` local-update steps plus ``tau2`` gossip steps; its
resource cost decomposes as

    time   = tau1 * t_compute_step + tau2 * t_gossip_step
    bits   = tau2 * copies * model_bits * compression_ratio      (per node)
    energy = tau1 * e_compute_step + tau2 * e_gossip_step

(under the pipelined executor, ``overlap="pipeline"``, the time term is
``tau1 * t_compute_step + max(0, tau2 * t_gossip_step - overlap_window)``
with the window equal to the local-phase time — gossip rides under the
next round's compute and only the overhang is paid; bits and energy are
unchanged)

where ``copies`` — the model copies each node receives per gossip step —
comes from ``mixing.gossip_copies_per_step(topology, engine)`` so the dense
all-gather lowering (N-1 copies) and the sparse per-neighbor engine
(max_degree copies) are priced correctly, and the compression ratio comes
from the C-DFL compressor's ``bits_per_value``. Link time is either a
single shared ``LinkModel`` or a ``WirelessLinks`` table with per-edge
bandwidth/SNR (Shannon capacity, in the spirit of arXiv:2308.06496's
resource-constrained DFL over wireless networks).

``CostModel.round_cost(tau1, tau2, compressor)`` is the one entry point;
the reference's ``planner.optimize.plan`` minimizes a convergence bound
subject to a budget expressed in any of these currencies.

Numpy only. This is a copy of ``repro.planner.cost`` with its imports
pointed at the port (``repro_torch.core.mixing``, ``compression``,
``topology``), so its prices are the reference's; the rest of the planner
(bounds, optimize, adaptive) is ported beside it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import mixing as mixing_lib
from repro_torch.core.compression import Compressor
from repro_torch.core.topology import Topology

__all__ = [
    "ComputeModel",
    "LinkModel",
    "WirelessLinks",
    "wireless_link",
    "RoundCost",
    "CostModel",
    "Episode",
    "CostProcess",
    "straggler_links",
    "faded_links",
    "edge_outage",
    "unit_cost_model",
    "comm_compute_cost",
]


@dataclasses.dataclass(frozen=True)
class ComputeModel:
    """One local SGD step priced from its FLOPs.

    step_flops: FLOPs of one local update on one node (fwd+bwd+opt).
    flops_per_s: sustained device throughput.
    joules_per_flop: optional energy price (0 disables energy accounting).
    """

    step_flops: float
    flops_per_s: float
    joules_per_flop: float = 0.0

    @property
    def t_step(self) -> float:
        return self.step_flops / self.flops_per_s

    @property
    def energy_step(self) -> float:
        return self.step_flops * self.joules_per_flop


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """A point-to-point link: fixed latency + bandwidth + energy price."""

    bytes_per_s: float
    latency_s: float = 0.0
    joules_per_byte: float = 0.0

    def t_transfer(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bytes_per_s

    def energy_transfer(self, nbytes: float) -> float:
        return nbytes * self.joules_per_byte


def wireless_link(
    bandwidth_hz: float,
    snr_db: float,
    *,
    efficiency: float = 1.0,
    latency_s: float = 0.0,
    joules_per_byte: float = 0.0,
) -> LinkModel:
    """Shannon-capacity link: rate = eff * B * log2(1 + SNR) bits/s.

    The standard physical-layer model for DFL over wireless networks
    (arXiv:2308.06496 Sec. II): per-edge bandwidth and SNR determine the
    achievable rate; ``efficiency`` < 1 derates for coding/protocol
    overhead.
    """
    snr = 10.0 ** (snr_db / 10.0)
    bits_per_s = efficiency * bandwidth_hz * math.log2(1.0 + snr)
    return LinkModel(bytes_per_s=bits_per_s / 8.0, latency_s=latency_s,
                     joules_per_byte=joules_per_byte)


@dataclasses.dataclass(frozen=True)
class WirelessLinks:
    """A per-edge link table over a topology's undirected edges.

    ``per_edge[(i, j)]`` (i < j) overrides ``default`` for that edge —
    heterogeneous bandwidth/SNR per link, the defining feature of the
    wireless DFL setting. Synchronous gossip waits for the slowest
    transfer, so the step time is a max over the active links:

      concurrency="parallel": all edges transfer simultaneously (wired
        full-duplex ICI); t_step = max over edges of the edge time.
      concurrency="serial": each node's radio serves its neighbors one at
        a time (half-duplex wireless); t_step = max over nodes of the SUM
        of that node's incoming-edge times.
    """

    default: LinkModel
    per_edge: Mapping[Tuple[int, int], LinkModel] = dataclasses.field(
        default_factory=dict)
    concurrency: str = "parallel"

    def link(self, i: int, j: int) -> LinkModel:
        key = (min(i, j), max(i, j))
        return self.per_edge.get(key, self.default)

    def gossip_time(self, topology: Topology, copy_bytes: float,
                    active_edges: Optional[Sequence[Tuple[int, int]]] = None,
                    ) -> float:
        """Time of one gossip step shipping ``copy_bytes`` per neighbor.

        ``active_edges``: optional undirected edge subset actually carrying
        traffic this step (a sporadic round's unmasked edges) — masked
        edges ship nothing and so never gate the step, which is exactly
        why a sporadic round is cheaper than a blocking round waiting on
        an outage tariff.
        """
        if self.concurrency not in ("parallel", "serial"):
            raise ValueError(f"unknown concurrency {self.concurrency!r}")
        act = (None if active_edges is None else
               {(min(i, j), max(i, j)) for (i, j) in active_edges})
        per_node = []
        for i, nbrs in enumerate(topology.neighbors):
            times = [self.link(i, j).t_transfer(copy_bytes)
                     for (j, _w) in nbrs
                     if act is None or (min(i, j), max(i, j)) in act]
            if not times:
                per_node.append(0.0)
            elif self.concurrency == "serial":
                per_node.append(sum(times))
            else:
                per_node.append(max(times))
        return max(per_node, default=0.0)

    def gossip_energy(self, topology: Topology, copy_bytes: float,
                      active_edges: Optional[Sequence[Tuple[int, int]]] = None,
                      ) -> float:
        """Per-node mean energy of one gossip step (receive side)."""
        n = max(topology.num_nodes, 1)
        act = (None if active_edges is None else
               {(min(i, j), max(i, j)) for (i, j) in active_edges})
        total = sum(
            self.link(i, j).energy_transfer(copy_bytes)
            for i, nbrs in enumerate(topology.neighbors) for (j, _w) in nbrs
            if act is None or (min(i, j), max(i, j)) in act)
        return total / n


@dataclasses.dataclass(frozen=True)
class RoundCost:
    """The priced resources of ONE DFL round (per node)."""

    time_s: float
    wire_bits: float
    energy_j: float
    t_compute_step: float
    t_gossip_step: float
    _comm_time: float = 0.0

    @property
    def comm_fraction(self) -> float:
        return self._comm_time / self.time_s if self.time_s > 0.0 else 0.0


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prices (tau1, tau2, compressor) schedules on one deployment.

    compute:    the local-step model.
    link:       a shared LinkModel or a per-edge WirelessLinks table.
    topology:   gossip graph (copies per step + edge set).
    model_bits: uncompressed wire bits of one model copy (fp32 tree).
    engine:     wire-accounting engine — "sparse" per-neighbor (deployment
                truth & the ppermute engine), "dense" all-gather lowering,
                "auto" whichever the launcher would pick (see
                ``mixing.gossip_copies_per_step``).
    overlap:    executor overlap mode being priced. "none" is the paper's
                additive round time; "pipeline" hides the wire under the
                NEXT round's local steps (``RoundExecutor(overlap=
                "pipeline")``), so the round time becomes

                    tau1 * t_c + max(0, tau2 * t_g - overlap_window)

                with overlap_window = tau1 * t_c — i.e. only the gossip
                time that does not fit under compute is paid. Degenerates
                EXACTLY to the additive model at "none" (window 0). Wire
                bits and energy are unchanged: overlap hides time, it does
                not remove traffic.
    """

    compute: ComputeModel
    link: Union[LinkModel, WirelessLinks]
    topology: Topology
    model_bits: float
    engine: str = "sparse"
    overlap: str = "none"

    def __post_init__(self):
        if self.overlap not in ("none", "pipeline"):
            raise ValueError(
                f"overlap must be 'none' or 'pipeline', got {self.overlap!r}")

    def overlap_window(self, tau1: int) -> float:
        """Seconds of gossip hidden under the next round's local phase."""
        if self.overlap == "pipeline":
            return tau1 * self.compute.t_step
        return 0.0

    def compression_ratio(self, compressor: Optional[Compressor]) -> float:
        """Wire-bits ratio vs fp32 for one model copy (1.0 uncompressed)."""
        if compressor is None:
            return 1.0
        d = max(int(round(self.model_bits / 32.0)), 1)
        return float(compressor.bits_per_value(d)) / 32.0

    def copies_per_step(self) -> int:
        return mixing_lib.gossip_copies_per_step(self.topology, self.engine)

    def gossip_bits_per_step(
        self, compressor: Optional[Compressor] = None
    ) -> float:
        """Wire bits each node receives per gossip step."""
        return (self.copies_per_step() * self.model_bits
                * self.compression_ratio(compressor))

    def t_gossip_step(self, compressor: Optional[Compressor] = None) -> float:
        copy_bytes = (self.model_bits * self.compression_ratio(compressor)
                      / 8.0)
        if isinstance(self.link, WirelessLinks):
            return self.link.gossip_time(self.topology, copy_bytes)
        return self.link.t_transfer(self.copies_per_step() * copy_bytes)

    def round_cost(self, tau1: int, tau2: int,
                   compressor: Optional[Compressor] = None) -> RoundCost:
        t_c = self.compute.t_step
        t_g = self.t_gossip_step(compressor)
        copy_bytes = (self.model_bits * self.compression_ratio(compressor)
                      / 8.0)
        if isinstance(self.link, WirelessLinks):
            e_g = self.link.gossip_energy(self.topology, copy_bytes)
        else:
            e_g = self.link.energy_transfer(
                self.copies_per_step() * copy_bytes)
        comm_time = max(0.0, tau2 * t_g - self.overlap_window(tau1))
        return RoundCost(
            time_s=tau1 * t_c + comm_time,
            wire_bits=tau2 * self.gossip_bits_per_step(compressor),
            energy_j=tau1 * self.compute.energy_step + tau2 * e_g,
            t_compute_step=t_c,
            t_gossip_step=t_g,
            _comm_time=comm_time,
        )

    def masked_round_cost(
        self, tau1: int, tau2: int,
        compressor: Optional[Compressor] = None,
        *,
        active_nodes: Optional[Sequence[int]] = None,
        active_edges: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> RoundCost:
        """Price a SPORADIC round over its realized participation.

        A masked node skips its local steps; a masked edge ships nothing
        (its ppermute still runs, but the accumulation weight is zero —
        nothing crosses the wire). Deployment truth for the round is
        therefore: compute time 0 when every node is masked, gossip time
        gated only by the ACTIVE edges, wire/energy counted only on
        active traffic. This is why the sporadic engine beats a blocking
        baseline at equal deployment-clock budget: the blocking round
        pays the outage tariff (``edge_outage`` residual-rate links) on
        the very edges the sporadic round simply drops.
        """
        n_active = (self.topology.num_nodes if active_nodes is None
                    else len(set(active_nodes)))
        act = (None if active_edges is None else
               [(min(i, j), max(i, j)) for (i, j) in active_edges])
        t_c = self.compute.t_step if n_active > 0 else 0.0
        copy_bytes = (self.model_bits * self.compression_ratio(compressor)
                      / 8.0)
        wl = _as_wireless(self.link)
        t_g = wl.gossip_time(self.topology, copy_bytes, active_edges=act)
        e_g = wl.gossip_energy(self.topology, copy_bytes, active_edges=act)
        if act is None:
            bits_step = self.gossip_bits_per_step(compressor)
        else:
            # each active undirected edge delivers one copy per direction;
            # per-node mean received copies = 2|E_active| / N
            n = max(self.topology.num_nodes, 1)
            bits_step = (2.0 * len(set(act)) / n
                         * self.model_bits
                         * self.compression_ratio(compressor))
        # the window only spans compute that actually runs: a fully masked
        # round (t_c = 0) hides nothing.
        window = (tau1 * t_c if self.overlap == "pipeline" else 0.0)
        comm_time = max(0.0, tau2 * t_g - window)
        frac = n_active / max(self.topology.num_nodes, 1)
        return RoundCost(
            time_s=tau1 * t_c + comm_time,
            wire_bits=tau2 * bits_step,
            energy_j=(tau1 * self.compute.energy_step * frac + tau2 * e_g),
            t_compute_step=t_c,
            t_gossip_step=t_g,
            _comm_time=comm_time,
        )


# ---------------------------------------------------------------------------
# Time-varying deployments: straggler episodes, fading links, outages
# ---------------------------------------------------------------------------


def _as_wireless(link: Union[LinkModel, WirelessLinks]) -> WirelessLinks:
    return link if isinstance(link, WirelessLinks) else WirelessLinks(
        default=link)


def _scale_link(link: LinkModel, slowdown: float) -> LinkModel:
    return dataclasses.replace(link, bytes_per_s=link.bytes_per_s / slowdown)


def straggler_links(
    link: Union[LinkModel, WirelessLinks],
    topology: Topology,
    node: int,
    slowdown: float,
) -> WirelessLinks:
    """Every edge touching ``node`` runs ``slowdown``x slower.

    Synchronous gossip waits for the slowest transfer
    (``WirelessLinks.gossip_time`` is a max over active links), so one
    straggling node gates every gossip step of the whole network — the
    canonical heterogeneous-node episode the per-round trajectory planner
    exists to route around.
    """
    wl = _as_wireless(link)
    # undirected edge set (neighbors lists both directions — dedupe first
    # so each edge is slowed exactly once).
    touched = {(min(i, j), max(i, j))
               for i, nbrs in enumerate(topology.neighbors)
               for j, _w in nbrs if node in (i, j)}
    per = dict(wl.per_edge)
    for key in sorted(touched):
        per[key] = _scale_link(per.get(key, wl.default), slowdown)
    return dataclasses.replace(wl, per_edge=per)


def faded_links(
    link: Union[LinkModel, WirelessLinks], slowdown: float
) -> WirelessLinks:
    """Uniform fading: every link's rate (default and per-edge overrides)
    divides by ``slowdown`` — a network-wide deep-fade / congestion
    episode."""
    wl = _as_wireless(link)
    per = {k: _scale_link(v, slowdown) for k, v in wl.per_edge.items()}
    return dataclasses.replace(wl, default=_scale_link(wl.default, slowdown),
                               per_edge=per)


def edge_outage(
    link: Union[LinkModel, WirelessLinks],
    edges: Sequence[Tuple[int, int]],
    residual: float = 1e-3,
) -> WirelessLinks:
    """Per-edge outage: the named undirected edges drop to ``residual`` of
    their rate (a hard 0 would make the synchronous gossip step infinite;
    DFL over a severed edge in practice degrades to retransmission at some
    residual throughput)."""
    wl = _as_wireless(link)
    per = dict(wl.per_edge)
    for (i, j) in edges:
        key = (min(i, j), max(i, j))
        per[key] = _scale_link(per.get(key, wl.default), 1.0 / residual)
    return dataclasses.replace(wl, per_edge=per)


@dataclasses.dataclass(frozen=True)
class Episode:
    """A wall-clock window during which the deployment deviates from base.

    t_start/t_stop: the window [t_start, t_stop) on the deployment clock
      (seconds, same clock ``CostProcess.at`` is queried with).
    link: optional LinkModel/WirelessLinks replacing the base link table
      for the window (build with ``straggler_links``/``faded_links``/
      ``edge_outage`` for the standard scenarios).
    compute_scale: >1 slows every local step by that factor for the window
      (synchronous local epochs wait for the slowest node, so a compute
      straggler scales the whole step time).
    """

    t_start: float
    t_stop: float
    link: Optional[Union[LinkModel, WirelessLinks]] = None
    compute_scale: float = 1.0
    label: str = ""

    def __post_init__(self):
        assert self.t_stop > self.t_start, "empty episode window"
        assert self.compute_scale > 0.0

    def active(self, t: float) -> bool:
        return self.t_start <= t < self.t_stop


@dataclasses.dataclass(frozen=True)
class CostProcess:
    """A time-varying deployment: base costs plus episodic deviations.

    ``at(t)`` is the cost model in force at deployment-clock ``t``;
    overlapping episodes compose in declaration order (a later episode's
    link override wins, compute scales multiply). The trajectory planner
    (``planner.optimize.plan_trajectory``) walks this clock to price each
    round of a length-K schedule; ``is_static`` processes degenerate to
    the fixed-schedule ``plan``.
    """

    base: CostModel
    episodes: Tuple[Episode, ...] = ()

    @property
    def is_static(self) -> bool:
        return not self.episodes

    def at(self, t: float) -> CostModel:
        cm = self.base
        for ep in self.episodes:
            if not ep.active(t):
                continue
            if ep.link is not None:
                cm = dataclasses.replace(cm, link=ep.link)
            if ep.compute_scale != 1.0:
                comp = cm.compute
                cm = dataclasses.replace(
                    cm, compute=dataclasses.replace(
                        comp,
                        flops_per_s=comp.flops_per_s / ep.compute_scale))
        return cm

    def horizon(self) -> float:
        """The last episode boundary (0.0 when static) — after this the
        process is its base forever."""
        return max((ep.t_stop for ep in self.episodes), default=0.0)


def unit_cost_model(topology: Topology, comm_compute_ratio: float, *,
                    engine: str = "sparse",
                    rep_dim: int = 1024,
                    overlap: str = "none") -> CostModel:
    """The benchmarks' abstract cost unit: t_compute_step = 1, and one
    gossip step costs ``comm_compute_ratio`` — the "comm/comp" knob that
    ``bench_balance`` sweeps. ``rep_dim`` is the representative parameter
    count used to price compressors (their ``bits_per_value`` depends on
    the vector dimension)."""
    model_bits = 32.0 * rep_dim
    copies = mixing_lib.gossip_copies_per_step(topology, engine)
    bytes_per_step = max(copies, 1) * model_bits / 8.0
    link = LinkModel(bytes_per_s=bytes_per_step / comm_compute_ratio)
    return CostModel(
        compute=ComputeModel(step_flops=1.0, flops_per_s=1.0),
        link=link, topology=topology, model_bits=model_bits, engine=engine,
        overlap=overlap)


def comm_compute_cost(
    tau1: int,
    tau2: int,
    rounds: int,
    *,
    step_flops: float,
    model_bytes: float,
    degree: int,
    flops_per_s: float,
    link_bytes_per_s: float,
    bits_per_value_ratio: float = 1.0,
) -> Dict[str, float]:
    """Analytic time model for the paper's 'balancing' trade-off.

    Total time = rounds * (tau1 * t_compute + tau2 * t_comm) with
    t_comm = degree * model_bytes * bits_ratio / link_bw. Kept as the
    degree-explicit flat API (the old ``core.metrics.comm_compute_cost``,
    now a deprecation shim over this); ``CostModel`` is the composable
    topology-aware replacement.

    Example: step_flops=1e9, model_bytes=4e6, degree=2, flops_per_s=1e12,
    link_bytes_per_s=1e9 gives t_compute=1e-3 s, t_comm=8e-3 s.
    """
    compute = ComputeModel(step_flops=step_flops, flops_per_s=flops_per_s)
    link = LinkModel(bytes_per_s=link_bytes_per_s)
    t_compute = compute.t_step
    t_comm = link.t_transfer(degree * model_bytes * bits_per_value_ratio)
    per_round = tau1 * t_compute + tau2 * t_comm
    return {
        "t_compute": t_compute,
        "t_comm": t_comm,
        "per_round": per_round,
        "total": per_round * rounds,
        "comm_fraction": (tau2 * t_comm) / per_round if per_round else 0.0,
    }
