"""Runtime (tau1, tau2) control from *measured* round timings.

The static planner prices schedules from a priori FLOPs/bandwidth numbers;
real deployments drift (thermal throttling, contended links, interpret-mode
kernels). ``AdaptiveController`` closes the loop: every round it records
the measured wall-clock of the (tau1, tau2) schedule that actually ran,
every ``replan_every`` rounds it re-fits the per-step compute/gossip times
by least squares over the observed (tau1, tau2, seconds) history and
re-plans the remainder of the budget with ``planner.optimize.plan``.

Identifiability: with observations at a single (tau1, tau2) the 2-unknown
fit is rank-1. Rather than re-planning off an unidentifiable fit, the
controller then INJECTS A PROBE ROUND — the grid schedule closest in
predicted round time to the current one whose (tau1, tau2) row is linearly
independent of everything observed — so one round of measurement buys full
identification; until a probe lands, ``fitted_cost_model`` scales the
prior uniformly to match the measured round time (preserving the prior
compute/comm split).

Two control surfaces, both build- and capture-free under the port's
executor: ``maybe_replan`` (superstep-boundary re-plan, the reference's
``train.py --plan-budget``) and ``next_trajectory`` (a per-round [k, 2]
schedule emitted for the NEXT superstep — re-planning INSIDE the superstep
via ``RoundExecutor.dispatch_trajectory``, optionally against a known
time-varying ``CostProcess``; the reference's ``train.py --schedule
trajectory``, and ``repro_torch.launch.planned_run`` here). Every
(re)plan/probe/trajectory event is appended to ``controller.history`` so
the emitted metrics show the schedule trajectory.

Numpy only: a copy of ``repro.planner.adaptive`` over the port's planner,
so the same observations give the reference's plans, bit for bit. The
reference's telemetry sink (``telemetry=``) raises ``NotImplementedError``
until the port has its event stream (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compression import Compressor
from repro_torch.planner.bounds import Availability
from repro_torch.planner.cost import (ComputeModel, CostModel, CostProcess,
                               LinkModel, WirelessLinks)
from repro_torch.planner.optimize import (Budget, DEFAULT_GRID, Plan,
                                    plan as plan_fn,
                                    plan_trajectory as plan_trajectory_fn)

__all__ = ["AdaptiveController"]

_T_FLOOR = 1e-9  # seconds; keeps fitted per-step times strictly positive
_NOT_PORTED = "is not ported yet (ROADMAP.md, modules to port, item {})"


@dataclasses.dataclass(frozen=True)
class _Observation:
    tau1: int
    tau2: int
    seconds: float
    compression_ratio: float  # wire-bits ratio active during this round


class AdaptiveController:
    """Re-plans (tau1, tau2, compressor) from measured timings.

    Args:
      budget: total resource envelope for the WHOLE session (the
        controller spends it down as rounds complete).
      cost_model: the prior — engine/topology/model_bits are trusted, the
        compute/link speeds are re-fitted from measurements.
      sigma, f_gap, L, gamma, grid, compressors: forwarded to
        ``planner.optimize.plan``.
      replan_every: rounds between re-plans (K).
      process: optional KNOWN time-varying deviation (straggler/fading/
        outage episodes on the deployment clock). ``next_trajectory``
        re-bases it on the measured-fit cost model each superstep, so the
        emitted per-round schedule routes around announced episodes while
        the base speeds stay measurement-driven.
      telemetry: the reference's event sink; anything but None raises
        ``NotImplementedError`` (not ported yet).
    """

    def __init__(
        self,
        budget: Budget,
        cost_model: CostModel,
        *,
        sigma: float,
        f_gap: float,
        replan_every: int = 10,
        grid: Optional[Sequence[Tuple[int, int]]] = None,
        compressors: Sequence[Optional[Compressor]] = (None,),
        gamma: float = 1.0,
        L: float = 1.0,
        process: Optional[CostProcess] = None,
        telemetry=None,
    ):
        if telemetry is not None:
            raise NotImplementedError(f"telemetry {_NOT_PORTED.format(9)}")
        assert replan_every >= 1
        self.budget = budget
        self.cost_model = cost_model
        self.process = process
        self.sigma = sigma
        self.f_gap = f_gap
        self.replan_every = replan_every
        self.grid = grid
        self.compressors = tuple(compressors)
        self.gamma = gamma
        self.L = L
        self.observations: List[_Observation] = []
        self.spent_s = 0.0
        self.spent_bits = 0.0
        self.spent_j = 0.0
        # sporadic-participation tallies (observe_participation)
        self.resume_tau2 = 1.0
        self._node_up = 0
        self._node_total = 0
        self._edge_up = 0
        self._edge_total = 0
        self.history: List[dict] = []   # one dict per (re)plan event
        self.current: Optional[Plan] = None
        self.exhausted = False

    # -- planning ----------------------------------------------------------

    def _plan_kwargs(self):
        kw = dict(sigma=self.sigma, f_gap=self.f_gap,
                  compressors=self.compressors, gamma=self.gamma, L=self.L)
        if self.grid is not None:
            kw["grid"] = self.grid
        avail = self.availability()
        if avail is not None:
            kw["availability"] = avail
        return kw

    def _remaining_budget(self) -> Optional[Budget]:
        wall = (self.budget.wall_clock_s - self.spent_s
                if self.budget.wall_clock_s is not None else None)
        bits = (self.budget.wire_bits - self.spent_bits
                if self.budget.wire_bits is not None else None)
        joules = (self.budget.energy_j - self.spent_j
                  if self.budget.energy_j is not None else None)
        if any(rem is not None and rem <= 0.0
               for rem in (wall, bits, joules)):
            return None
        return Budget(wall_clock_s=wall, wire_bits=bits, energy_j=joules)

    def _emit(self, round_idx: int, cause: str, **extra) -> None:
        p = self.current
        assert p is not None
        rec = {
            "round": round_idx,
            "cause": cause,
            "tau1": p.tau1,
            "tau2": p.tau2,
            "compressor": p.compressor_name,
            "eta": p.eta,
            "rounds_planned": p.rounds,
            "predicted_bound": p.predicted_bound,
            "t_compute_step": p.round_cost.t_compute_step,
            "t_gossip_step": p.round_cost.t_gossip_step,
            "spent_s": self.spent_s,
            **extra,
        }
        self.history.append(rec)

    def initial_plan(self) -> Plan:
        """Plan round 0 from the prior cost model and the full budget."""
        self.current = plan_fn(self.budget, self.cost_model,
                               **self._plan_kwargs())
        self._emit(0, "initial")
        return self.current

    # -- measurement -------------------------------------------------------

    def observe(self, tau1: int, tau2: int, seconds: float, *,
                fit: Optional[bool] = None) -> None:
        """Record one completed round's measured wall-clock.

        EVERY measured round enters the least-squares cost fit: under the
        build- and capture-free executor (``repro_torch.core.executor``) a
        schedule change is host data, so no round's wall-clock is ever
        contaminated by a build or a capture, and the old ``fit=False``
        escape hatch (used to drop freshly-(re)built rounds) is obsolete.
        The parameter is kept as a deprecation shim and IGNORED.
        """
        if fit is not None:
            import warnings

            warnings.warn(
                "AdaptiveController.observe(fit=...) is deprecated and "
                "ignored: dynamic-tau dispatch never compile-contaminates "
                "a round, so every measured round enters the cost fit",
                DeprecationWarning, stacklevel=2)
        comp = self.current.compressor if self.current is not None else None
        ratio = self.cost_model.compression_ratio(comp)
        self.observations.append(
            _Observation(tau1, tau2, float(seconds), ratio))
        self.spent_s += float(seconds)
        # wire/energy accounting is analytic (exact), not measured:
        self.spent_bits += (
            tau2 * self.cost_model.gossip_bits_per_step(comp))
        self.spent_j += self.cost_model.round_cost(tau1, tau2, comp).energy_j

    def observe_chunk(self, taus, seconds: float) -> None:
        """Record one dispatched SUPERSTEP's measured wall-clock as a
        single aggregated observation: the fit row is
        (sum tau1_k, sum tau2_k) over the chunk's [k, 2] schedule.

        This is how heterogeneous-trajectory supersteps must be observed:
        the host can only time the fused dispatch as a whole, and
        amortizing elapsed/K uniformly over rounds of DIFFERENT schedules
        (``MetricsBuffer``'s per-round rows) would corrupt a per-round
        least-squares fit — e.g. a probe round inherits the chunk mean and
        the 'identified' fit is garbage. The per-step model is linear, so
        the chunk total  seconds ~= (sum tau1) t_step + (sum tau2) ratio
        t_gossip  is an exact aggregation, and a chunk carrying a probe
        still raises the fit rank (its tau1:tau2 ratio differs from the
        uniform chunks').
        """
        arr = np.asarray(taus, dtype=np.int64).reshape(-1, 2)
        assert len(arr) >= 1
        comp = self.current.compressor if self.current is not None else None
        ratio = self.cost_model.compression_ratio(comp)
        t1_sum, t2_sum = int(arr[:, 0].sum()), int(arr[:, 1].sum())
        self.observations.append(
            _Observation(t1_sum, t2_sum, float(seconds), ratio))
        self.spent_s += float(seconds)
        self.spent_bits += (
            t2_sum * self.cost_model.gossip_bits_per_step(comp))
        # per-round energy is linear in (tau1, tau2): pricing the sums
        # equals summing the rounds.
        self.spent_j += self.cost_model.round_cost(
            t1_sum, t2_sum, comp).energy_j

    def observe_participation(self, node_mask, edge_mask) -> None:
        """Tally one round's realized participation (the [N]/[E] masks of
        a sporadic round, or the ``active_nodes``/``masked_edges`` counts
        already reduced by the executor — any 0/1 array-likes work). The
        running rates feed ``availability()``, which every subsequent
        (re)plan prices schedules with."""
        nm = np.asarray(node_mask).ravel()
        em = np.asarray(edge_mask).ravel()
        self._node_up += int(nm.sum())
        self._node_total += int(nm.size)
        self._edge_up += int(em.sum())
        self._edge_total += int(em.size)

    def availability(self) -> Optional[Availability]:
        """The estimated sporadic-participation rates, or None while no
        participation has been observed (or it has been full — the exact
        Prop-1 formulas then apply unmodified)."""
        if self._node_total == 0 and self._edge_total == 0:
            return None
        node_rate = (self._node_up / self._node_total
                     if self._node_total else 1.0)
        edge_rate = (self._edge_up / self._edge_total
                     if self._edge_total else 1.0)
        avail = Availability(node_rate=min(node_rate, 1.0),
                             edge_rate=min(edge_rate, 1.0),
                             resume_tau2=self.resume_tau2)
        return None if avail.is_full else avail

    def spend_overhead(self, seconds: float) -> None:
        """Charge one-off wall-clock (executor warmup compiles, stalls) to
        the budget WITHOUT entering the per-round cost fit — overhead is
        real budget spend but is not a (tau1, tau2) round sample."""
        self.spent_s += float(seconds)

    def _obs_rows(self) -> np.ndarray:
        """The least-squares design matrix rows of every observation."""
        return np.array([[o.tau1, o.tau2 * o.compression_ratio]
                         for o in self.observations], dtype=np.float64)

    def fit_rank(self) -> int:
        """Rank of the step/gossip-time fit (0 no data, 1 unidentifiable —
        all history proportional to one (tau1, tau2) direction, 2 full)."""
        if not self.observations:
            return 0
        return int(np.linalg.matrix_rank(self._obs_rows()))

    def fitted_cost_model(self) -> CostModel:
        """The prior cost model with compute/link speeds re-fitted.

        Least squares over rows  seconds ~= tau1 * t_step + (tau2 * ratio)
        * t_gossip  (ratio = the observation's compression factor, so the
        fitted t_gossip is the UNCOMPRESSED per-step gossip time and
        compressed candidates are priced consistently). Rank-deficient
        histories fall back to scaling the prior uniformly.
        """
        if not self.observations:
            return self.cost_model
        a = self._obs_rows()
        b = np.array([o.seconds for o in self.observations], dtype=np.float64)
        prior_t_step = self.cost_model.compute.t_step
        prior_t_gossip = self.cost_model.t_gossip_step(None)
        if np.linalg.matrix_rank(a) >= 2:
            (t_step, t_gossip), *_ = np.linalg.lstsq(a, b, rcond=None)
            t_step = max(float(t_step), _T_FLOOR)
            t_gossip = max(float(t_gossip), _T_FLOOR)
        else:
            # all history at one schedule: scale the prior split to match
            # the measured mean round time.
            predicted = a @ np.array([prior_t_step, prior_t_gossip])
            scale = float(np.sum(predicted * b) /
                          max(np.sum(predicted * predicted), _T_FLOOR))
            scale = max(scale, _T_FLOOR)
            t_step = max(prior_t_step * scale, _T_FLOOR)
            t_gossip = max(prior_t_gossip * scale, _T_FLOOR)
        bytes_per_step = max(
            self.cost_model.copies_per_step(), 1
        ) * self.cost_model.model_bits / 8.0
        # fitted model carries step_flops = t_step at unit throughput; keep
        # the prior's per-step ENERGY prices invariant under that reparam
        # (timing refits speed, not joules).
        e_step = self.cost_model.compute.energy_step
        prior_link = self.cost_model.link
        jpb = (prior_link.default.joules_per_byte
               if isinstance(prior_link, WirelessLinks)
               else prior_link.joules_per_byte)
        return dataclasses.replace(
            self.cost_model,
            compute=ComputeModel(step_flops=t_step, flops_per_s=1.0,
                                 joules_per_flop=e_step / t_step),
            link=LinkModel(bytes_per_s=bytes_per_step / t_gossip,
                           joules_per_byte=jpb))

    # -- identifiability probes -------------------------------------------

    def _probe_candidate(self) -> Optional[Tuple[int, int]]:
        """A grid (tau1, tau2) whose observation row is linearly
        independent of everything measured so far (i.e. it RAISES the fit
        rank), closest in predicted round time to the current schedule so
        the probe disturbs the budget as little as possible. None when the
        grid has no rank-raising point."""
        if self.current is None or not self.observations:
            return None
        grid = tuple(self.grid) if self.grid is not None else DEFAULT_GRID
        rows = self._obs_rows()
        rank = np.linalg.matrix_rank(rows)
        cm = self.fitted_cost_model()
        comp = self.current.compressor
        ratio = self.cost_model.compression_ratio(comp)
        cur_t = cm.round_cost(self.current.tau1, self.current.tau2,
                              comp).time_s
        best = None
        for (t1, t2) in grid:
            row = np.array([[t1, t2 * ratio]], dtype=np.float64)
            if np.linalg.matrix_rank(np.vstack([rows, row])) <= rank:
                continue
            dt = abs(cm.round_cost(t1, t2, comp).time_s - cur_t)
            if best is None or dt < best[0]:
                best = (dt, (t1, t2))
        return best[1] if best is not None else None

    def _probe_plan(self, remaining: Budget) -> Optional[Plan]:
        """The probe candidate priced as a full Plan under the
        (scaled-prior) fitted model, so callers get eta/rounds/bound for
        the probe schedule too."""
        cand = self._probe_candidate()
        if cand is None:
            return None
        kw = self._plan_kwargs()
        kw["grid"] = [cand]
        try:
            return plan_fn(remaining, self.fitted_cost_model(), **kw)
        except ValueError:
            return None

    # -- the control loop hooks -------------------------------------------

    def maybe_replan(self, round_idx: int) -> Optional[Plan]:
        """Call once per completed round (after ``observe``).

        Returns a NEW Plan when the schedule changed at this boundary,
        else None. Sets ``exhausted`` when the remaining budget affords no
        further rounds. With a rank-deficient timing fit (all history at
        one schedule direction) the boundary emits a PROBE plan — a
        rank-raising grid schedule — instead of re-planning off the
        unidentifiable scaled fit; the probe's own measurements make the
        next boundary fully identified.
        """
        if self.exhausted or self.current is None:
            return None
        remaining = self._remaining_budget()
        if remaining is None:
            self.exhausted = True
            return None
        if round_idx % self.replan_every != 0:
            return None
        if self.observations and self.fit_rank() < 2:
            probe = self._probe_plan(remaining)
            if probe is not None:
                self.current = probe
                self._emit(round_idx, "probe")
                return probe
        self.cost_model = self.fitted_cost_model()
        try:
            new = plan_fn(remaining, self.cost_model, **self._plan_kwargs())
        except ValueError:
            self.exhausted = True
            return None
        changed = (new.tau1, new.tau2, new.compressor_name) != (
            self.current.tau1, self.current.tau2,
            self.current.compressor_name)
        self.current = new
        self._emit(round_idx, "replan")
        return new if changed else None

    def _trajectory_candidate(self, k: int):
        """Compute the next k-round trajectory WITHOUT mutating any
        controller state: (fitted_cost_model, trajectory_plan, taus,
        probe) or None when the remaining budget affords no round. Both
        ``next_trajectory`` (which commits the result) and
        ``predict_trajectory`` (which only peeks) run exactly this, so a
        prediction taken between ``observe_chunk`` and the next
        ``next_trajectory`` call is deterministic-identical to what the
        controller will emit — the contract the prefetch-ahead path in the
        reference's ``train.py --schedule trajectory`` relies on."""
        remaining = self._remaining_budget()
        if remaining is None:
            return None
        probe = (self._probe_candidate()
                 if self.observations and self.fit_rank() < 2 else None)
        cm = self.fitted_cost_model()
        process = (CostProcess(base=cm)
                   if self.process is None
                   else dataclasses.replace(self.process, base=cm))
        try:
            tp = plan_trajectory_fn(remaining, process, rounds=k,
                                    t0=self.spent_s, **self._plan_kwargs())
        except ValueError:
            return None
        if tp.rounds == 0:
            return None
        taus = tp.taus
        if probe is not None:
            # the probe replaces the chunk's LAST planned round — only if
            # the swapped chunk still fits the remaining budget (the
            # probe is chosen nearest in round time, but a tight budget
            # end could not absorb an expensive rank-raiser).
            comp = tp.steps[0].compressor
            rc_probe = cm.round_cost(int(probe[0]), int(probe[1]), comp)
            rc_last = tp.steps[-1].round_cost
            fits = (
                (remaining.wall_clock_s is None
                 or tp.total_time_s - rc_last.time_s + rc_probe.time_s
                 <= remaining.wall_clock_s)
                and (remaining.wire_bits is None
                     or tp.total_wire_bits - rc_last.wire_bits
                     + rc_probe.wire_bits <= remaining.wire_bits)
                and (remaining.energy_j is None
                     or tp.total_energy_j - rc_last.energy_j
                     + rc_probe.energy_j <= remaining.energy_j))
            if fits:
                taus[-1] = probe
            else:
                probe = None
        return cm, tp, taus, probe

    def predict_trajectory(self, k: int) -> Optional[np.ndarray]:
        """PREDICT the next k-round [k, 2] schedule without committing it.

        Pure read: no observation, no spend, no history event, no
        ``current``/``cost_model``/``exhausted`` update — calling it any
        number of times leaves the controller bit-identical. Called with
        the same observation/spend state the next ``next_trajectory`` will
        see (i.e. after the chunk's ``observe_chunk`` and before any new
        spend), the returned rows equal what ``next_trajectory`` will
        emit — which is what lets trajectory mode prefetch host batches
        against the prediction and rebuild only on a genuine mismatch
        (``HostPrefetcher.mark_stale``). Returns None when the controller
        is exhausted or the remaining budget affords no round (prediction
        never *sets* ``exhausted`` — the committing call does)."""
        assert k >= 1
        if self.exhausted or self.current is None:
            return None
        cand = self._trajectory_candidate(k)
        return None if cand is None else cand[2]

    def next_trajectory(self, k: int,
                        round_idx: int = 0) -> Optional[np.ndarray]:
        """The next k rounds' [k, 2] (tau1, tau2) schedule — the
        per-round control surface for ``RoundExecutor.dispatch_trajectory``
        (``repro_torch.launch.planned_run``).

        Re-fits the cost model from every observation, then plans a
        per-round trajectory over the remaining budget: against the known
        ``process`` episodes (re-based on the fitted speeds) when one was
        given, else the fitted model held constant (a uniform chunk). A
        rank-deficient fit rides a probe round on the LAST round of the
        chunk — re-planning INSIDE the superstep, not just at its
        boundary — so identifiability costs one round and no build or
        capture. Returns None (and sets ``exhausted``) when the budget
        affords no further round; the returned trajectory may be SHORTER
        than k when the budget runs out mid-chunk.
        """
        assert k >= 1
        if self.exhausted or self.current is None:
            return None
        cand = self._trajectory_candidate(k)
        if cand is None:
            self.exhausted = True
            return None
        cm, tp, taus, probe = cand
        self.cost_model = cm
        self.current = tp.steps[0]
        self._emit(round_idx, "trajectory",
                   schedule=[[int(a), int(b)] for a, b in taus],
                   probe=([int(probe[0]), int(probe[1])]
                          if probe is not None else None))
        return taus
