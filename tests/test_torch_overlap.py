"""The port's pipelined executor (``RoundExecutor(overlap="pipeline")``,
``core.dfl.make_pipeline_fns``, ``core.executor.make_pipeline_superstep``),
the cases of tests/test_overlap.py that need only ported modules.

Tolerances, each with its reason:
  * ``overlap="none"`` and the pipelined executor against the eager
    pipeline and the port's copy of the stale oracle: bitwise (the same
    stages, the same arithmetic, on the CPU).
  * Against the reference's pipelined executor on the same numpy batches:
    plain DFL and TopK to rtol 1e-5 (f32 rounding of two frameworks, as
    tests/test_torch_executor.py), C-DFL QSGD with the reference's own
    draws replayed at the stale keys to rtol 1e-4 (a QSGD level may sit an
    ulp from a boundary).
  * K = 1 against the legacy round: rtol 2e-6, the reference's own
    (``z + (g - z)`` is not ``g`` bitwise).
  * ``predict_overlap`` / ``OverlapPrediction`` against the reference's on
    the same ``Roofline`` numbers (the reference's
    ``test_predict_overlap_arithmetic`` cases): bitwise, pure float
    arithmetic in both; ``stale_mixing_zeta`` against the reference's at
    the same staleness, bitwise (numpy in both), with the reference's
    assertions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DFLConfig as JDFLConfig
from repro.core import RoundExecutor as JRoundExecutor
from repro.core import init_state as jinit_state
from repro.core import make_compressor as jmake_compressor
from repro.core import ring as jring
from repro.core import stack_round_batches as jstack_round_batches
from repro.optim import sgd as jsgd
from repro_torch.core import (DFLConfig, RoundExecutor, init_state,
                              make_compressor, make_round_fn, ring,
                              stack_round_batches)
from repro_torch.core.dfl import (gossip_phase, local_phase,
                                  make_pipeline_fns)
from repro_torch.core.executor import make_pipeline_superstep
from repro_torch.core.rng import ReplayDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.optim import sgd
from test_torch_round import _reference_draws

N = 8
DIM = 5
TAUS = np.array([[3, 2], [1, 1], [2, 2], [3, 0]], np.int32)


def quad_loss(p, b):
    return torch.mean((p["w"] - b) ** 2)


def jquad_loss(p, b, k=None):
    return jnp.mean((p["w"] - b) ** 2)


def batches_for(tau1, seed=2):
    return np.random.default_rng(seed).normal(
        size=(tau1, N, DIM)).astype(np.float32)


def _round_batches(taus, seed0=10):
    return [batches_for(int(t1), seed=seed0 + i)
            for i, (t1, _) in enumerate(taus)]


def fresh_state(opt, compressed=False, seed=1, draws=None):
    return init_state({"w": torch.zeros(DIM)}, N, opt, compressed=compressed,
                      seed=seed, draws=draws)


def stacked(rb, tau1):
    return stack_round_batches(rb, tau1, "cpu")


def assert_model_state_bitwise(a, b):
    for field in ("params", "opt_state", "hat_params"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None)
        if x is None:
            continue
        for k in x:
            assert torch.equal(x[k], y[k]), (field, k)


def stale_reference(cfg, opt, state, round_batches, taus):
    """The one-round-stale oracle of tests/test_overlap.py on the port's
    stages: round k's local phase, then round k-1's exchange (its draws,
    its tau2) folded into the post-local params; the last exchange drained
    after the loop. A reference for the schedule, from the same
    ``local_phase`` / ``gossip_phase`` the legacy round composes."""
    sub = DenseSubstrate(cfg.topology)
    params, opt_state, hat = state.params, state.opt_state, state.hat_params
    r0 = state.round_idx
    buf = prev_t2 = None
    losses = []
    for i, ((t1, t2), b) in enumerate(zip(taus, round_batches)):
        r = r0 + i
        bt = np.zeros((cfg.tau1,) + b.shape[1:], np.float32)
        bt[: b.shape[0]] = b
        z, opt_state, loss = local_phase(cfg, quad_loss, opt, sub, params,
                                         opt_state, torch.from_numpy(bt),
                                         int(t1))
        losses.append(float(loss))
        if buf is not None:
            g, hat_g = gossip_phase(cfg, sub, buf, hat, state.draws, r - 1,
                                    prev_t2)
            params = {k: z[k] + (g[k] - buf[k]) for k in z}
            if cfg.is_compressed:
                hat = hat_g
        else:
            params = z
        buf = z
        prev_t2 = int(t2)
    g, hat_d = gossip_phase(cfg, sub, buf, hat, state.draws,
                            r0 + len(taus) - 1, prev_t2)
    params = {k: params[k] + (g[k] - buf[k]) for k in params}
    if cfg.is_compressed:
        hat = hat_d
    return params, hat, losses


# ---------------------------------------------------------------------------
# overlap="none" is the legacy path, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp", [None, "top_k"])
def test_overlap_none_bitwise_equals_legacy(comp):
    compressor = make_compressor(comp, frac=0.5) if comp else None
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N), compression=compressor,
                    gamma=0.5)
    opt = sgd(0.1)
    rb = _round_batches(TAUS)
    batches = stacked(rb, cfg.tau1)
    c = compressor is not None
    legacy = RoundExecutor(cfg, quad_loss, opt, donate=False)
    none = RoundExecutor(cfg, quad_loss, opt, donate=False, overlap="none")
    sa, ma = legacy.dispatch_trajectory(fresh_state(opt, c), batches, TAUS)
    sb, mb = none.dispatch_trajectory(fresh_state(opt, c), batches, TAUS)
    assert_model_state_bitwise(sa, sb)
    for key in ("loss", "consensus_sq"):
        assert torch.equal(ma[key], mb[key])
    # and the legacy rounds one by one, eagerly
    round_fn = make_round_fn(cfg, quad_loss, opt, dynamic_taus=True)
    ref = fresh_state(opt, c)
    for i, (t1, t2) in enumerate(TAUS):
        ref, _ = round_fn(ref, batches[i], int(t1), int(t2))
    assert_model_state_bitwise(ref, sb)
    su, _ = legacy.dispatch(sa, batches, 2, 1)
    sv, _ = none.dispatch(sb, batches, 2, 1)
    assert_model_state_bitwise(su, sv)


# ---------------------------------------------------------------------------
# overlap="pipeline" == the one-round-stale reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp", [None, "top_k"])
def test_pipeline_matches_stale_reference(comp):
    spec = {"frac": 0.5}
    compressor = make_compressor(comp, **spec) if comp else None
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N), compression=compressor,
                    gamma=0.5)
    opt = sgd(0.1)
    rb = _round_batches(TAUS)
    batches = stacked(rb, cfg.tau1)
    c = compressor is not None
    ex = RoundExecutor(cfg, quad_loss, opt, donate=False, overlap="pipeline")
    out, m = ex.dispatch_trajectory(fresh_state(opt, c), batches, TAUS)
    ref_p, ref_hat, ref_losses = stale_reference(cfg, opt,
                                                 fresh_state(opt, c), rb, TAUS)
    assert torch.equal(out.params["w"], ref_p["w"])
    if c:
        assert torch.equal(out.hat_params["w"], ref_hat["w"])
    np.testing.assert_array_equal(m["loss"].numpy(),
                                  np.asarray(ref_losses, np.float32))
    np.testing.assert_array_equal(m["tau1"].numpy(), TAUS[:, 0])
    np.testing.assert_array_equal(m["tau2"].numpy(), TAUS[:, 1])
    assert out.round_idx == len(TAUS)
    # the eager superstep over make_pipeline_fns, bitwise
    sup = make_pipeline_superstep(*make_pipeline_fns(cfg, quad_loss, opt))
    eager, me = sup(fresh_state(opt, c), batches, TAUS)
    assert_model_state_bitwise(eager, out)
    for key in me:
        assert torch.equal(me[key], m[key])
    # the reference's pipelined executor on the same numbers
    jcfg = JDFLConfig(tau1=3, tau2=2, topology=jring(N),
                      compression=(jmake_compressor(comp, **spec)
                                   if comp else None), gamma=0.5)
    jex = JRoundExecutor(jcfg, jquad_loss, jsgd(0.1), donate=False,
                         overlap="pipeline")
    jst, jm = jex.dispatch_trajectory(
        jinit_state({"w": jnp.zeros((DIM,))}, N, jsgd(0.1),
                    jax.random.key(1), compressed=c),
        jstack_round_batches(rb, cfg.tau1), TAUS)
    np.testing.assert_allclose(out.params["w"].numpy(),
                               np.asarray(jst.params["w"]), rtol=1e-5,
                               atol=1e-6)
    if c:
        np.testing.assert_allclose(out.hat_params["w"].numpy(),
                                   np.asarray(jst.hat_params["w"]),
                                   rtol=1e-5, atol=1e-6)
    for key in ("loss", "consensus_sq"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=1e-5)


def test_pipeline_cdfl_qsgd_matches_reference_with_its_draws():
    """C-DFL QSGD pipelined, the reference's own draws replayed: the stale
    exchange of round r-1 draws at (r - 1, t), as the reference's does."""
    comp = make_compressor("qsgd", levels=4)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N), compression=comp,
                    gamma=0.5)
    rb = _round_batches(TAUS)
    rng = jax.random.key(3)
    draws = ReplayDraws(_reference_draws(
        comp, rng, {"w": (DIM,)}, rounds=len(TAUS),
        tau2=[int(t2) for _, t2 in TAUS], n=N), device="cpu")
    jex = JRoundExecutor(JDFLConfig(tau1=3, tau2=2, topology=jring(N),
                                    compression=jmake_compressor(
                                        "qsgd", levels=4), gamma=0.5),
                         jquad_loss, jsgd(0.1), donate=False,
                         overlap="pipeline")
    jst, jm = jex.dispatch_trajectory(
        jinit_state({"w": jnp.zeros((DIM,))}, N, jsgd(0.1), rng,
                    compressed=True),
        jstack_round_batches(rb, cfg.tau1), TAUS)
    ex = RoundExecutor(cfg, quad_loss, sgd(0.1), donate=False,
                       overlap="pipeline")
    out, m = ex.dispatch_trajectory(fresh_state(sgd(0.1), True, draws=draws),
                                    stacked(rb, cfg.tau1), TAUS)
    for got, want in ((out.params, jst.params),
                      (out.hat_params, jst.hat_params)):
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=1e-4, atol=1e-6)
    for key in ("loss", "consensus_sq"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=1e-4)


def test_pipeline_single_round_equals_legacy():
    """K = 1: one local phase and one drained exchange is the legacy round;
    the pipeline is stale only between rounds."""
    opt = sgd(0.1)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N))
    taus1 = np.array([[2, 2]], np.int32)
    b1 = stacked([batches_for(2, seed=33)], cfg.tau1)
    legacy = RoundExecutor(cfg, quad_loss, opt, donate=False)
    pipe = RoundExecutor(cfg, quad_loss, opt, donate=False, overlap="pipeline")
    s_leg, _ = legacy.dispatch_trajectory(fresh_state(opt), b1, taus1)
    s_pipe, _ = pipe.dispatch_trajectory(fresh_state(opt), b1, taus1)
    np.testing.assert_allclose(s_pipe.params["w"].numpy(),
                               s_leg.params["w"].numpy(), rtol=2e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# drain semantics at superstep / checkpoint boundaries
# ---------------------------------------------------------------------------


def test_pipeline_drains_at_superstep_boundary():
    """A dispatch returns drained state: chunked dispatches equal the
    per-chunk stale reference, and a fresh executor restarted from the
    first chunk's output continues bitwise."""
    opt = sgd(0.1)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N))
    rb = _round_batches(TAUS)
    chunk_a, chunk_b = stacked(rb[:2], cfg.tau1), stacked(rb[2:], cfg.tau1)
    ex = RoundExecutor(cfg, quad_loss, opt, donate=False, overlap="pipeline")
    mid, _ = ex.dispatch_trajectory(fresh_state(opt), chunk_a, TAUS[:2])
    end, _ = ex.dispatch_trajectory(mid, chunk_b, TAUS[2:])
    p1, _, _ = stale_reference(cfg, opt, fresh_state(opt), rb[:2], TAUS[:2])
    assert torch.equal(mid.params["w"], p1["w"])
    ref_mid = fresh_state(opt)._replace(params=p1, opt_state=mid.opt_state,
                                        round_idx=mid.round_idx)
    p2, _, _ = stale_reference(cfg, opt, ref_mid, rb[2:], TAUS[2:])
    assert torch.equal(end.params["w"], p2["w"])
    ex2 = RoundExecutor(cfg, quad_loss, opt, donate=False, overlap="pipeline")
    end2, _ = ex2.dispatch_trajectory(mid, chunk_b, TAUS[2:])
    assert_model_state_bitwise(end, end2)


# ---------------------------------------------------------------------------
# no new build or capture / validation / participation
# ---------------------------------------------------------------------------


def test_pipeline_zero_recompiles_across_trajectories():
    opt = sgd(0.1)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N))
    ex = RoundExecutor(cfg, quad_loss, opt, donate=False, overlap="pipeline")
    batches = stacked(_round_batches(TAUS), cfg.tau1)
    st, _ = ex.dispatch_trajectory(fresh_state(opt), batches, TAUS)
    assert ex.compile_count == 1
    captures = ex.capture_count
    other = np.array([[1, 2], [3, 1], [2, 0], [1, 1]], np.int32)
    st, _ = ex.dispatch_trajectory(st, batches, other)
    st, _ = ex.dispatch(st, batches, 2, 2)
    st, _ = ex.dispatch(st, stacked(_round_batches(TAUS[:1]), 3), 1, 1)
    assert ex.compile_count == 1 and ex.capture_count == captures


def test_overlap_validation():
    opt = sgd(0.1)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N))
    with pytest.raises(ValueError, match="overlap"):
        RoundExecutor(cfg, quad_loss, opt, overlap="bogus")
    with pytest.raises(ValueError, match="dynamic"):
        RoundExecutor(cfg, quad_loss, opt, dynamic=False, overlap="pipeline")
    with pytest.raises(ValueError, match="batched engine"):
        RoundExecutor(cfg, quad_loss, opt, engine="batched", population=16,
                      overlap="pipeline")
    cfg_pow = DFLConfig(tau1=2, tau2=2, topology=ring(N),
                        mixing_impl="dense_power")
    with pytest.raises(ValueError, match="dense_power"):
        make_pipeline_fns(cfg_pow, quad_loss, opt)
    with pytest.raises(ValueError, match="batched engine"):
        make_pipeline_fns(cfg, quad_loss, opt, engine="batched")
    sched = DFLConfig(tau1=2, tau2=1, topology=ring(N),
                      topology_schedule=(ring(N), ring(N)))
    with pytest.raises(ValueError, match="topology schedule"):
        make_pipeline_fns(sched, quad_loss, opt, participation=True)
    with pytest.raises(ValueError, match="topology schedule"):
        RoundExecutor(sched, quad_loss, opt, participation=True,
                      overlap="pipeline")
    with pytest.raises(ValueError, match="process group"):
        make_pipeline_fns(cfg, quad_loss, opt, engine="sparse")
    from repro_torch.planner import CostModel
    from repro_torch.planner.cost import ComputeModel, LinkModel
    with pytest.raises(ValueError, match="overlap"):
        CostModel(compute=ComputeModel(1.0, 1.0), link=LinkModel(1.0),
                  topology=ring(N), model_bits=32.0, overlap="bogus")


def test_participation_pipeline_all_ones_equals_plain():
    """Widened rows pipeline too: all-ones masks are bitwise the plain
    pipeline, heterogeneous masks match the eager pipelined superstep and
    capture nothing new."""
    opt = sgd(0.1)
    cfg = DFLConfig(tau1=2, tau2=2, topology=ring(N))
    e = cfg.topology.num_edges
    k = 3
    rng = np.random.RandomState(0)
    rows = [[2, 2] + rng.binomial(1, 0.8, N).tolist()
            + rng.binomial(1, 0.8, e).tolist() for _ in range(k)]
    taus = np.asarray(rows, np.int32)
    rb = [batches_for(2, seed=10 + i) for i in range(k)]
    batches = stacked(rb, cfg.tau1)
    ex_p = RoundExecutor(cfg, quad_loss, opt, participation=True,
                         overlap="pipeline", donate=False)
    st, m = ex_p.dispatch_trajectory(fresh_state(opt), batches, taus)
    assert torch.isfinite(st.params["w"]).all()
    sup = make_pipeline_superstep(
        *make_pipeline_fns(cfg, quad_loss, opt, participation=True),
        participation=True, num_nodes=N, num_edges=e)
    eager, me = sup(fresh_state(opt), batches, taus)
    assert_model_state_bitwise(eager, st)
    for key in me:
        assert torch.equal(me[key], m[key]), key
    ones = np.concatenate([taus[:, :2], np.ones((k, N + e), np.int32)], 1)
    ex_plain = RoundExecutor(cfg, quad_loss, opt, overlap="pipeline",
                             donate=False)
    s1, _ = ex_p.dispatch_trajectory(fresh_state(opt), batches, ones)
    s2, _ = ex_plain.dispatch_trajectory(fresh_state(opt), batches,
                                         taus[:, :2].copy())
    assert torch.equal(s1.params["w"], s2.params["w"])
    n0 = (ex_p.compile_count, ex_p.capture_count)
    ex_p.dispatch_trajectory(st, batches, taus)
    assert (ex_p.compile_count, ex_p.capture_count) == n0


# ---------------------------------------------------------------------------
# planner: the max-form round time
# ---------------------------------------------------------------------------


def test_cost_model_overlap_round_time():
    from repro_torch.planner import unit_cost_model

    cm_none = unit_cost_model(ring(N), 4.0)
    cm_pipe = unit_cost_model(ring(N), 4.0, overlap="pipeline")
    t_c = cm_none.compute.t_step
    t_g = cm_none.t_gossip_step(None)
    for (t1, t2) in [(1, 1), (4, 2), (2, 4), (3, 0)]:
        none = cm_none.round_cost(t1, t2)
        pipe = cm_pipe.round_cost(t1, t2)
        assert none.time_s == pytest.approx(t1 * t_c + t2 * t_g)
        assert pipe.time_s == pytest.approx(
            t1 * t_c + max(0.0, t2 * t_g - t1 * t_c))
        assert pipe.wire_bits == none.wire_bits
        assert pipe.time_s <= none.time_s
    assert cm_pipe.round_cost(3, 0).time_s == cm_none.round_cost(3, 0).time_s
    assert cm_none.overlap_window(5) == 0.0
    assert cm_pipe.overlap_window(5) == pytest.approx(5 * t_c)


def test_masked_round_cost_overlap_window():
    """A fully masked round computes nothing, so it hides nothing."""
    from repro_torch.planner import unit_cost_model

    cm_none = unit_cost_model(ring(N), 4.0)
    cm_pipe = unit_cost_model(ring(N), 4.0, overlap="pipeline")
    dead_n = cm_none.masked_round_cost(2, 2, active_nodes=[])
    dead_p = cm_pipe.masked_round_cost(2, 2, active_nodes=[])
    assert dead_p.time_s == pytest.approx(dead_n.time_s)
    live_n = cm_none.masked_round_cost(2, 2)
    live_p = cm_pipe.masked_round_cost(2, 2)
    t_c = cm_none.compute.t_step
    assert live_p.time_s == pytest.approx(
        2 * t_c + max(0.0, (live_n.time_s - 2 * t_c) - 2 * t_c))
    assert live_p.time_s <= live_n.time_s
    assert live_p.wire_bits == live_n.wire_bits


# ---------------------------------------------------------------------------
# observability: the gossip slice rides its own track
# ---------------------------------------------------------------------------


def test_pipeline_emits_overlap_events():
    """The reference's ``tests/test_overlap.py`` case on the port: one
    ``overlap`` event a pipelined dispatch, on its own track; none under
    ``overlap="none"``."""
    from repro_torch.obs import Telemetry
    from repro_torch.obs.events import validate_events

    tel = Telemetry()
    opt = sgd(0.1)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N))
    ex = RoundExecutor(cfg, quad_loss, opt, donate=False,
                       overlap="pipeline", telemetry=tel)
    batches = stacked(_round_batches(TAUS), cfg.tau1)
    ex.dispatch_trajectory(fresh_state(opt), batches, TAUS)
    ov = [e for e in tel.events if e["type"] == "overlap"]
    assert len(ov) == 1
    assert ov[0]["track"] == "overlap" and ov[0]["dur"] is not None
    assert ov[0]["data"]["mode"] == "pipeline"
    assert ov[0]["data"]["k"] == len(TAUS)
    assert validate_events(tel.events) == []
    tel2 = Telemetry()
    ex_n = RoundExecutor(cfg, quad_loss, opt, donate=False,
                         telemetry=tel2)
    ex_n.dispatch_trajectory(fresh_state(opt), batches, TAUS)
    assert not [e for e in tel2.events if e["type"] == "overlap"]


def test_run_report_aggregates_overlap():
    from repro_torch.obs.events import make_event
    from repro_torch.obs.report import format_report, run_report

    events = [
        make_event("run", 0.0, "run",
                   data={"schema": 3, "wall_start": 1.0}),
        make_event("overlap", 0.5, "overlap", name="gossip-inflight-k4",
                   dur=0.25, data={"mode": "pipeline", "k": 4,
                                   "dispatch": 1}),
        make_event("overlap", 1.0, "overlap", name="gossip-inflight-k4",
                   dur=0.15, data={"mode": "pipeline", "k": 4,
                                   "dispatch": 2}),
    ]
    rep = run_report(events)
    assert rep["overlap"] == {"supersteps": 2, "mode": "pipeline",
                              "inflight_s": pytest.approx(0.4)}
    assert "overlap: mode=pipeline over 2 superstep(s)" in format_report(rep)


# ---------------------------------------------------------------------------
# roofline and staleness: the predicted win before a round runs
# ---------------------------------------------------------------------------


def _overlap_cases():
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline as roof

    def rooflines(mod):
        local = mod.Roofline(flops=2e12, hbm_bytes=1e9, collective_bytes=0.0,
                             chips=8)
        gossip = mod.Roofline(flops=0.0, hbm_bytes=0.0,
                              collective_bytes=9e8, chips=8)
        return local, gossip

    return (roof, rooflines(roof)), (jroof, rooflines(jroof))


@pytest.mark.parametrize("taus,override", [
    ((4, 2), None), ((4, 2), 0.5), ((64, 1), None), ((2, 4), 1e-3),
    ((3, 0), None)])
def test_predict_overlap_equals_reference(taus, override):
    """The same Roofline numbers (each package's own peak and link rates
    given explicitly as the port's) give the reference's prediction
    bitwise; ``analyze_step``-style dicts give the same as Rooflines."""
    (roof, (local, gossip)), (jroof, _) = _overlap_cases()
    kw = {"t_local_step_s": override} if override is not None else {}
    mine = roof.predict_overlap(local, gossip, *taus, **kw)
    jlocal = jroof.Roofline(flops=2e12, hbm_bytes=1e9, collective_bytes=0.0,
                            chips=8, peak_flops=local.peak_flops,
                            hbm_bw=local.hbm_bw, link_bw=local.link_bw)
    jgossip = jroof.Roofline(flops=0.0, hbm_bytes=0.0, collective_bytes=9e8,
                             chips=8, peak_flops=gossip.peak_flops,
                             hbm_bw=gossip.hbm_bw, link_bw=gossip.link_bw)
    want = jroof.predict_overlap(jlocal, jgossip, *taus, **kw)
    assert mine.as_dict() == want.as_dict()
    as_dicts = roof.predict_overlap({"roofline": local.as_dict()},
                                    gossip.as_dict(), *taus, **kw)
    assert as_dicts.as_dict() == mine.as_dict()


def test_predict_overlap_arithmetic():
    """The reference's case, on the port's module."""
    from repro_torch.launch.roofline import Roofline, predict_overlap

    local = Roofline(flops=2e12, hbm_bytes=1e9, collective_bytes=0.0,
                     chips=8)
    gossip = Roofline(flops=0.0, hbm_bytes=0.0, collective_bytes=9e8,
                      chips=8)
    p = predict_overlap(local, gossip, tau1=4, tau2=2)
    tl = max(local.compute_s, local.memory_s)
    tg = gossip.collective_s
    assert p.additive_s == pytest.approx(4 * tl + 2 * tg)
    assert p.pipelined_s == pytest.approx(4 * tl + max(0.0, 2 * tg - 4 * tl))
    assert p.hidden_s == pytest.approx(p.additive_s - p.pipelined_s)
    assert p.speedup == pytest.approx(p.additive_s / p.pipelined_s)
    assert p.hidden_s > 0                             # gossip-heavy: a win
    pm = predict_overlap(local, gossip, tau1=4, tau2=2, t_local_step_s=0.5)
    assert pm.t_local_step_s == 0.5
    assert pm.t_gossip_step_s == pytest.approx(tg)
    big = predict_overlap(local, gossip, tau1=64, tau2=1)
    assert big.hidden_s == pytest.approx(big.tau2 * tg)
    assert big.pipelined_s == pytest.approx(64 * tl)
    assert p.as_dict()["speedup"] == pytest.approx(p.speedup)


@pytest.mark.parametrize("topo", ["ring", "full"])
def test_stale_mixing_zeta_equals_reference(topo):
    from repro.core import fully_connected as jfully_connected
    from repro.planner import stale_mixing_zeta as jstale
    from repro.planner.bounds import sporadic_zeta as jsporadic
    from repro_torch.core import fully_connected
    from repro_torch.planner import stale_mixing_zeta
    from repro_torch.planner.bounds import sporadic_zeta

    t = ring(N) if topo == "ring" else fully_connected(N)
    jt = jring(N) if topo == "ring" else jfully_connected(N)
    zs = [stale_mixing_zeta(t, s) for s in (0.0, 0.5, 1.0, 3.0)]
    assert zs == [jstale(jt, s) for s in (0.0, 0.5, 1.0, 3.0)]
    assert zs[0] == sporadic_zeta(t, 1.0) == jsporadic(jt, 1.0)
    if topo == "ring":
        assert zs[0] < zs[2] < zs[3] < 1.0
    with pytest.raises(ValueError, match="staleness"):
        stale_mixing_zeta(t, -0.5)
