"""The port's round executor (``repro_torch.core.executor``) and its dynamic
round, mirroring every dense-engine case of tests/test_executor.py and
holding supersteps against the reference's ``RoundExecutor``.

Within the port, the contracts are bitwise on the CPU: a dynamic round's
state is the static round's (its loss within 1 f32 ulp, the summation
order differing), and a superstep or a ``[K, 2]`` trajectory is K
sequential rounds, for plain DFL and every compressor (the random ones draw
from the state's seam at ``round_idx + k``). Against the reference: plain
DFL and TopK to rtol 1e-5, QSGD fed the reference's own draws to rtol 1e-4
(``test_torch_round._reference_draws``). Eager PyTorch has no compile, so
``compile_count`` counts builds of the round function: one for the dynamic
mode whatever the schedule or K, one per (tau1, tau2) for the static one.
"""
import time

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
from repro_torch.core import (DFLConfig, HostPrefetcher, MetricsBuffer,
                              RoundExecutor, consensus_distance, init_state,
                              make_compressor, make_round_fn, ring,
                              stack_round_batches)
from repro_torch.core.rng import ReplayDraws
from repro_torch.core.topology import from_adjacency
from repro_torch.optim import momentum_sgd, sgd
from test_torch_round import _reference_draws

N = 8
DIM = 5
COMPRESSORS = {"dfl": None, "top_k": ("top_k", {"frac": 0.6}),
               "qsgd": ("qsgd", {"levels": 4}),
               "rand_k": ("rand_k", {"frac": 0.6}),
               "rand_gossip": ("rand_gossip", {"p": 0.7})}


def quad_loss(p, b):
    return torch.mean((p["w"] - b) ** 2)


def batches_for(tau1, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(tau1, N, DIM)).astype(np.float32))


def fresh_state(opt, compressed=False, seed=1):
    return init_state({"w": torch.zeros(DIM)}, N, opt, compressed=compressed,
                      seed=seed)


def comp_of(label):
    spec = COMPRESSORS[label]
    return make_compressor(spec[0], **spec[1]) if spec else None


def assert_tree_bitwise(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_tree_bitwise(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b) and torch.equal(torch.signbit(a),
                                             torch.signbit(b))


def assert_state_bitwise(a, b):
    for field in ("params", "opt_state", "hat_params"):
        assert_tree_bitwise(getattr(a, field), getattr(b, field))


# ---------------------------------------------------------------------------
# Dynamic taus == static taus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp,opt_name", [
    ("dfl", "sgd"), ("qsgd", "sgd"), ("top_k", "momentum"),
    ("rand_k", "sgd"), ("rand_gossip", "sgd")])
def test_dynamic_round_equals_static_round(comp, opt_name):
    opt = sgd(0.1) if opt_name == "sgd" else momentum_sgd(0.1)
    c = comp_of(comp)
    cfg_static = DFLConfig(tau1=3, tau2=2, topology=ring(N), compression=c,
                           gamma=0.5)
    cfg_max = DFLConfig(tau1=5, tau2=4, topology=ring(N), compression=c,
                        gamma=0.5)
    full = batches_for(5)
    ref, m_ref = make_round_fn(cfg_static, quad_loss, opt)(
        fresh_state(opt, c is not None), full[:3])
    out, m_dyn = make_round_fn(cfg_max, quad_loss, opt, dynamic_taus=True)(
        fresh_state(opt, c is not None), full, 3, 2)
    assert_state_bitwise(ref, out)
    assert out.round_idx == 1
    assert torch.equal(m_ref["consensus_sq"], m_dyn["consensus_sq"])
    assert_within_ulp(m_dyn["loss"], m_ref["loss"])


def assert_within_ulp(got, want):
    """The loss metric: within 1 f32 ulp (l_0 + l_1 + ... then / tau1,
    against the static round's mean of the stacked losses)."""
    a, b = np.float32(got.item()), np.float32(want.item())
    assert abs(a - b) <= np.spacing(abs(b)), (a, b)


def test_dynamic_round_at_maxima_and_tau2_zero():
    """The bounds themselves and the no-gossip edge run through one built
    round."""
    opt = sgd(0.1)
    cfg_max = DFLConfig(tau1=4, tau2=3, topology=ring(N))
    ex = RoundExecutor(cfg_max, quad_loss, opt, donate=False)
    full = batches_for(4)
    st = fresh_state(opt)
    for (t1, t2) in [(4, 3), (1, 0), (2, 3)]:
        cfg_s = DFLConfig(tau1=t1, tau2=t2, topology=ring(N))
        ref, _ = make_round_fn(cfg_s, quad_loss, opt)(st, full[:t1])
        out, _ = ex.dispatch_round(st, full, t1, t2)
        assert_state_bitwise(ref, out)
    assert ex.compile_count == 1


def test_dynamic_round_topology_schedule_parity():
    """Round-varying topologies under dynamic taus: round k gossips over
    schedule[k % len] through mix_dense; the static round and the
    reference's agree."""
    adj = np.zeros((N, N), np.int64)
    for i in range(0, N, 2):
        j = (i + 1) % N
        adj[i, j] = adj[j, i] = 1
    m0 = from_adjacency("m0", adj)
    sched = (m0, ring(N))
    opt = sgd(0.1)
    cfg_s = DFLConfig(tau1=2, tau2=2, topology=m0, topology_schedule=sched)
    cfg_max = DFLConfig(tau1=3, tau2=3, topology=m0, topology_schedule=sched)
    full = batches_for(3)
    rf_s = make_round_fn(cfg_s, quad_loss, opt)
    rf_d = make_round_fn(cfg_max, quad_loss, opt, dynamic_taus=True)
    ref = out = fresh_state(opt)
    for _ in range(2):   # two rounds: both topologies of the schedule
        ref, _ = rf_s(ref, full[:2])
        out, _ = rf_d(out, full, 2, 2)
    assert_state_bitwise(ref, out)
    # and the reference's schedule, from the same numbers
    from repro.core import make_round_fn as jmake_round_fn
    from repro.core.topology import from_adjacency as jfrom_adjacency

    jm0 = jfrom_adjacency("m0", adj)
    jcfg = JDFLConfig(tau1=2, tau2=2, topology=jm0,
                      topology_schedule=(jm0, jring(N)))
    jst = jinit_state({"w": jnp.zeros((DIM,))}, N, jsgd(0.1),
                      jax.random.key(1))
    jrf = jax.jit(jmake_round_fn(jcfg, lambda p, b, k=None: jnp.mean(
        (p["w"] - b) ** 2), jsgd(0.1)))
    for _ in range(2):
        jst, _ = jrf(jst, jnp.asarray(full[:2].numpy()))
    np.testing.assert_allclose(out.params["w"].numpy(),
                               np.asarray(jst.params["w"]), rtol=1e-6,
                               atol=1e-7)


def test_dense_power_rejects_dynamic_taus():
    cfg = DFLConfig(tau1=2, tau2=2, topology=ring(N),
                    mixing_impl="dense_power")
    with pytest.raises(ValueError, match="dense_power"):
        make_round_fn(cfg, quad_loss, sgd(0.1), dynamic_taus=True)
    with pytest.raises(ValueError, match="dense_power"):
        RoundExecutor(cfg, quad_loss, sgd(0.1))
    with pytest.raises(ValueError, match="dense_power"):
        DFLConfig(tau1=2, tau2=2, topology=ring(N), mixing_impl="dense_power",
                  compression=comp_of("top_k"))


def test_dense_power_static_executor_matches_iterated_rounds():
    """dense_power runs on the static fallback: one C^tau2 product a round,
    within f32 rounding of tau2 iterated steps, and its own rounds bitwise
    through the executor."""
    opt = sgd(0.1)
    per_round = [batches_for(2, seed=30 + i) for i in range(3)]
    cfg_pow = DFLConfig(tau1=2, tau2=3, topology=ring(N),
                        mixing_impl="dense_power")
    rf = make_round_fn(cfg_pow, quad_loss, opt)
    it = make_round_fn(DFLConfig(tau1=2, tau2=3, topology=ring(N)),
                       quad_loss, opt)
    ref = iterated = fresh_state(opt)
    for b in per_round:
        ref, m = rf(ref, b)
        iterated, mi = it(iterated, b)
        assert float(m["consensus_sq"]) == pytest.approx(
            float(mi["consensus_sq"]), rel=1e-5)
    np.testing.assert_allclose(ref.params["w"].numpy(),
                               iterated.params["w"].numpy(), rtol=1e-6,
                               atol=1e-7)
    ex = RoundExecutor(cfg_pow, quad_loss, opt, dynamic=False)
    out, _ = ex.dispatch(fresh_state(opt),
                         stack_round_batches(per_round, 2, "cpu"), 2, 3)
    assert_state_bitwise(ref, out)
    assert ex.compile_count == 1


# ---------------------------------------------------------------------------
# Supersteps
# ---------------------------------------------------------------------------


def test_superstep_equals_sequential_rounds():
    """K rounds of one dispatch are K sequential round_fn calls: state
    bitwise, metrics stacked [K], round_idx advanced K, the seam kept."""
    opt = sgd(0.1)
    rf = make_round_fn(DFLConfig(tau1=2, tau2=1, topology=ring(N)),
                       quad_loss, opt)
    per_round = [batches_for(2, seed=10 + i) for i in range(4)]
    ref = fresh_state(opt)
    ref_metrics = []
    for b in per_round:
        ref, m = rf(ref, b)
        ref_metrics.append(m)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                       quad_loss, opt)
    st = fresh_state(opt)
    draws = st.draws
    out, m = ex.dispatch(st, stack_round_batches(per_round, 3, "cpu"), 2, 1)
    assert_state_bitwise(ref, out)
    assert out.round_idx == 4 and out.draws is draws
    assert m["loss"].shape == (4,)
    for i, mr in enumerate(ref_metrics):
        assert torch.equal(mr["consensus_sq"], m["consensus_sq"][i])
        assert_within_ulp(m["loss"][i], mr["loss"])


@pytest.mark.parametrize("label", sorted(COMPRESSORS))
def test_trajectory_superstep_equals_sequential_rounds(label):
    """A [K, 2] trajectory in one superstep equals the same schedule as K
    sequential static rounds, each at its own (tau1, tau2): state bitwise,
    metrics tagged with the realized schedule, and the random compressors'
    draws taken at round_idx + k."""
    schedule = [(2, 1), (3, 0), (1, 2), (3, 2)]
    comp = comp_of(label)
    opt = sgd(0.1)
    per_round = [batches_for(3, seed=20 + i) for i in range(len(schedule))]
    ref = fresh_state(opt, compressed=comp is not None)
    for b, (t1, t2) in zip(per_round, schedule):
        cfg_s = DFLConfig(tau1=t1, tau2=t2, topology=ring(N),
                          compression=comp, gamma=0.5)
        ref, _ = make_round_fn(cfg_s, quad_loss, opt)(ref, b[:t1])
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N),
                                 compression=comp, gamma=0.5),
                       quad_loss, opt)
    out, m = ex.dispatch_trajectory(
        fresh_state(opt, compressed=comp is not None),
        stack_round_batches(per_round, 3, "cpu"),
        np.array(schedule, np.int32))
    assert_state_bitwise(ref, out)
    assert out.round_idx == len(schedule)
    assert m["tau1"].tolist() == [t1 for t1, _ in schedule]
    assert m["tau2"].tolist() == [t2 for _, t2 in schedule]


def test_trajectory_shares_the_build_with_uniform_dispatch():
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=4, tau2=3, topology=ring(N)),
                       quad_loss, opt)
    stacked = stack_round_batches([batches_for(4, seed=i) for i in range(3)],
                                  4, "cpu")
    st, _ = ex.dispatch(fresh_state(opt), stacked, 2, 2)
    assert ex.compile_count == 1
    st, _ = ex.dispatch_trajectory(
        st, stacked, np.array([(4, 3), (1, 0), (2, 1)], np.int32))
    st, _ = ex.dispatch_trajectory(
        st, stacked, np.array([(1, 1), (4, 0), (3, 3)], np.int32))
    assert ex.compile_count == 1


def test_trajectory_static_fallback_segments():
    """dynamic=False plays a trajectory as contiguous uniform segments
    through the keyed cache: one build per distinct (tau1, tau2), the state
    bitwise the dynamic mode's."""
    opt = sgd(0.1)
    schedule = np.array([(2, 1), (2, 1), (3, 2)], np.int32)
    stacked = stack_round_batches([batches_for(3, seed=i) for i in range(3)],
                                  3, "cpu")
    dyn = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                        quad_loss, opt)
    want, _ = dyn.dispatch_trajectory(fresh_state(opt), stacked, schedule)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                       quad_loss, opt, dynamic=False)
    out, m = ex.dispatch_trajectory(fresh_state(opt), stacked, schedule)
    assert ex.compile_count == 2
    assert_state_bitwise(want, out)
    assert m["tau1"].tolist() == [2, 2, 3]
    assert m["tau2"].tolist() == [1, 1, 2]
    assert m["loss"].shape == (3,)


def test_trajectory_validation():
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                       quad_loss, opt)
    stacked = stack_round_batches([batches_for(3)] * 2, 3, "cpu")
    st = fresh_state(opt)
    with pytest.raises(ValueError, match=r"\[K, 2\]"):
        ex.dispatch_trajectory(st, stacked, np.array([2, 1], np.int32))
    with pytest.raises(ValueError, match="K=2"):
        ex.dispatch_trajectory(st, stacked, np.array([(2, 1)] * 3, np.int32))
    with pytest.raises(ValueError, match="tau1=4"):
        ex.dispatch_trajectory(st, stacked,
                               np.array([(2, 1), (4, 1)], np.int32))
    with pytest.raises(ValueError, match="tau2=3"):
        ex.dispatch_trajectory(st, stacked,
                               np.array([(2, 1), (2, 3)], np.int32))
    assert ex.dispatch_count == 0


def test_superstep_round_idx_continues_across_dispatches():
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=2, tau2=1, topology=ring(N)),
                       quad_loss, opt)
    stacked = stack_round_batches([batches_for(2), batches_for(2, 3)], 2,
                                  "cpu")
    st, _ = ex.dispatch(fresh_state(opt), stacked, 2, 1)
    st, _ = ex.dispatch(st, stacked, 2, 1)
    assert st.round_idx == 4
    assert ex.rounds_dispatched == 4 and ex.dispatch_count == 2


# ---------------------------------------------------------------------------
# Builds across re-plans
# ---------------------------------------------------------------------------


def test_replan_triggers_zero_builds():
    """Re-planning (tau1, tau2) dispatches through the round already
    built; in eager mode a new K is no new build either (the reference
    compiles once more there)."""
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=5, tau2=4, topology=ring(N)),
                       quad_loss, opt)
    stacked = stack_round_batches([batches_for(5)], 5, "cpu")
    assert ex.compile_count == 0
    st, _ = ex.dispatch(fresh_state(opt), stacked, 3, 2)
    assert ex.compile_count == 1
    for (t1, t2) in [(5, 4), (1, 0), (2, 3), (3, 2)]:
        st, _ = ex.dispatch(st, stacked, t1, t2)
    st, _ = ex.dispatch(
        st, stack_round_batches([batches_for(5)] * 2, 5, "cpu"), 2, 2)
    assert ex.compile_count == 1


def test_static_fallback_build_cache():
    """dynamic=False: one build per distinct (tau1, tau2), cached; the
    padding is sliced off, so it matches the static round."""
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=5, tau2=4, topology=ring(N)),
                       quad_loss, opt, dynamic=False)
    stacked = stack_round_batches([batches_for(5)], 5, "cpu")
    st, _ = ex.dispatch(fresh_state(opt), stacked, 3, 2)
    st, _ = ex.dispatch(st, stacked, 3, 2)
    assert ex.compile_count == 1
    st, _ = ex.dispatch(st, stacked, 2, 2)
    assert ex.compile_count == 2
    st, _ = ex.dispatch(st, stacked, 3, 2)
    assert ex.compile_count == 2
    ref, _ = make_round_fn(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                           quad_loss, opt)(fresh_state(opt),
                                           batches_for(5)[:3])
    ex2 = RoundExecutor(DFLConfig(tau1=5, tau2=4, topology=ring(N)),
                        quad_loss, opt, dynamic=False)
    out, _ = ex2.dispatch(fresh_state(opt), stacked, 3, 2)
    assert_state_bitwise(ref, out)


def test_dispatch_rejects_out_of_bounds_taus():
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                       quad_loss, opt)
    stacked = stack_round_batches([batches_for(3)], 3, "cpu")
    st = fresh_state(opt)
    for (t1, t2), what in (((4, 1), "tau1=4"), ((1, 3), "tau2=3"),
                           ((0, 1), "tau1=0")):
        with pytest.raises(ValueError, match=what):
            ex.dispatch(st, stacked, t1, t2)
    with pytest.raises(ValueError, match="tau1=4"):
        make_round_fn(DFLConfig(tau1=3, tau2=2, topology=ring(N)), quad_loss,
                      opt, dynamic_taus=True)(st, batches_for(3), 4, 1)


def test_unported_executor_modes_raise():
    """The sparse engine without a node group of N ranks raises the
    reference's ``ValueError``; participation, sampled populations, the
    pipeline and telemetry are ported, and the modes refuse what the
    reference refuses (the static fallback, a population on the dense
    engine)."""
    from repro_torch.core.sharded import NodeGroup
    from repro_torch.obs import Telemetry, validate_stream

    cfg = DFLConfig(tau1=2, tau2=1, topology=ring(N))
    with pytest.raises(ValueError, match="process group"):
        RoundExecutor(cfg, quad_loss, sgd(0.1), engine="sparse")
    with pytest.raises(ValueError, match="has 1 ranks but"):
        RoundExecutor(cfg, quad_loss, sgd(0.1), engine="sparse",
                      group=NodeGroup(0, 1, "cpu", "gloo"))
    tel = Telemetry()
    assert RoundExecutor(cfg, quad_loss, sgd(0.1),
                         telemetry=tel)._tel is tel
    assert RoundExecutor(cfg, quad_loss, sgd(0.1),
                         overlap="pipeline").overlap == "pipeline"
    with pytest.raises(ValueError, match="overlap"):
        RoundExecutor(cfg, quad_loss, sgd(0.1), overlap="sideways")
    with pytest.raises(ValueError, match="batched-engine parameter"):
        RoundExecutor(cfg, quad_loss, sgd(0.1), population=16)
    for kw in ({"participation": True}, {"engine": "auto",
                                         "population": 16}):
        with pytest.raises(ValueError, match="dynamic"):
            RoundExecutor(cfg, quad_loss, sgd(0.1), dynamic=False, **kw)
    assert RoundExecutor(cfg, quad_loss, sgd(0.1),
                         participation=True).row_width == 2 + N + N
    assert RoundExecutor(cfg, quad_loss, sgd(0.1), engine="auto",
                         population=16).row_width == 2 + 2 * N + N
    pf = HostPrefetcher(telemetry=tel)
    pf.schedule(lambda: 1, meta="m")
    assert pf.take() == (1, "m")
    pf.close()
    buf = MetricsBuffer(telemetry=tel)
    buf.push(0, 1, 2, 1, {"loss": torch.ones(1)})
    assert buf.flush()[0]["loss"] == 1.0
    kinds = [(e["type"], e.get("name")) for e in tel.events]
    assert kinds[1:] == [("prefetch", "build"), ("prefetch", "close"),
                         ("flush", "metrics-flush")]
    assert validate_stream(tel.events) == []


# ---------------------------------------------------------------------------
# Donation: the state stays in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", ["dfl", "top_k"])
def test_donate_keeps_storage(label):
    """donate=True returns the passed state's tensors, overwritten with the
    result, so every data_ptr comes back; donate=False leaves the passed
    state untouched. Both give the same values."""
    comp = comp_of(label)
    opt = momentum_sgd(0.1)
    cfg = DFLConfig(tau1=3, tau2=2, topology=ring(N), compression=comp,
                    gamma=0.5)
    stacked = stack_round_batches([batches_for(3, seed=i) for i in range(3)],
                                  3, "cpu")
    schedule = np.array([(3, 2), (1, 0), (2, 1)], np.int32)
    kept = fresh_state(opt, compressed=comp is not None)
    before = {f: [t.clone() for t in _leaves(getattr(kept, f))]
              for f in ("params", "opt_state", "hat_params")}
    want, _ = RoundExecutor(cfg, quad_loss, opt, donate=False)\
        .dispatch_trajectory(kept, stacked, schedule)
    for f, ts in before.items():
        for a, b in zip(_leaves(getattr(kept, f)), ts):
            assert torch.equal(a, b)
    st = fresh_state(opt, compressed=comp is not None)
    ptrs = {f: [t.data_ptr() for t in _leaves(getattr(st, f))]
            for f in ("params", "opt_state", "hat_params")}
    out, _ = RoundExecutor(cfg, quad_loss, opt).dispatch_trajectory(
        st, stacked, schedule)
    for f, ps in ptrs.items():
        assert [t.data_ptr() for t in _leaves(getattr(out, f))] == ps
    assert_state_bitwise(want, out)
    assert out.round_idx == 3


def _leaves(tree):
    from repro_torch.core.tree import tree_leaves
    return tree_leaves(tree)


# ---------------------------------------------------------------------------
# Against the reference RoundExecutor
# ---------------------------------------------------------------------------

LIN_DIM, LIN_B = 16, 4


def lin_loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def jlin_loss(p, b, k=None):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def lin_round_batches(k, tau1s, seed=5):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=LIN_DIM).astype(np.float32)
    out = []
    for r in range(k):
        x = rng.normal(size=(tau1s[r], N, LIN_B, LIN_DIM)).astype(np.float32)
        x += np.linspace(-1, 1, N, dtype=np.float32)[None, :, None, None]
        out.append({"x": x, "y": (x @ w_true).astype(np.float32)})
    return out


@pytest.mark.parametrize("label", ["dfl", "top_k", "qsgd"])
def test_trajectory_matches_reference_executor(label):
    """A K = 3 trajectory of the port's executor against the reference's on
    the same numpy batches (dict batches): plain DFL and TopK to rtol 1e-5,
    QSGD with the reference's own draws replayed to rtol 1e-4."""
    schedule = [(3, 2), (1, 0), (2, 1)]
    spec = COMPRESSORS[label]
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    jcomp = jmake_compressor(spec[0], **spec[1]) if spec else None
    rtol = 1e-4 if label == "qsgd" else 1e-5
    per_round = lin_round_batches(3, [t1 for t1, _ in schedule])
    rng = jax.random.key(3)
    draws = None
    if label == "qsgd":  # before the reference's dispatch donates rng
        draws = ReplayDraws(_reference_draws(
            comp, rng, {"w": (LIN_DIM,)}, rounds=3,
            tau2=[t2 for _, t2 in schedule], n=N), device="cpu")
    jex = JRoundExecutor(JDFLConfig(tau1=3, tau2=2, topology=jring(N),
                                    compression=jcomp, gamma=0.5),
                         jlin_loss, jsgd(0.05))
    jst, jm = jex.dispatch_trajectory(
        jinit_state({"w": jnp.zeros((LIN_DIM,))}, N, jsgd(0.05), rng,
                    compressed=comp is not None),
        jstack_round_batches(per_round, 3), np.array(schedule, np.int32))
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N),
                                 compression=comp, gamma=0.5),
                       lin_loss, sgd(0.05))
    st = init_state({"w": torch.zeros(LIN_DIM)}, N, sgd(0.05),
                    compressed=comp is not None, draws=draws)
    out, m = ex.dispatch_trajectory(st, stack_round_batches(per_round, 3,
                                                            "cpu"),
                                    np.array(schedule, np.int32))
    for key in ("loss", "consensus_sq"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=rtol)
    for key in ("tau1", "tau2"):
        np.testing.assert_array_equal(m[key].numpy(), np.asarray(jm[key]))
    trees = [(out.params, jst.params)]
    if comp is not None:
        trees.append((out.hat_params, jst.hat_params))
    for got, want in trees:
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=rtol, atol=1e-6)
    assert out.round_idx == int(jst.round_idx) == 3
    assert float(consensus_distance(out.params)) == pytest.approx(
        float(m["consensus_sq"][-1]), rel=1e-5)


# ---------------------------------------------------------------------------
# Host-side pieces: batch stacking, prefetch, deferred metrics
# ---------------------------------------------------------------------------


def test_stack_round_batches_pads_and_checks():
    a = {"x": np.ones((2, 4)), "y": np.ones((2, 3, 2))}
    b = {"x": 2 * np.ones((2, 4)), "y": 2 * np.ones((2, 3, 2))}
    out = stack_round_batches([a, b], tau1_max=4, device="cpu")
    assert out["x"].shape == (2, 4, 4) and out["y"].shape == (2, 4, 3, 2)
    assert torch.equal(out["x"][1, :2], torch.full((2, 4), 2.0,
                                                   dtype=torch.float64))
    assert not out["x"][:, 2:].any()
    tup = stack_round_batches([(torch.ones(1, 3), torch.zeros(1))], 2, "cpu")
    assert isinstance(tup, tuple) and tup[0].shape == (1, 2, 3)
    with pytest.raises(ValueError, match="tau1_max"):
        stack_round_batches([{"x": np.ones((5, 4))}], tau1_max=4,
                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stack_round_batches([a], tau1_max=4)


def test_host_prefetcher_overlap_and_staleness():
    pf = HostPrefetcher()

    def build(r, k):
        time.sleep(0.01)
        return ("batches", r, k)

    pf.schedule(build, 3, 2, meta=(3, 2))
    assert pf.pending_meta == (3, 2)
    out, meta = pf.take()
    assert out == ("batches", 3, 2) and meta == (3, 2)
    assert pf.pending_meta is None
    pf.schedule(lambda: 1 / 0, meta="boom")
    with pytest.raises(ZeroDivisionError):
        pf.take()
    pf.schedule(build, 0, 1, meta="stale")
    pf.cancel()
    assert pf.pending_meta is None


def test_host_prefetcher_failure_paths():
    """Misuse raises; a worker's exception surfaces on take() and counts as
    an error; retries re-run a failing build; close() joins and refuses."""
    pf = HostPrefetcher()
    with pytest.raises(RuntimeError, match="nothing scheduled"):
        pf.take()
    pf.schedule(lambda: "ok", meta="a")
    with pytest.raises(RuntimeError, match="previous prefetch not taken"):
        pf.schedule(lambda: "ok2", meta="b")
    assert pf.take() == ("ok", "a")
    pf.schedule(lambda: 1 / 0, meta="boom")
    with pytest.raises(ZeroDivisionError):
        pf.take()
    pf.schedule(lambda: "alive", meta="c")
    assert pf.take() == ("alive", "c")
    pf.schedule(lambda: "discarded", meta="d")
    pf.cancel()
    assert pf.pending_meta is None
    pf.cancel()
    pf.mark_stale()
    assert pf.stats == {"scheduled": 4, "taken": 2, "cancelled": 1,
                        "stale": 1, "errors": 1, "retries": 0}
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "third time"

    pf2 = HostPrefetcher(retries=2, backoff_s=0.0)
    pf2.schedule(flaky)
    assert pf2.take() == ("third time", None)
    assert pf2.stats["retries"] == 2
    pf2.schedule(time.sleep, 0.01)
    pf2.close()
    pf2.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf2.schedule(lambda: 1)


def test_metrics_buffer_defers_and_amortizes():
    buf = MetricsBuffer()
    assert buf.flush() == []
    m1 = {"loss": torch.tensor([1.0, 2.0]),
          "consensus_sq": torch.tensor([0.1, 0.2])}
    m2 = {"loss": torch.tensor([3.0]), "consensus_sq": torch.tensor([0.3])}
    buf.push(10, 2, 4, 1, m1, dispatched_at=time.perf_counter() - 0.3)
    buf.push(12, 1, 2, 2, m2)
    assert buf.pending_rounds == 3
    rows = buf.flush()
    assert [r["round"] for r in rows] == [10, 11, 12]
    assert [r["loss"] for r in rows] == [1.0, 2.0, 3.0]
    assert [r["tau1"] for r in rows] == [4, 4, 2]
    assert rows[0]["round_s"] == rows[2]["round_s"] >= 0.1
    assert buf.pending_rounds == 0 and buf.flush() == []


def test_metrics_buffer_uses_metric_carried_taus():
    """An executor dispatch's metrics carry each round's realized taus;
    the buffer's rows report those."""
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                       quad_loss, opt)
    t0 = time.perf_counter()
    _, m = ex.dispatch_trajectory(
        fresh_state(opt), stack_round_batches([batches_for(3)] * 3, 3, "cpu"),
        np.array([(2, 1), (3, 0), (1, 2)], np.int32))
    buf = MetricsBuffer()
    buf.push(5, 3, None, None, m, dispatched_at=t0)
    rows = buf.flush()
    assert [(r["tau1"], r["tau2"]) for r in rows] == [(2, 1), (3, 0), (1, 2)]
    assert all(isinstance(r["tau1"], int) for r in rows)
    assert [r["loss"] for r in rows] == [float(v) for v in m["loss"]]
    assert [r["round"] for r in rows] == [5, 6, 7]


def test_executor_warmup_builds_without_stats():
    """warmup() builds the round and runs it on a copy of the state: the
    first real dispatch adds no build, and the statistics and the caller's
    state are untouched."""
    opt = sgd(0.1)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=ring(N)),
                       quad_loss, opt)
    st = fresh_state(opt)
    w0 = st.params["w"].clone()
    stacked = stack_round_batches([batches_for(3)] * 2, 3, "cpu")
    ex.warmup(st, stacked)
    assert ex.compile_count == 1
    assert ex.dispatch_count == 0 and ex.rounds_dispatched == 0
    assert torch.equal(st.params["w"], w0) and st.round_idx == 0
    out, _ = ex.dispatch(st, stacked, 3, 2)
    assert ex.compile_count == 1
    assert out.round_idx == 2


def test_config_helpers_and_consensus_distance_match_reference():
    """d_sgd / c_sgd / sync_sgd configs and ``tau`` as the reference's;
    ``consensus_distance`` to rtol 1e-6 of the reference's on the same
    stacked tree (one f32 sum per leaf, summed in another order)."""
    from repro.core import (c_sgd_config as jc_sgd, consensus_distance
                            as jconsensus, d_sgd_config as jd_sgd,
                            sync_sgd_config as jsync)
    from repro_torch.core import (c_sgd_config, d_sgd_config,
                                  sync_sgd_config)

    for got, want in ((d_sgd_config(ring(N)), jd_sgd(jring(N))),
                      (c_sgd_config(5, ring(N)), jc_sgd(5, jring(N))),
                      (sync_sgd_config(N, tau1=3), jsync(N, tau1=3))):
        assert (got.tau1, got.tau2, got.tau) == (want.tau1, want.tau2,
                                                 want.tau)
        np.testing.assert_array_equal(got.topology.mixing,
                                      want.topology.mixing)
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(N, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(N, 7)).astype(np.float32)}
    got = consensus_distance({k: torch.from_numpy(v)
                              for k, v in tree.items()})
    want = jconsensus({k: jnp.asarray(v) for k, v in tree.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-6)
