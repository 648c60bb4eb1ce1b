"""Sporadic participation and fault plans on the port
(``repro_torch.faults``, ``RoundExecutor(participation=True)``), against
the reference (``repro.faults``, ``tests/test_faults.py``).

What is held here:

* ``FaultPlan`` masks, mask trajectories and events, and ``CohortSampler``
  draws, are the reference's bitwise (the same numpy ``SeedSequence``
  streams), over 200 rounds of a plan with all five fault kinds; specs
  round-trip and are validated as the reference's are.
* All-ones masks are bitwise the unmasked round and executor, for plain
  DFL, TopK and QSGD, on the kernel's circulant path and on ``mix_dense``.
* A crashed node (node mask 0, every incident edge masked) keeps its
  parameters, step count and optimizer slots bitwise; the others move.
* A masked trajectory of the port's executor against the reference's
  masked dense executor: rtol 1e-5 plain DFL, 1e-4 C-DFL (the reference
  mixes by a dense product, the port by the gossip kernel's table), QSGD
  fed the reference's own draws.
* A participation dispatch is bitwise its sequential masked rounds.
* The port's recorded faults: trees of mixed dtypes mix and compress
  against the reference's dense round (1e-5 in f32, 1e-2 in bf16), one
  kernel call per dtype; the entry points hold cuDNN to deterministic
  algorithms for their run and restore the flags after.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.core import DFLConfig as JDFLConfig
from repro.core import RoundExecutor as JRoundExecutor
from repro.core import init_state as jinit_state
from repro.core import make_compressor as jmake_compressor
from repro.core import make_round_fn as jmake_round_fn
from repro.core import ring as jring
from repro.core import stack_round_batches as jstack_round_batches
from repro.core import torus as jtorus
from repro.optim import sgd as jsgd
from repro_torch import faults
from repro_torch.core import (DFLConfig, RoundExecutor, fully_connected,
                              init_state, make_compressor, make_round_fn,
                              mixing, ring, stack_round_batches, torus)
from repro_torch.core import dfl
from repro_torch.core.rng import ReplayDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.kernels import ops
from repro_torch.optim import adamw, momentum_sgd, sgd
from test_torch_round import _reference_draws

N, DIM, B = 8, 12, 3
COMPRESSORS = {"dfl": None, "top_k": ("top_k", {"frac": 0.6}),
               "qsgd": ("qsgd", {"levels": 4}),
               "rand_k": ("rand_k", {"frac": 0.6}),
               "rand_gossip": ("rand_gossip", {"p": 0.7})}
TOPOLOGIES = {"ring": (ring, jring, (N,)), "torus": (torus, jtorus, (2, 4))}


def comp_of(label, mod=None):
    spec = COMPRESSORS[label]
    make = make_compressor if mod is None else jmake_compressor
    return make(spec[0], **spec[1]) if spec else None


def lin_loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def jlin_loss(p, b, k=None):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def lin_round_batches(tau1s, seed=5):
    """One round's {"x" [tau1, N, B, DIM], "y" [tau1, N, B]} per entry of
    ``tau1s``: non-IID linear regression, node i's features shifted."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=DIM).astype(np.float32)
    out = []
    for t1 in tau1s:
        x = rng.normal(size=(t1, N, B, DIM)).astype(np.float32)
        x += np.linspace(-1, 1, N, dtype=np.float32)[None, :, None, None]
        out.append({"x": x, "y": (x @ w_true).astype(np.float32)})
    return out


def fresh(opt, compressed=False, draws=None, seed=1):
    return init_state({"w": torch.zeros(DIM)}, N, opt, compressed=compressed,
                      seed=seed, draws=draws)


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


def five_kinds(mod, topo, seed):
    """A plan with every fault kind, overlapping windows."""
    e = topo.edges()
    return mod.FaultPlan(topo, (
        mod.NodeCrash(node=3, r_start=10, r_stop=40),
        mod.LinkOutage(edges=(e[0], e[2]), r_start=30, r_stop=90),
        mod.StragglerDelay(node=1, slowdown=3.0, r_start=5, r_stop=60),
        mod.LinkFlap(edge=e[4], period=5, up_rounds=2, r_start=50,
                     r_stop=150),
        mod.SporadicParticipation(p_node=0.7, p_edge=0.8, r_start=80,
                                  r_stop=200),
    ), seed=seed)


# ---------------------------------------------------------------------------
# FaultPlan and CohortSampler: the reference's arrays, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_fault_plan_masks_equal_reference(topo_name, seed):
    make, jmake, args = TOPOLOGIES[topo_name]
    plan = five_kinds(faults, make(*args), seed)
    jplan = five_kinds(jfaults, jmake(*args), seed)
    for r in range(200):
        for got, want in zip(plan.masks(r), jplan.masks(r)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert plan.events(r) == jplan.events(r)
    taus = np.random.default_rng(seed).integers(1, 5, (200, 2)).astype(
        np.int32)
    for round0 in (0, 13):
        got = plan.mask_trajectory(taus, round0=round0)
        want = jplan.mask_trajectory(taus, round0=round0)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert plan.to_spec() == jplan.to_spec()


@pytest.mark.parametrize("pop,cohort,seed", [(1000, 10, 0), (37, 8, 5),
                                             (8, 8, 9)])
def test_cohort_sampler_equals_reference(pop, cohort, seed):
    s = faults.CohortSampler(population=pop, cohort=cohort, seed=seed)
    js = jfaults.CohortSampler(population=pop, cohort=cohort, seed=seed)
    assert s.rate == js.rate and s.to_spec() == js.to_spec()
    for r in range(200):
        got, want = s.draw(r), js.draw(r)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    taus = np.tile(np.array([[2, 1]], np.int32), (200, 1))
    topo, jtopo = ring(cohort), jring(cohort)
    wide = five_kinds(faults, topo, seed).mask_trajectory(taus) \
        if cohort >= 5 else taus
    for rows in (taus, wide):
        got = s.cohort_trajectory(rows, round0=3, num_edges=topo.num_edges)
        want = js.cohort_trajectory(rows, round0=3,
                                    num_edges=jtopo.num_edges)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_fault_plan_deterministic_and_composed():
    topo = ring(8)
    plan = faults.FaultPlan(topo, (
        faults.NodeCrash(node=3, r_start=2, r_stop=5),
        faults.LinkOutage(edges=((0, 1),), r_start=4, r_stop=6),
        faults.SporadicParticipation(p_node=0.7, p_edge=0.6, r_start=6,
                                     r_stop=9),
    ), seed=11)
    for r in range(9):
        a, b = plan.masks(r), plan.masks(r)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not all(np.array_equal(plan.masks(6)[0], plan.masks(r)[0])
                   for r in (7, 8))
    nm, em = plan.masks(1)
    assert nm.sum() == 8 and em.sum() == topo.num_edges
    nm, em = plan.masks(4)
    assert nm[3] == 0 and nm.sum() == 7
    assert {e for e, m in zip(topo.edges(), em) if not m} == {
        (2, 3), (3, 4), (0, 1)}
    other = faults.FaultPlan(topo, plan.faults, seed=12)
    assert np.array_equal(other.masks(4)[0], nm)
    assert any(not np.array_equal(other.masks(r)[0], plan.masks(r)[0])
               for r in range(6, 9))


def test_fault_plan_validation():
    topo = ring(4)
    with pytest.raises(ValueError, match="node"):
        faults.FaultPlan(topo, (faults.NodeCrash(node=9, r_start=0,
                                                 r_stop=1),))
    with pytest.raises(ValueError, match="edge"):
        faults.FaultPlan(topo, (faults.LinkOutage(edges=((0, 2),),
                                                  r_start=0, r_stop=1),))
    with pytest.raises(ValueError):
        faults.NodeCrash(node=0, r_start=3, r_stop=3)
    with pytest.raises(ValueError):
        faults.LinkFlap(edge=(0, 1), period=2, up_rounds=2, r_start=0,
                        r_stop=4)


def test_fault_plan_spec_roundtrip(tmp_path):
    import json
    topo = ring(8)
    plan = faults.FaultPlan(topo, (
        faults.NodeCrash(node=1, r_start=0, r_stop=3),
        faults.StragglerDelay(node=2, slowdown=3, r_start=0, r_stop=9),
        faults.LinkFlap(edge=(4, 5), period=3, up_rounds=1, r_start=2,
                        r_stop=8),
        faults.SporadicParticipation(p_node=0.5, p_edge=0.9, r_start=1,
                                     r_stop=7),
    ), seed=5)
    spec = plan.to_spec()
    again = faults.FaultPlan.from_spec(topo, spec)
    assert again.to_spec() == spec
    jagain = jfaults.FaultPlan.from_spec(jring(8), spec)
    for r in range(9):
        for a, b, c in zip(plan.masks(r), again.masks(r), jagain.masks(r)):
            assert np.array_equal(a, b) and np.array_equal(a, c)
    inline = faults.load_fault_spec(json.dumps(spec))
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(spec))
    assert faults.load_fault_spec(f"@{path}") == inline == spec
    with pytest.raises(ValueError, match="faults"):
        faults.load_fault_spec("{}")


def test_mask_trajectory_widens_rows():
    topo = ring(4)
    plan = faults.FaultPlan(topo, (faults.NodeCrash(node=0, r_start=1,
                                                    r_stop=2),))
    taus = np.array([[2, 1], [3, 0], [1, 1]], np.int32)
    rows = plan.mask_trajectory(taus)
    assert rows.shape == (3, 2 + 4 + topo.num_edges)
    assert np.array_equal(rows[:, :2], taus)
    assert rows[0, 2:].sum() == 4 + topo.num_edges
    assert rows[1, 2] == 0
    assert plan.mask_trajectory(taus, round0=1)[0, 2] == 0


def test_cohort_sampler_spec_roundtrip_and_validation():
    s = faults.CohortSampler(population=1000, cohort=32, seed=77)
    assert faults.CohortSampler.from_spec(s.to_spec()) == s
    assert abs(s.rate - 0.032) < 1e-12
    for pop, cohort in ((4, 5), (4, 0)):
        with pytest.raises(ValueError):
            faults.CohortSampler(population=pop, cohort=cohort)
    with pytest.raises(ValueError):
        s.cohort_trajectory(np.zeros((2, 3), np.int32), num_edges=4)
    full = faults.CohortSampler(population=8, cohort=8, seed=3)
    assert np.array_equal(full.draw(11), np.arange(8, dtype=np.int32))


# ---------------------------------------------------------------------------
# The masked round: all ones, a crash, the weight table
# ---------------------------------------------------------------------------


def all_ones(topo, k=1):
    return (np.ones((k, topo.num_nodes), np.int32),
            np.ones((k, topo.num_edges), np.int32))


@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
@pytest.mark.parametrize("label", ["dfl", "top_k", "qsgd"])
def test_all_ones_masks_bitwise_unmasked(label, topo_name):
    """The round with all-ones masks is bitwise the dynamic round, and a
    participation executor's all-ones trajectory the plain executor's."""
    topo = TOPOLOGIES[topo_name][0](*TOPOLOGIES[topo_name][2])
    c = comp_of(label)
    cfg = DFLConfig(tau1=3, tau2=2, topology=topo, compression=c, gamma=0.5)
    opt = momentum_sgd(0.05)
    per_round = lin_round_batches([3, 3])
    b0 = {k: torch.from_numpy(v) for k, v in per_round[0].items()}
    nm, em = all_ones(topo)
    ref, m_ref = make_round_fn(cfg, lin_loss, opt, dynamic_taus=True)(
        fresh(opt, c is not None), b0, 3, 2)
    out, m = make_round_fn(cfg, lin_loss, opt, dynamic_taus=True,
                           participation=True)(
        fresh(opt, c is not None), b0, 3, 2, nm[0], em[0])
    assert_state_bitwise(ref, out)
    for key in m_ref:
        assert torch.equal(m_ref[key], m[key])
    stacked = stack_round_batches(per_round, 3, "cpu")
    rows = np.array([[3, 2], [2, 1]], np.int32)
    plain, mp = RoundExecutor(cfg, lin_loss, opt).dispatch_trajectory(
        fresh(opt, c is not None), stacked, rows)
    part = RoundExecutor(cfg, lin_loss, opt, participation=True)
    wide = np.concatenate([rows, *all_ones(topo, 2)], axis=1)
    out, mw = part.dispatch_trajectory(fresh(opt, c is not None), stacked,
                                       wide)
    assert_state_bitwise(plain, out)
    for key in mp:
        assert torch.equal(mp[key], mw[key])
    assert mw["active_nodes"].tolist() == [topo.num_nodes] * 2
    assert mw["masked_edges"].tolist() == [0, 0]


def test_all_ones_auto_padding_equals_explicit_masks():
    cfg = DFLConfig(tau1=2, tau2=1, topology=ring(N))
    opt = sgd(0.1)
    part = RoundExecutor(cfg, lin_loss, opt, donate=False,
                         participation=True)
    stacked = stack_round_batches(lin_round_batches([2, 2]), 2, "cpu")
    narrow, _ = part.dispatch_trajectory(fresh(opt), stacked,
                                         np.array([[2, 1], [2, 1]], np.int32))
    wide = np.concatenate([np.array([[2, 1], [2, 1]], np.int32),
                           np.ones((2, part.row_width - 2), np.int32)], 1)
    out, _ = part.dispatch_trajectory(fresh(opt), stacked, wide)
    assert_state_bitwise(narrow, out)
    out, m = part.dispatch(fresh(opt), stacked, 2, 1)
    assert_state_bitwise(narrow, out)
    assert part.compile_count == 1


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("label", ["dfl", "qsgd"])
def test_crashed_node_frozen(label, opt_name):
    """A node crashed over rounds 1-2 of 4 keeps its parameters, its step
    count and its optimizer slots bitwise through them; every other node
    moves, and the crashed one moves again once it is back."""
    opt = {"sgd": sgd(0.05), "momentum": momentum_sgd(0.05),
           "adamw": adamw(0.01)}[opt_name]
    topo = ring(N)
    c = comp_of(label)
    cfg = DFLConfig(tau1=2, tau2=2, topology=topo, compression=c, gamma=0.5)
    plan = faults.FaultPlan(topo, (faults.NodeCrash(node=3, r_start=1,
                                                    r_stop=3),))
    rows = plan.mask_trajectory(np.tile(np.array([[2, 2]], np.int32),
                                        (4, 1)))
    ex = RoundExecutor(cfg, lin_loss, opt, participation=True)
    per_round = lin_round_batches([2] * 4)
    state = fresh(opt, c is not None)
    snaps = []
    for r in range(4):
        state, m = ex.dispatch_trajectory(
            state, stack_round_batches(per_round[r:r + 1], 2, "cpu"),
            rows[r:r + 1])
        snaps.append((state.params["w"].clone(),
                      {k: (v.clone() if torch.is_tensor(v) else
                           {n: t.clone() for n, t in v.items()})
                       for k, v in state.opt_state.items()}))
        if r in (1, 2):
            assert int(m["active_nodes"][0]) == N - 1
            assert int(m["masked_edges"][0]) == 2
    for r in (1, 2):
        (w0, o0), (w1, o1) = snaps[r - 1], snaps[r]
        assert torch.equal(w0[3], w1[3])
        for i in (0, 1, 2, 4, 5, 6, 7):
            assert not torch.equal(w0[i], w1[i])
        assert int(o1["step"][3]) == int(o0["step"][3]) == 2
        assert o1["step"].tolist() == [2 * (r + 1)] * 3 + [2] + \
            [2 * (r + 1)] * 4
        for slot, v in o1.items():
            if isinstance(v, dict):
                assert torch.equal(v["w"][3], o0[slot]["w"][3])
    assert not torch.equal(snaps[2][0][3], snaps[3][0][3])
    assert int(snaps[3][1]["step"][3]) == 4


def test_masked_gossip_weights():
    """The round's weight table: bitwise ``gossip_table``'s at all ones;
    a crashed node's row (1, 0, ..., 0); every masked table equal to the
    masked mixing matrix read by columns."""
    rng = np.random.default_rng(0)
    for topo in (ring(10), ring(3), ring(4), fully_connected(6)):
        nbr, w = mixing.gossip_table(topo)
        ones = np.ones(topo.num_edges, np.int32)
        assert np.array_equal(mixing.masked_gossip_weights(topo, ones)
                              .view(np.int32), w.view(np.int32))
        for _ in range(5):
            mask = rng.integers(0, 2, topo.num_edges).astype(np.int32)
            got = mixing.masked_gossip_weights(topo, mask)
            cm = mixing.masked_mixing_matrix(
                topo, torch.from_numpy(mask), torch.float64).numpy()
            dense = np.zeros_like(cm)
            for i in range(topo.num_nodes):
                dense[i, i] += got[i, 0]
                for k in range(nbr.shape[1]):
                    dense[nbr[i, k], i] += got[i, k + 1]
            np.testing.assert_allclose(dense, cm, atol=1e-7)
        crash = np.array([0 if 2 in e else 1 for e in topo.edges()],
                         np.int32)
        row = mixing.masked_gossip_weights(topo, crash)[2]
        assert row[0] == np.float32(1.0) and not row[1:].any()
    with pytest.raises(ValueError, match="edges"):
        mixing.masked_gossip_weights(ring(4), np.ones(3, np.int32))


def test_masked_mix_on_the_kernel_path_matches_mix_dense():
    """``DenseSubstrate.mix`` with an edge mask on a circulant C (K1's plain
    version with the round's weight table) against ``mix_dense`` with the
    masked matrix; f32 and bf16."""
    rng = np.random.default_rng(1)
    topo = ring(6)
    sub = DenseSubstrate(topo)
    tree = {"a": torch.from_numpy(rng.normal(size=(6, 5, 3)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(6, 7)).astype(
            np.float32)).to(torch.bfloat16)}
    for _ in range(4):
        mask = rng.integers(0, 2, topo.num_edges).astype(np.int32)
        got = sub.mix(tree, mask)
        want = mixing.mix_dense(tree, topo, torch.from_numpy(mask))
        for k, tol in (("a", 1e-6), ("b", 1e-2)):
            np.testing.assert_allclose(got[k].float().numpy(),
                                       want[k].float().numpy(), atol=tol)
    with pytest.raises(TypeError, match="host data"):
        sub.mix(tree, torch.ones(topo.num_edges, device="meta"))
    with pytest.raises(ValueError, match="edges"):
        sub.mix(tree, np.ones(3, np.int32))


def test_select_nodes_and_masked_mean():
    sub = DenseSubstrate(ring(4))
    mask = sub.node_mask_local(np.array([1, 0, 1, 0]))
    new = {"step": torch.tensor([5, 5, 5, 5], dtype=torch.int32),
           "velocity": {"w": torch.ones(4, 3)}}
    old = {"step": torch.tensor([4, 4, 4, 4], dtype=torch.int32),
           "velocity": {"w": torch.zeros(4, 3)}}
    out = sub.select_nodes(mask, new, old)
    assert out["step"].tolist() == [5, 4, 5, 4]
    assert out["velocity"]["w"][:, 0].tolist() == [1.0, 0.0, 1.0, 0.0]
    assert sub.select_nodes(np.ones(4, np.int32), new, old) is new
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(sub.masked_mean_over_nodes(x, mask)) == pytest.approx(2.0)
    assert torch.equal(sub.masked_mean_over_nodes(x, np.ones(4, np.int32)),
                       sub.mean_over_nodes(x))
    assert float(sub.masked_mean_over_nodes(x, np.zeros(4, np.int32))) == 0.0
    with pytest.raises(ValueError, match="node mask"):
        sub.node_mask_local(np.ones(3, np.int32))


def test_masks_refused_with_schedule_and_dense_power():
    base = dict(tau1=2, tau2=1, topology=ring(4))
    sched = DFLConfig(**base, topology_schedule=(ring(4), ring(4)))
    with pytest.raises(ValueError, match="topology schedule"):
        make_round_fn(sched, lin_loss, sgd(0.1), dynamic_taus=True,
                      participation=True)
    power = DFLConfig(**base, mixing_impl="dense_power")
    with pytest.raises(ValueError, match="dense_power"):
        dfl.gossip_phase(power, DenseSubstrate(ring(4)),
                         {"w": torch.zeros(4, 3)}, None,
                         edge_mask=np.ones(4, np.int32))
    with pytest.raises(ValueError, match="0/1"):
        RoundExecutor(DFLConfig(**base), lin_loss, sgd(0.1),
                      participation=True).dispatch_trajectory(
            fresh(sgd(0.1)), torch.zeros(1, 2, N, B),
            np.array([[2, 1] + [2] * (4 + 4)], np.int32))


# ---------------------------------------------------------------------------
# Against the reference's masked dense executor, and sequential rounds
# ---------------------------------------------------------------------------


def plan_rows(topo, taus):
    e = topo.edges()
    plan = faults.FaultPlan(topo, (
        faults.NodeCrash(node=3, r_start=1, r_stop=3),
        faults.LinkOutage(edges=(e[0], e[5]), r_start=0, r_stop=2),
        faults.SporadicParticipation(p_node=0.7, p_edge=0.7, r_start=2,
                                     r_stop=4)), seed=2)
    return plan.mask_trajectory(np.asarray(taus, np.int32))


@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
@pytest.mark.parametrize("label", ["dfl", "top_k", "qsgd"])
def test_masked_trajectory_matches_reference(label, topo_name):
    make, jmake, args = TOPOLOGIES[topo_name]
    topo, jtopo = make(*args), jmake(*args)
    schedule = [(3, 2), (2, 1), (3, 2), (1, 2)]
    rows = plan_rows(topo, schedule)
    assert (rows[:, 2:] == 0).any()
    c, jc = comp_of(label), comp_of(label, "ref")
    rtol = 1e-5 if c is None else 1e-4
    per_round = lin_round_batches([t1 for t1, _ in schedule])
    rng = jax.random.key(3)
    draws = None
    if label == "qsgd":
        draws = ReplayDraws(_reference_draws(
            c, rng, {"w": (DIM,)}, rounds=4,
            tau2=[t2 for _, t2 in schedule], n=N), device="cpu")
    jex = JRoundExecutor(JDFLConfig(tau1=3, tau2=2, topology=jtopo,
                                    compression=jc, gamma=0.5),
                         jlin_loss, jsgd(0.05), participation=True)
    jst, jm = jex.dispatch_trajectory(
        jinit_state({"w": jnp.zeros((DIM,))}, N, jsgd(0.05), rng,
                    compressed=c is not None),
        jstack_round_batches(per_round, 3), rows)
    ex = RoundExecutor(DFLConfig(tau1=3, tau2=2, topology=topo,
                                 compression=c, gamma=0.5),
                       lin_loss, sgd(0.05), participation=True)
    out, m = ex.dispatch_trajectory(
        fresh(sgd(0.05), c is not None, draws),
        stack_round_batches(per_round, 3, "cpu"), rows)
    for key in ("loss", "consensus_sq"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=rtol)
    for key in ("tau1", "tau2", "active_nodes", "masked_edges"):
        np.testing.assert_array_equal(m[key].numpy(), np.asarray(jm[key]))
    trees = [(out.params, jst.params)]
    if c is not None:
        trees.append((out.hat_params, jst.hat_params))
    for got, want in trees:
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=rtol, atol=1e-4 if c else 1e-6)
    # a masked node's step count does not advance
    np.testing.assert_array_equal(
        out.opt_state["step"].numpy(),
        (rows[:, :1] * rows[:, 2:2 + N]).sum(axis=0))


@pytest.mark.parametrize("label", sorted(COMPRESSORS))
def test_participation_dispatch_equals_sequential_masked_rounds(label):
    topo = ring(N)
    c = comp_of(label)
    opt = momentum_sgd(0.05)
    cfg = DFLConfig(tau1=3, tau2=2, topology=topo, compression=c, gamma=0.5)
    schedule = [(3, 2), (2, 1), (3, 0), (1, 2)]
    rows = plan_rows(topo, schedule)
    per_round = lin_round_batches([3] * 4)
    out, m = RoundExecutor(cfg, lin_loss, opt, participation=True)\
        .dispatch_trajectory(fresh(opt, c is not None),
                             stack_round_batches(per_round, 3, "cpu"), rows)
    round_fn = make_round_fn(cfg, lin_loss, opt, dynamic_taus=True,
                             participation=True)
    ref = fresh(opt, c is not None)
    for k, (t1, t2) in enumerate(schedule):
        b = {key: torch.from_numpy(v) for key, v in per_round[k].items()}
        ref, mr = round_fn(ref, b, t1, t2, rows[k, 2:2 + N], rows[k, 2 + N:])
        for key in ("loss", "consensus_sq"):
            assert torch.equal(m[key][k], mr[key])
    assert_state_bitwise(ref, out)
    assert out.round_idx == ref.round_idx == 4


# ---------------------------------------------------------------------------
# The port's recorded faults
# ---------------------------------------------------------------------------

MIXED = {"a": ((9,), np.float32), "b": ((4, 5), "bf16")}


def mixed_loss(p, b):
    return (torch.mean((p["a"] - b["ta"]) ** 2)
            + torch.mean((p["b"].float() - b["tb"]) ** 2))


def jmixed_loss(p, b, k=None):
    return (jnp.mean((p["a"] - b["ta"]) ** 2)
            + jnp.mean((p["b"].astype(jnp.float32) - b["tb"]) ** 2))


@pytest.mark.parametrize("label", ["dfl", "top_k"])
def test_mixed_dtype_tree_round_matches_reference(label):
    """A {f32, bf16} tree on ring(6): three rounds of plain DFL or C-DFL
    TopK against the reference's dense round, 1e-5 in f32 and 1e-2 in
    bf16; the gossip kernel and the TopK threshold are called once per
    dtype in each gossip step."""
    n, tau1, tau2 = 6, 2, 2
    rng = np.random.default_rng(8)
    p0 = {"a": rng.normal(size=(9,)).astype(np.float32),
          "b": rng.normal(size=(4, 5)).astype(np.float32)}
    c, jc = comp_of(label), comp_of(label, "ref")
    cfg = DFLConfig(tau1=tau1, tau2=tau2, topology=ring(n), compression=c,
                    gamma=0.5)
    jcfg = JDFLConfig(tau1=tau1, tau2=tau2, topology=jring(n),
                      compression=jc, gamma=0.5)
    state = init_state({"a": torch.from_numpy(p0["a"]),
                        "b": torch.from_numpy(p0["b"]).to(torch.bfloat16)},
                       n, sgd(0.1), compressed=c is not None)
    jstate = jinit_state({"a": jnp.asarray(p0["a"]),
                          "b": jnp.asarray(p0["b"], jnp.bfloat16)}, n,
                         jsgd(0.1), jax.random.key(0),
                         compressed=c is not None)
    round_fn = make_round_fn(cfg, mixed_loss, sgd(0.1))
    jround = jax.jit(jmake_round_fn(jcfg, jmixed_loss, jsgd(0.1)))
    calls = {"gossip_mix_many": 0, "topk_threshold_many": 0}
    real = {name: getattr(ops, name) for name in calls}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    for r in range(3):
        ta = rng.normal(size=(tau1, n, 9)).astype(np.float32)
        tb = rng.normal(size=(tau1, n, 4, 5)).astype(np.float32)
        with pytest.MonkeyPatch.context() as mp:
            for name in calls:
                mp.setattr(ops, name, counted(name))
            state, m = round_fn(state, {"ta": torch.from_numpy(ta),
                                        "tb": torch.from_numpy(tb)})
        jstate, jm = jround(jstate, {"ta": jnp.asarray(ta),
                                     "tb": jnp.asarray(tb)})
        for key in ("loss", "consensus_sq"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-2)
    steps = 3 * tau2
    assert calls == {"gossip_mix_many": 2 * steps,
                     "topk_threshold_many": 2 * steps if c else 0}
    trees = [(state.params, jstate.params)]
    if c is not None:
        trees.append((state.hat_params, jstate.hat_params))
    for got, want in trees:
        assert got["b"].dtype == torch.bfloat16
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["b"].float().numpy(),
                                   np.asarray(want["b"], np.float32),
                                   rtol=1e-2, atol=1e-2)


def test_entry_points_hold_cudnn_deterministic_for_their_run(monkeypatch):
    """``RoundExecutor``, ``run_dfl_cnn`` and the quickstart run with
    ``cudnn.deterministic`` on and ``cudnn.benchmark`` off, and restore
    the caller's flags after; ``deterministic=False`` leaves them."""
    from repro_torch.data.images import SyntheticImages
    from repro_torch.examples import quickstart
    from repro_torch.launch import cnn_run

    cudnn = torch.backends.cudnn
    seen = []

    def record(fn):
        def loss(*a, **kw):
            seen.append((cudnn.deterministic, cudnn.benchmark))
            return fn(*a, **kw)
        return loss

    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    cfg = DFLConfig(tau1=2, tau2=1, topology=ring(N))
    stacked = stack_round_batches(lin_round_batches([2]), 2, "cpu")
    for det in (True, False):
        seen.clear()
        RoundExecutor(cfg, record(lin_loss), sgd(0.1),
                      deterministic=det).dispatch(fresh(sgd(0.1)), stacked,
                                                  2, 1)
        assert seen and set(seen) == {(True, False) if det else (False,
                                                                 True)}
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    monkeypatch.setattr(cnn_run, "get_data", lambda flavor: SyntheticImages(
        flavor=flavor, train_size=60, test_size=8, seed=7))
    monkeypatch.setattr(cnn_run, "cnn_loss", record(cnn_run.cnn_loss))
    spec = cnn_run.RunSpec(name="t", tau1=1, tau2=1, rounds=2, batch=2,
                           nodes=4)
    seen.clear()
    runs = [cnn_run.run_dfl_cnn(spec, device="cpu", log_every=1)
            for _ in range(2)]
    assert set(seen) == {(True, False)}
    assert runs[0]["history"] == runs[1]["history"]
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    monkeypatch.setattr(quickstart, "loss_fn", record(quickstart.loss_fn))
    seen.clear()
    quickstart.train(quickstart.variants()[0][1], 2, "t", "cpu")
    assert set(seen) == {(True, False)}
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)


def test_bench_faults_reproduces_the_sign_on_cpu(tmp_path):
    """The port's fault bench: sporadic participation reaches a lower loss
    than blocking at the same budget (the reference's BENCH_faults.json
    reports the same sign), on the same priced schedules, with no build
    after the warmup."""
    import json
    import os

    from repro_torch.benchmarks import bench_faults

    out = bench_faults.main(["--smoke", "--check", "--device", "cpu",
                             "--out", str(tmp_path / "bf")])
    assert out["sporadic_beats_blocking"] and out["margin_x"] > 2.0
    assert out["builds_after_warmup"] == 0
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BENCH_faults.json")) as f:
        ref = json.load(f)
    for policy in ("blocking", "sporadic"):
        assert out[policy]["rounds"] == ref[policy]["rounds"]
        assert out[policy]["priced_time"] == pytest.approx(
            ref[policy]["priced_time"], rel=1e-12)
    assert out["sporadic"]["degraded_rounds"] == \
        ref["sporadic"]["degraded_rounds"]
    assert out["config"]["faults"] == ref["config"]["faults"]
    assert (tmp_path / "bf.json").is_file()
