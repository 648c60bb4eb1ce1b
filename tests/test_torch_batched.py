"""The port's node-batched engine (``BatchedSubstrate``,
``RoundExecutor(engine="batched", population=V)``) against its oracles, as
``tests/test_batched_parity.py`` holds the reference's:

* an identity cohort at V = C is bitwise the dense executor on model
  state and metrics, for {plain, QSGD, TopK} x {full cohort, sampled
  cohort as masks} x {ring, torus};
* rows outside the cohort are bitwise untouched by a sampled round, and
  the cohort's rows are written back into the state's own tensors;
* a sampled cohort equals the dense round over the gathered rows with the
  seam drawing by global id, bitwise, for every compressor;
* against the reference's batched executor: rtol 1e-5 plain DFL, 1e-4
  C-DFL QSGD fed the reference's draws by global id.

The reference's parity tests use a loss that draws noise from its key; the
port's losses take no key, so the per-node jitter is drawn by numpy per
global node id and carried in the batch (QSGD's draws still come from the
seam by id).
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
from repro.core.dfl import round_keys as jround_keys
from repro.optim import sgd as jsgd
from repro_torch import faults
from repro_torch.core import (BatchedSubstrate, DFLConfig, RoundExecutor,
                              init_state, make_compressor, make_round_fn,
                              ring, torus)
from repro_torch.core.rng import Draws, GeneratorDraws, ReplayDraws
from repro_torch.core.tree import tree_leaves
from repro_torch.optim import momentum_sgd, sgd

DIM, TAU1, TAU2, K = 7, 2, 1, 3
COMPRESSORS = {"plain": None, "qsgd": ("qsgd", {"levels": 4}),
               "top_k": ("top_k", {"frac": 0.5}),
               "rand_k": ("rand_k", {"frac": 0.5}),
               "rand_gossip": ("rand_gossip", {"p": 0.7})}
TOPOLOGIES = {"ring": lambda: ring(8), "torus": lambda: torus(2, 4)}


def comp_of(name, make=make_compressor):
    spec = COMPRESSORS[name]
    return make(spec[0], **spec[1]) if spec else None


def noisy_loss(p, b):
    return torch.mean((p["w"] + b["j"] - b["t"]) ** 2)


def jnoisy_loss(p, b, k=None):
    return jnp.mean((p["w"] + b["j"] - b["t"]) ** 2)


def jitter(population, seed=11):
    """Per global node id, per local step: [population, TAU1, DIM]."""
    return (0.05 * np.random.default_rng(seed).normal(
        size=(population, TAU1, DIM))).astype(np.float32)


def cohort_batches(ids_per_round, population, seed=7):
    """[K, TAU1, C, DIM] targets and the jitter of each slot's global id."""
    rng = np.random.default_rng(seed)
    jit = jitter(population)
    k, c = len(ids_per_round), len(ids_per_round[0])
    t = rng.normal(size=(k, TAU1, c, DIM)).astype(np.float32)
    j = np.stack([jit[np.asarray(ids)].transpose(1, 0, 2)
                  for ids in ids_per_round])
    return {"t": t, "j": j}


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def fresh(population, opt, compressed, seed=1, rows=False):
    st = init_state({"w": torch.zeros(DIM)}, population, opt,
                    compressed=compressed, seed=seed)
    if rows:  # distinguishable rows, so that "untouched" is a real claim
        w = np.random.default_rng(0).normal(size=(population, DIM))
        st = st._replace(params={"w": torch.from_numpy(w.astype(np.float32))})
    return st


def assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def model_state(st):
    return (st.params, st.opt_state, st.hat_params)


def rows_for(topo, sampled):
    n, e = topo.num_nodes, topo.num_edges
    plain = np.tile(np.array([[TAU1, TAU2]], np.int32), (K, 1))
    if not sampled:
        return plain, plain
    nm = np.random.default_rng(3).integers(0, 2, (K, n)).astype(np.int32)
    nm[:, 0] = 1
    ones_e = np.ones((K, e), np.int32)
    ids = np.tile(np.arange(n, dtype=np.int32), (K, 1))
    return (np.concatenate([plain, nm, ones_e], 1),
            np.concatenate([plain, ids, nm, ones_e], 1))


@pytest.mark.parametrize("comp_name", ["plain", "qsgd", "top_k"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["full-cohort", "sampled-as-masks"])
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_identity_cohort_equals_dense_bitwise(comp_name, sampled, topo_name):
    topo = TOPOLOGIES[topo_name]()
    n = topo.num_nodes
    c = comp_of(comp_name)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo, compression=c,
                    gamma=0.5)
    dense_rows, batched_rows = rows_for(topo, sampled)
    b = to_torch(cohort_batches([range(n)] * K, n))
    opt = sgd(0.1)
    sd, md = RoundExecutor(cfg, noisy_loss, opt, participation=True)\
        .dispatch_trajectory(fresh(n, opt, c is not None), b, dense_rows)
    sb, mb = RoundExecutor(cfg, noisy_loss, opt, engine="batched",
                           population=n)\
        .dispatch_trajectory(fresh(n, opt, c is not None), b, batched_rows)
    assert_bitwise(model_state(sd), model_state(sb))
    assert_bitwise(md, mb)
    assert sb.round_idx == K


@pytest.mark.parametrize("comp_name", ["plain", "qsgd"])
def test_noncohort_rows_bitwise_untouched(comp_name):
    """V = 16, C = 4: a sampled dispatch leaves every other row of every
    state leaf (parameters, step, velocity, estimates) as it was, moves
    the cohort's, and keeps the state's storage."""
    topo, pop = ring(4), 16
    c = comp_of(comp_name)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo, compression=c,
                    gamma=0.5)
    opt = momentum_sgd(0.1)
    state = fresh(pop, opt, c is not None, rows=True)
    before = [t.clone() for t in tree_leaves(model_state(state))]
    ptrs = [t.data_ptr() for t in tree_leaves(model_state(state))]
    ids = np.array([1, 5, 8, 14], np.int32)
    rows = np.concatenate([
        np.tile(np.array([[TAU1, TAU2]], np.int32), (K, 1)),
        np.tile(ids, (K, 1)),
        np.ones((K, topo.num_nodes + topo.num_edges), np.int32)], 1)
    ex = RoundExecutor(cfg, noisy_loss, opt, engine="batched",
                       population=pop)
    out, m = ex.dispatch_trajectory(
        state, to_torch(cohort_batches([ids] * K, pop)), rows)
    others = np.setdiff1d(np.arange(pop), ids)
    after = tree_leaves(model_state(out))
    assert [t.data_ptr() for t in after] == ptrs
    for a, b in zip(after, before):
        assert torch.equal(a[others], b[others])
    assert not torch.equal(out.params["w"][ids], before[0][ids])
    assert out.opt_state["step"].tolist() == [
        K * TAU1 if i in ids else 0 for i in range(pop)]
    assert m["active_nodes"].tolist() == [4] * K


class ByIds(Draws):
    """A seam over a dense slot axis that draws for fixed global ids."""

    def __init__(self, inner, ids):
        self.inner, self.ids = inner, list(ids)

    def uniform(self, round_idx, step, leaf, shape, node_ids=None):
        assert node_ids is None
        return self.inner.uniform(round_idx, step, leaf, shape,
                                  node_ids=self.ids)


@pytest.mark.parametrize("comp_name", sorted(COMPRESSORS))
def test_sampled_cohort_equals_dense_round_on_gathered_rows(comp_name):
    """One batched round over ids [9, 2, 13, 6] of V = 16 (masks too) is
    bitwise the dense round over those rows with the seam drawing for the
    same global ids, and writes them back into the population."""
    topo, pop = ring(4), 16
    ids = [9, 2, 13, 6]
    c = comp_of(comp_name)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo, compression=c,
                    gamma=0.5)
    opt = momentum_sgd(0.1)
    b = {k: v[0] for k, v in to_torch(cohort_batches([ids], pop)).items()}
    nm, em = np.array([1, 0, 1, 1]), np.array([1, 1, 0, 1])
    state = fresh(pop, opt, c is not None, rows=True)
    gathered = state._replace(
        params={"w": state.params["w"][ids].clone()},
        opt_state={"step": state.opt_state["step"][ids].clone(),
                   "velocity": {"w": state.opt_state["velocity"]["w"][ids]
                                .clone()}},
        hat_params=(None if state.hat_params is None else
                    {"w": state.hat_params["w"][ids].clone()}),
        draws=ByIds(state.draws, ids))
    want, mw = make_round_fn(cfg, noisy_loss, opt, dynamic_taus=True,
                             participation=True)(gathered, b, TAU1, TAU2,
                                                 nm, em)
    got, mg = make_round_fn(cfg, noisy_loss, opt, engine="batched",
                            dynamic_taus=True, population=pop)(
        state, b, TAU1, TAU2, ids, nm, em)
    assert_bitwise(mw, mg)
    for a, w in zip(tree_leaves(model_state(got)),
                    tree_leaves(model_state(want))):
        assert torch.equal(a[ids], w)
    assert got.params["w"] is state.params["w"]


def test_batched_matches_reference_batched_executor():
    """A sampled-cohort trajectory (V = 12, C = 4) of plain DFL and of
    C-DFL QSGD against the reference's batched executor, the QSGD draws the
    reference's own by global id."""
    topo, pop = ring(4), 12
    sampler = faults.CohortSampler(population=pop, cohort=4, seed=3)
    rows = sampler.cohort_trajectory(
        np.tile(np.array([[TAU1, TAU2]], np.int32), (K, 1)),
        num_edges=topo.num_edges)
    b = cohort_batches([r[2:6] for r in rows], pop)
    for comp_name in ("plain", "qsgd"):
        c, jc = comp_of(comp_name), comp_of(comp_name, jmake_compressor)
        rng = jax.random.key(5)
        draws = None
        if c is not None:
            table = {}
            for r in range(K):
                step = jax.random.fold_in(jround_keys(rng, r)[1], 0)
                table[(r, 0, "w")] = np.stack([np.asarray(jax.random.uniform(
                    jax.random.split(jax.random.fold_in(step, i), 1)[0],
                    (DIM,))) for i in range(pop)])
            draws = ReplayDraws(table, "cpu")
        jex = JRoundExecutor(JDFLConfig(tau1=TAU1, tau2=TAU2,
                                        topology=jring(4), compression=jc,
                                        gamma=0.5),
                             jnoisy_loss, jsgd(0.1), engine="batched",
                             population=pop)
        jst, jm = jex.dispatch_trajectory(
            jinit_state({"w": jnp.zeros((DIM,))}, pop, jsgd(0.1), rng,
                        compressed=c is not None),
            {k: jnp.asarray(v) for k, v in b.items()}, rows)
        ex = RoundExecutor(DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo,
                                     compression=c, gamma=0.5),
                           noisy_loss, sgd(0.1), engine="batched",
                           population=pop)
        st = init_state({"w": torch.zeros(DIM)}, pop, sgd(0.1),
                        compressed=c is not None, draws=draws)
        out, m = ex.dispatch_trajectory(st, to_torch(b), rows)
        rtol = 1e-5 if c is None else 1e-4
        for key in ("loss", "consensus_sq"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                       rtol=rtol)
        for key in ("active_nodes", "masked_edges", "tau1", "tau2"):
            np.testing.assert_array_equal(m[key].numpy(),
                                          np.asarray(jm[key]))
        trees = [(out.params, jst.params)]
        if c is not None:
            trees.append((out.hat_params, jst.hat_params))
        for got, want in trees:
            np.testing.assert_allclose(got["w"].numpy(),
                                       np.asarray(want["w"]), rtol=rtol,
                                       atol=1e-6)


def test_donate_false_keeps_the_passed_population():
    topo, pop = ring(4), 10
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo)
    opt = sgd(0.1)
    ids = [[0, 3, 7, 9], [1, 2, 3, 4], [9, 8, 7, 6]]
    rows = np.concatenate([
        np.tile(np.array([[TAU1, TAU2]], np.int32), (K, 1)),
        np.asarray(ids, np.int32),
        np.ones((K, 4 + topo.num_edges), np.int32)], 1)
    b = to_torch(cohort_batches(ids, pop))
    kept = fresh(pop, opt, False, rows=True)
    before = [t.clone() for t in tree_leaves(model_state(kept))]
    want, _ = RoundExecutor(cfg, noisy_loss, opt, engine="batched",
                            population=pop, donate=False)\
        .dispatch_trajectory(kept, b, rows)
    for a, c in zip(tree_leaves(model_state(kept)), before):
        assert torch.equal(a, c)
    got, _ = RoundExecutor(cfg, noisy_loss, opt, engine="batched",
                           population=pop).dispatch_trajectory(
        fresh(pop, opt, False, rows=True), b, rows)
    assert_bitwise(model_state(want), model_state(got))


def test_cohort_trajectory_validation():
    topo = ring(4)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo)
    opt = sgd(0.1)
    ex = RoundExecutor(cfg, noisy_loss, opt, engine="batched", population=8)
    assert ex.row_width == 2 + 2 * 4 + topo.num_edges
    base = np.tile(np.array([[TAU1, TAU2]], np.int32), (2, 1))
    masks = np.ones((2, 4 + topo.num_edges), np.int32)

    def rows_with(ids_row):
        ids = np.tile(np.asarray(ids_row, np.int32), (2, 1))
        return np.concatenate([base, ids, masks], axis=1)

    with pytest.raises(ValueError, match="unique"):
        ex._check_trajectory(rows_with([1, 1, 2, 3]), 2)
    with pytest.raises(ValueError, match="lie in"):
        ex._check_trajectory(rows_with([0, 1, 2, 8]), 2)
    padded = ex._check_trajectory(base, 2)
    np.testing.assert_array_equal(padded[:, 2:6], np.tile(np.arange(4),
                                                          (2, 1)))
    assert (padded[:, 6:] == 1).all()
    with pytest.raises(ValueError, match="batched-engine parameter"):
        RoundExecutor(cfg, noisy_loss, opt, engine="dense", population=8)
    with pytest.raises(ValueError, match="population"):
        RoundExecutor(cfg, noisy_loss, opt, engine="batched")
    with pytest.raises(ValueError, match="smaller"):
        BatchedSubstrate(topo, 3)
    sub = BatchedSubstrate(topo, 8)
    for bad in ([0, 1, 2], [0, 1, 2, 9], [0, 0, 1, 2]):
        with pytest.raises(ValueError):
            sub.with_cohort(bad)


def test_sampler_driven_population_run():
    """CohortSampler rows drive a V = 50 population through six rounds in
    two dispatches, one build: nodes never sampled stay untouched, every
    sampled node moved and counted its steps, and the seam's draws follow
    global ids (a QSGD run replays identically)."""
    topo, pop = ring(5), 50
    sampler = faults.CohortSampler(population=pop, cohort=5, seed=2)
    cfg = DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo,
                    compression=make_compressor("qsgd", levels=4), gamma=0.5)
    ex = RoundExecutor(cfg, noisy_loss, sgd(0.1), engine="batched",
                       population=pop)
    finals = []
    for _ in range(2):
        st = init_state({"w": torch.zeros(DIM)}, pop, sgd(0.1),
                        compressed=True, draws=GeneratorDraws(4, pop, ["w"],
                                                              "cpu"))
        seen = set()
        for r0 in (0, 3):
            rows = sampler.cohort_trajectory(
                np.tile(np.array([[TAU1, TAU2]], np.int32), (3, 1)), r0,
                num_edges=topo.num_edges)
            seen |= set(rows[:, 2:7].ravel().tolist())
            st, _ = ex.dispatch_trajectory(
                st, to_torch(cohort_batches([r[2:7] for r in rows], pop,
                                            seed=r0)), rows)
        finals.append(st)
    assert ex.compile_count == 1
    never = sorted(set(range(pop)) - seen)
    assert never and not finals[0].params["w"][never].any()
    assert finals[0].params["w"][sorted(seen)].abs().sum(1).min() > 0
    steps = finals[0].opt_state["step"]
    assert int(steps.sum()) == 6 * 5 * TAU1 and not steps[never].any()
    assert_bitwise(model_state(finals[0]), model_state(finals[1]))


def test_bench_megascale_runs_on_cpu(tmp_path):
    """The port's megascale bench at its smoke scale (10k virtual nodes),
    fewer rounds: the bitwise gate holds, the scale trains with no build
    after the warmup, and its state bytes are the stacked state's."""
    from repro_torch.benchmarks import bench_megascale as bm

    out = bm.main(["--smoke", "--check", "--rounds", "12", "--device",
                   "cpu", "--out", str(tmp_path / "bm")])
    assert all(out["parity"].values()) and len(out["parity"]) == 4
    (scale,) = out["scales"]
    assert scale["virtual_nodes"] == 10_000 and scale["trained"]
    assert scale["builds_after_warmup"] == 0
    assert scale["state_bytes"] == 10_000 * (bm.DIM * 4 + 4)
    assert scale["rounds_per_s"] > 0 and "peak_rss_mb" in scale
    assert (tmp_path / "bm.json").is_file()
