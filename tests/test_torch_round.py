"""The port's DFL / C-DFL round against the JAX reference's dense engine.

Three rounds of the MNIST CNN on ring(4), tau1 = tau2 = 2, batch 4, from
the same converted weights and the same numpy batches. Plain DFL holds the
per-round loss, consensus and final parameters to rtol 1e-5 (conv and
matmul reductions are ordered differently, never bitwise). C-DFL is held
to rtol 1e-4 on the metrics and 1e-4 absolute on the parameters and
estimates: a coordinate at the TopK boundary may flip in or out of the
kept set when the gradients differ in the last ulp, which moves that
coordinate's estimate by one gap; QSGD, RandK and randomized gossip keep
the same tolerance, their draws being the reference's own, derived from
its keys (``round_keys``, then the step, the node and the leaf split) and
replayed through the port's RNG seam.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DFLConfig as JDFLConfig
from repro.core import init_state as jinit_state
from repro.core import make_compressor as jmake_compressor
from repro.core import make_round_fn as jmake_round_fn
from repro.core import ring as jring
from repro.core import round_wire_bits as jround_wire_bits
from repro.core.dfl import round_keys as jround_keys
from repro.models import cnn as jcnn
from repro.optim import sgd as jsgd
from repro_torch.convert import params_from_jax
from repro_torch.core import dfl
from repro_torch.core.compression import make_compressor
from repro_torch.core.rng import Draws, GeneratorDraws, ReplayDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.core.topology import paper_quasi_ring, ring
from repro_torch.data.images import SyntheticImages, image_batches_for_dfl
from repro_torch.kernels import ops
from repro_torch.launch import cnn_run
from repro_torch.models.cnn import cnn_loss
from repro_torch.optim import sgd

N, TAU1, TAU2, BATCH, LR, GAMMA, ROUNDS = 4, 2, 2, 4, 0.05, 0.6, 3
COMPRESSORS = {"dfl": None, "cdfl_topk": ("top_k", {"frac": 0.67}),
               "cdfl_qsgd": ("qsgd", {"levels": 16}),
               "cdfl_rand_k": ("rand_k", {"frac": 0.67}),
               "cdfl_rand_gossip": ("rand_gossip", {"p": 0.8})}


def _reference_draws(comp, rng, shapes, rounds=ROUNDS, tau2=TAU2, n=N):
    """The uniforms the reference's dense engine draws from ``rng`` for
    every (round, gossip step, leaf), stacked over nodes: comm key =
    round_keys(rng, r)[1], step key = fold_in(comm, t), node key =
    fold_in(step, i), leaf key = split(node, n_leaves)[j] in sorted-name
    order. ``tau2`` is the gossip steps of every round, or a list of them
    round by round."""
    names = sorted(shapes)
    table = {}
    for r in range(rounds):
        comm = jround_keys(rng, r)[1]
        for t in range(tau2[r] if isinstance(tau2, (list, tuple)) else tau2):
            step = jax.random.fold_in(comm, t)
            leaf_keys = [jax.random.split(jax.random.fold_in(step, i),
                                          len(names)) for i in range(n)]
            for j, name in enumerate(names):
                shape = comp.draw_shape(int(np.prod(shapes[name])))
                table[(r, t, name)] = np.stack([np.asarray(
                    jax.random.uniform(leaf_keys[i][j], shape))
                    for i in range(n)])
    return table


def _run_both(label):
    data = SyntheticImages(flavor="mnist", train_size=200, test_size=8, seed=7)
    parts = data.partition(N, seed=0)
    p0 = jcnn.init_cnn(jax.random.key(0), "mnist")
    rng = jax.random.key(1)
    spec = COMPRESSORS[label]
    jcomp = jmake_compressor(spec[0], **spec[1]) if spec else None
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    jcfg = JDFLConfig(tau1=TAU1, tau2=TAU2, topology=jring(N),
                      compression=jcomp, gamma=GAMMA)
    cfg = dfl.DFLConfig(tau1=TAU1, tau2=TAU2, topology=ring(N),
                        compression=comp, gamma=GAMMA)
    jstate = jinit_state(p0, N, jsgd(LR), rng, compressed=cfg.is_compressed)
    draws = None
    if comp is not None and comp.draw_shape(1) is not None:
        draws = ReplayDraws(_reference_draws(
            comp, rng, {k: v.shape for k, v in p0.items()}), device="cpu")
    state = dfl.init_state(
        params_from_jax({k: np.asarray(v) for k, v in p0.items()}, "cpu"),
        N, sgd(LR), compressed=cfg.is_compressed, draws=draws)
    jround = jax.jit(jmake_round_fn(
        jcfg, lambda p, b, k=None: jcnn.cnn_loss(p, b, "mnist"), jsgd(LR)))
    round_fn = dfl.make_round_fn(cfg, lambda p, b: cnn_loss(p, b, "mnist"),
                                 sgd(LR))
    rows = []
    for r in range(ROUNDS):
        xs, ys = image_batches_for_dfl(data, parts, TAU1, BATCH, r)
        jstate, jm = jround(jstate, (jnp.asarray(xs), jnp.asarray(ys)))
        state, m = round_fn(state, (torch.from_numpy(xs),
                                    torch.from_numpy(ys)))
        rows.append((float(jm["loss"]), float(m["loss"]),
                     float(jm["consensus_sq"]), float(m["consensus_sq"])))
    return rows, jstate, state


@pytest.mark.parametrize("label", sorted(COMPRESSORS))
def test_three_rounds_match_reference_dense_engine(label):
    compression = COMPRESSORS[label] is not None
    rtol, atol = (1e-4, 1e-4) if compression else (1e-5, 1e-6)
    ops.reset_launches()
    rows, jstate, state = _run_both(label)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    for jl, tl, jc, tc in rows:
        assert np.isfinite(tl) and np.isfinite(tc)
        assert tl == pytest.approx(jl, rel=rtol)
        assert tc == pytest.approx(jc, rel=rtol)
    assert state.round_idx == ROUNDS
    trees = [(jstate.params, state.params)]
    if compression:
        trees.append((jstate.hat_params, state.hat_params))
    else:
        assert state.hat_params is None
    for want, got in trees:
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=rtol, atol=atol)


# sha256 (first 16 hex digits) of the gossip phase's (params, hat) on the
# fixed inputs below, from the port as it was before it had an RNG seam
SEAMLESS_DIGESTS = {"dfl": "4fa4cb714be92c50", "cdfl_topk": "4fec6a0367542a00"}


class _RefuseDraws(Draws):
    def uniform(self, round_idx, step, leaf, shape):
        raise AssertionError("plain DFL and TopK draw nothing")


@pytest.mark.parametrize("label", sorted(SEAMLESS_DIGESTS))
def test_seam_leaves_dfl_and_topk_bitwise_unchanged(label):
    """The gossip phase of plain DFL and C-DFL TopK is bitwise what it was
    before the seam, whatever seam it is handed, and whole rounds are
    bitwise the same under the default seam and one that refuses to draw
    (the gossip phase is exact f32 elementwise arithmetic and a select, the
    same on any CPU)."""
    spec = COMPRESSORS[label]
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    shapes = {"c": (3, 3, 1, 16), "b": (16,), "d": (98, 10)}
    rng = np.random.default_rng(21)
    params, hat = ({k: torch.from_numpy(rng.normal(size=(4,) + s).astype(
        np.float32)) for k, s in shapes.items()} for _ in range(2))
    cfg = dfl.DFLConfig(2, 3, ring(4), compression=comp, gamma=GAMMA)
    for draws in (None, GeneratorDraws(0, 4, shapes, "cpu"), _RefuseDraws()):
        p, h = dfl.gossip_phase(cfg, DenseSubstrate(ring(4)), params, hat,
                                draws, 2)
        blob = b"".join(t[k].numpy().tobytes() for t in (p, h)
                        for k in sorted(t))
        assert hashlib.sha256(blob).hexdigest()[:16] == SEAMLESS_DIGESTS[label]
    data = SyntheticImages(flavor="mnist", train_size=80, test_size=8, seed=7)
    parts = data.partition(N, seed=0)
    p0 = params_from_jax({k: np.asarray(v) for k, v in jcnn.init_cnn(
        jax.random.key(0), "mnist").items()}, "cpu")
    cfg = dfl.DFLConfig(TAU1, TAU2, ring(N), compression=comp, gamma=GAMMA)
    round_fn = dfl.make_round_fn(cfg, lambda p, b: cnn_loss(p, b, "mnist"),
                                 sgd(LR))
    finals = []
    for draws in (None, _RefuseDraws()):
        state = dfl.init_state(p0, N, sgd(LR), compressed=comp is not None,
                               draws=draws)
        for r in range(2):
            xs, ys = image_batches_for_dfl(data, parts, TAU1, BATCH, r)
            state, _ = round_fn(state, (torch.from_numpy(xs),
                                        torch.from_numpy(ys)))
        finals.append(state)
    assert (finals[0].hat_params is None) == (comp is None)
    for tree in ("params", "hat_params"):
        a, b = (getattr(s, tree) for s in finals)
        assert (a is None) == (b is None)
        for k in a or {}:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))


def test_round_wire_bits_matches_reference():
    p0 = {k: np.asarray(v) for k, v in
          jcnn.init_cnn(jax.random.key(0), "cifar").items()}
    for spec in COMPRESSORS.values():
        cfg = dfl.DFLConfig(4, 4, ring(10), compression=(
            make_compressor(spec[0], **spec[1]) if spec else None))
        jcfg = JDFLConfig(4, 4, jring(10), compression=(
            jmake_compressor(spec[0], **spec[1]) if spec else None))
        for engine in ("sparse", "dense"):
            assert dfl.round_wire_bits(cfg, p0, engine) == \
                jround_wire_bits(jcfg, p0, engine)


def test_unported_options_raise():
    """The sparse engine without a node group raises the reference's
    ``ValueError`` (tests/test_torch_sharded.py runs it). Participation
    masks and sampled populations are ported (tests/test_torch_faults.py,
    tests/test_torch_batched.py) and refuse, as the reference does, a
    round without dynamic taus and a batched engine without a
    population."""
    cfg = dfl.DFLConfig(2, 2, ring(4))
    loss = lambda p, b: cnn_loss(p, b)  # noqa: E731
    with pytest.raises(ValueError, match="process group"):
        dfl.make_round_fn(cfg, loss, sgd(0.1), engine="sparse")
    for kw in ({"participation": True}, {"population": 8}):
        with pytest.raises(ValueError, match="dynamic_taus"):
            dfl.make_round_fn(cfg, loss, sgd(0.1), **kw)
    with pytest.raises(ValueError, match="population"):
        dfl.make_round_fn(cfg, loss, sgd(0.1), engine="batched",
                          dynamic_taus=True)
    assert callable(dfl.make_round_fn(cfg, loss, sgd(0.1), dynamic_taus=True,
                                      participation=True))
    with pytest.raises(ValueError):
        dfl.DFLConfig(0, 2, ring(4))


@pytest.mark.parametrize("flags", [["--compression", "qsgd", "--levels", "4"],
                                   ["--compression", "rand_k", "--frac", "0.5"],
                                   ["--compression", "rand_gossip", "--p", "0.6"]],
                         ids=["qsgd", "rand_k", "rand_gossip"])
def test_cli_runs_the_random_compressors_on_cpu(monkeypatch, flags):
    """``run_dfl_cnn`` through the CLI with each random compressor: finite
    metrics, the same history for the same seed, another for another."""
    monkeypatch.setattr(cnn_run, "get_data", lambda flavor: SyntheticImages(
        flavor=flavor, train_size=80, test_size=16, seed=7))
    argv = ["--flavor", "mnist", "--nodes", "4", "--tau1", "1", "--tau2", "2",
            "--batch", "2", "--rounds", "2", "--device", "cpu", *flags]
    runs = [cnn_run.main(argv + ["--seed", s]) for s in ("0", "0", "1")]
    spec = runs[0]["spec"]
    assert spec["compression"] == flags[1]
    assert spec["comp_kwargs"] == {flags[2][2:]: float(flags[3])}
    h = [r["history"] for r in runs]
    assert all(np.isfinite(h[0][k]).all() for k in ("loss", "global_loss",
                                                     "consensus"))
    assert h[0]["consensus"] == h[1]["consensus"]
    assert h[0]["consensus"] != h[2]["consensus"]


def test_run_dfl_cnn_on_cpu(monkeypatch):
    """The harness end to end at a tiny size, on the quasi-ring (which
    mixes through mix_dense, not the kernel)."""
    monkeypatch.setattr(cnn_run, "get_data", lambda flavor: SyntheticImages(
        flavor=flavor, train_size=120, test_size=16, seed=7))
    spec = cnn_run.RunSpec(name="t", tau1=1, tau2=2, topology="quasi",
                           compression="top_k", comp_kwargs={"frac": 0.67},
                           gamma=0.6, rounds=2, batch=2, flavor="mnist",
                           nodes=10)
    out = cnn_run.run_dfl_cnn(spec, device="cpu", log_every=1)
    h = out["history"]
    assert h["round"] == [1, 2] and len(out["round_ms"]) == 2
    assert all(np.isfinite(h[k]).all() for k in ("loss", "global_loss",
                                                  "consensus", "test_acc"))
    assert out["zeta"] == pytest.approx(paper_quasi_ring().zeta)
    assert out["device"] == "cpu" and out["tf32"] is None
