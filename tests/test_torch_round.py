"""The port's DFL / C-DFL round against the JAX reference's dense engine.

Three rounds of the MNIST CNN on ring(4), tau1 = tau2 = 2, batch 4, from
the same converted weights and the same numpy batches. Plain DFL holds the
per-round loss, consensus and final parameters to rtol 1e-5 (conv and
matmul reductions are ordered differently, never bitwise). C-DFL TopK is
held to rtol 1e-4 on the metrics and 1e-4 absolute on the parameters: a
coordinate at the TopK boundary may flip in or out of the kept set when
the gradients differ in the last ulp, which moves that coordinate's
estimate by one gap.
"""
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
from repro.models import cnn as jcnn
from repro.optim import sgd as jsgd
from repro_torch.convert import params_from_jax
from repro_torch.core import dfl
from repro_torch.core.compression import make_compressor
from repro_torch.core.topology import paper_quasi_ring, ring
from repro_torch.data.images import SyntheticImages, image_batches_for_dfl
from repro_torch.kernels import ops
from repro_torch.launch import cnn_run
from repro_torch.models.cnn import cnn_loss
from repro_torch.optim import sgd

N, TAU1, TAU2, BATCH, LR, GAMMA = 4, 2, 2, 4, 0.05, 0.6


def _run_both(compression):
    data = SyntheticImages(flavor="mnist", train_size=200, test_size=8, seed=7)
    parts = data.partition(N, seed=0)
    p0 = jcnn.init_cnn(jax.random.key(0), "mnist")
    jcomp = jmake_compressor("top_k", frac=0.67) if compression else None
    comp = make_compressor("top_k", frac=0.67) if compression else None
    jcfg = JDFLConfig(tau1=TAU1, tau2=TAU2, topology=jring(N),
                      compression=jcomp, gamma=GAMMA)
    cfg = dfl.DFLConfig(tau1=TAU1, tau2=TAU2, topology=ring(N),
                        compression=comp, gamma=GAMMA)
    jstate = jinit_state(p0, N, jsgd(LR), jax.random.key(1),
                         compressed=cfg.is_compressed)
    state = dfl.init_state(
        params_from_jax({k: np.asarray(v) for k, v in p0.items()}, "cpu"),
        N, sgd(LR), compressed=cfg.is_compressed)
    jround = jax.jit(jmake_round_fn(
        jcfg, lambda p, b, k=None: jcnn.cnn_loss(p, b, "mnist"), jsgd(LR)))
    round_fn = dfl.make_round_fn(cfg, lambda p, b: cnn_loss(p, b, "mnist"),
                                 sgd(LR))
    rows = []
    for r in range(3):
        xs, ys = image_batches_for_dfl(data, parts, TAU1, BATCH, r)
        jstate, jm = jround(jstate, (jnp.asarray(xs), jnp.asarray(ys)))
        state, m = round_fn(state, (torch.from_numpy(xs),
                                    torch.from_numpy(ys)))
        rows.append((float(jm["loss"]), float(m["loss"]),
                     float(jm["consensus_sq"]), float(m["consensus_sq"])))
    return rows, jstate, state


@pytest.mark.parametrize("compression", [False, True], ids=["dfl", "cdfl_topk"])
def test_three_rounds_match_reference_dense_engine(compression):
    rtol, atol = (1e-4, 1e-4) if compression else (1e-5, 1e-6)
    ops.reset_launches()
    rows, jstate, state = _run_both(compression)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    for jl, tl, jc, tc in rows:
        assert np.isfinite(tl) and np.isfinite(tc)
        assert tl == pytest.approx(jl, rel=rtol)
        assert tc == pytest.approx(jc, rel=rtol)
    assert state.round_idx == 3
    trees = [(jstate.params, state.params)]
    if compression:
        trees.append((jstate.hat_params, state.hat_params))
    else:
        assert state.hat_params is None
    for want, got in trees:
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=rtol, atol=atol)


def test_round_wire_bits_matches_reference():
    p0 = {k: np.asarray(v) for k, v in
          jcnn.init_cnn(jax.random.key(0), "cifar").items()}
    for comp in ("", "top_k"):
        cfg = dfl.DFLConfig(4, 4, ring(10), compression=(
            make_compressor("top_k", frac=0.67) if comp else None))
        jcfg = JDFLConfig(4, 4, jring(10), compression=(
            jmake_compressor("top_k", frac=0.67) if comp else None))
        for engine in ("sparse", "dense"):
            assert dfl.round_wire_bits(cfg, p0, engine) == \
                jround_wire_bits(jcfg, p0, engine)


def test_unported_options_raise():
    cfg = dfl.DFLConfig(2, 2, ring(4))
    loss = lambda p, b: cnn_loss(p, b)  # noqa: E731
    for kw in ({"engine": "sparse"}, {"engine": "batched"},
               {"dynamic_taus": True}, {"participation": True},
               {"population": 8}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dfl.make_round_fn(cfg, loss, sgd(0.1), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dfl.DFLConfig(2, 2, ring(4), mixing_impl="dense_power")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dfl.DFLConfig(2, 2, ring(4), topology_schedule=(ring(4),))
    with pytest.raises(ValueError):
        dfl.DFLConfig(0, 2, ring(4))


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
