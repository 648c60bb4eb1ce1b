"""The port's quickstart (``repro_torch.examples.quickstart``) against the
reference's round on the same numpy batches.

Three rounds of each variant: C-SGD and DFL per-round loss, consensus and
final parameters to rtol 1e-5 (the x @ w products sum in another order);
C-DFL QSGD with the reference's own draws replayed through the seam to
rtol 1e-4. The script's ``main`` runs end to end on the CPU.
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
from repro.optim import sgd as jsgd
from repro_torch.core.rng import ReplayDraws
from repro_torch.examples import quickstart as qs
from test_torch_round import _reference_draws

ROUNDS = 3


def jloss(params, batch, key=None):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


@pytest.mark.parametrize("index", [0, 1, 2], ids=["c_sgd", "dfl",
                                                  "cdfl_qsgd"])
def test_quickstart_variant_matches_reference(index):
    label, cfg = qs.variants()[index]
    rng = jax.random.key(1)
    jcfg = JDFLConfig(tau1=cfg.tau1, tau2=cfg.tau2, topology=jring(qs.N),
                      compression=(jmake_compressor("qsgd")
                                   if cfg.is_compressed else None),
                      gamma=cfg.gamma)
    draws = None
    if cfg.is_compressed:
        draws = ReplayDraws(_reference_draws(
            cfg.compression, rng, {"w": (qs.DIM,)}, rounds=ROUNDS,
            tau2=cfg.tau2, n=qs.N), device="cpu")
    out = qs.train(cfg, ROUNDS, label, device="cpu", draws=draws)
    jstate = jinit_state({"w": jnp.zeros((qs.DIM,))}, qs.N, jsgd(qs.LR), rng,
                         compressed=cfg.is_compressed)
    jround = jax.jit(jmake_round_fn(jcfg, jloss, jsgd(qs.LR)))
    data = np.random.default_rng(qs.DATA_SEED)
    losses, consensus = [], []
    for _ in range(ROUNDS):
        b = qs.make_batches(data, cfg.tau1)
        jstate, m = jround(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        consensus.append(float(m["consensus_sq"]))
    rtol = 1e-4 if cfg.is_compressed else 1e-5
    np.testing.assert_allclose(out["losses"], losses, rtol=rtol)
    np.testing.assert_allclose(out["consensus"], consensus, rtol=rtol)
    avg = np.asarray(jstate.params["w"]).mean(axis=0)
    assert out["err"] == pytest.approx(float(np.linalg.norm(avg - qs.TRUE_W)),
                                       rel=rtol)


def test_quickstart_main_runs_on_cpu(capsys):
    results = qs.main(device="cpu", rounds=2)
    assert [r["label"] for r in results] == [lbl for lbl, _ in qs.variants()]
    for r in results:
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
        assert np.isfinite(r["err"]) and r["device"] == "cpu"
    assert "10-node ring" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            qs.main(rounds=1)
