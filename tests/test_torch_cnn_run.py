"""C-DFL QSGD on the CIFAR CNN at gamma 0.6 diverges in the reference's
harness (``benchmarks/common.py:run_dfl_cnn``) and in the port's
(``repro_torch.launch.cnn_run``) alike: 16 levels over the CIFAR leaves
give delta = 1/c of about 0.025, too small for a consensus step of 0.6. The
same spec, 10-node ring, tau1 = tau2 = 4, batch 16, 5 rounds, each
harness's own initial weights and draws, on the CPU; both histories are
printed (``pytest -s``)."""
import json

import pytest

import benchmarks.common as jcommon
from repro_torch.launch import cnn_run

ROUNDS = 5


@pytest.mark.parametrize("harness", ["reference", "port"])
def test_cifar_qsgd_at_gamma_06_diverges(harness):
    kw = dict(name="qsgd-gamma-0.6", tau1=4, tau2=4, topology="ring",
              compression="qsgd", comp_kwargs={"levels": 16}, gamma=0.6,
              flavor="cifar", nodes=10, rounds=ROUNDS, batch=16)
    if harness == "reference":
        out = jcommon.run_dfl_cnn(jcommon.RunSpec(**kw), log_every=1)
    else:
        out = cnn_run.run_dfl_cnn(cnn_run.RunSpec(**kw), device="cpu",
                                  log_every=1)
    h = out["history"]
    print(f"{harness} gamma 0.6 " + json.dumps(
        {k: h[k] for k in ("loss", "consensus")}))
    cons, loss = h["consensus"], h["loss"]
    assert len(cons) == ROUNDS
    assert all(b > a for a, b in zip(cons, cons[1:])), cons
    assert cons[-1] > 20 * cons[0], cons
    assert loss[-1] > 2 * loss[2], loss
