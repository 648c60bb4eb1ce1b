"""Quickstart: DFL on the PyTorch port.

Ten nodes on a ring learn a shared linear model from non-IID data with
tau1 local SGD steps and tau2 gossip steps per round (the paper's
Algorithm 1), then the same problem with compressed gossip (C-DFL,
Algorithm 2, QSGD). The port of ``examples/quickstart.py``: the same
problem and variants, with the data drawn from numpy seeds::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the gossip runs the CUDA kernels (K1 on the ring, K2 for
C-DFL QSGD); ``--device cpu`` runs their plain versions.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (DFLConfig, average_model, init_state,
                              make_compressor, make_round_fn, ring)
from repro_torch.core.rng import Draws
from repro_torch.device import deterministic_algorithms, resolve_device
from repro_torch.optim import sgd

N = 10                       # nodes (paper Sec. VI-A)
DIM = 32
LR = 0.01
DATA_SEED = 2                # every variant sees the same batches

# --- non-IID linear regression: each node sees a biased slice -------------
TRUE_W = np.random.default_rng(1).standard_normal(DIM, dtype=np.float32)
NODE_BIAS = np.linspace(-1.0, 1.0, N, dtype=np.float32)


def make_batches(rng: np.random.Generator, tau1: int,
                 batch: int = 16) -> Dict[str, np.ndarray]:
    """One round's batches {"x": [tau1, N, batch, DIM], "y": [tau1, N,
    batch]}, node i's features shifted by NODE_BIAS[i]."""
    x = rng.standard_normal((tau1, N, batch, DIM), dtype=np.float32)
    x += NODE_BIAS[None, :, None, None]
    noise = rng.standard_normal((tau1, N, batch), dtype=np.float32)
    return {"x": x, "y": x @ TRUE_W + np.float32(0.05) * noise}


def loss_fn(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2)


def variants() -> List[Tuple[str, DFLConfig]]:
    """The three runs of the quickstart: C-SGD, DFL and C-DFL QSGD."""
    return [("C-SGD (tau2=1)", DFLConfig(tau1=4, tau2=1, topology=ring(N))),
            ("DFL   (tau2=4)", DFLConfig(tau1=4, tau2=4, topology=ring(N))),
            ("C-DFL (qsgd)", DFLConfig(tau1=4, tau2=4, topology=ring(N),
                                       compression=make_compressor("qsgd"),
                                       gamma=0.5))]


def train(cfg: DFLConfig, rounds: int = 60, label: str = "",
          device="cuda", draws: Optional[Draws] = None,
          deterministic: bool = True) -> Dict:
    """``rounds`` rounds of ``cfg`` from w = 0 on ``device``; ``draws``
    replaces the random compressors' seam (seed 1); ``deterministic``
    holds cuDNN to deterministic algorithms for the run. Prints and
    returns the last round's loss and consensus, |w - w*| of the average
    model, and every round's loss and consensus."""
    with deterministic_algorithms(deterministic):
        return _train(cfg, rounds, label, resolve_device(device), draws)


def _train(cfg: DFLConfig, rounds: int, label: str, dev: torch.device,
           draws: Optional[Draws]) -> Dict:
    opt = sgd(LR)
    state = init_state({"w": torch.zeros(DIM, device=dev)}, N, opt,
                       compressed=cfg.is_compressed, seed=1, draws=draws)
    round_fn = make_round_fn(cfg, loss_fn, opt)
    rng = np.random.default_rng(DATA_SEED)
    history = []
    for _ in range(rounds):
        batches = {k: torch.from_numpy(v).to(dev)
                   for k, v in make_batches(rng, cfg.tau1).items()}
        state, metrics = round_fn(state, batches)
        history.append(metrics)
    avg = average_model(state.params)
    err = float(torch.linalg.norm(avg["w"] - torch.from_numpy(TRUE_W).to(dev)))
    out = {"label": label, "device": str(dev), "err": err,
           "losses": torch.stack([m["loss"] for m in history]).tolist(),
           "consensus": torch.stack([m["consensus_sq"]
                                     for m in history]).tolist()}
    print(f"{label:28s} loss={out['losses'][-1]:.4f} "
          f"consensus={out['consensus'][-1]:.2e} |w-w*|={err:.4f}")
    return out


def main(device="cuda", rounds: int = 60) -> List[Dict]:
    print(f"{N}-node ring, zeta={ring(N).zeta:.3f}\n")
    return [train(cfg, rounds, label, device) for label, cfg in variants()]


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rounds", type=int, default=60)
    a = p.parse_args()
    main(a.device, a.rounds)
