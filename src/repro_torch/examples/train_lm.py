"""End-to-end driver: DFL-train a ~100M-parameter qwen3-style LM for a few
hundred rounds on the synthetic non-IID corpus (no download).

The port of ``examples/train_lm.py``, with its flags and log lines::

    PYTHONPATH=src python -m repro_torch.examples.train_lm --rounds 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --rounds 20 \\
        [--device cpu]

The public API end to end: ModelConfig -> init_params -> DFLConfig ->
make_round_fn -> checkpointing (``--ckpt DIR``: the parameters every
``CKPT_EVERY`` rounds). 12 layers, d_model 768, 12 query / 4 KV heads of
64, d_ff 2048, vocab 32,768, f32; 4 nodes on a ring,
``adamw(warmup_cosine(3e-4, ...))``. On the card every gossip step runs
K1 (``kernels/csrc/gossip_mix.cu``); ``--device cpu`` its plain version.
The loss should fall from about ln(V) toward the corpus entropy.
``main(argv, cfg=..., device=..., params=...)`` runs the same loop on any
``ModelConfig`` and initial parameters and returns the record.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import DFLConfig, init_state, make_round_fn, ring
from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params, train_loss
from repro_torch.optim import adamw
from repro_torch.optim.schedules import warmup_cosine

CKPT_EVERY = 100

# ~100M params: 12L, d=768, standard GQA block (qwen3-ish reduced).
CFG = ModelConfig(
    name="qwen3-100m", arch_type="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
    qk_norm=True, dtype=torch.float32, attn_q_chunk=128, attn_kv_chunk=256,
    loss_seq_chunk=128, remat=False,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--tau1", type=int, default=4)
    ap.add_argument("--tau2", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, cfg: Optional[ModelConfig] = None, *, device=None,
         params: Optional[Dict[str, torch.Tensor]] = None,
         log=print) -> Dict[str, Any]:
    """Train ``cfg`` (default ``CFG``) from ``params`` (default: drawn from
    a CPU generator seeded 0) as the CLI does, on ``device`` (default
    ``--device``). Returns the record: every round's loss and consensus
    distance, tokens/s over the run and the final state."""
    args = parse_args(argv)
    cfg = CFG if cfg is None else cfg
    dev = resolve_device(args.device if device is None else device)
    if params is None:
        params, _ = init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = sum(x.numel() for x in params.values())
    log(f"model: {cfg.name}  {n_params/1e6:.1f}M params, "
        f"{args.nodes} DFL nodes, ring topology")

    dcfg = DFLConfig(tau1=args.tau1, tau2=args.tau2, topology=ring(args.nodes))
    total_steps = args.rounds * args.tau1
    opt = adamw(warmup_cosine(3e-4, warmup_steps=total_steps // 20,
                              total_steps=total_steps))
    corpus = SyntheticLM(vocab_size=cfg.vocab_size, num_nodes=args.nodes,
                         noniid_alpha=0.5, branching=8)

    state = init_state(params, args.nodes, opt, seed=1)
    round_fn = make_round_fn(dcfg, lambda p, b: train_loss(p, b, cfg), opt)

    losses, consensus = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for r in range(args.rounds):
        host = lm_batches_for_dfl(corpus, args.tau1, args.nodes, args.batch,
                                  args.seq, r)
        batches = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        state, m = round_fn(state, batches)
        losses.append(m["loss"])
        consensus.append(m["consensus_sq"])
        if (r + 1) % max(1, args.rounds // 50) == 0 or r == 0:
            loss = float(m["loss"])         # waits for the round
            dt = time.perf_counter() - t0
            toks = (r + 1) * args.tau1 * args.nodes * args.batch * args.seq
            log(f"round {r+1:4d}/{args.rounds} loss={loss:.4f} "
                f"consensus={float(m['consensus_sq']):.2e} "
                f"{toks/dt:.0f} tok/s")
        if args.ckpt and (r + 1) % CKPT_EVERY == 0:
            save_checkpoint(args.ckpt, r + 1, state.params,
                            {"loss": float(m["loss"])})
    losses = [float(v) for v in losses]
    seconds = time.perf_counter() - t0
    log(f"trained {args.rounds} rounds in {seconds:.0f}s")
    tokens = args.rounds * args.tau1 * args.nodes * args.batch * args.seq
    return {"losses": losses, "consensus_sq": [float(v) for v in consensus],
            "seconds": seconds, "tokens_per_s": tokens / seconds,
            "params": n_params, "state": state}


if __name__ == "__main__":
    main()
