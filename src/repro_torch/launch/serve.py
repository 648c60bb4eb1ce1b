"""Batched serving driver: prefill a batch of prompts, decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch 4 --prompt-len 64 --gen 32 [--device cuda]

Ported from ``repro.launch.serve``, with its flags and log lines. As in
the reference, ``main`` serves the architecture's REDUCED config, with
weights and prompts drawn from ``--seed``; ``run(args, cfg)`` is the body
for any ``ModelConfig`` (``chip_smoke.py --only serve`` passes full
ones). Greedy sampling. The decode step is the serving engine's
(``serving.engine``): on the card one CUDA graph, captured before the
decode clock starts, replayed once a token; ``--device cpu`` runs the
same step eagerly. Reports tokens/s and per-phase wall-clock, each phase
ended by a device sync.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params, prefill
from repro_torch.serving import ServingEngine

__all__ = ["parse_args", "run", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args: argparse.Namespace,
        cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Serve ``cfg`` (default: the ``--arch``'s reduced config) as the CLI
    does: weights from a CPU generator seeded ``--seed``, prompts (and
    memory, where the config reads one) from one seeded ``--seed`` + 1.
    Returns the generated tokens [batch, gen], the last logits, the
    prefill, capture and decode seconds and the engine's capture count."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_arch(args.arch).reduced
    params, _ = init_params(cfg, torch.Generator().manual_seed(args.seed),
                            dev)
    max_len = args.prompt_len + args.gen
    gen = torch.Generator().manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        dtype=torch.int32).to(dev)}
    if cfg.has_memory_input:
        m = cfg.memory_tokens or 16
        batch["memory"] = torch.randn(
            (args.batch, m, cfg.memory_dim or cfg.d_model),
            generator=gen).to(dev)
    engine = ServingEngine(cfg, params, max_batch=args.batch,
                           max_len=max_len, seed=args.seed, device=dev)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = prefill(params, batch, cfg, max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        dec = engine.decoder(logits, state)
        _sync(dev)
        t_capture = time.perf_counter() - t0 - t_prefill
        out = [dec.tok.clone()]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            dec.step()
            out.append(dec.tok.clone())
        gen_toks = torch.cat(out, 1).cpu()
        t_decode = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"prefill: {t_prefill*1e3:.0f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.0f} ms "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):.0f} tok/s)")
    print(f"sample token ids: {gen_toks[0, :16].tolist()}")
    last = dec.logits if dec.logits is not None else logits
    return {"tokens": gen_toks, "logits": last, "prefill_s": t_prefill,
            "capture_s": t_capture, "decode_s": t_decode,
            "capture_count": engine.capture_count}


def main(argv=None) -> Dict[str, Any]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
