"""Serve a small model with batched requests: prefill + KV-cache decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch gemma3-4b [--device cuda]

The port of ``examples/serve_decode.py``: the serving path (``prefill``
and the engine's decode step, one CUDA graph on the card) on the reduced
config, including the sliding-window ring-buffer cache for gemma3 and the
O(1) SSM state for falcon-mamba. Weights from seed 0, prompts from seed 1.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from repro_torch.configs import list_archs
from repro_torch.launch import serve


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rec = serve.run(serve.parse_args(
        ["--arch", args.arch, "--batch", str(args.batch), "--prompt-len",
         str(args.prompt_len), "--gen", str(args.gen), "--seed", "0",
         "--device", args.device]))
    assert bool(torch.isfinite(rec["logits"]).all())
    print("first request tokens:", rec["tokens"][0, :12].tolist())
    print("OK")
    return rec


if __name__ == "__main__":
    main()
