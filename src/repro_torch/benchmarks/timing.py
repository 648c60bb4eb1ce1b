"""Device times of calls on the card: warm (``device_ms``) and with the
operands read from DRAM (``cold_device_ms``), both from CUDA-graph replay
between CUDA events, so no host overhead is in the reading; and the card's
name and power limit (``card_line``), which every reading is kept beside.

``chip_smoke.py`` and ``benchmarks/bench_kernels.py`` read the kernels'
times through these. Both need a CUDA card.
"""
from __future__ import annotations

import math
import subprocess
from typing import Callable

import torch

__all__ = ["device_ms", "cold_device_ms", "card_line"]


def device_ms(fn: Callable, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events (no host overhead;
    inputs stay warm in L2 where they fit, as between gossip steps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def cold_device_ms(make: Callable[[], Callable], nbytes: float,
                   reps: int = 5) -> float:
    """Device time of one call with its operands read from DRAM, not from
    L2: ``make()`` returns a call on operands of its own, and so many are
    made that the bytes moved between two uses of one set (``nbytes`` a
    call) exceed three times the L2 cache. The calls are captured by turns
    in one CUDA graph (20 at least), each keeping its outputs apart, and
    replayed ``reps`` times between CUDA events."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    calls = [make() for _ in range(1 + math.ceil(3 * l2 / nbytes))]
    iters = len(calls) * math.ceil(20 / len(calls))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph, kept = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(iters):
            kept.append(calls[i % len(calls)]())
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]
