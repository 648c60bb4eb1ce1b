"""Device selection for the port's entry points (the card unless asked),
host-to-device copies that do not block, the determinism switch, and the
host's cores shared among processes that run at once."""
from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent, so a run never falls back to the CPU unannounced."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes to the card through pinned
    memory without blocking the host (a plain ``.to`` from pageable memory
    waits for the copy)."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def share_host_threads(processes: int) -> int:
    """Set torch's intra-op threads to this process's share of the host's
    cores when ``processes`` processes run at once (the cores over
    ``processes``, at least one), and return the share. Left at torch's
    default, each process takes a thread a core, and the threads of one
    parallel region spin waiting for those the other processes' threads
    keep off the cores."""
    share = max(1, (os.cpu_count() or 1) // processes)
    torch.set_num_threads(share)
    return share


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True) -> Iterator[None]:
    """Inside the block, cuDNN runs deterministic algorithms and does not
    autotune (``cudnn.deterministic = True``, ``cudnn.benchmark = False``),
    so a run on the card gives the same bits twice; the previous flags are
    restored after. ``on=False`` leaves the flags alone."""
    if not on:
        yield
        return
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
