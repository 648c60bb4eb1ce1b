"""Step builders of the launcher: the part the train CLI needs.

Ported from ``repro.launch.steps``: ``kernelize_compressor`` only. The
builders for lowering and the roofline wait for the roofline analogue and
telemetry (ROADMAP.md items 5 and 9).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.compression import Compressor

__all__ = ["kernelize_compressor"]


def kernelize_compressor(compression: Optional[Compressor],
                         use_kernels: bool) -> Optional[Compressor]:
    """The compressor the round runs with under ``--use-kernels``. In the
    reference the flag routes TopK through the Pallas kernels; in the port
    a tensor on the card always takes the CUDA kernels and one on the CPU
    their plain versions (``kernels/ops.py``), so the flag changes nothing
    and the compressor comes back as it is."""
    del use_kernels
    return compression
