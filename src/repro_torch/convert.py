"""Parameters of the JAX reference, given as numpy arrays, as the port's.

Both packages keep the same layout (HWIO conv kernels, ``[fin, fout]``
dense weights, an optional leading node axis), so the conversion copies
bytes and changes no axis; the same seed's weights then drive both.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Mapping[str, np.ndarray],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """``{name: array}`` (stacked ``[N, ...]`` or one node's) as tensors on
    ``device``, bit for bit and in the same layout."""
    dev = resolve_device(device)
    return {name: _to_tensor(a).to(dev) for name, a in tree.items()}
