"""Parameters of the JAX reference, given as numpy arrays, as the port's.

Both packages keep the same layout (HWIO conv kernels, ``[fin, fout]``
dense weights, an optional leading node axis), so the conversion copies
bytes and changes no axis; the same seed's weights then drive both. A
nested reference tree (the LM's dicts and lists of stacked blocks) becomes
the port's flat dict keyed by the joined tree path
(``checkpoint/io.py:_key_of``), in the reference's leaf order.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import flatten


def _to_tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """``{name: array}`` (stacked ``[N, ...]`` or one node's), or a nested
    dict / list tree of arrays, as tensors on ``device``, bit for bit and
    in the same layout. A flat dict keeps its order; a nested tree comes
    back flat, keyed by path, in the reference's leaf order."""
    dev = resolve_device(device)
    if not any(isinstance(v, (dict, list, tuple)) for v in tree.values()):
        items = list(tree.items())
    else:
        items = flatten(tree)
    return {name: _to_tensor(a).to(dev) for name, a in items}
