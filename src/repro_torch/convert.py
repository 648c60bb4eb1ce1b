"""Parameters and decode states of the JAX reference, given as numpy
arrays, as the port's.

Both packages keep the same layout (HWIO conv kernels, ``[fin, fout]``
dense weights, an optional leading node axis), so the conversion copies
bytes and changes no axis; the same seed's weights then drive both. A
nested reference tree (the LM's dicts and lists of stacked blocks) becomes
the port's flat dict keyed by the joined tree path
(``checkpoint/io.py:_key_of``), in the reference's leaf order. A
reference ``DecodeState`` becomes the port's ``models.DecodeState``, leaf
for leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig, flatten
from repro_torch.models.transformer import DecodeState


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


def decode_state_from_jax(state: Any, cfg: ModelConfig,
                          device="cuda") -> DecodeState:
    """The reference's ``DecodeState`` (``caches``: per period position a
    dict of leaves stacked over periods; ``memory``; the 0-d ``position``;
    numpy leaves) as the port's on ``device``, bit for bit."""
    dev = resolve_device(device)
    if len(state.caches) != len(cfg.pattern):
        raise ValueError(f"{cfg.name}: {len(state.caches)} cache positions "
                         f"for a period of {len(cfg.pattern)}")
    caches = tuple({n: _to_tensor(a).to(dev) for n, a in c.items()}
                   for c in state.caches)
    memory = (None if state.memory is None
              else _to_tensor(state.memory).to(dev))
    position = _to_tensor(np.asarray(state.position, np.int32)).to(dev)
    return DecodeState(caches=caches, memory=memory, position=position)
