"""Minimal, dependency-free checkpointing in the reference's format.

Copied from ``repro.checkpoint.io``: leaves go to one ``.npz`` keyed by the
joined tree path (``_key_of``; the port's parameter dicts are keyed by that
path already) and a sidecar ``ckpt_<step>.json`` manifest records the step,
the metrics and the leaf count. Writes are atomic (a temp file in the same
directory, then ``os.replace``); ``restore_checkpoint(step=None)`` walks
the steps newest-first past any checkpoint that fails to load.

The port has no ``ml_dtypes``: a bfloat16 leaf is written as its raw two
bytes (numpy ``V2``, what the reference's ``np.savez`` writes for an
``ml_dtypes.bfloat16`` array) and read back through a ``uint16`` view into
the template's dtype, so a checkpoint written by either package restores
in the other, bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import leaf_order
from repro_torch.models.common import flatten

__all__ = ["save_checkpoint", "restore_checkpoint", "available_steps",
           "latest_step", "ShapeMismatchError"]

PyTree = Any


def _flat(tree: PyTree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs: a flat path-keyed dict in the reference's
    leaf order, a nested tree flattened by path."""
    if isinstance(tree, dict) and not any(
            isinstance(v, (dict, list, tuple)) for v in tree.values()):
        return [(k, tree[k]) for k in leaf_order(tree)]
    return flatten(tree)


def _to_numpy(v) -> np.ndarray:
    """A leaf as numpy; bfloat16 as its raw bytes (``V2``)."""
    if torch.is_tensor(v):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view(
                np.dtype("V2"))
        return v.numpy()
    return np.asarray(v)


def _atomic_write(path: str, write_fn) -> None:
    """Write via a temp file in the SAME directory, fsync, os.replace —
    the canonical name only ever points at a complete file."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    metrics: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flat(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    _atomic_write(path, lambda f: np.savez(f, **arrays))
    manifest = {
        "step": step,
        "metrics": metrics or {},
        "num_leaves": len(arrays),
    }
    _atomic_write(
        os.path.join(directory, f"ckpt_{step:08d}.json"),
        lambda f: f.write(json.dumps(manifest, indent=2).encode("utf-8")))
    return path


def available_steps(directory: str) -> List[int]:
    """All checkpoint steps present in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1))
        for fn in os.listdir(directory)
        if (m := re.match(r"ckpt_(\d+)\.npz$", fn)))


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return max(steps) if steps else None


# what a torn/corrupt .npz (or a manifest mismatch) surfaces as across
# numpy versions: BadZipFile for truncated archives, ValueError/KeyError/
# EOFError/OSError for header damage and short reads.
_CORRUPT_ERRORS = (zipfile.BadZipFile, ValueError, KeyError, EOFError,
                   OSError)


class ShapeMismatchError(ValueError):
    """Checkpoint/template structural disagreement — caller error (the
    model changed), not data damage; the newest-first fallback never
    skips past it."""


def _leaf(arr: np.ndarray, tmpl) -> torch.Tensor:
    """A loaded array as a tensor of the template leaf's dtype (raw
    two-byte leaves through ``uint16``) on its device."""
    dtype = tmpl.dtype if torch.is_tensor(tmpl) else None
    if arr.dtype.kind == "V":
        if dtype is None or torch.empty((), dtype=dtype).element_size() \
                != arr.dtype.itemsize:
            raise ValueError(f"raw {arr.dtype} leaf for a template of "
                             f"dtype {dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            dtype)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(tmpl.device) if torch.is_tensor(tmpl) else t


def _unflatten(template: PyTree, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict) and prefix == "" and not any(
            isinstance(v, (dict, list, tuple)) for v in template.values()):
        return {k: leaves[k] for k in template}
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, leaves, f"{prefix}{i}/")
               for i, v in enumerate(template)]
        return type(template)(out)
    if template is None:
        return None
    return leaves[prefix[:-1]]


def _load_step(directory: str, step: int, template: PyTree) -> PyTree:
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        leaves = {}
        for key, tmpl in _flat(template):
            arr = data[key]
            if (hasattr(tmpl, "shape")
                    and tuple(arr.shape) != tuple(tmpl.shape)):
                raise ShapeMismatchError(
                    f"{key}: checkpoint shape {arr.shape} != "
                    f"template {tuple(tmpl.shape)}")
            leaves[key] = _leaf(arr, tmpl)
    return _unflatten(template, leaves)


def restore_checkpoint(directory: str, template: PyTree,
                       step: Optional[int] = None) -> Tuple[PyTree, int]:
    """Restore into the structure of ``template`` (shapes are validated;
    each leaf a tensor of the template leaf's dtype on its device).

    ``step=None`` restores the newest VALID checkpoint: steps are tried
    newest-first and unreadable/corrupt ones are skipped (an explicit
    ``step`` is trusted and raises on damage — the caller asked for that
    exact file). Raises FileNotFoundError when the directory holds no
    loadable checkpoint at all.
    """
    if step is not None:
        return _load_step(directory, step, template), step
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    failures: List[str] = []
    for s in reversed(steps):
        try:
            return _load_step(directory, s, template), s
        except ShapeMismatchError:
            raise  # wrong template, not a torn file — older ckpts won't fit
        except _CORRUPT_ERRORS as e:
            failures.append(f"step {s}: {type(e).__name__}: {e}")
    raise FileNotFoundError(
        f"no loadable checkpoint in {directory}; "
        f"tried {len(failures)} (newest first): " + "; ".join(failures))
