"""The port's kernel ops, their parity shapes and the parity harness,
written from the reference's ``repro/kernels/registry.py``.

* ``KernelOp`` / ``get_op`` / ``list_ops``: one entry for each of the
  reference's seven registered ops, under its name and with its bitwise
  contract. ``topk_partials`` is the reference's name for the TopK select;
  in the port that is K4, ``ops.topk_threshold`` (a radix select that
  gives the exact k-th largest |x|, not per-tile candidates).
* ``parity_suite``: every op run through ``repro_torch.kernels.ops``
  against its oracle in ``repro_torch.kernels.ref`` over a sweep of shapes
  and dtypes; ops with ``bitwise=True`` must match exactly. The tensors'
  device picks the path, as everywhere in the port: on the card the CUDA
  kernel (or a raise), on the CPU the kernel's plain version.

The reference's ``backend()``, ``reset_backend_cache()``, ``on_tpu()``,
``resolve_mode`` and ``resolve_interpret`` are not ported. They choose
between Mosaic, interpret mode and an XLA fallback, and none of the three
has a meaning in PyTorch, where the device of a tensor decides. A parity
operand is the reference's tensor flattened to one row, ``[1, numel]``:
the reference's ops treat a whole tensor as one vector, and the port's
kernels take ``[rows, cols]`` leaves with per-row norms and thresholds.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["KernelOp", "get_op", "list_ops", "parity_suite", "PARITY_SHAPES",
           "PARITY_DTYPES", "dtype_name"]

PARITY_SHAPES: Tuple[Tuple[int, ...], ...] = (
    (64,), (1000,), (256, 128), (3, 5, 7), (32768,), (300, 70), (32769,))
PARITY_DTYPES = (torch.float32, torch.bfloat16)
LEVELS = 16


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One registered kernel op.

    bitwise: the kernel must match its oracle exactly (``parity_suite``
             holds its error to 0).
    parity:  (rng, shape, dtype, device) -> max |kernel - oracle| in f32,
             on operands drawn from the numpy generator ``rng``.
    """

    name: str
    bitwise: bool
    doc: str
    parity: Callable[[np.random.Generator, Tuple[int, ...], torch.dtype,
                      torch.device], float]


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float().reshape(-1)
                  - want.float().reshape(-1)).abs().max())


def _normal(rng, shape, dtype, dev, scale=1.0) -> torch.Tensor:
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def _uniform(rng, shape, dev) -> torch.Tensor:
    return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)


def _row(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1, -1)


def _parity_qsgd(rng, shape, dtype, dev) -> float:
    from repro_torch.core.compression import QSGD
    from repro_torch.kernels import ops, ref

    x = _normal(rng, shape, dtype, dev, scale=3.0)
    noise = _uniform(rng, shape, dev)
    c = QSGD(levels=LEVELS)._c(x.numel())
    norm = torch.linalg.vector_norm(_row(x).float(), dim=1)
    got = ops.qsgd_quantize(_row(x), _row(noise), norm, LEVELS, c)
    return _max_err(got, ref.qsgd_ref(x, noise, levels=LEVELS, c=c))


def _parity_gossip_mix(rng, shape, dtype, dev) -> float:
    """Both of K1's forms at deg 2: the gather form over the rows [x, n_1,
    n_2] with each row mixing the next two (every row held to the oracle),
    and the received-buffer form of x with its two received rows."""
    from repro_torch.kernels import ops, ref

    deg = 2
    x = _normal(rng, shape, dtype, dev)
    nbrs = _normal(rng, (deg,) + tuple(shape), dtype, dev)
    w = torch.tensor([0.5] + [0.25] * deg, dtype=torch.float32, device=dev)
    rows = torch.cat([_row(x), nbrs.reshape(deg, -1)])
    table = [[(i + j) % (deg + 1) for j in range(1, deg + 1)]
             for i in range(deg + 1)]
    nbr = torch.tensor(table, dtype=torch.int32, device=dev)
    got = ops.gossip_mix(rows, nbr, w[None].repeat(deg + 1, 1).contiguous())
    want = torch.stack([ref.gossip_mix_ref(rows[i], rows[nbr[i].long()], w)
                        for i in range(deg + 1)])
    got_recv = ops.gossip_mix_received(x.reshape(-1), nbrs.reshape(deg, -1),
                                       w)
    return max(_max_err(got, want),
               _max_err(got_recv, ref.gossip_mix_ref(x, nbrs, w)))


def _parity_choco_move(rng, shape, dtype, dev) -> float:
    from repro_torch.kernels import ops, ref

    x, y, my = (_normal(rng, shape, dtype, dev) for _ in range(3))
    got = ops.choco_move(_row(x), _row(y), _row(my), 0.37)
    want = ref.choco_move_ref(x, y, my, 0.37)
    return max(_max_err(got[0], want[0]), _max_err(got[1], want[1]))


def _parity_topk(rng, shape, dtype, dev) -> float:
    """TopK of the whole tensor through the port's kernels: K4's threshold,
    then K5's mask (the reference's ``top_k_compress``)."""
    from repro_torch.kernels import ops, ref

    x = _normal(rng, shape, dtype, dev)
    k = max(1, x.numel() // 4)
    got = ops.topk_mask(_row(x), ops.topk_threshold(_row(x), k))
    return _max_err(got, ref.top_k_ref(x, k))


def _parity_topk_mask(rng, shape, dtype, dev) -> float:
    """K5 alone against a hand-built threshold, the median |x|,
    independent of the select."""
    from repro_torch.kernels import ops

    x = _normal(rng, shape, dtype, dev)
    flat = x.reshape(-1)
    thresh = torch.sort(flat.abs()).values[flat.numel() // 2]
    got = ops.topk_mask(_row(x), thresh.reshape(1))
    want = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return _max_err(got, want)


def _parity_choco_qsgd(rng, shape, dtype, dev) -> float:
    """K2 fed the gap's f32 norm as the substrate feeds it."""
    from repro_torch.core.compression import QSGD
    from repro_torch.kernels import choco_fused, ops, ref

    x, y, my = (_normal(rng, shape, dtype, dev) for _ in range(3))
    noise = _uniform(rng, shape, dev)
    c = QSGD(levels=LEVELS)._c(x.numel())
    norm = torch.linalg.vector_norm(
        choco_fused.gap(_row(x), _row(y), _row(my), 0.5).float(), dim=1)
    got = ops.choco_qsgd(_row(x), _row(y), _row(my), _row(noise), norm, 0.5,
                         LEVELS, c)
    want = ref.choco_qsgd_ref(x, y, my, 0.5, noise, levels=LEVELS, c=c)
    return max(_max_err(got[0], want[0]), _max_err(got[1], want[1]))


def _parity_choco_topk(rng, shape, dtype, dev) -> float:
    """K3 fed the gap and K4's threshold of it, as the substrate feeds
    them."""
    from repro_torch.kernels import choco_fused, ops, ref

    x, y, my = (_normal(rng, shape, dtype, dev) for _ in range(3))
    k = max(1, x.numel() // 4)
    d = choco_fused.gap(_row(x), _row(y), _row(my), 0.5)
    got = ops.choco_topk(_row(x), _row(y), _row(my), d,
                         ops.topk_threshold(d, k), 0.5)
    want = ref.choco_topk_ref(x, y, my, 0.5, k)
    return max(_max_err(got[0], want[0]), _max_err(got[1], want[1]))


_REGISTRY: Dict[str, KernelOp] = {}


def _register(name: str, **kw) -> None:
    _REGISTRY[name] = KernelOp(name=name, **kw)


_register("qsgd_quantize", bitwise=False,
          doc="K6, QSGD quantization (element-wise, norm fed in)",
          parity=_parity_qsgd)
_register("gossip_mix", bitwise=False,
          doc="K1, weighted gossip accumulate over deg neighbours (gather "
              "and received-buffer forms)",
          parity=_parity_gossip_mix)
_register("choco_move", bitwise=False,
          doc="K7, CHOCO consensus move, (x_new, gap) in one pass",
          parity=_parity_choco_move)
_register("topk_partials", bitwise=True,
          doc="K4, the exact k-th largest |x| (radix select), with K5's mask",
          parity=_parity_topk)
_register("topk_mask", bitwise=True,
          doc="K5, keep-or-zero against the TopK threshold",
          parity=_parity_topk_mask)
_register("choco_qsgd", bitwise=False,
          doc="K2, fused CHOCO move + QSGD of the gap + estimate update",
          parity=_parity_choco_qsgd)
_register("choco_topk", bitwise=False,
          doc="K3, fused CHOCO move + TopK of the gap + estimate update",
          parity=_parity_choco_topk)


def get_op(name: str) -> KernelOp:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel op {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_ops() -> List[KernelOp]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, as numpy names the reference's."""
    return str(dtype).removeprefix("torch.")


def parity_suite(
    shapes: Sequence[Tuple[int, ...]] = PARITY_SHAPES,
    dtypes: Sequence[torch.dtype] = PARITY_DTYPES,
    seed: int = 0,
    ops: Optional[Sequence[str]] = None,
    device: Any = "cuda",
) -> List[Dict[str, Any]]:
    """Run every registered op (or those named in ``ops``) on ``device``
    against its oracle.

    Returns one record per (op, shape, dtype):
    ``{"op", "shape", "dtype", "max_err", "bitwise", "ok"}`` where ``ok``
    requires ``max_err == 0.0`` for bitwise ops and ``max_err <= tol``
    otherwise (1e-5 in f32, 1e-2 in bf16: the reference's tolerances). A
    case's operands come from numpy, seeded by the crc32 of the case as in
    the reference, so every process and device draws the same values.
    ``device`` defaults to the card and raises without one.
    """
    dev = resolve_device(device)
    records: List[Dict[str, Any]] = []
    names = [o.name for o in list_ops()] if ops is None else list(ops)
    for name in names:
        op = get_op(name)
        for shape in shapes:
            for dtype in dtypes:
                case = f"{name}:{tuple(shape)}".encode()
                rng = np.random.default_rng(
                    (seed * 7919 + zlib.crc32(case)) % 2 ** 31)
                err = op.parity(rng, tuple(shape), dtype, dev)
                tol = 0.0 if op.bitwise else (
                    1e-5 if dtype == torch.float32 else 1e-2)
                records.append({
                    "op": name,
                    "shape": list(shape),
                    "dtype": dtype_name(dtype),
                    "max_err": err,
                    "bitwise": op.bitwise,
                    "ok": bool(err <= tol),
                })
    return records
