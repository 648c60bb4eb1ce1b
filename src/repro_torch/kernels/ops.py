"""Public wrappers around the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches on the current CUDA stream. A
tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the kernel or raises; nothing falls back.

``LAUNCHES`` counts kernel launches, one per launch and nowhere else (the
analogue of the reference's ``op_stats``), so a run can show that its
main path went through the kernels::

    reset_launches()
    ... drive the path ...
    assert LAUNCHES["gossip_mix"] == expected

Entry points (all on 2-D ``[rows, cols]`` views of stacked leaves), one
for each of the reference's seven Pallas kernels:
  * ``gossip_mix_many(xs, nbr, w)``        K1, one circulant gossip step
                                           over every leaf of a tree;
                                           ``gossip_mix`` for one leaf.
  * ``gossip_mix_received_many(xs, recvs, w)``
                                           K1's received-buffer form, one
                                           node's step on the sharded
                                           engine over every leaf;
                                           ``gossip_mix_received`` for one.
  * ``choco_qsgd(x, y, my, noise, norm, gamma, levels, c)``
                                           K2, fused CHOCO-QSGD step.
  * ``choco_topk(x, y, my, d, t, gamma)``  K3, fused CHOCO-TopK step.
  * ``topk_threshold_many(xs, ks)``        K4, per-row k-th largest |x| of
                                           every leaf of a list;
                                           ``topk_threshold`` for one.
  * ``topk_threshold_sharded_many(xs, ks, span)``
                                           K4's sharded-row form: the
                                           k-th largest |x| of rows split
                                           over the ranks of ``span``
                                           (``core.sharded.RowSpan``).
  * ``topk_mask_many(xs, threshs)``       K5, per-row keep-or-zero of
                                           every leaf of a list;
                                           ``topk_mask`` for one.
  * ``qsgd_quantize_many(xs, noises, norms, levels, cs)``
                                           K6, per-row QSGD of every leaf
                                           of a tree in one launch;
                                           ``qsgd_quantize`` for one.
  * ``choco_move(x, y, my, gamma)``        K7, CHOCO move, (x_new, gap).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import choco_fused as _choco
from repro_torch.kernels import choco_update as _move
from repro_torch.kernels import gossip_mix as _mix
from repro_torch.kernels import qsgd as _qsgd
from repro_torch.kernels import topk as _topk

DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES: Dict[str, int] = {"gossip_mix": 0, "gossip_mix_received": 0,
                            "choco_qsgd": 0,
                            "choco_topk": 0, "topk_threshold": 0,
                            "topk_threshold_sharded": 0,
                            "topk_mask": 0, "qsgd_quantize": 0,
                            "choco_move": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(op: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises on anything else
    or on a mix of devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{op}: operands on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{op}: unsupported device {dev}")
    return dev.type == "cuda"


def _check_leaf(op: str, name: str, t: torch.Tensor, shape=None,
                grid_rows: bool = True) -> None:
    """A 2-D float32 or bfloat16 leaf, contiguous, of ``shape`` if given;
    ``grid_rows``: its rows are a kernel's ``blockIdx.y``, at most 65,535."""
    if t.dtype not in DTYPES:
        raise TypeError(f"{op}: {name} has dtype {t.dtype}; kernels take "
                        "float32 and bfloat16")
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{op}: {name} must be a non-empty [rows, cols] "
                         f"tensor, got {tuple(t.shape)}")
    if grid_rows and t.shape[0] > 65535:
        raise ValueError(f"{op}: {t.shape[0]} rows exceed the launch grid")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def _check_rows(op: str, name: str, t: torch.Tensor, rows: int, dtype) -> None:
    if t.dtype != dtype or tuple(t.shape) != (rows,) or not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be a contiguous [{rows}] {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


def _check_like(op: str, x: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Each of ``tensors`` is a leaf of x's shape and dtype."""
    for name, t in tensors.items():
        _check_leaf(op, name, t, x.shape)
        if t.dtype != x.dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}, x is {x.dtype}")


def _check_noise(op: str, noise: torch.Tensor, shape,
                 grid_rows: bool = True) -> None:
    if noise.dtype != torch.float32:
        raise TypeError(f"{op}: noise must be float32, got {noise.dtype}")
    _check_leaf(op, "noise", noise, shape, grid_rows)


def gossip_mix_many(xs: Sequence[torch.Tensor], nbr: torch.Tensor,
                    w: torch.Tensor) -> List[torch.Tensor]:
    """K1 over every leaf of ``xs`` (each ``[N, D_i]``, one dtype):
    ``out[i] = w[i,0] x[i] + sum_k w[i,k+1] x[nbr[i,k]]`` (f32 accumulate,
    leaf dtype out). ``nbr`` [N, deg] int32, ``w`` [N, deg+1] float32,
    shared by all leaves. One launch per ``gossip_mix.MAX_LEAVES`` leaves;
    on the card N is at most ``gossip_mix.MAX_ROWS``."""
    op = "gossip_mix"
    xs = list(xs)
    if not xs:
        raise ValueError(f"{op}: no leaves")
    on_card = _on_card(op, *xs, nbr, w)
    for x in xs:
        _check_leaf(op, "x", x)
        if x.dtype != xs[0].dtype or x.shape[0] != xs[0].shape[0]:
            raise ValueError(f"{op}: leaves must share dtype and rows, got "
                             f"{tuple(x.shape)} {x.dtype} and "
                             f"{tuple(xs[0].shape)} {xs[0].dtype}")
    rows = xs[0].shape[0]
    if (nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[0] != rows
            or not nbr.is_contiguous()):
        raise ValueError(f"{op}: nbr must be a contiguous [{rows}, deg] int32 "
                         f"tensor, got {tuple(nbr.shape)} {nbr.dtype}")
    deg = nbr.shape[1]
    if (w.dtype != torch.float32 or tuple(w.shape) != (rows, deg + 1)
            or not w.is_contiguous()):
        raise ValueError(f"{op}: w must be a contiguous [{rows}, {deg + 1}] "
                         f"float32 tensor, got {tuple(w.shape)} {w.dtype}")
    if not on_card:
        return [_mix.plain(x, nbr, w) for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    with torch.cuda.device(xs[0].device):
        LAUNCHES[op] += _mix.launch_many(xs, nbr, w, outs)
    return outs


def gossip_mix(x: torch.Tensor, nbr: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """K1 on one leaf ``x`` [N, D]: ``gossip_mix_many([x], nbr, w)``."""
    return gossip_mix_many([x], nbr, w)[0]


def gossip_mix_received_many(xs: Sequence[torch.Tensor],
                             recvs: Sequence[torch.Tensor],
                             w: torch.Tensor) -> List[torch.Tensor]:
    """K1's received-buffer form over every leaf of ``xs`` (one node's
    leaves, each ``[D_i]`` or ``[1, D_i]``, contiguous, one dtype):
    ``out = w[0] x + sum_j w[j+1] recvs[i][j]`` (f32 accumulate, leaf dtype
    out), with ``recvs[i]`` the ``[deg, D_i]`` buffers received for leaf i
    (x's dtype; rows contiguous, any row stride) and ``w`` ``[deg + 1]``
    float32 on x's device, shared by all leaves. One launch per
    ``gossip_mix.MAX_LEAVES`` leaves."""
    op = "gossip_mix_received"
    xs, recvs = list(xs), list(recvs)
    if not xs or len(xs) != len(recvs):
        raise ValueError(f"{op}: {len(xs)} leaves and {len(recvs)} received "
                         "buffers")
    on_card = _on_card(op, *xs, *recvs, w)
    deg = recvs[0].shape[0] if recvs[0].dim() == 2 else -1
    for x, recv in zip(xs, recvs):
        if x.dtype not in DTYPES or x.dtype != xs[0].dtype:
            raise TypeError(f"{op}: leaves must share one of {DTYPES}, got "
                            f"{x.dtype} and {xs[0].dtype}")
        if (x.dim() not in (1, 2) or (x.dim() == 2 and x.shape[0] != 1)
                or x.numel() < 1 or not x.is_contiguous()):
            raise ValueError(f"{op}: x must be a contiguous non-empty [D] or "
                             f"[1, D] tensor, got {tuple(x.shape)}")
        if (recv.dtype != x.dtype or tuple(recv.shape) != (deg, x.numel())
                or (x.numel() > 1 and recv.stride(1) != 1)):
            raise ValueError(
                f"{op}: received buffers must be [{deg}, {x.numel()}] "
                f"{x.dtype} with contiguous rows, got {tuple(recv.shape)} "
                f"{recv.dtype} strides {recv.stride()}")
    if (w.dtype != torch.float32 or tuple(w.shape) != (deg + 1,)
            or not w.is_contiguous()):
        raise ValueError(f"{op}: w must be a contiguous [{deg + 1}] float32 "
                         f"tensor, got {tuple(w.shape)} {w.dtype}")
    if not on_card:
        return [_mix.plain_received(x, recv, w) for x, recv in zip(xs, recvs)]
    outs = [torch.empty_like(x) for x in xs]
    with torch.cuda.device(xs[0].device):
        LAUNCHES[op] += _mix.launch_received_many(xs, recvs, w, outs)
    return outs


def gossip_mix_received(x: torch.Tensor, recv: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """K1's received form on one leaf: ``gossip_mix_received_many([x],
    [recv], w)``."""
    return gossip_mix_received_many([x], [recv], w)[0]


def topk_threshold_many(xs: Sequence[torch.Tensor],
                        ks: Sequence[int]) -> List[torch.Tensor]:
    """K4: per row of each leaf ``xs[i]`` ([R_i, D_i], one dtype), the
    ``ks[i]``-th largest |x| in that dtype (ties inclusive); one ``[R_i]``
    tensor per leaf. On the card, one call of ``topk.launch_threshold_many``
    per ``topk.MAX_LEAVES`` leaves."""
    op = "topk_threshold"
    xs, ks = list(xs), [int(k) for k in ks]
    if not xs or len(xs) != len(ks):
        raise ValueError(f"{op}: {len(xs)} leaves and {len(ks)} k values")
    on_card = _on_card(op, *xs)
    for x, k in zip(xs, ks):
        _check_leaf(op, "x", x)
        if x.dtype != xs[0].dtype:
            raise TypeError(f"{op}: leaves of {x.dtype} and {xs[0].dtype}")
        if not 1 <= k <= x.shape[1]:
            raise ValueError(
                f"TopK k={k} out of range for a size-{x.shape[1]} vector")
        if x.shape[1] >= 2 ** 31:
            raise ValueError(f"{op}: {x.shape[1]} columns exceed the 32-bit "
                             "counts")
    if not on_card:
        return [_topk.threshold_plain(x, k) for x, k in zip(xs, ks)]
    outs = [torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
            for x in xs]
    with torch.cuda.device(xs[0].device):
        LAUNCHES[op] += _topk.launch_threshold_many(xs, ks, outs)
    return outs


def topk_threshold_sharded_many(xs: Sequence[torch.Tensor],
                                ks: Sequence[int],
                                span) -> List[torch.Tensor]:
    """K4's sharded-row form: ``xs[i]`` ([R_i, D_i], one dtype) is this
    rank's part of R_i rows that ``span`` (``core.sharded.RowSpan``)
    splits over ``span.size`` ranks; per row, the ``ks[i]``-th largest |x|
    of the WHOLE row in that dtype (ties inclusive), the same on every rank
    and bitwise ``topk_threshold`` on the gathered rows. Every rank of the
    span calls it with the same shapes. On the card one call of
    ``topk.launch_threshold_sharded_many`` per ``topk.MAX_LEAVES`` leaves,
    the histograms summed through ``span.sum``; on the CPU the plain
    version gathers each leaf's rows (``span.gather_cols``)."""
    op = "topk_threshold_sharded"
    xs, ks = list(xs), [int(k) for k in ks]
    if not xs or len(xs) != len(ks):
        raise ValueError(f"{op}: {len(xs)} leaves and {len(ks)} k values")
    on_card = _on_card(op, *xs)
    for x, k in zip(xs, ks):
        _check_leaf(op, "x", x)
        if x.dtype != xs[0].dtype:
            raise TypeError(f"{op}: leaves of {x.dtype} and {xs[0].dtype}")
        if not 1 <= k <= x.shape[1] * span.size:
            raise ValueError(f"TopK k={k} out of range for a size-"
                             f"{x.shape[1] * span.size} vector")
        if x.shape[1] * span.size >= 2 ** 31:
            raise ValueError(f"{op}: {x.shape[1] * span.size} columns exceed "
                             "the 32-bit counts")
    if not on_card:
        return [_topk.threshold_sharded_plain(x, k, span.gather_cols)
                for x, k in zip(xs, ks)]
    outs = [torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
            for x in xs]
    with torch.cuda.device(xs[0].device):
        LAUNCHES[op] += _topk.launch_threshold_sharded_many(xs, ks, outs,
                                                            span.sum)
    return outs


def topk_threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """K4 on one leaf: ``topk_threshold_many([x], [k])``."""
    return topk_threshold_many([x], [k])[0]


def topk_mask_many(xs: Sequence[torch.Tensor],
                   threshs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K5: ``where(|x| >= thresh[row], x, 0)`` in x's dtype for each leaf
    ``xs[i]`` ([R_i, D_i], one dtype) and its ``threshs[i]`` ([R_i], x's
    dtype). One launch per ``topk.MAX_LEAVES`` leaves, with no cap on the
    rows."""
    op = "topk_mask"
    xs, threshs = list(xs), list(threshs)
    if not xs or len(xs) != len(threshs):
        raise ValueError(f"{op}: {len(xs)} leaves and {len(threshs)} "
                         "thresholds")
    on_card = _on_card(op, *xs, *threshs)
    for x, t in zip(xs, threshs):
        _check_leaf(op, "x", x, grid_rows=False)
        if x.dtype != xs[0].dtype:
            raise TypeError(f"{op}: leaves of {x.dtype} and {xs[0].dtype}")
        _check_rows(op, "thresh", t, x.shape[0], x.dtype)
    if not on_card:
        return [_topk.mask_plain(x, t) for x, t in zip(xs, threshs)]
    outs = [torch.empty_like(x) for x in xs]
    with torch.cuda.device(xs[0].device):
        LAUNCHES[op] += _topk.launch_mask_many(xs, threshs, outs)
    return outs


def topk_mask(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """K5 on one leaf: ``topk_mask_many([x], [thresh])``."""
    return topk_mask_many([x], [thresh])[0]


def choco_topk(x: torch.Tensor, y: torch.Tensor, my: torch.Tensor,
               d: torch.Tensor, thresh: torch.Tensor,
               gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``x_new = x + gamma (my - y)`` (f32, cast to the leaf dtype) and
    ``y_new = y + where(|d| >= thresh[row], d, 0)``; returns both."""
    op = "choco_topk"
    on_card = _on_card(op, x, y, my, d, thresh)
    _check_leaf(op, "x", x)
    _check_like(op, x, y=y, my=my, d=d)
    _check_rows(op, "thresh", thresh, x.shape[0], x.dtype)
    if not on_card:
        return _choco.plain(x, y, my, d, thresh, gamma)
    x_out = torch.empty_like(x)
    y_out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _choco.launch(x, y, my, d, thresh, float(gamma), x_out, y_out)
    LAUNCHES[op] += 1
    return x_out, y_out


def qsgd_quantize_many(xs: Sequence[torch.Tensor],
                       noises: Sequence[torch.Tensor],
                       norms: Sequence[torch.Tensor], levels: int,
                       cs: Sequence[float]) -> List[torch.Tensor]:
    """K6 over every leaf of ``xs`` (each ``[R_i, D_i]``, one dtype): per
    row, ``sign(x) norm floor(s |x| / norm + noise) / (s c)`` in f32 (0
    where ``norm[row]`` is not > 0), cast to x's dtype. ``noises[i]``
    float32 of ``xs[i]``'s shape, ``norms[i]`` [R_i] float32, ``s =
    levels`` for all leaves and ``cs[i]`` leaf i's c. One launch per
    ``qsgd.MAX_LEAVES`` leaves, with no cap on the rows."""
    op = "qsgd_quantize"
    xs, noises, norms, cs = list(xs), list(noises), list(norms), list(cs)
    if not xs or not len(xs) == len(noises) == len(norms) == len(cs):
        raise ValueError(f"{op}: {len(xs)} leaves, {len(noises)} noises, "
                         f"{len(norms)} norms and {len(cs)} c values")
    on_card = _on_card(op, *xs, *noises, *norms)
    for x, noise, norm in zip(xs, noises, norms):
        _check_leaf(op, "x", x, grid_rows=False)
        if x.dtype != xs[0].dtype:
            raise TypeError(f"{op}: leaves of {x.dtype} and {xs[0].dtype}")
        _check_noise(op, noise, x.shape, grid_rows=False)
        _check_rows(op, "norm", norm, x.shape[0], torch.float32)
    scs = [_qsgd.scale(levels, c) for c in cs]
    if not on_card:
        return [_qsgd.plain(x, noise, norm, levels, sc)
                for x, noise, norm, sc in zip(xs, noises, norms, scs)]
    outs = [torch.empty_like(x) for x in xs]
    with torch.cuda.device(xs[0].device):
        LAUNCHES[op] += _qsgd.launch_many(xs, noises, norms, float(levels),
                                          scs, outs)
    return outs


def qsgd_quantize(x: torch.Tensor, noise: torch.Tensor, norm: torch.Tensor,
                  levels: int, c: float) -> torch.Tensor:
    """K6 on one leaf: ``qsgd_quantize_many([x], [noise], [norm], levels,
    [c])``."""
    return qsgd_quantize_many([x], [noise], [norm], levels, [c])[0]


def choco_qsgd(x: torch.Tensor, y: torch.Tensor, my: torch.Tensor,
               noise: torch.Tensor, norm: torch.Tensor, gamma: float,
               levels: int, c: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``x_new = x + gamma (my - y)`` (f32, cast to the leaf dtype) and
    ``y_new = y + q``, ``q`` the QSGD (as K6) of the gap ``x_new - y`` in
    the leaf dtype, with ``norm`` [rows] float32 the gap's row norms and
    ``noise`` float32 of x's shape; returns both."""
    op = "choco_qsgd"
    on_card = _on_card(op, x, y, my, noise, norm)
    _check_leaf(op, "x", x)
    _check_like(op, x, y=y, my=my)
    _check_noise(op, noise, x.shape)
    _check_rows(op, "norm", norm, x.shape[0], torch.float32)
    sc = _qsgd.scale(levels, c)
    if not on_card:
        return _choco.qsgd_plain(x, y, my, noise, norm, gamma, levels, sc)
    x_out = torch.empty_like(x)
    y_out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _choco.launch_qsgd(x, y, my, noise, norm, float(gamma), float(levels),
                           sc, x_out, y_out)
    LAUNCHES[op] += 1
    return x_out, y_out


def choco_move(x: torch.Tensor, y: torch.Tensor, my: torch.Tensor,
               gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: ``x_new = x + gamma (my - y)`` in f32 and ``d = x_new - y`` from
    the f32 ``x_new``, both cast to the leaf dtype; returns (x_new, d)."""
    op = "choco_move"
    on_card = _on_card(op, x, y, my)
    _check_leaf(op, "x", x)
    _check_like(op, x, y=y, my=my)
    if not on_card:
        return _move.plain(x, y, my, gamma)
    x_out = torch.empty_like(x)
    d_out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _move.launch(x, y, my, float(gamma), x_out, d_out)
    LAUNCHES[op] += 1
    return x_out, d_out
