"""Mamba-1 selective-SSM mixer (falcon-mamba / jamba layers): the
full-sequence mixer (training, prefill) and the O(1) recurrent decode step.

Ported from ``repro.models.mamba``. Sequences are processed in chunks of
``cfg.ssm_chunk``; within a chunk the recurrence h_t = a_t h_{t-1} + u_t
is a log-step (Hillis-Steele) scan over the chunk in plain tensor ops,
the port of the reference's ``lax.associative_scan``, and chunks are
chained by a loop carrying h. The two scans combine the same products in
another order, so they agree to a tolerance, not bitwise
(``tests/test_torch_lm_models.py``). The [B, chunk, d_inner, state]
intermediate lives only inside one chunk. The leaves keep the reference's
mix of dtypes: ``a_log`` and ``d_skip`` are f32 whatever the model dtype.
Decode is the recurrent step on ``{"conv": [B, K-1, di] model dtype,
"ssm": [B, di, st] f32}``; ``mamba_decode`` writes the new state into
those tensors (the reference returns a new state), so a decode step can be
captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, ParamFactory

__all__ = ["mamba_params", "mamba_mixer", "init_mamba_state", "mamba_decode"]


def mamba_params(f: ParamFactory, cfg: ModelConfig) -> Dict:
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, k = cfg.dt_rank_actual, cfg.ssm_conv
    a_init = np.broadcast_to(np.arange(1, st + 1, dtype=np.float32), (di, st))
    return {
        "wx": f.dense((d, di), ("embed", "ssm_inner")),
        "wz": f.dense((d, di), ("embed", "ssm_inner")),
        "conv_w": f.dense((k, di), (None, "ssm_inner"), scale=0.2),
        "conv_b": f.zeros((di,), ("ssm_inner",)),
        "w_dt": f.dense((di, dtr), ("ssm_inner", None)),
        "w_bc": f.dense((di, 2 * st), ("ssm_inner", None)),
        "dt_proj": f.dense((dtr, di), (None, "ssm_inner")),
        "dt_bias": f.zeros((di,), ("ssm_inner",)),
        "a_log": f.const(np.log(a_init), ("ssm_inner", None)),
        "d_skip": f.ones((di,), ("ssm_inner",), dtype=torch.float32),
        "out_proj": f.dense((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along seq. x [B,S,di]; w [K,di]; history
    [B,K-1,di] carries the last inputs of the previous segment."""
    k = w.shape[0]
    if history is None:
        history = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([history, x], dim=1)
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _ssm_inputs(p: Dict, xc: torch.Tensor, cfg: ModelConfig):
    """xc [B,S,di] (post conv+silu) -> (dt [B,S,di], B/C [B,S,st])."""
    st = cfg.ssm_state
    dt_low = torch.einsum("bsd,dr->bsr", xc, p["w_dt"].to(xc.dtype))
    dt = torch.einsum("bsr,rd->bsd", dt_low, p["dt_proj"].to(xc.dtype))
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    bc = torch.einsum("bsd,dn->bsn", xc, p["w_bc"].to(xc.dtype))
    return dt, bc[..., :st].float(), bc[..., st:].float()


def _scan_chunk(a: torch.Tensor, u: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t h_{t-1} + u_t within one chunk by a log-step scan.

    a, u: [B, Q, di, st]; h0: [B, di, st]. After the pass at offset o,
    (a_t, u_t) is the composition of steps t-2o+1 .. t, the reference's
    combine ``(a1, b1) o (a2, b2) = (a1 a2, b1 a2 + b2)``. Returns (h_all
    [B,Q,di,st], h_last)."""
    q = a.shape[1]
    off = 1
    while off < q:
        a_prev, u_prev = a[:, :-off], u[:, :-off]
        a_cur, u_cur = a[:, off:], u[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        u = torch.cat([u[:, :off], u_prev * a_cur + u_cur], dim=1)
        off *= 2
    h_all = u + a * h0[:, None]
    return h_all, h_all[:, -1]


def mamba_mixer(
    p: Dict,
    x: torch.Tensor,                # [B, S, D]
    cfg: ModelConfig,
    *,
    checkpoint: bool = False,
    return_state: bool = False,
):
    """Full-sequence mamba block (train / prefill). ``checkpoint`` has no
    effect (no remat under the port's ``vmap(grad)``). ``return_state``:
    also the decode state after the sequence, ``{"conv": the last K-1
    rows of the conv input (left-padded with zeros when S < K-1), "ssm":
    h_last}``."""
    del checkpoint
    b, s, _ = x.shape
    di, st = cfg.d_inner, cfg.ssm_state
    xin = torch.einsum("bsd,de->bse", x, p["wx"].to(x.dtype))
    z = torch.einsum("bsd,de->bse", x, p["wz"].to(x.dtype))
    xc = _causal_conv(xin, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    a = -torch.exp(p["a_log"].float())                   # [di, st]

    q = cfg.ssm_chunk
    while s % q:
        q -= 1
    h = torch.zeros((b, di, st), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(s // q):
        xc_c = xc[:, c * q:(c + 1) * q]                  # [B, q, di]
        dt, bmat, cmat = _ssm_inputs(p, xc_c, cfg)
        decay = torch.exp(dt[..., None] * a)             # [B,q,di,st]
        u = (dt * xc_c.float())[..., None] * bmat[:, :, None, :]
        h_all, h = _scan_chunk(decay, u, h)
        y = torch.einsum("bqds,bqs->bqd", h_all, cmat)
        y = y + p["d_skip"].float() * xc_c.float()
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)

    y = y * F.silu(z.float()).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    if return_state:
        k = cfg.ssm_conv
        conv_state = xin[:, s - (k - 1):] if s >= k - 1 else F.pad(
            xin, (0, 0, k - 1 - s, 0))
        return out, {"conv": conv_state, "ssm": h}
    return out


def init_mamba_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Zero decode state: the conv history in the model dtype, the SSM
    state in f32."""
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=cfg.dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device)}


def mamba_decode(
    p: Dict,
    x: torch.Tensor,                # [B, 1, D]
    cfg: ModelConfig,
    state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step; the new conv history and SSM state are
    written into ``state``'s tensors. Returns (out, state)."""
    xin = torch.einsum("bsd,de->bse", x, p["wx"].to(x.dtype))   # [B,1,di]
    z = torch.einsum("bsd,de->bse", x, p["wz"].to(x.dtype))
    conv_hist = state["conv"].to(x.dtype)
    xc = _causal_conv(xin, p["conv_w"], p["conv_b"], history=conv_hist)
    xc = F.silu(xc.float()).to(x.dtype)
    new_conv = torch.cat([conv_hist[:, 1:], xin], dim=1)

    dt, bmat, cmat = _ssm_inputs(p, xc, cfg)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt[:, 0, :, None] * a)                 # [B,di,st]
    u = (dt[:, 0] * xc[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = decay * state["ssm"] + u
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])
    y = y + p["d_skip"].float() * xc[:, 0].float()
    y = y[:, None].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    state["conv"].copy_(new_conv)
    state["ssm"].copy_(h)
    return out, state
