"""Mixture-of-Experts FFN: top-k routing with grouped GShard dispatch.

Ported from ``repro.models.moe``, the capacity dispatch exactly as the
reference does it: tokens are blocked into groups of ``DISPATCH_GROUP``
and dispatched to per-(group, expert) capacity buffers with one-hot
einsums; a (token, choice) past its expert's capacity is dropped. The
one-hot encodings are comparisons with an ``arange`` and the routing is
``torch.topk``, forms that ``torch.func.vmap`` maps over the node axis and
that read nothing back to the host. Ties between router probabilities may
pick other experts than ``lax.top_k`` (the tests run the router in f32).
Returns the Switch-style load-balance aux loss per call.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, ParamFactory
from repro_torch.models.policy import shard_tokens

__all__ = ["DISPATCH_GROUP", "moe_params", "moe_ffn"]

DISPATCH_GROUP = 256


def moe_params(f: ParamFactory, cfg: ModelConfig) -> Dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": f.dense((d, e), ("embed", None), scale=0.02),
        "w_gate": f.dense((e, d, ff), ("experts", "embed", "mlp")),
        "w_up": f.dense((e, d, ff), ("experts", "embed", "mlp")),
        "w_down": f.dense((e, ff, d), ("experts", "mlp", "embed")),
    }


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes (``jax.nn.one_hot``: a
    comparison with ``arange(n)``, all zeros outside the range)."""
    classes = torch.arange(n, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == classes).float()


def moe_ffn(
    p: Dict,
    x: torch.Tensor,                # [B, S, D]
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B,S,D], aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    tg = min(DISPATCH_GROUP, t)
    while t % tg:
        tg -= 1
    g = t // tg
    xg = shard_tokens(x.reshape(g, tg, d))

    logits = torch.einsum("gtd,de->gte", xg, p["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)                  # [G,Tg,E]
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)           # [G,Tg,k]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux loss (fraction routed vs mean prob).
    me = torch.mean(probs, dim=(0, 1))                             # [E]
    ce = torch.mean(_one_hot(expert_idx[..., 0], e), dim=(0, 1))
    aux = e * torch.sum(me * ce)

    cap = max(1, int(cfg.capacity_factor * k * tg / e))
    cap = min(cap, tg)

    onehot = _one_hot(expert_idx, e)                               # [G,Tg,k,E]
    # position of each (token, choice) within its (group, expert) buffer:
    # order: token-major then choice-major within token.
    flat = onehot.reshape(g, tg * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                         # [G,Tg*k,E]
    pos = pos.reshape(g, tg, k, e)
    within_cap = pos < cap
    slot = torch.einsum("gtke,gtke->gtk", pos, onehot)             # slot idx
    keep = torch.einsum("gtke,gtke->gtk", within_cap.float(), onehot)

    slot_oh = _one_hot(slot, cap)                                  # [G,Tg,k,C]
    # dispatch [G,Tg,E,C] (0/1), combine adds the gate weights.
    dispatch = torch.einsum("gtke,gtkc,gtk->gtec", onehot, slot_oh, keep)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, slot_oh,
                           keep * gate_vals.float())

    xd = x.dtype
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch.to(xd), xg)
    gg = torch.einsum("egcd,edf->egcf", expert_in, p["w_gate"].to(xd))
    uu = torch.einsum("egcd,edf->egcf", expert_in, p["w_up"].to(xd))
    hh = F.silu(gg.float()).to(xd) * uu
    out_buf = torch.einsum("egcf,efd->egcd", hh, p["w_down"].to(xd))
    out = torch.einsum("gtec,egcd->gtd", combine.to(xd), out_buf)
    return out.reshape(b, s, d), aux
