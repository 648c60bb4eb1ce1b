"""GQA attention: chunked (flash-style) training / prefill path and the
KV-cache decode path, with sliding windows, qk-norm, RoPE and
cross-attention.

Ported from ``repro.models.attention``. The reference writes attention in
plain ``jnp``, outside any Pallas kernel, and so does the port in plain
torch ops. The chunked path never materializes the full [S, T] score
matrix: it loops over query chunks and, inside each, over key/value chunks
with an online softmax. Scores and the softmax-weighted sum are taken in
f32 from the model-dtype operands, as the reference's
``preferred_element_type=float32`` does.

The decode path keeps the reference's cache, ``{"k", "v": [B, size, KVH,
hd], "pos": [size] int32}`` with ``pos = -1`` for an empty slot, and a
sliding-window layer's ring buffer at ``slot(p) = p % size``.
``decode_attention`` writes the new token's k, v and position into the
cache's own tensors (``index_copy_`` at a slot computed on the device from
the 0-d position tensor), so a decode step reads nothing back to the host
and can be captured in a CUDA graph; the reference returns a new cache.
A full-attention layer's slot is clamped to the cache, as the reference's
``dynamic_update_slice`` clamps its start index.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import (LayerSpec, ModelConfig, ParamFactory,
                                       rms_norm, rope, softcap)

NEG_INF = -1e9

__all__ = ["attn_params", "chunked_attention", "self_attention",
           "init_kv_cache", "prefill_attention", "decode_attention",
           "cross_attention"]


def attn_params(f: ParamFactory, cfg: ModelConfig, cross: bool = False) -> Dict:
    h_ax = "heads" if cfg.attn_shard == "heads" else None
    kv_ax = "kv_heads" if cfg.attn_shard == "heads" else None
    hd_ax = "head_dim" if cfg.attn_shard == "head_dim" else None
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": f.dense((d, h, hd), ("embed", h_ax, hd_ax)),
        "wk": f.dense((d, kvh, hd), ("embed", kv_ax, hd_ax)),
        "wv": f.dense((d, kvh, hd), ("embed", kv_ax, hd_ax)),
        "wo": f.dense((h, hd, d), (h_ax, hd_ax, "embed")),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = f.zeros((hd,), (None,))
        p["k_norm"] = f.zeros((hd,), (None,))
    return p


def _pick_chunk(total: int, want: int) -> int:
    """Largest divisor of ``total`` that is <= want (>=1)."""
    c = min(want, total)
    while total % c:
        c -= 1
    return c


def _valid(qpos, kpos, causal: bool, window: int) -> torch.Tensor:
    """[q, k] mask: the key exists, is not in the future (``causal``) and
    lies inside the window."""
    valid = (kpos[None, :] >= 0).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    return valid


def chunked_attention(
    q: torch.Tensor,                # [B, S, H, hd]
    k: torch.Tensor,                # [B, T, KVH, hd]
    v: torch.Tensor,                # [B, T, KVH, hd]
    *,
    q_positions: torch.Tensor,      # [S] absolute positions of queries
    kv_positions: torch.Tensor,     # [T] absolute positions of keys (-1 = empty)
    causal: bool = True,
    window: int = 0,
    cap: float = 0.0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    checkpoint: bool = False,
) -> torch.Tensor:
    """The reference's chunked attention. ``checkpoint`` (recompute the
    tiles in the backward pass) has no counterpart that composes with the
    port's per-node ``vmap(grad)``, and changes nothing here."""
    del checkpoint
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qc = _pick_chunk(s, q_chunk)
    kc = _pick_chunk(t, kv_chunk)
    nq, nk = s // qc, t // kc
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()

    if nq == 1 and nk == 1:
        qr1 = q.reshape(b, s, kvh, g, hd).float()
        s_ = torch.einsum("bqngd,bknd->bngqk", qr1, kf) * scale
        s_ = softcap(s_, cap)
        valid = _valid(q_positions, kv_positions, causal, window)
        s_ = torch.where(valid, s_, NEG_INF)
        m = torch.amax(s_, dim=-1, keepdim=True)
        p = torch.exp(s_ - m)
        p = torch.where(valid, p, 0.0)
        l = torch.sum(p, dim=-1, keepdim=True)
        out1 = torch.einsum("bngqk,bknd->bngqd", p, vf)
        out1 = out1 / torch.clamp(l, min=1e-20)
        return (out1.permute(0, 3, 1, 2, 4)
                .reshape(b, s, h, hd).to(q.dtype))

    outs = []
    for i in range(nq):
        qblk = q[:, i * qc:(i + 1) * qc].reshape(b, qc, kvh, g, hd).float()
        qpos = q_positions[i * qc:(i + 1) * qc]
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, qc, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            kblk, vblk = kf[:, j * kc:(j + 1) * kc], vf[:, j * kc:(j + 1) * kc]
            kpos = kv_positions[j * kc:(j + 1) * kc]
            s_ = torch.einsum("bqngd,bknd->bngqk", qblk, kblk) * scale
            s_ = softcap(s_, cap)
            valid = _valid(qpos, kpos, causal, window)
            s_ = torch.where(valid, s_, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s_, dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            p = torch.where(valid, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bngqk,bknd->bngqd", p, vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        # [B,KVH,G,qc,hd] -> [B,qc,KVH*G,hd]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _project_q(p, x, positions, theta):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    return rope(q, positions[None, :], theta)


def _project_kv(p, x, positions, theta):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"])
    k = rope(k, positions[None, :], theta)
    return k, v


def self_attention(
    p: Dict,
    x: torch.Tensor,                # [B, S, D]
    cfg: ModelConfig,
    spec: LayerSpec,
    *,
    positions: torch.Tensor,        # [S]
    checkpoint: bool = False,
    causal: bool = True,
) -> torch.Tensor:
    theta = spec.rope_theta or cfg.rope_theta
    q = _project_q(p, x, positions, theta)
    k, v = _project_kv(p, x, positions, theta)
    out = chunked_attention(
        q, k, v, q_positions=positions, kv_positions=positions,
        causal=causal, window=spec.window, cap=cfg.logit_softcap,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        checkpoint=checkpoint)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def init_kv_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                  max_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    """An empty cache of one layer: ``size = min(window, max_len)`` slots
    for a sliding-window layer, else ``max_len``; k and v zeros in the
    model dtype, every ``pos`` -1."""
    size = min(spec.window, max_len) if spec.window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.full((size,), -1, dtype=torch.int32, device=device)}


def prefill_attention(
    p: Dict,
    x: torch.Tensor,                # [B, S, D]
    cfg: ModelConfig,
    spec: LayerSpec,
    cache: Dict[str, torch.Tensor],
    *,
    positions: torch.Tensor,        # [S]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention that also fills the KV cache, writing into
    ``cache``'s tensors in place. When the prompt outruns the cache the
    last ``size`` rows are kept, rolled so that position p sits at slot
    ``p % size``, as decode writes them. Returns (out, cache)."""
    theta = spec.rope_theta or cfg.rope_theta
    q = _project_q(p, x, positions, theta)
    k, v = _project_kv(p, x, positions, theta)
    out = chunked_attention(
        q, k, v, q_positions=positions, kv_positions=positions,
        causal=True, window=spec.window, cap=cfg.logit_softcap,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    size, s = cache["k"].shape[1], k.shape[1]
    if size >= s:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"][:s] = positions
    else:
        shift = (s - size) % size
        cache["k"].copy_(torch.roll(k[:, s - size:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, s - size:], shift, dims=1))
        cache["pos"].copy_(torch.roll(positions[s - size:], shift, dims=0))
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, cache


def decode_attention(
    p: Dict,
    x: torch.Tensor,                # [B, 1, D]
    cfg: ModelConfig,
    spec: LayerSpec,
    cache: Dict[str, torch.Tensor],
    *,
    position: torch.Tensor,         # 0-d int32: the token's position
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token against the cache. Writes k, v and ``position`` into
    ``cache``'s tensors at ``position % size`` (window) or ``position``
    (clamped to the last slot), then attends over the whole cache; the
    empty slots (``pos = -1``) are masked. Returns (out, cache)."""
    theta = spec.rope_theta or cfg.rope_theta
    pos_arr = position.reshape(1)
    q = _project_q(p, x, pos_arr, theta)
    k_new, v_new = _project_kv(p, x, pos_arr, theta)
    size = cache["k"].shape[1]
    slot = (pos_arr % size if spec.window
            else torch.clamp(pos_arr, max=size - 1)).long()
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)
    cache["pos"].index_copy_(0, slot, pos_arr.to(torch.int32))
    out = chunked_attention(
        q, cache["k"], cache["v"], q_positions=pos_arr,
        kv_positions=cache["pos"], causal=True, window=spec.window,
        cap=cfg.logit_softcap, q_chunk=1,
        kv_chunk=size if cfg.decode_unchunked else cfg.attn_kv_chunk)
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, cache


def cross_attention(
    p: Dict,
    x: torch.Tensor,                # [B, S, D]
    memory: torch.Tensor,           # [B, M, D]
    cfg: ModelConfig,
    *,
    checkpoint: bool = False,
) -> torch.Tensor:
    """No RoPE on cross-attention (memory has its own geometry)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bmd,dhk->bmhk", memory, p["wk"].to(memory.dtype))
    v = torch.einsum("bmd,dhk->bmhk", memory, p["wv"].to(memory.dtype))
    m = memory.shape[1]
    out = chunked_attention(
        q, k, v,
        q_positions=torch.zeros((x.shape[1],), dtype=torch.int32,
                                device=x.device),
        kv_positions=torch.zeros((m,), dtype=torch.int32, device=x.device),
        causal=False, window=0, cap=cfg.logit_softcap,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        checkpoint=checkpoint)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
