"""The generic decoder / encoder-decoder stack over LayerSpec patterns:
training, prefill and one-token decode.

Ported from ``repro.models.transformer``. One code path serves all ten
architectures: the config chooses the repeating ``pattern`` of layers
(attn / mamba mixer, mlp / moe FFN, sliding windows, cross-attention). The
parameters are a flat dict keyed by the reference's tree path in its leaf
order (``models.common``); the layers of one position in the period are
stacked ``[num_periods, ...]`` under ``blocks/<position>/``, as the
reference stacks them for its ``lax.scan``, and the port loops over the
periods. Without remat (ROADMAP.md item 7 records it): no checkpoint form
composes with the per-node ``torch.func.vmap(grad)`` of the round.

Entry points:
  init_params(cfg, generator, device)        -> (params, logical_axes)
  forward(params, tokens, cfg, memory=None)  -> (hidden, moe_aux)
  train_loss(params, batch, cfg)             -> scalar loss (+ aux)
  prefill(params, batch, cfg, max_len)       -> (last_logits, DecodeState)
  decode_step(params, state, tokens, cfg)    -> (logits, DecodeState)
  init_decode_state(cfg, batch, max_len)     -> DecodeState (empty)

``DecodeState`` keeps the reference's layout: per position in the period,
the cache leaves stacked ``[num_periods, ...]``. ``decode_step`` writes
the caches and advances the 0-d ``position`` tensor in place and returns
the same state (the reference returns a new one): a step reads nothing
back to the host, so the serving engine replays it as a CUDA graph.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (Annotated, LayerSpec, ModelConfig,
                                       ParamFactory, pad_vocab, rms_norm,
                                       split_annotations, sub_tree, swiglu)
from repro_torch.models.policy import shard_hidden

Params = Dict[str, torch.Tensor]

__all__ = ["init_params", "forward", "train_loss", "DecodeState",
           "init_decode_state", "prefill", "decode_step"]


def _mlp_params(f: ParamFactory, cfg: ModelConfig) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": f.dense((d, ff), ("embed", "mlp")),
        "w_up": f.dense((d, ff), ("embed", "mlp")),
        "w_down": f.dense((ff, d), ("mlp", "embed")),
    }


def _layer_params(f: ParamFactory, cfg: ModelConfig, spec: LayerSpec) -> Dict:
    p: Dict[str, Any] = {"ln1": f.zeros((cfg.d_model,), ("embed",))}
    if spec.mixer == "attn":
        p["mixer"] = attn_lib.attn_params(f, cfg)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_lib.mamba_params(f, cfg)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.cross_attn:
        p["ln_cross"] = f.zeros((cfg.d_model,), ("embed",))
        p["cross"] = attn_lib.attn_params(f, cfg, cross=True)
    if spec.ffn == "mlp":
        p["ln2"] = f.zeros((cfg.d_model,), ("embed",))
        p["ffn"] = _mlp_params(f, cfg)
    elif spec.ffn == "moe":
        p["ln2"] = f.zeros((cfg.d_model,), ("embed",))
        p["ffn"] = moe_lib.moe_params(f, cfg)
    elif spec.ffn != "none":
        raise ValueError(f"unknown ffn {spec.ffn!r}")
    return p


def _stack(trees: List[Dict]) -> Dict:
    """Stack identical-structure trees of ``Annotated`` along a new axis 0,
    prepending the 'layers' logical axis."""
    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(t[k] for t in leaves)) for k in leaves[0]}
        vals = [a.value for a in leaves]
        if vals[0].device.type == "meta":
            v = torch.empty((len(vals),) + tuple(vals[0].shape),
                            dtype=vals[0].dtype, device="meta")
        else:
            v = torch.stack(vals)
        return Annotated(v, ("layers",) + leaves[0].axes)

    return stack(*trees)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda", abstract: bool = False
                ) -> Tuple[Params, Dict[str, Tuple]]:
    """(params, logical_axes), flat dicts keyed by the reference's tree
    path in its leaf order, with the reference's shapes, scales and dtypes;
    the normal draws come from ``generator`` in the reference's order of
    creation. ``abstract``: shape-only ``meta`` tensors."""
    f = ParamFactory(generator, cfg.dtype, device, abstract=abstract)
    v = pad_vocab(cfg.vocab_size)
    tree: Dict[str, Any] = {
        "embed": f.dense((v, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "final_norm": f.zeros((cfg.d_model,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = f.dense((cfg.d_model, v), ("embed", "vocab"))
    if cfg.has_memory_input:
        mem_dim = cfg.memory_dim or cfg.d_model
        tree["mem_proj"] = f.dense((mem_dim, cfg.d_model), (None, "embed"))
    if cfg.is_enc_dec:
        enc_spec = LayerSpec(mixer="attn", ffn="mlp")
        assert cfg.encoder_layers >= 1
        tree["encoder"] = _stack([_layer_params(f, cfg, enc_spec)
                                  for _ in range(cfg.encoder_layers)])
        tree["encoder_norm"] = f.zeros((cfg.d_model,), ("embed",))
    period_blocks = [_layer_params(f, cfg, spec) for spec in cfg.pattern]
    stacked = []
    for pos, spec in enumerate(cfg.pattern):
        copies = [period_blocks[pos]] + [
            _layer_params(f, cfg, spec) for _ in range(cfg.num_periods - 1)]
        stacked.append(_stack(copies))
    tree["blocks"] = stacked
    return split_annotations(tree)


def _encode_memory(params: Params, memory: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """VLM: project frontend embeddings. Audio enc-dec: project then run the
    bidirectional encoder stack."""
    mem = torch.einsum("bmd,de->bme", memory.to(cfg.dtype),
                       params["mem_proj"].to(cfg.dtype))
    if not cfg.is_enc_dec:
        return mem
    positions = torch.arange(mem.shape[1], dtype=torch.int32,
                             device=mem.device)
    enc_spec = LayerSpec(mixer="attn", ffn="mlp")
    h = shard_hidden(mem)
    for i in range(cfg.encoder_layers):
        lp = sub_tree(params, "encoder", i)
        h = h + attn_lib.self_attention(
            sub_tree(lp, "mixer"), rms_norm(h, lp["ln1"]), cfg, enc_spec,
            positions=positions, causal=False)
        h = h + swiglu(rms_norm(h, lp["ln2"]), lp["ffn/w_gate"],
                       lp["ffn/w_up"], lp["ffn/w_down"])
        h = shard_hidden(h)
    return rms_norm(h, params["encoder_norm"])


def _apply_layer(lp: Params, spec: LayerSpec, h: torch.Tensor,
                 cfg: ModelConfig, positions: torch.Tensor,
                 memory: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer on the residual stream ``h``; returns (h', MoE aux or
    None)."""
    x = rms_norm(h, lp["ln1"])
    mixer = sub_tree(lp, "mixer")
    if spec.mixer == "attn":
        mixed = attn_lib.self_attention(mixer, x, cfg, spec,
                                        positions=positions)
    else:
        mixed = mamba_lib.mamba_mixer(mixer, x, cfg)
    return _after_mixer(lp, spec, h + mixed, cfg, memory)


def _after_mixer(lp: Params, spec: LayerSpec, h: torch.Tensor,
                 cfg: ModelConfig, memory: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's cross-attention and FFN sub-blocks, on the residual
    stream after its mixer; returns (h', MoE aux or None)."""
    aux = None
    if spec.cross_attn:
        assert memory is not None, f"{cfg.name}: cross-attn layer needs memory"
        xc = rms_norm(h, lp["ln_cross"])
        h = h + attn_lib.cross_attention(sub_tree(lp, "cross"), xc, memory,
                                         cfg)
    if spec.ffn == "mlp":
        x2 = rms_norm(h, lp["ln2"])
        h = h + swiglu(x2, lp["ffn/w_gate"], lp["ffn/w_up"], lp["ffn/w_down"])
    elif spec.ffn == "moe":
        x2 = rms_norm(h, lp["ln2"])
        out, aux = moe_lib.moe_ffn(sub_tree(lp, "ffn"), x2, cfg)
        h = h + out
    return h, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            memory: Optional[torch.Tensor] = None,
            checkpoint: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden [B,S,D], moe_aux scalar). ``checkpoint`` (the
    reference's remat switch) changes nothing: the port has no remat."""
    del checkpoint
    h = F.embedding(tokens.long(), params["embed"].to(cfg.dtype))
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=h.device)
    mem = None
    if cfg.has_memory_input:
        assert memory is not None, f"{cfg.name} requires memory input"
        mem = _encode_memory(params, memory, cfg)
    h = shard_hidden(h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for period in range(cfg.num_periods):
        for pos, spec in enumerate(cfg.pattern):
            h, aux_l = _apply_layer(sub_tree(params, f"blocks/{pos}", period),
                                    spec, h, cfg, positions, mem)
            if aux_l is not None:
                aux = aux + aux_l
        h = shard_hidden(h)
    return rms_norm(h, params["final_norm"]), aux


def _unembed(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", h, params["embed"].to(h.dtype))
    return torch.einsum("...d,dv->...v", h, params["lm_head"].to(h.dtype))


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, rng=None) -> torch.Tensor:
    """Next-token cross-entropy, chunked over the sequence so the full
    [B,S,V] logit tensor never materializes, plus the router aux loss."""
    del rng
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = forward(params, tokens, cfg, memory=batch.get("memory"))
    h = shard_hidden(h)
    b, s, _ = h.shape
    chunk = cfg.loss_seq_chunk
    while s % chunk:
        chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(s // chunk):
        hblk = shard_hidden(h[:, c * chunk:(c + 1) * chunk])
        lblk = labels[:, c * chunk:(c + 1) * chunk].long()
        logits = _unembed(params, hblk, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lblk[..., None])[..., 0]
        total = total + torch.sum(logz - gold)
    loss = total / (b * s)
    return loss + cfg.router_aux_coef * aux


class DecodeState(NamedTuple):
    caches: Tuple[Dict[str, torch.Tensor], ...]  # per period position,
    #                                              stacked over periods
    memory: Optional[torch.Tensor]   # encoder output / projected patches
    position: torch.Tensor           # 0-d int32: next position to write


def _empty_caches(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Per pattern position, an empty layer cache stacked over periods."""
    caches = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            one = attn_lib.init_kv_cache(cfg, spec, batch, max_len, device)
        else:
            one = mamba_lib.init_mamba_state(cfg, batch, device)
        caches.append({n: torch.stack([t] * cfg.num_periods)
                       for n, t in one.items()})
    return tuple(caches)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> DecodeState:
    """An empty state: every KV slot empty (``pos`` -1), zero SSM states,
    zero memory of ``memory_tokens`` (256 when unset) rows, position 0."""
    device = resolve_device(device)
    caches = _empty_caches(cfg, batch, max_len, device)
    mem = None
    if cfg.has_memory_input:
        mem = torch.zeros((batch, cfg.memory_tokens or 256, cfg.d_model),
                          dtype=cfg.dtype, device=device)
    return DecodeState(caches=caches, memory=mem,
                       position=torch.zeros((), dtype=torch.int32,
                                            device=device))


def prefill(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, max_len: int
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Process the prompt ``batch["tokens"]`` [B, S] (and ``"memory"``
    where the config reads one); returns (logits of the last token
    [B, pad_vocab(V)], a new state with ``position`` S)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = F.embedding(tokens.long(), params["embed"].to(cfg.dtype))
    positions = torch.arange(s, dtype=torch.int32, device=h.device)
    mem = None
    if cfg.has_memory_input:
        mem = _encode_memory(params, batch["memory"], cfg)
    h = shard_hidden(h)
    caches = _empty_caches(cfg, b, max_len, h.device)
    for period in range(cfg.num_periods):
        for pos, spec in enumerate(cfg.pattern):
            lp = sub_tree(params, f"blocks/{pos}", period)
            x = rms_norm(h, lp["ln1"])
            mixer = sub_tree(lp, "mixer")
            cache = {n: t[period] for n, t in caches[pos].items()}
            if spec.mixer == "attn":
                mixed, _ = attn_lib.prefill_attention(
                    mixer, x, cfg, spec, cache, positions=positions)
            else:
                mixed, last = mamba_lib.mamba_mixer(mixer, x, cfg,
                                                    return_state=True)
                for n, t in last.items():
                    cache[n].copy_(t)
            h, _ = _after_mixer(lp, spec, h + mixed, cfg, mem)
        h = shard_hidden(h)
    h = rms_norm(h, params["final_norm"])
    state = DecodeState(
        caches=caches, memory=mem,
        position=torch.full((), s, dtype=torch.int32, device=h.device))
    return _unembed(params, h[:, -1], cfg), state


def decode_step(params: Params, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeState]:
    """One token [B, 1] against the caches and SSM states; writes them and
    advances ``state.position`` in place. Returns (logits [B,
    pad_vocab(V)], state)."""
    h = F.embedding(tokens.long(), params["embed"].to(cfg.dtype))
    for period in range(cfg.num_periods):
        for pos, spec in enumerate(cfg.pattern):
            lp = sub_tree(params, f"blocks/{pos}", period)
            cache = {n: t[period] for n, t in state.caches[pos].items()}
            x = rms_norm(h, lp["ln1"])
            mixer = sub_tree(lp, "mixer")
            if spec.mixer == "attn":
                mixed, _ = attn_lib.decode_attention(
                    mixer, x, cfg, spec, cache, position=state.position)
            else:
                mixed, _ = mamba_lib.mamba_decode(mixer, x, cfg, cache)
            h, _ = _after_mixer(lp, spec, h + mixed, cfg, state.memory)
    h = rms_norm(h, params["final_norm"])
    state.position.add_(1)
    return _unembed(params, h[:, -1], cfg), state
