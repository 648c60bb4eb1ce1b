"""Shared model-definition machinery of the language models.

Ported from ``repro.models.common``. Models are plain functions over a
flat parameter dict keyed by the reference's joined tree path
(``"blocks/0/mixer/wq"``, ``checkpoint/io.py:_key_of``), in the
reference's ``tree_flatten_with_path`` leaf order (``core.tree.
leaf_order``), so every gossip, compression and checkpoint leaf is the
reference's, element for element. ``ParamFactory`` makes every parameter
with the reference's shape, scale and dtype, drawn from an explicit
``torch.Generator`` (threefry's bits are not matched: tests carry the
reference's weights across with ``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]

__all__ = ["LayerSpec", "ModelConfig", "Annotated", "ParamFactory",
           "split_annotations", "flatten", "rms_norm", "rope", "swiglu",
           "softcap", "pad_vocab", "sub_tree"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period block of a stack."""

    mixer: str = "attn"          # attn | mamba
    ffn: str = "mlp"             # mlp | moe | none
    window: int = 0              # sliding-window size; 0 = full attention
    cross_attn: bool = False     # adds a cross-attention sub-block
    rope_theta: float = 0.0      # 0 = use model default


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters, generic over the six families
    (the reference's fields; ``dtype`` is a ``torch.dtype``)."""

    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int              # decoder layers (excludes encoder_layers)
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    logit_softcap: float = 0.0
    # repeating layer pattern; default = uniform (attn + cfg-default ffn)
    pattern: Tuple[LayerSpec, ...] = ()
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0             # 0 = ceil(d_model / 16)
    # encoder-decoder / multimodal
    encoder_layers: int = 0      # >0 => enc-dec (audio); encoder is bidirectional
    memory_tokens: int = 0       # VLM patches / audio frames expected (spec hint)
    memory_dim: int = 0          # frontend embedding dim (stub); 0 = d_model
    # embeddings / numerics
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # training-time mechanics (scan_layers and remat are the reference's
    # XLA options; the port runs the layers in a loop, without remat)
    scan_layers: bool = True
    remat: bool = True
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    decode_unchunked: bool = False
    loss_seq_chunk: int = 512
    ssm_chunk: int = 128
    # attention sharding family: heads | head_dim | replicated
    attn_shard: str = "heads"
    # provenance
    citation: str = ""

    def __post_init__(self):
        if self.pattern == ():
            ffn = "moe" if self.num_experts > 0 else "mlp"
            mixer = "mamba" if self.arch_type == "ssm" else "attn"
            object.__setattr__(self, "pattern",
                               (LayerSpec(mixer=mixer, ffn=ffn),))
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"pattern period {len(self.pattern)}"
        )

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or int(math.ceil(self.d_model / 16))

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_memory_input(self) -> bool:
        return self.arch_type in ("vlm", "audio")

    def layer_specs(self) -> List[LayerSpec]:
        return list(self.pattern) * self.num_periods

    def param_count(self) -> int:
        """Total parameter count (exact, from the init shapes; nothing is
        allocated)."""
        from repro_torch.models.transformer import init_params

        params, _ = init_params(self, None, abstract=True)
        return sum(int(np.prod(p.shape)) for p in params.values())

    def active_param_count(self) -> int:
        """Active params per token (MoE discounts inactive experts)."""
        total = self.param_count()
        if self.num_experts == 0:
            return total
        n_moe = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        per_expert = 3 * self.d_model * self.d_ff
        return (total - n_moe * self.num_experts * per_expert
                + n_moe * self.experts_per_token * per_expert)


# ---------------------------------------------------------------------------
# Params with logical axes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Annotated:
    """A parameter leaf paired with its logical-axis names."""

    value: Any
    axes: Tuple[Optional[str], ...]


class ParamFactory:
    """Creates ``Annotated`` params with the reference's shapes, scales and
    dtypes: ``dense`` is a normal draw in f32 times its std, cast to the
    model dtype; ``zeros`` / ``ones`` in the model dtype unless given one;
    ``const`` in f32. Draws come from ``generator`` on its own device and
    land on ``device``. ``abstract`` makes shape-only tensors on the
    ``meta`` device (nothing drawn or allocated)."""

    def __init__(self, generator: Optional[torch.Generator], dtype,
                 device="cuda", abstract: bool = False):
        self._gen = generator
        self._dtype = dtype
        self._abstract = abstract
        self._device = torch.device("meta") if abstract else resolve_device(
            device)

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    def dense(self, shape: Sequence[int], axes: Sequence[Optional[str]],
              scale: Optional[float] = None) -> Annotated:
        assert len(shape) == len(axes), (shape, axes)
        fan_in = shape[0]
        std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        if self._abstract:
            return Annotated(self._empty(shape, self._dtype), tuple(axes))
        v = torch.randn(tuple(shape), generator=self._gen,
                        dtype=torch.float32, device=self._gen.device) * std
        return Annotated(v.to(self._dtype).to(self._device), tuple(axes))

    def zeros(self, shape: Sequence[int], axes: Sequence[Optional[str]],
              dtype=None) -> Annotated:
        dt = dtype or self._dtype
        if self._abstract:
            return Annotated(self._empty(shape, dt), tuple(axes))
        return Annotated(torch.zeros(tuple(shape), dtype=dt,
                                     device=self._device), tuple(axes))

    def ones(self, shape: Sequence[int], axes: Sequence[Optional[str]],
             dtype=None) -> Annotated:
        dt = dtype or self._dtype
        if self._abstract:
            return Annotated(self._empty(shape, dt), tuple(axes))
        return Annotated(torch.ones(tuple(shape), dtype=dt,
                                    device=self._device), tuple(axes))

    def const(self, value: np.ndarray,
              axes: Sequence[Optional[str]]) -> Annotated:
        value = np.asarray(value, np.float32)
        if self._abstract:
            return Annotated(self._empty(value.shape, torch.float32),
                             tuple(axes))
        return Annotated(torch.from_numpy(np.ascontiguousarray(value)).to(
            self._device), tuple(axes))


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict / list / tuple tree in the
    reference's ``tree_flatten_with_path`` order (dict keys sorted, list
    items in order), each path the joined keys and indices
    (``checkpoint/io.py:_key_of``); ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def split_annotations(tree: Any) -> Tuple[Params, Dict[str, Tuple]]:
    """A nested tree of ``Annotated`` as (values, logical axes), both flat
    dicts keyed by path in the reference's leaf order."""
    flat = flatten(tree)
    return ({k: a.value for k, a in flat}, {k: a.axes for k, a in flat})


def sub_tree(params: Params, prefix: str, index: Optional[int] = None
             ) -> Params:
    """The leaves under ``prefix/`` with the prefix cut off, each indexed
    at ``index`` along its leading (stacked layers) axis when given."""
    p = prefix + "/"
    return {k[len(p):]: (v if index is None else v[index])
            for k, v in params.items() if k.startswith(p)}


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq            # [..., S, half]
    sin = torch.sin(ang)[..., None, :]                   # over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = torch.einsum("...d,df->...f", x, w_gate.to(x.dtype))
    u = torch.einsum("...d,df->...f", x, w_up.to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("...f,fd->...d", h, w_down.to(x.dtype))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def pad_vocab(v: int, multiple: int = 128) -> int:
    return int(math.ceil(v / multiple) * multiple)
