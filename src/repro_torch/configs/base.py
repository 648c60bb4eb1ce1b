"""Per-architecture deployment config: model + DFL mapping + shape policy."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """An assigned architecture + its production mapping."""

    arch_id: str
    model: ModelConfig
    reduced: ModelConfig          # smoke-test variant (<=2 periods, d<=512)
    # DFL node mapping (see DESIGN.md section 3):
    #   gossip-dp   — node axis = mesh data axis (16 / 32 divergent replicas)
    #   gossip-fsdp — few replicated nodes; weights FSDP x TP sharded
    sharding_mode: str = "gossip-dp"
    fsdp_nodes: int = 4           # node count in gossip-fsdp mode
    # which shapes run (long_500k gated on sub-quadratic support)
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""

    def shapes(self) -> Tuple[str, ...]:
        return tuple(s for s in SHAPES if s not in self.skip_shapes)


def reduced_from(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Derive the CPU smoke-test variant of a full config."""
    base = dict(
        name=cfg.name + "-reduced",
        num_layers=2 * len(cfg.pattern) if len(cfg.pattern) <= 2 else len(cfg.pattern),
        d_model=min(cfg.d_model, 256),
        num_heads=min(cfg.num_heads, 4) or 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 0,
        head_dim=min(cfg.head_dim, 32) or 0,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 8),
        encoder_layers=min(cfg.encoder_layers, 2),
        memory_dim=min(cfg.memory_dim, 64) if cfg.memory_dim else 0,
        memory_tokens=min(cfg.memory_tokens, 16) if cfg.memory_tokens else 0,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        loss_seq_chunk=16,
        ssm_chunk=8,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
