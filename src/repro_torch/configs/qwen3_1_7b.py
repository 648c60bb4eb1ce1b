"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm. [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="hf:Qwen/Qwen3-8B",
)

ARCH = ArchConfig(
    arch_id="qwen3-1.7b",
    model=CONFIG,
    reduced=reduced_from(CONFIG),
    sharding_mode="gossip-dp",
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention stack; no sub-quadratic variant in the "
                "source model card (DESIGN.md section 4)",
)
