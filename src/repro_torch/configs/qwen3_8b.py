"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936; qk_norm. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen3-8B",
)

ARCH = ArchConfig(
    arch_id="qwen3-8b",
    model=CONFIG,
    reduced=reduced_from(CONFIG),
    sharding_mode="gossip-dp",
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention stack; no sub-quadratic variant in the "
                "source model card (DESIGN.md section 4)",
)
