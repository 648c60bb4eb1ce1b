"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                    # per-expert FFN width
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

ARCH = ArchConfig(
    arch_id="granite-moe-1b-a400m",
    model=CONFIG,
    reduced=reduced_from(CONFIG),
    sharding_mode="gossip-dp",
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention stack; no sub-quadratic variant in the "
                "source model card (DESIGN.md section 4)",
)
