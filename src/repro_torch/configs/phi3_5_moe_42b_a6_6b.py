"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
(per expert) vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)

ARCH = ArchConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    model=CONFIG,
    reduced=reduced_from(CONFIG),
    sharding_mode="gossip-fsdp",
    fsdp_nodes=4,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention stack; no sub-quadratic variant in the "
                "source model card (DESIGN.md section 4)",
)
