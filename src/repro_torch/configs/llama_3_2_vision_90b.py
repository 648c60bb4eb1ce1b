"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision (family card); 90B variant geometry]

The ViT vision encoder + adapter are a STUB per the assignment: the backbone
consumes pre-computed patch embeddings (memory_dim=1280, the vision tower
width) through the trained projector.
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import LayerSpec, ModelConfig

_SELF = LayerSpec(mixer="attn", ffn="mlp")
_CROSS = LayerSpec(mixer="attn", ffn="mlp", cross_attn=True)

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    pattern=(_SELF, _SELF, _SELF, _SELF, _CROSS),   # 20 periods of 5
    memory_dim=1280,
    memory_tokens=4096,          # patch embeddings per request (stub frontend)
    tie_embeddings=False,
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
)

ARCH = ArchConfig(
    arch_id="llama-3.2-vision-90b",
    model=CONFIG,
    reduced=reduced_from(
        CONFIG, num_layers=2, pattern=(_SELF, _CROSS), memory_tokens=16),
    sharding_mode="gossip-fsdp",
    fsdp_nodes=4,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention decoder; no sliding-window variant in "
                "the source model card (DESIGN.md section 4)",
)
