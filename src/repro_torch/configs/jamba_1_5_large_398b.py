"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 (per expert) vocab=65536, MoE 16 experts top-2; Mamba:attention
1:7 interleave. [arXiv:2403.19887]

Period-8 block (HF Jamba: attn_layer_period=8 offset=4; expert_layer_period=2
offset=1): position 4 is attention, the rest Mamba; odd positions carry the
MoE FFN, even positions a dense FFN of the same width.

long_500k RUNS: 63/72 layers are O(1)-state Mamba; the 9 attention layers
keep the 512k KV cache sharded over the `model` mesh axis (decode is linear).
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import LayerSpec, ModelConfig

def _spec(pos: int) -> LayerSpec:
    mixer = "attn" if pos == 4 else "mamba"
    ffn = "moe" if pos % 2 == 1 else "mlp"
    return LayerSpec(mixer=mixer, ffn=ffn)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,                # d_inner = 16384
    pattern=tuple(_spec(i) for i in range(8)),
    tie_embeddings=False,
    citation="arXiv:2403.19887",
)

ARCH = ArchConfig(
    arch_id="jamba-1.5-large-398b",
    model=CONFIG,
    reduced=reduced_from(
        CONFIG, num_layers=2,
        pattern=(LayerSpec(mixer="mamba", ffn="moe"),
                 LayerSpec(mixer="attn", ffn="mlp"))),
    sharding_mode="gossip-fsdp",
    fsdp_nodes=2,                # 2 x 796 GB bf16 replicas / 256 chips
)
