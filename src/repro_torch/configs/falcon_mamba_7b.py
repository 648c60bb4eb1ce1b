"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, mamba-1 architecture. [arXiv:2410.05355]

long_500k RUNS: decode state is O(1) in sequence length (the arch the
assignment's sub-quadratic rule is made for).
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # mamba block has no separate FFN
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,                # d_inner = 8192
    pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    tie_embeddings=False,
    citation="arXiv:2410.05355",
)

ARCH = ArchConfig(
    arch_id="falcon-mamba-7b",
    model=CONFIG,
    reduced=reduced_from(CONFIG),
    sharding_mode="gossip-dp",
)
