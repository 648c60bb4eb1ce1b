"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256; llama-architecture. [arXiv:2401.14196]

56 heads do not divide the 16-way `model` mesh axis, so attention shards on
head_dim (contraction-dim sharding; GSPMD inserts the psum) — see DESIGN.md.
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    tie_embeddings=False,
    attn_shard="head_dim",
    citation="arXiv:2401.14196",
)

ARCH = ArchConfig(
    arch_id="deepseek-coder-33b",
    model=CONFIG,
    reduced=reduced_from(CONFIG),
    sharding_mode="gossip-fsdp",
    fsdp_nodes=4,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention stack; no sub-quadratic variant in the "
                "source model card (DESIGN.md section 4)",
)
