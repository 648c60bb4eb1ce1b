"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144; 5:1 local(sliding-window 1024):global attention, 128k context.
[hf:google/gemma-3-1b-pt family card; 4B geometry]

The 5:1 pattern over 34 layers is not periodic, so the full per-layer
pattern is materialized (scan period = 34, num_periods = 1): global
attention at layers 5, 11, 17, 23, 29 (0-indexed), sliding-window 1024
elsewhere. Local layers use rope_theta=10k, global layers 1M (model card).

long_500k RUNS for this arch: the sliding-window layers keep a 1024-slot
cache; only the 5 global layers carry the full 512k KV (sharded over the
`model` mesh axis).
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="attn", ffn="mlp", window=1024, rope_theta=10_000.0)
_GLOBAL = LayerSpec(mixer="attn", ffn="mlp", rope_theta=1_000_000.0)

_PATTERN = tuple(
    _GLOBAL if (i % 6) == 5 else _LOCAL for i in range(34)
)

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    qk_norm=True,
    rope_theta=1_000_000.0,
    pattern=_PATTERN,
    tie_embeddings=True,
    attn_shard="head_dim",       # 8 heads don't divide the 16-way model axis
    citation="hf:google/gemma-3-1b-pt",
)

ARCH = ArchConfig(
    arch_id="gemma3-4b",
    model=CONFIG,
    reduced=reduced_from(
        CONFIG, num_layers=2, pattern=(_LOCAL, _GLOBAL), head_dim=32),
    sharding_mode="gossip-dp",
)
