"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=256206; encoder-decoder, multimodal. [arXiv:2308.11596]

Backbone interpretation: 12 encoder layers (bidirectional, over speech-frame
embeddings) + 12 decoder layers (causal self-attn + cross-attn to the
encoder memory). The mel-spectrogram + conv feature extractor frontend is a
STUB per the assignment — ``input_specs`` supplies frame embeddings
(memory_dim = 1024) directly; frames = seq_len // 4.

Skips: long_500k (full-attention enc-dec speech model; 512k-token decode is
out of scope for the family) — see DESIGN.md section 4.
"""
from repro_torch.configs.base import ArchConfig, reduced_from
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,               # decoder
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
    memory_dim=1024,             # conv feature extractor output width (stub)
    memory_tokens=1024,          # default; launcher scales to seq_len // 4
    tie_embeddings=True,
    citation="arXiv:2308.11596",
)

ARCH = ArchConfig(
    arch_id="seamless-m4t-medium",
    model=CONFIG,
    reduced=reduced_from(CONFIG),
    sharding_mode="gossip-dp",
    skip_shapes=("long_500k",),
    skip_reason="full-attention encoder-decoder speech model; 512k-token "
                "decode out of scope for the family (DESIGN.md section 4)",
)
