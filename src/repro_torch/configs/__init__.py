"""Architecture registry: the 10 assigned configs, copied from
``repro.configs`` with the port's ``ModelConfig`` (dtype a torch dtype);
``reduced_from`` and ``SHAPES`` are the reference's."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import SHAPES, ArchConfig, InputShape

from repro_torch.configs import (
    granite_moe_1b_a400m,
    llama_3_2_vision_90b,
    qwen3_1_7b,
    qwen3_8b,
    gemma3_4b,
    seamless_m4t_medium,
    falcon_mamba_7b,
    jamba_1_5_large_398b,
    deepseek_coder_33b,
    phi3_5_moe_42b_a6_6b,
)

_MODULES = [
    granite_moe_1b_a400m,
    llama_3_2_vision_90b,
    qwen3_1_7b,
    qwen3_8b,
    gemma3_4b,
    seamless_m4t_medium,
    falcon_mamba_7b,
    jamba_1_5_large_398b,
    deepseek_coder_33b,
    phi3_5_moe_42b_a6_6b,
]

REGISTRY: Dict[str, ArchConfig] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}


def get_arch(arch_id: str) -> ArchConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; options: {sorted(REGISTRY)}"
        ) from None


def list_archs() -> List[str]:
    return sorted(REGISTRY)


__all__ = ["SHAPES", "ArchConfig", "InputShape", "REGISTRY", "get_arch", "list_archs"]
