"""Architecture registry of the port: the configs it serves.

The dense GQA family (qwen2-1.5b) and DeepSeek's MLA + MoE family
(deepseek-v3-671b) are ported; the other architectures of the reference
registry arrive with their block families (ROADMAP D6).
"""

from .base import ModelConfig
from . import deepseek_v3_671b, qwen2_1_5b

CONFIGS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                   for m in (qwen2_1_5b, deepseek_v3_671b)}


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port serves: "
                       f"{sorted(CONFIGS)}") from None


__all__ = ["ModelConfig", "CONFIGS", "get_config"]
