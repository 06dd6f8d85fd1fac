"""Architecture registry of the port: the configs it serves.

Only the dense GQA family is ported so far; the other architectures of the
reference registry arrive with their block families (ROADMAP D2, D6).
"""

from .base import ModelConfig
from . import qwen2_1_5b

CONFIGS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                   for m in (qwen2_1_5b,)}


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port serves: "
                       f"{sorted(CONFIGS)}") from None


__all__ = ["ModelConfig", "CONFIGS", "get_config"]
