"""Architecture registry of the port: the configs it serves.

Every full-attention decoder of the reference registry: the dense GQA
models qwen2-1.5b, qwen2-72b, phi3-mini-3.8b (MHA, head_dim 96) and the
paper's deepseek-r1-distill-qwen-32b; GQA beside routed experts,
llama4-scout-17b-a16e; and DeepSeek's MLA + MoE, deepseek-v3-671b.  The
other architectures of the reference registry arrive with their block
families (ROADMAP D6).
"""

from .base import ModelConfig
from . import (deepseek_r1_distill_qwen_32b, deepseek_v3_671b,
               llama4_scout_17b_a16e, phi3_mini_3_8b, qwen2_1_5b, qwen2_72b)

CONFIGS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (
    qwen2_1_5b, qwen2_72b, phi3_mini_3_8b, deepseek_r1_distill_qwen_32b,
    llama4_scout_17b_a16e, deepseek_v3_671b)}


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port serves: "
                       f"{sorted(CONFIGS)}") from None


__all__ = ["ModelConfig", "CONFIGS", "get_config"]
