"""ModelConfig: the architecture dataclass (a copy of the reference's).

The port keeps its own copy so that it imports nothing of ``repro``; the
fields, ``padded_vocab`` and ``reduced()`` are identical, so a config means
the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio | mla_moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    d_ff: int = 0
    head_dim: Optional[int] = None   # default: d_model // n_heads

    # --- block pattern ------------------------------------------------------
    block_pattern: tuple[str, ...] = ("attn",)
    window: int = 0                  # sliding-window size for local_attn
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False        # gemma-style sqrt(d_model) embed scaling

    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    d_shared_expert: int = 0
    first_dense_layers: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    # --- MLA (deepseek) -------------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- recurrent ------------------------------------------------------------
    lru_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.334

    # --- encoder-decoder --------------------------------------------------------
    encoder_layers: int = 0

    # --- modality frontend --------------------------------------------------------
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    frontend_dim: int = 0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so embedding/output shard cleanly."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def moe_layer(self, layer: int) -> bool:
        return self.is_moe and layer >= self.first_dense_layers

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        n_pat = len(self.block_pattern)
        n_layers = max(2, n_pat)
        if self.is_moe and self.first_dense_layers:
            n_layers = max(n_layers, self.first_dense_layers + 2)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=64,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            window=min(self.window, 64) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_expert=128 if self.d_expert else 0,
            d_shared_expert=128 if self.d_shared_expert else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            lru_width=256 if self.lru_width else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
            frontend_dim=64 if self.frontend_dim else 0,
            capacity_factor=8.0,
        )
