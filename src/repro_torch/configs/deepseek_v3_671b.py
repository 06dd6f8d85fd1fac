"""deepseek-v3-671b — the paper's own model: MLA + fine-grained MoE.

[arXiv:2412.19437]  61L d_model=7168, MLA (q_lora 1536, kv_lora 512,
qk_nope 128 + qk_rope 64, v 128, 128 heads), first 3 layers dense FFN
(18432), then MoE: 256 routed experts top-8 (d_expert 2048) + 1 shared
expert, vocab=129280.  671B total / ~37B active.  The multi-token
prediction head is not modelled.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,                  # dense layers 0-2
    vocab_size=129280,
    n_experts=256,
    top_k=8,
    d_expert=2048,
    n_shared_experts=1,
    d_shared_expert=2048,
    first_dense_layers=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
)
