"""deepseek-r1-distill-qwen-32b — the paper's distilled 32B (Qwen2.5-32B).

[arXiv:2501.12948; hf deepseek-ai/DeepSeek-R1-Distill-Qwen-32B]
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-r1-distill-qwen-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)
