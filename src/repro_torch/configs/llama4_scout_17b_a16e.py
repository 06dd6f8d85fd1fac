"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert.

[hf meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 per expert, vocab=202048.  Every layer MoE with one
always-on shared expert; text backbone only (early-fusion image encoder
out of scope for the LM shape set).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    d_expert=8192,
    n_shared_experts=1,
    d_shared_expert=8192,
    rope_theta=5e5,
)
