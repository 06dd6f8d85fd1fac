"""Shared model primitives: quant-aware linear, embedding, norm, RoPE, FFN.

``linear`` accepts a plain weight tensor or a packed
:class:`~repro_torch.core.qtensor.QTensor`; quantized weights go through
``kernels.ops.qmatmul`` (kernel B1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.qtensor import QTensor
from ..kernels import ops


def linear(w, x: torch.Tensor, bias=None) -> torch.Tensor:
    """``y = x @ w (+ bias)`` for fp or quantized ``w``; output in x.dtype."""
    if isinstance(w, QTensor):
        y = ops.qmatmul(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def embed(w, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding -> (..., d_model); ``w`` is (d_model, vocab)."""
    if isinstance(w, QTensor):
        e = ops.qgather_columns(w, tokens)           # (d, *tokens.shape)
    else:
        e = w[:, tokens]
    return torch.movedim(e.to(dtype), 0, -1)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate (..., T, H, hd) at absolute ``positions`` (..., T) — the
    split-half convention."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def ffn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN from a param subview with gate/up/down."""
    return linear(p["down"], swiglu(linear(p["gate"], x), linear(p["up"], x)))
