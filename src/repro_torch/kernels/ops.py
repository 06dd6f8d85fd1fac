"""Quantized-weight ops: ``qmatmul`` dispatch and ``qgather_columns``.

``qmatmul(x, qt)`` computes ``x @ dequant(qt)`` through kernel B1 for the
formats that have one (q4_k, q6_k); the wrapper picks the CUDA kernel or
its plain version by the tensors' device.  Weights with a leading expert
dim are not on the ported path.
"""

from __future__ import annotations

import torch

from ..core.qtensor import QTensor
from .qmatmul import KERNELS


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x: (..., K) -> (..., N) in ``x.dtype``."""
    if qt.shape[:-2]:
        raise NotImplementedError(
            "batched (expert) weights are not ported yet "
            "(ROADMAP D2, DeepSeek MLA + MoE)")
    if qt.fmt not in KERNELS:
        raise NotImplementedError(
            f"no kernel for {qt.fmt!r} weights yet (ROADMAP D4, kernel B8: the "
            "remaining formats' kernels)")
    return KERNELS[qt.fmt](x, qt)


def qgather_columns(qt: QTensor, idx: torch.Tensor) -> torch.Tensor:
    """Dequantize only columns ``idx`` of a (K, N) QTensor -> (K, *idx.shape).

    Embedding lookup: every packed field carries N last, so gathering the
    tokens' columns before dequantizing never materialises the full
    embedding matrix in floating point.
    """
    flat = idx.reshape(-1)
    fields = {k: v.index_select(-1, flat) for k, v in qt.fields.items()}
    sub = QTensor(fields, qt.fmt, qt.shape[:-1] + (flat.shape[0],))
    w = sub.dequantize(torch.float32)                    # (K, n_idx)
    return w.reshape(qt.shape[-2], *idx.shape)
