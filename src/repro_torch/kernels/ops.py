"""Quantized-weight ops: ``qmatmul`` dispatch and ``qgather_columns``.

``qmatmul(x, qt)`` computes ``x @ dequant(qt)`` through kernel B1, which
takes every packed format (q4_k, q6_k, q3_k, q5_k, q2_k, q8_0), for one
(K, N) weight or a stack of expert weights (E, K, N) against x (E, C, K);
the wrapper picks the CUDA kernel or its plain version by the tensors'
device.
"""

from __future__ import annotations

import torch

from ..core.qtensor import QTensor
from .qmatmul import EXPERT_KERNELS, KERNELS


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x: (..., K) -> (..., N), or (E, ..., K) -> (E, ..., N) for expert
    weights, in ``x.dtype``."""
    if qt.fmt not in KERNELS:
        raise ValueError(f"qmatmul takes packed weights, not {qt.fmt!r}")
    if len(qt.shape) == 2:
        return KERNELS[qt.fmt](x, qt)
    if len(qt.shape) == 3:
        return EXPERT_KERNELS[qt.fmt](x, qt)
    raise ValueError(f"qmatmul takes (K, N) or (E, K, N) weights, got "
                     f"{qt.shape}")


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
