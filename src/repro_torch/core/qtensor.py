"""QTensor: one K-quant-packed weight matrix as a set of field tensors.

The logical tensor is ``(..., K, N)``; blocks run along ``K`` (the
contraction dim of ``y = x @ W``), which is zero-padded up to a multiple of
the format's superblock.  Field layouts are the reference's ``(S, X, N)``,
so a reference QTensor converts field by field with no repacking
(``repro_torch.convert``).
"""

from __future__ import annotations

import torch

from .formats import FORMATS, BlockFormat


class QTensor:
    """Packed fields (``name -> tensor``), the format name and the logical
    ``(..., K, N)`` shape."""

    __slots__ = ("fields", "fmt", "shape")

    def __init__(self, fields: dict[str, torch.Tensor], fmt: str,
                 shape: tuple[int, ...]):
        self.fields = fields
        self.fmt = fmt
        self.shape = tuple(int(s) for s in shape)

    def __repr__(self) -> str:
        return f"QTensor({self.fmt}, shape={self.shape})"

    @property
    def format(self) -> BlockFormat:
        return FORMATS[self.fmt]

    @property
    def device(self) -> torch.device:
        return next(iter(self.fields.values())).device

    @property
    def num_superblocks(self) -> int:
        blk = self.format.block
        return (self.shape[-2] + blk - 1) // blk

    def packed_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.fields.values())

    def to(self, device) -> "QTensor":
        return QTensor({k: v.to(device) for k, v in self.fields.items()},
                       self.fmt, self.shape)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        w = self.format.dequantize(self.fields)          # (..., S, B, N)
        *lead, s, b, n = w.shape
        w = w.reshape(*lead, s * b, n)[..., : self.shape[-2], :]
        return w.to(dtype)


def _pad_blocks(w: torch.Tensor, block: int) -> torch.Tensor:
    k = w.shape[-2]
    pad = (-k) % block
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    *lead, kp, n = w.shape
    return w.reshape(*lead, kp // block, block, n)


def quantize(w: torch.Tensor, fmt: str) -> QTensor:
    """Quantize ``w`` of shape (..., K, N) into packed fields (on ``w``'s
    device)."""
    f = FORMATS[fmt]
    fields = f.quantize(_pad_blocks(w, f.block))
    return QTensor(fields, fmt, tuple(w.shape))
