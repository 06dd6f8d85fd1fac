"""Carry parameters into the port: from the reference's numpy-exported tree,
and between devices.

``from_jax_params(tree)`` takes the reference's flat parameter dict with
every leaf already converted to numpy — a floating-point array, or a
quantized weight as ``{"fmt": str, "shape": tuple, "fields": {name:
ndarray}}`` — and returns the port's parameters (tensors and
:class:`~repro_torch.core.qtensor.QTensor`s) on ``device``.  The field
layouts are the same in both packages, so nothing is repacked.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.qtensor import QTensor


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:             # arrays exported by JAX are not
        a = a.copy()
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16 (from JAX)
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(tree: dict[str, Any], device="cpu") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for path, leaf in tree.items():
        if isinstance(leaf, dict):
            fields = {k: _tensor(v, device) for k, v in leaf["fields"].items()}
            out[path] = QTensor(fields, leaf["fmt"], tuple(leaf["shape"]))
        else:
            out[path] = _tensor(leaf, device)
    return out


def tree_to(params: dict[str, Any], device) -> dict[str, Any]:
    """Move every tensor / QTensor leaf to ``device`` (no copy when it is
    already there)."""
    return {k: v.to(device) for k, v in params.items()}
