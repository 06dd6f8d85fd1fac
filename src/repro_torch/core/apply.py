"""Apply a quantization policy to a model's parameter tree (PTQ step).

``quantize_params`` maps each quantizable weight to a packed QTensor using
the policy's per-role / per-layer format; float-role weights (norms,
biases) pass through in the policy's float format.  Quantization runs on
the device the weights live on (the card, at full width).

``init_quantized_params`` makes the seeded random weights and quantizes
each before the next one is made, expert weights a group of experts at a
time, so the card never holds the unquantized tree: a 7-layer DeepSeek-V3
cut is ~99 GB in bf16 but ~24 GB packed under DQ3_K_M.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models import spec as mspec
from .formats import FLOAT_BITS
from .policy import Policy
from .qtensor import QTensor, quantize

_FLOAT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "f16": torch.float16, "f8": torch.bfloat16}


def format_map(cfg: ModelConfig, policy: Policy) -> dict[str, str]:
    """path -> format name for every weight."""
    specs = mspec.model_specs(cfg)
    tables = mspec.role_layer_tables(specs)
    return {path: mspec.resolve_format(s, policy, tables)
            for path, s in specs.items()}


def _cast(w: torch.Tensor, fmt: str) -> torch.Tensor:
    return w.to(_FLOAT_DTYPES[fmt])


def quantize_params(cfg: ModelConfig, params: dict[str, torch.Tensor],
                    policy: Policy) -> dict[str, Any]:
    fmap = format_map(cfg, policy)
    out: dict[str, Any] = {}
    for path, w in params.items():
        fmt = fmap[path]
        if fmt in FLOAT_BITS:
            out[path] = _cast(w, fmt)
        else:
            out[path] = quantize(w, fmt)
    return out


def quantize_in_groups(make, n: int, fmt: str, group: int,
                       dim: int) -> QTensor:
    """Quantize a weight ``group`` slices at a time along ``dim``: 0 for
    the experts of (E, K, N), -1 for the columns of (K, N).  ``make(r)``
    returns the unquantized slices ``r``.  Blocks run along K inside one
    expert and every field carries N last, so the whole weight's fields
    are the groups' fields concatenated along ``dim``.  (The quantizers
    hold several f32 temporaries of their input's size: quantized whole,
    one 256-expert weight would need ~100 GB of them, the 7168 x 129280
    head ~25 GB.)"""
    parts = [quantize(make(range(i, min(i + group, n))), fmt)
             for i in range(0, n, group)]
    fields = {k: torch.cat([q.fields[k] for q in parts], dim=dim)
              for k in parts[0].fields}
    shape = list(parts[0].shape)
    shape[dim] = n
    return QTensor(fields, fmt, tuple(shape))


def init_quantized_params(cfg: ModelConfig, policy: Policy, seed: int = 0,
                          dtype=torch.bfloat16, device=None,
                          expert_group: int = 16,
                          column_group: int = 16384) -> dict[str, Any]:
    """``quantize_params(cfg, init_params(cfg, seed, dtype, device),
    policy)``, bitwise, without ever holding more than one unquantized
    weight on ``device``: expert weights are made and quantized
    ``expert_group`` experts at a time, the others quantized
    ``column_group`` columns at a time."""
    fmap = format_map(cfg, policy)
    out: dict[str, Any] = {}
    for path, s in sorted(mspec.model_specs(cfg).items()):
        fmt = fmap[path]
        if fmt in FLOAT_BITS:
            out[path] = _cast(mspec.make_weight(s, seed, dtype, device), fmt)
        elif len(s.shape) == 3:
            out[path] = quantize_in_groups(
                lambda r, s=s: mspec.make_weight(s, seed, dtype, device, r),
                s.shape[0], fmt, expert_group, dim=0)
        else:
            w = mspec.make_weight(s, seed, dtype, device)
            out[path] = quantize_in_groups(
                lambda r, w=w: w[:, r.start:r.stop], w.shape[1], fmt,
                column_group, dim=-1)
    return out
