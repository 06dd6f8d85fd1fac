"""Apply a quantization policy to a model's parameter tree (PTQ step).

``quantize_params`` maps each quantizable weight to a packed QTensor using
the policy's per-role / per-layer format; float-role weights (norms,
biases) pass through in the policy's float format.  Quantization runs on
the device the weights live on (the card, at full width).
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models import spec as mspec
from .formats import FLOAT_BITS
from .policy import Policy
from .qtensor import quantize

_FLOAT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "f16": torch.float16, "f8": torch.bfloat16}


def format_map(cfg: ModelConfig, policy: Policy) -> dict[str, str]:
    """path -> format name for every weight."""
    specs = mspec.model_specs(cfg)
    tables = mspec.role_layer_tables(specs)
    return {path: mspec.resolve_format(s, policy, tables)
            for path, s in specs.items()}


def quantize_params(cfg: ModelConfig, params: dict[str, torch.Tensor],
                    policy: Policy) -> dict[str, Any]:
    fmap = format_map(cfg, policy)
    out: dict[str, Any] = {}
    for path, w in params.items():
        fmt = fmap[path]
        if fmt in FLOAT_BITS:
            out[path] = w.to(_FLOAT_DTYPES[fmt])
        else:
            out[path] = quantize(w, fmt)
    return out
