"""Analytic model-size / average-bit-width calculator (the paper's Table 1
and 6), the port's copy of the reference's ``repro.core.size``.

For (architecture x policy) it gives the exact quantized byte count per
module role, the average bits per weight ("Avg Quants" in Table 1) and
serving-memory estimates (weights + KV cache + auxiliary), allocating
nothing.  ``tpu_bytes`` counts the structure-of-arrays layout both
packages store (8-bit scale fields): the bytes of
``core.apply.init_quantized_params``' QTensor fields and float leaves.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from ..configs.base import ModelConfig
from ..models import spec as mspec
from .formats import FLOAT_BITS, FORMATS
from .policy import Policy

GIB = 1024 ** 3


@dataclasses.dataclass
class SizeReport:
    arch: str
    policy: str
    total_params: int
    gguf_bytes: int          # GGUF-exact accounting (the paper's Table 1)
    tpu_bytes: int           # the structure-of-arrays layout stored
    by_role: dict            # role -> (params, gguf_bytes)
    by_format: dict          # fmt -> params

    @property
    def avg_bits(self) -> float:
        return self.gguf_bytes * 8.0 / self.total_params

    @property
    def gib(self) -> float:
        return self.gguf_bytes / GIB

    @property
    def tpu_gib(self) -> float:
        return self.tpu_bytes / GIB


def _weight_bytes(s: mspec.WeightSpec, fmt: str, exact: bool) -> int:
    """Bytes of one weight under one format: quantized formats count whole
    superblocks along K (axis -2), as GGUF and the packed layout store it
    (K zero-padded to the block); float formats params x width."""
    if fmt in FLOAT_BITS:
        return int(s.num_params * FLOAT_BITS[fmt] // 8)
    f = FORMATS[fmt]
    *lead, k, n = s.shape
    nblocks = -(-k // f.block)
    lead_n = 1
    for x in lead:
        lead_n *= x
    bits = f.gguf_bits if exact else f.tpu_bits
    return int(round(lead_n * nblocks * n * f.block * bits / 8))


def model_size(cfg: ModelConfig, policy: Policy) -> SizeReport:
    specs = mspec.model_specs(cfg)
    tables = mspec.role_layer_tables(specs)
    by_role: dict[str, list[int]] = defaultdict(lambda: [0, 0])
    by_format: dict[str, int] = defaultdict(int)
    gguf = tpu = total = 0
    for s in specs.values():
        fmt = mspec.resolve_format(s, policy, tables)
        gb = _weight_bytes(s, fmt, exact=True)
        gguf += gb
        tpu += _weight_bytes(s, fmt, exact=False)
        total += s.num_params
        by_role[s.role][0] += s.num_params
        by_role[s.role][1] += gb
        by_format[fmt] += s.num_params
    return SizeReport(cfg.name, policy.name, total, gguf, tpu,
                      dict(by_role), dict(by_format))


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int,
                   dtype_bytes: int = 2, mla_compressed: bool = True) -> int:
    """Decode-cache bytes of the whole model (all layers, one replica).
    ``mla_compressed=False`` is llama.cpp's accounting for DeepSeek (full
    per-head K and V, what the paper's Table-1 "MU @32k" holds); the
    serving path stores the compressed MLA latent (~9x smaller)."""
    mspec.check_supported(cfg)
    if cfg.mla and mla_compressed:
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    elif cfg.mla:
        per_tok = cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                                 + cfg.v_head_dim)
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
    return cfg.n_layers * batch * seq * per_tok * dtype_bytes


def serving_memory(cfg: ModelConfig, policy: Policy, *, batch: int = 1,
                   context: int = 32768, n_devices: int = 8,
                   aux_gb: float = 4.0, mla_compressed: bool = False) -> dict:
    """The paper's MU accounting (Table 1/6): weights + KV + auxiliary.
    MU in decimal GB = GGUF weights + uncompressed KV at 32k + ~4 GB of
    runtime workspace reproduces Table 1's columns within a few GB."""
    GB = 1e9
    rep = model_size(cfg, policy)
    kv = kv_cache_bytes(cfg, batch, context, mla_compressed=mla_compressed)
    total = rep.gguf_bytes + kv + aux_gb * GB
    return {
        "weights_gib": rep.gib,
        "weights_gb": rep.gguf_bytes / GB,
        "kv_gb": kv / GB,
        "aux_gb": aux_gb,
        "total_gb": total / GB,
        "per_device_gb": total / GB / n_devices,
        "total_gib": total / GIB,
        "per_device_gib": total / GIB / n_devices,
        "avg_bits": rep.avg_bits,
    }
