"""K-quant block formats (llama.cpp family) in plain PyTorch.

A copy, op for op, of the reference's ``repro.core.formats``: quantize and
dequantize are bitwise equal to it (``tests/test_torch_formats.py``).  Every
format quantizes a weight ``W`` of logical shape ``(K, N)`` in superblocks
along the contraction dimension ``K``; each field is stored
structure-of-arrays as ``(..., S, X, N)`` with ``S = ceil(K / block)`` and
the per-superblock count ``X`` (scalar-per-superblock fields are
``(..., S, N)``).  The 6-bit scale fields of q3_k/q4_k/q5_k are kept as
8-bit arrays, as in the reference (not GGUF's 12-byte packing).

Packing order (element index ``i`` within a 256-superblock):

  * 4-bit (q4_k, q5_k low bits, q6_k low bits): byte ``k`` in ``0..127``
    holds element ``k`` in its low nibble and ``k + 128`` in its high one.
  * 2-bit (q2_k, q3_k low bits, q6_k high bits): byte ``k`` holds elements
    ``k + 64*p`` in bit-pair ``p`` (p = 0..3).
  * 1-bit (q3_k high bit, q5_k high bit): byte ``k`` in ``0..31`` holds the
    high bit of element ``k + 32*b`` in bit ``b``.

Numerics that bitwise equality depends on: rounding is half away from zero
(:func:`_rnd`, not ``torch.round``); reciprocals are taken once and then
multiplied (:func:`_safe_inv`, never a division); the quants are computed
from the f32 ``d``/``dmin`` before the f16 cast that is stored; the
symmetric formats take the first arg-max of ``|x|``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

QK_K = 256  # superblock size for the K-quant family
QK8_0 = 32  # block size for q8_0

_F16 = torch.float16
_U8 = torch.uint8
_I8 = torch.int8
_F32 = torch.float32


# ---------------------------------------------------------------------------
# bit packing helpers (element-order preserving, see module docstring)
# ---------------------------------------------------------------------------

def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(..., 2*H, N) uint8 values in [0,16) -> (..., H, N) packed bytes."""
    h = q.shape[-2] // 2
    return (q[..., :h, :] | (q[..., h:, :] << 4)).to(_U8)


def unpack_nibbles(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`."""
    return torch.cat([b & 0x0F, (b >> 4) & 0x0F], dim=-2)


def pack_2bit(q: torch.Tensor) -> torch.Tensor:
    """(..., 4*H, N) uint8 values in [0,4) -> (..., H, N) packed bytes."""
    h = q.shape[-2] // 4
    out = q[..., :h, :]
    for p in range(1, 4):
        out = out | (q[..., p * h:(p + 1) * h, :] << (2 * p))
    return out.to(_U8)


def unpack_2bit(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([(b >> (2 * p)) & 0x03 for p in range(4)], dim=-2)


def pack_1bit(q: torch.Tensor) -> torch.Tensor:
    """(..., 8*H, N) uint8 values in [0,2) -> (..., H, N) packed bytes."""
    h = q.shape[-2] // 8
    out = q[..., :h, :]
    for p in range(1, 8):
        out = out | (q[..., p * h:(p + 1) * h, :] << p)
    return out.to(_U8)


def unpack_1bit(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([(b >> p) & 0x01 for p in range(8)], dim=-2)


def _rnd(x: torch.Tensor) -> torch.Tensor:
    """Round-half-away-from-zero, llama.cpp's nearest_int behaviour."""
    half = torch.full_like(x, 0.5)
    return torch.trunc(x + torch.where(x >= 0, half, -half))


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    nz = x != 0
    return torch.where(nz, 1.0 / torch.where(nz, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def _expand_sub(s: torch.Tensor, sub: int) -> torch.Tensor:
    """(..., S, nsub, N) per-sub-block value -> (..., S, nsub*sub, N)."""
    return torch.repeat_interleave(s, sub, dim=-2)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(_F32)


# ---------------------------------------------------------------------------
# format definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockFormat:
    """One quantization format.

    ``quantize`` maps fp blocks ``(..., S, B, N)`` to a dict of field
    tensors; ``dequantize`` inverts it (up to quantization error).
    ``gguf_bits`` is the exact GGUF bits-per-weight (Table-1 accounting);
    ``tpu_bits`` is the bits-per-weight of the structure-of-arrays layout
    both packages store (8-bit scale fields).
    """

    name: str
    block: int
    gguf_bits: float
    tpu_bits: float
    quantize: Callable[[torch.Tensor], dict[str, torch.Tensor]]
    dequantize: Callable[[dict[str, torch.Tensor]], torch.Tensor]


# -- q8_0 -------------------------------------------------------------------

def _q8_0_quantize(w):  # (..., S, 32, N)
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    d = amax / 127.0
    q = torch.clamp(_rnd(w * _safe_inv(d)), -127, 127).to(_I8)
    return {"qs": q, "d": d.squeeze(-2).to(_F16)}


def _q8_0_dequantize(f):
    return _f32(f["qs"]) * _f32(f["d"])[..., None, :]


# -- asymmetric family (q2_k, q4_k, q5_k) -----------------------------------

def _minmax_scales(w, sub, qmax, smax):
    """Asymmetric per-sub-block quantization: ``x ~= d*sc*q - dmin*m``."""
    *lead, s, b, n = w.shape
    wb = w.reshape(*lead, s, b // sub, sub, n)
    wmax = torch.amax(wb, dim=-2)                    # (..., S, nsub, N)
    wmin = torch.amin(wb, dim=-2)
    wmin = torch.minimum(wmin, torch.zeros_like(wmin))   # llama.cpp: min <= 0
    wmax = torch.maximum(wmax, wmin)                 # degenerate guard
    scale = (wmax - wmin) / qmax
    mins = -wmin
    d = torch.amax(scale, dim=-2, keepdim=True) / smax      # (..., S, 1, N)
    dmin = torch.amax(mins, dim=-2, keepdim=True) / smax
    sc = torch.clamp(_rnd(scale * _safe_inv(d)), 0, smax)
    m = torch.clamp(_rnd(mins * _safe_inv(dmin)), 0, smax)
    return d.squeeze(-2), dmin.squeeze(-2), sc, m


def _asym_quants(w, sub, d, dmin, sc, m, qmax):
    eff_scale_e = _expand_sub(d[..., None, :] * sc, sub)
    eff_min_e = _expand_sub(dmin[..., None, :] * m, sub)
    q = torch.clamp(_rnd((w + eff_min_e) * _safe_inv(eff_scale_e)), 0, qmax)
    return q.to(_U8)


def _asym_dequant(q, sub, d, dmin, sc, m):
    eff_scale = _expand_sub(d[..., None, :] * sc, sub)
    eff_min = _expand_sub(dmin[..., None, :] * m, sub)
    return _f32(q) * eff_scale - eff_min


def _q4_k_quantize(w):  # (..., S, 256, N)
    w = _f32(w)
    d, dmin, sc, m = _minmax_scales(w, 32, 15, 63)
    q = _asym_quants(w, 32, d, dmin, sc, m, 15)
    return {"qs": pack_nibbles(q), "scales": sc.to(_U8), "mins": m.to(_U8),
            "d": d.to(_F16), "dmin": dmin.to(_F16)}


def _q4_k_dequantize(f):
    return _asym_dequant(unpack_nibbles(f["qs"]), 32, _f32(f["d"]),
                         _f32(f["dmin"]), _f32(f["scales"]), _f32(f["mins"]))


def _q5_k_quantize(w):
    w = _f32(w)
    d, dmin, sc, m = _minmax_scales(w, 32, 31, 63)
    q = _asym_quants(w, 32, d, dmin, sc, m, 31)
    return {"qs": pack_nibbles(q & 0x0F), "qh": pack_1bit((q >> 4) & 0x01),
            "scales": sc.to(_U8), "mins": m.to(_U8),
            "d": d.to(_F16), "dmin": dmin.to(_F16)}


def _q5_k_dequantize(f):
    q = unpack_nibbles(f["qs"]) | (unpack_1bit(f["qh"]) << 4)
    return _asym_dequant(q, 32, _f32(f["d"]), _f32(f["dmin"]),
                         _f32(f["scales"]), _f32(f["mins"]))


def _q2_k_quantize(w):
    w = _f32(w)
    d, dmin, sc, m = _minmax_scales(w, 16, 3, 15)
    q = _asym_quants(w, 16, d, dmin, sc, m, 3)
    # GGUF-exact nibble packing of (scale, min): low nibble scale
    sm = sc.to(_U8) | (m.to(_U8) << 4)
    return {"qs": pack_2bit(q), "sm": sm, "d": d.to(_F16),
            "dmin": dmin.to(_F16)}


def _q2_k_dequantize(f):
    q = unpack_2bit(f["qs"])
    sc = _f32(f["sm"] & 0x0F)
    m = _f32((f["sm"] >> 4) & 0x0F)
    return _asym_dequant(q, 16, _f32(f["d"]), _f32(f["dmin"]), sc, m)


# -- symmetric family (q3_k, q6_k) -------------------------------------------

def _sym_scales(w, sub, qabs, sabs):
    """Symmetric per-sub-block quantization: ``x ~= d * sc * q``."""
    *lead, s, b, n = w.shape
    wb = w.reshape(*lead, s, b // sub, sub, n)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    amax_idx = torch.argmax(torch.abs(wb), dim=-2, keepdim=True)
    wmax = torch.gather(wb, -2, amax_idx).squeeze(-2)
    # llama.cpp make_qx_quants: the scale carries the sign of the max-|x|
    # element so that element maps to -qabs-1
    scale = wmax / (-(qabs + 1))
    d = torch.amax(torch.abs(scale), dim=-2, keepdim=True) / sabs
    sc = torch.clamp(_rnd(scale * _safe_inv(d)), -(sabs + 1), sabs)
    return d.squeeze(-2), sc


def _sym_quants(w, sub, d, sc, qabs):
    eff = _expand_sub(d[..., None, :] * sc, sub)
    q = torch.clamp(_rnd(w * _safe_inv(eff)), -(qabs + 1), qabs)
    return q.to(torch.int32)


def _sym_dequant(q, sub, d, sc):
    return _f32(q) * _expand_sub(d[..., None, :] * sc, sub)


def _q3_k_quantize(w):
    w = _f32(w)
    d, sc = _sym_scales(w, 16, 3, 31)
    q = _sym_quants(w, 16, d, sc, 3) + 4                 # [0, 7]
    return {"qs": pack_2bit((q & 0x03).to(_U8)),
            "hmask": pack_1bit(((q >> 2) & 0x01).to(_U8)),
            "scales": sc.to(_I8), "d": d.to(_F16)}


def _q3_k_dequantize(f):
    q = (unpack_2bit(f["qs"]) | (unpack_1bit(f["hmask"]) << 2)).to(
        torch.int32) - 4
    return _sym_dequant(q, 16, _f32(f["d"]), _f32(f["scales"]))


def _q6_k_quantize(w):
    w = _f32(w)
    d, sc = _sym_scales(w, 16, 31, 127)
    q = _sym_quants(w, 16, d, sc, 31) + 32               # [0, 63]
    return {"ql": pack_nibbles((q & 0x0F).to(_U8)),
            "qh": pack_2bit(((q >> 4) & 0x03).to(_U8)),
            "scales": sc.to(_I8), "d": d.to(_F16)}


def _q6_k_dequantize(f):
    q = (unpack_nibbles(f["ql"]) | (unpack_2bit(f["qh"]) << 4)).to(
        torch.int32) - 32
    return _sym_dequant(q, 16, _f32(f["d"]), _f32(f["scales"]))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _bits(gguf_bytes: int, block: int) -> float:
    return gguf_bytes * 8.0 / block


FORMATS: dict[str, BlockFormat] = {
    "q8_0": BlockFormat("q8_0", QK8_0, _bits(34, 32), _bits(34, 32),
                        _q8_0_quantize, _q8_0_dequantize),
    "q6_k": BlockFormat("q6_k", QK_K, _bits(210, 256), _bits(210, 256),
                        _q6_k_quantize, _q6_k_dequantize),
    "q5_k": BlockFormat("q5_k", QK_K, _bits(176, 256), _bits(180, 256),
                        _q5_k_quantize, _q5_k_dequantize),
    "q4_k": BlockFormat("q4_k", QK_K, _bits(144, 256), _bits(148, 256),
                        _q4_k_quantize, _q4_k_dequantize),
    "q3_k": BlockFormat("q3_k", QK_K, _bits(110, 256), _bits(114, 256),
                        _q3_k_quantize, _q3_k_dequantize),
    "q2_k": BlockFormat("q2_k", QK_K, _bits(84, 256), _bits(84, 256),
                        _q2_k_quantize, _q2_k_dequantize),
}

# Unquantized formats participate in policies/size accounting.
FLOAT_BITS = {"f32": 32.0, "bf16": 16.0, "f16": 16.0, "f8": 8.0}
