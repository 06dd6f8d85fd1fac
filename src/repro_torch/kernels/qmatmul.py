"""Kernel B1: fused K-quant dequant-matmul ``y = x @ dequant(W)``.

Replaces the Pallas TPU kernel ``repro/kernels/common.py::build_qmatmul``
(body :119-131) for ``q4_k`` and ``q6_k``.  The CUDA kernel is
``csrc/qmatmul.cu`` (its header says what bounds it on an H100 and how the
design answers that); :func:`qmatmul_plain` is its plain PyTorch version —
dequantize to f32, then an f32 matmul.

Dispatch is by device only: :func:`qmatmul_q4_k` / :func:`qmatmul_q6_k`
run the plain version for CPU tensors and launch the kernel (or raise) for
CUDA tensors.  Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.qtensor import QTensor
from . import build

# fields in the order the C entry point takes them
FIELDS = {"q4_k": ("qs", "scales", "mins", "d", "dmin"),
          "q6_k": ("ql", "qh", "scales", "d")}
_FMT_ID = {"q4_k": 0, "q6_k": 1}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
_COLS = 128          # output columns per thread block (csrc/qmatmul.cu)
_ROWS = {True: 4, False: 16}   # row tile: M <= 4, else 16


def qmatmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ dequant(qt) (K, N): f32 dequantize, f32 matmul, output
    in ``x.dtype`` — the same function as the kernel."""
    w = qt.dequantize(torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _splits(device: torch.device, n: int, row_tiles: int, s: int) -> int:
    """Superblock splits so that the grid has ~2 blocks per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-2 * sms // (-(-n // _COLS) * row_tiles))
    return max(1, min(s, want))


def _field_ptrs(qt: QTensor, device: torch.device) -> list:
    """The C entry point's field pointers, padded to five."""
    ptrs = []
    for name in FIELDS[qt.fmt]:
        f = qt.fields[name]
        if f.device != device or not f.is_contiguous() or f.data_ptr() % 16:
            raise ValueError("B1 fields must be contiguous, 16-byte "
                             "aligned and on x's device")
        ptrs.append(f.data_ptr())
    return ptrs + [None] * (5 - len(ptrs))


def _qmatmul(x: torch.Tensor, qt: QTensor, fmt: str) -> torch.Tensor:
    """``x @ dequant(qt)`` for an unbatched weight of format ``fmt``.

    CPU tensors take :func:`qmatmul_plain`; CUDA tensors launch
    ``csrc/qmatmul.cu`` on the current stream (and count the launch on the
    format's wrapper).
    """
    if qt.fmt != fmt:
        raise ValueError(f"qmatmul_{fmt} got a {qt.fmt!r} weight")
    if len(qt.shape) != 2:
        raise ValueError(f"B1 takes unbatched (K, N) weights, got {qt.shape}")
    k, n = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not contract with {qt}")
    dev = x.device
    if dev.type == "cpu":
        return qmatmul_plain(x, qt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x.dtype not in _DTYPE_ID:
        raise TypeError(f"B1 takes float32 or bfloat16 x, got {x.dtype}")
    if n % 4:
        raise ValueError(f"B1 needs N % 4 == 0, got N={n}")
    ptrs = _field_ptrs(qt, dev)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return out.reshape(*lead, n)
    splits = _splits(dev, n, -(-m // _ROWS[m <= 4]), qt.num_superblocks)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    err = _entry()(_FMT_ID[fmt], _DTYPE_ID[x.dtype], x2.data_ptr(), *ptrs,
                   build.ptr(partial), out.data_ptr(), m, k, n, splits,
                   build.stream_ptr(dev))
    KERNELS[fmt].launches += 1
    build.check(err, f"qmatmul_{fmt}")
    return out.reshape(*lead, n)


def qmatmul_q4_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for q4_k weights (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q4_k")


def qmatmul_q6_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for q6_k weights (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q6_k")


qmatmul_q4_k.launches = 0
qmatmul_q6_k.launches = 0
KERNELS = {"q4_k": qmatmul_q4_k, "q6_k": qmatmul_q6_k}


@functools.lru_cache(maxsize=None)
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.bind("qmatmul", "qmatmul",
                      [i, i, v, v, v, v, v, v, v, v, i, i, i, i, v])
