"""Kernel B1: fused K-quant dequant-matmul ``y = x @ dequant(W)``.

Replaces the Pallas TPU kernel ``repro/kernels/common.py::build_qmatmul``
(body :119-131) for ``q4_k``, ``q6_k`` and ``q3_k``, and the reference's
XLA path for expert-batched weights (``repro/kernels/ops.py:39-50``).  The
CUDA kernel is ``csrc/qmatmul.cu`` (its header says what bounds it on an
H100 and how the design answers that); :func:`qmatmul_plain` is its plain
PyTorch version — dequantize to f32, then an f32 matmul.

Dispatch is by device only: each wrapper runs the plain version for CPU
tensors and launches the kernel (or raises) for CUDA tensors.  Each
wrapper's ``launches`` counts its kernel launches: ``qmatmul_<fmt>`` for
one (K, N) weight, ``qmatmul_experts_<fmt>`` for a stack of expert weights
(E, K, N) against x (E, C, K), all experts in one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.qtensor import QTensor
from . import build

# fields in the order the C entry point takes them
FIELDS = {"q4_k": ("qs", "scales", "mins", "d", "dmin"),
          "q6_k": ("ql", "qh", "scales", "d"),
          "q3_k": ("qs", "hmask", "scales", "d")}
_FMT_ID = {"q4_k": 0, "q6_k": 1, "q3_k": 2}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
_COLS = 128          # output columns per thread block (csrc/qmatmul.cu)
_ROWS = {True: 4, False: 16}   # row tile: M <= 4, else 16
_MAX_GRID_Z = 65535


def expert(qt: QTensor, e: int) -> QTensor:
    """Expert ``e`` of an (E, K, N) weight, as a (K, N) QTensor (views)."""
    return QTensor({k: v[e] for k, v in qt.fields.items()}, qt.fmt,
                   qt.shape[1:])


def qmatmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ dequant(qt) (K, N), or x (E, ..., K) against expert
    weights (E, K, N): f32 dequantize, f32 matmul, output in ``x.dtype`` —
    the same function as the kernel.  Expert weights are dequantized one
    expert at a time, and an expert whose rows of x are all zero (an
    expert no token was routed to) gives zeros without being read."""
    if len(qt.shape) == 2:
        w = qt.dequantize(torch.float32)
        return torch.matmul(x.to(torch.float32), w).to(x.dtype)
    out = torch.zeros((*x.shape[:-1], qt.shape[-1]), dtype=x.dtype,
                      device=x.device)
    used = x.reshape(x.shape[0], -1).any(dim=1).tolist()
    for e in (e for e, u in enumerate(used) if u):
        out[e] = qmatmul_plain(x[e], expert(qt, e))
    return out


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


def _launch(x: torch.Tensor, qt: QTensor, e: int, counter) -> torch.Tensor:
    """Launch ``csrc/qmatmul.cu`` on the current stream: x (e, m, k) in,
    (e, m, n) out; ``e == 1`` is one (K, N) weight."""
    dev = x.device
    k, n = qt.shape[-2:]
    if x.dtype not in _DTYPE_ID:
        raise TypeError(f"B1 takes float32 or bfloat16 x, got {x.dtype}")
    if n % 4:
        raise ValueError(f"B1 needs N % 4 == 0, got N={n}")
    ptrs = _field_ptrs(qt, dev)
    x3 = x.reshape(e, -1, k).contiguous()
    m = x3.shape[1]
    out = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    row_tiles = -(-m // _ROWS[m <= 4])
    if row_tiles * e > _MAX_GRID_Z:
        raise ValueError(f"B1 grid too tall: {e} experts x {row_tiles} row "
                         "tiles")
    splits = (_splits(dev, n, row_tiles, qt.num_superblocks) if e == 1
              else 1)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    err = _entry()(_FMT_ID[qt.fmt], _DTYPE_ID[x.dtype], x3.data_ptr(), *ptrs,
                   build.ptr(partial), out.data_ptr(), e, m, k, n, splits,
                   build.stream_ptr(dev))
    counter.launches += 1
    build.check(err, counter.__name__)
    return out


def _check(x: torch.Tensor, qt: QTensor, fmt: str, ndim: int) -> None:
    if qt.fmt != fmt:
        raise ValueError(f"B1 for {fmt} got a {qt.fmt!r} weight")
    if len(qt.shape) != ndim:
        raise ValueError(f"expected a {ndim}-d weight, got {qt.shape}")
    if x.shape[-1] != qt.shape[-2] or (ndim == 3 and x.shape[0] !=
                                       qt.shape[0]):
        raise ValueError(f"x {tuple(x.shape)} does not contract with {qt}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _qmatmul(x: torch.Tensor, qt: QTensor, fmt: str,
             experts: bool) -> torch.Tensor:
    """``x (..., K) @ dequant(qt) (K, N)`` for one weight of format
    ``fmt``, or ``x (E, ..., K)`` against expert weights ``qt (E, K, N)``
    -> ``(E, ..., N)`` with all experts in one launch.  CPU tensors take
    :func:`qmatmul_plain`; CUDA tensors launch the kernel (counted on the
    format's wrapper of that form)."""
    _check(x, qt, fmt, 3 if experts else 2)
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt)
    out = (_launch(x, qt, qt.shape[0], EXPERT_KERNELS[fmt]) if experts
           else _launch(x, qt, 1, KERNELS[fmt]))
    return out.reshape(*x.shape[:-1], qt.shape[-1])


def qmatmul_q4_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for one q4_k weight (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q4_k", experts=False)


def qmatmul_q6_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for one q6_k weight (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q6_k", experts=False)


def qmatmul_q3_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for one q3_k weight (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q3_k", experts=False)


def qmatmul_experts_q4_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for q4_k expert weights (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q4_k", experts=True)


def qmatmul_experts_q6_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for q6_k expert weights (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q6_k", experts=True)


def qmatmul_experts_q3_k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """B1 for q3_k expert weights (see :func:`_qmatmul`)."""
    return _qmatmul(x, qt, "q3_k", experts=True)


KERNELS = {"q4_k": qmatmul_q4_k, "q6_k": qmatmul_q6_k, "q3_k": qmatmul_q3_k}
EXPERT_KERNELS = {"q4_k": qmatmul_experts_q4_k, "q6_k": qmatmul_experts_q6_k,
                  "q3_k": qmatmul_experts_q3_k}
for _fn in (*KERNELS.values(), *EXPERT_KERNELS.values()):
    _fn.launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.bind("qmatmul", "qmatmul",
                      [i, i, v, v, v, v, v, v, v, v, i, i, i, i, i, v])
