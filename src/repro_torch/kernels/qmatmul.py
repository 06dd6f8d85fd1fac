"""Kernel B1: fused K-quant dequant-matmul ``y = x @ dequant(W)``.

Replaces the Pallas TPU kernel ``repro/kernels/common.py::build_qmatmul``
(body :119-131) for every K-quant format and ``q8_0`` (``q4_k``, ``q6_k``,
``q3_k``, ``q5_k``, ``q2_k``, ``q8_0``), and the reference's XLA path for
expert-batched weights (``repro/kernels/ops.py:39-50``).  The
CUDA kernels are in ``csrc/qmatmul.cu`` (its header says what bounds each
on an H100 and how the design answers that); :func:`qmatmul_plain` is
their plain PyTorch version — dequantize to f32, then an f32 matmul.

Dispatch is by device only: each wrapper runs the plain version for CPU
tensors and launches a kernel (or raises) for CUDA tensors.  Each
wrapper's ``launches`` counts its kernel launches: ``qmatmul_<fmt>`` for
one (K, N) weight, ``qmatmul_experts_<fmt>`` for a stack of expert weights
(E, K, N) against x (E, C, K), all experts in one launch.  Every call is
one launch of one of three kernels (:func:`library_launches` says which):

- A stack of expert weights takes ``qmatmul_experts_kernel``: at C = 1 it
  carries one row, turns codes into floats with a byte permute instead of
  an int-to-float conversion, factors each sub-block's scale (q8_0: each
  block's d) out of its sum, brings the weight tiles into shared memory
  through a ring of asynchronous copies, and reads no weight byte of an
  expert whose rows of x are all zero (it writes +0, the plain version's
  result); at C > 1 it dequantizes each weight once to the plain
  version's value for 20 rows.

- One weight at M <= 4 rows (decode) takes its format's decode form
  (:func:`decode_form`).  q4_k's is ``qmatmul_q4k_decode_kernel``: the
  expert form's code conversion and factored scales with up to four rows
  of x.  Every other format's is ``qmatmul_mma_decode_kernel``, on tensor
  cores: one bf16 ``mma.sync.m16n8k16`` a 16-element piece of a superblock
  (q8_0: half a block) and 16 columns, its codes made exact bf16 values by
  byte permutes (q3_k's assembled from a bit-pair of qs and a bit of
  hmask, q5_k's from a nibble of qs and a bit of qh, q2_k's a bit-pair of
  qs, q8_0's int8 code as its low 7 bits and a bias chosen by its sign
  bit), x (bf16, or f32 as three bf16 terms) the other operand, each
  product scaled in f32 by its sub-block's scale (q8_0: each block's d);
  q2_k's min term, ``dmin * m * sum x`` a sub-block, takes the sums of x
  from the same operand fragments, q5_k's is taken by every thread in a
  layout of its own from x's staged rows.  In both kernels, where the
  column tiles alone would leave SMs idle, the stages of K split over the
  blocks of a thread-block cluster (:data:`DECODE_KSPLIT`) whose sums are
  added in rank order in the same launch: no partial buffer and no second
  kernel.

- One weight at M > 4 rows (every prefill chunk: 4 x 128 = 512 rows), or
  at K > 65536, takes ``qmatmul_prefill_kernel`` (:func:`prefill_form`),
  on tensor cores: a block owns 128 rows of x (64 where such tiles are
  few, :func:`prefill_rows`) and 128 columns, converts each stage's codes
  once into an exact bf16 tile in shared memory (byte permutes, no
  int-to-float), multiplies it with bf16 ``mma.sync.m16n8k16`` against
  bf16 x, and applies each sub-block's scale (q8_0: each block's d; q4_k,
  q5_k and q2_k also their min term, from x's sums per sub-block) in f32
  to the sub-block's products.  f32 x takes the plain version's
  dequantized weights and x as three bf16 terms each (six mmas a
  product), so that it differs from the plain version in summation order
  only.  Where the tiles are fewer than the SMs, the half superblocks
  split over a cluster (:func:`prefill_ksplit`) merged in rank order, in
  the same launch.
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
          "q3_k": ("qs", "hmask", "scales", "d"),
          "q5_k": ("qs", "qh", "scales", "mins", "d", "dmin"),
          "q2_k": ("qs", "sm", "d", "dmin"),
          "q8_0": ("qs", "d")}
_FMT_ID = {fmt: build.QMATMUL_FORMATS.index(fmt) for fmt in FIELDS}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
_COLS = 128          # output columns per thread block (csrc/qmatmul.cu)
_TILE = 256          # rows of K per tile: a superblock, or 8 q8_0 blocks
_XROWS = 20          # qmatmul_experts_kernel's row tile at C > 1 (C = 1: 1)
_MAX_GRID_Y = 65535
# qmatmul_q4k_decode_kernel: the rows of x it carries, the K it takes, the
# blocks of a cluster (the portable size) and the superblocks of a block
_DECODE_ROWS = 4
_DECODE_MAX_K = 65536
_MAX_KSPLIT = 8
_DECODE_MAX_SB = 32
_Q6_MAX_KSPLIT = 16   # the tensor-core decode form: a non-portable size
_GPC_SMS = 16         # SMs a GPC holds at least (an H100's: 16-18)
# qmatmul_prefill_kernel: rows of x a block, and the count of such tiles
# at or below which it takes 64-row tiles instead
_PF_ROWS = 128
_PF_FEW_TILES = 8


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



def decode_form(fmt: str, e: int, m: int, k: int) -> bool:
    """Whether a call takes its format's decode form
    (``qmatmul_q4k_decode_kernel``, or ``qmatmul_mma_decode_kernel`` for
    every other format): one weight (``e == 1``) at M <= 4 rows, K <=
    65536."""
    return (fmt in DECODE_KSPLIT and e == 1 and m <= _DECODE_ROWS
            and k <= _DECODE_MAX_K)


def decode_ksplit(n: int, k: int, sms: int) -> int:
    """Blocks of a cluster that split the ``s = ceil(k / 256)`` superblocks
    of q4_k's decode form, from host integers: at most 8 (the portable
    cluster size), at most 32 superblocks a block, and a divisor of ``s``
    where one fits (so that no block carries a superblock more than the
    others), the least that gives the ``ceil(n / 128)`` column tiles about
    four blocks per SM, else the largest."""
    s = -(-k // _TILE)
    want = -(-4 * sms // -(-n // _COLS))
    lo, hi = -(-s // _DECODE_MAX_SB), min(_MAX_KSPLIT, s)
    even = [d for d in range(lo, hi + 1) if s % d == 0]
    if not even:
        return max(lo, min(hi, want))
    return next((d for d in even if d >= want), even[-1])


def decode_ksplit_q6k(n: int, k: int, sms: int) -> int:
    """Blocks of a cluster that split the ``s = ceil(k / 256)`` superblocks
    of q6_k's decode form (x staged a superblock at a time), from host
    integers: the most, up to ``min(16, s)`` (16 is a non-portable cluster
    size), with which the ``ceil(n / 128)`` column tiles' clusters are all
    resident at once, a block an SM, on GPCs of 16 SMs (an H100's hold
    16-18), else 1.  On an H100 SXM this was the fastest split at every
    shape timed (8960->1536: 8, 7168->576: 16, 18432->7168: 2; see
    ``PERF.md``)."""
    s = -(-k // _TILE)
    tiles, gpcs = -(-n // _COLS), max(1, sms // _GPC_SMS)
    return next((ks for ks in range(min(_Q6_MAX_KSPLIT, s), 0, -1)
                 if tiles <= gpcs * (_GPC_SMS // ks)), 1)


def decode_ksplit_q3k(n: int, k: int, sms: int) -> int:
    """Blocks of a cluster that split the ``s = ceil(k / 256)`` superblocks
    of q3_k's decode form, and of q2_k's (:func:`decode_ksplit_q2k`), from
    host integers (at most ``min(16, s)``; 16 is a non-portable cluster
    size).  A q3_k stage is half a q6_k one, and its time is set by the
    latency of each stage's instructions, not by its bytes, so the split is
    fitted to the shapes rather than to residency: where the ``ceil(n /
    128)`` column tiles are at most a quarter of the SMs, about 8/11 of the
    SMs' worth of blocks (96 on an H100's 132); else 4 where a block keeps
    at least 4 superblocks (s >= 16), 2 where s >= 8 and the tiles are
    fewer than the SMs, else 1.  On an H100 SXM this was the fastest of 1,
    2, 3, 4, 6, 8, 12 and 16 at each of the eight q3_k shapes of the
    DeepSeek cut and at its four q2_k shapes (``PERF.md``)."""
    s = -(-k // _TILE)
    tiles = -(-n // _COLS)
    if 4 * tiles <= sms:
        ks = (8 * sms // 11) // tiles
    elif s >= 16:
        ks = 4
    elif s >= 8 and tiles < sms:
        ks = 2
    else:
        ks = 1
    return max(1, min(_Q6_MAX_KSPLIT, s, ks))


# q2_k's stage (11.8 KB) and q5_k's (25.3 KB) are latency-bound as q3_k's
# is: q3_k's rule was the fastest split at q2_k's four served shapes, and
# at q5_k's two (18432->7168: 4, where q6_k's residency rule gives 2; 8960
# ->1536: 8) of the 16 sizes scanned (PERF.md)
decode_ksplit_q2k = decode_ksplit_q3k
decode_ksplit_q5k = decode_ksplit_q3k


def decode_stages(fmt: str, k: int) -> int:
    """Stages of K of the tensor-core decode form: superblocks, or 4-block
    stages (128 rows) of q8_0 (``md_k`` in ``csrc/qmatmul.cu``)."""
    return -(-k // (128 if fmt == "q8_0" else _TILE))


def decode_ksplit_q8_0(n: int, k: int, sms: int) -> int:
    """Blocks of a cluster that split the ``s`` stages of q8_0's decode
    form (:func:`decode_stages`), from host integers (at most ``min(16,
    s)``), fitted to the shapes as q3_k's is: where the ``ceil(n / 128)``
    column tiles are at most a quarter of the SMs, about 8/11 of the SMs'
    worth of blocks; else 2 where the tiles are fewer than the SMs, 3 where
    they are fewer than twice the SMs and K holds at least 32 stages (4096
    rows), else 1.  On an H100 SXM this was the fastest of 1, 2, 3, 4, 6,
    8, 12 and 16 (or within 1 % of it) at each of the nine q8_0 shapes of
    the DeepSeek cut (``PERF.md``)."""
    s = decode_stages("q8_0", k)
    tiles = -(-n // _COLS)
    if 4 * tiles <= sms:
        ks = (8 * sms // 11) // tiles
    elif tiles < sms:
        ks = 2
    elif tiles < 2 * sms and s >= 32:
        ks = 3
    else:
        ks = 1
    return max(1, min(_Q6_MAX_KSPLIT, s, ks))


# the formats' decode forms, and how each splits its stages of K
DECODE_KSPLIT = {"q4_k": decode_ksplit, "q6_k": decode_ksplit_q6k,
                 "q3_k": decode_ksplit_q3k, "q5_k": decode_ksplit_q5k,
                 "q2_k": decode_ksplit_q2k, "q8_0": decode_ksplit_q8_0}


def prefill_form(fmt: str, e: int, m: int, k: int) -> bool:
    """Whether a call takes the prefill form (``qmatmul_prefill_kernel``):
    one weight (``e == 1``) that does not take its decode form, at M > 4
    rows or K > 65536 (``launch_fmt`` in ``csrc/qmatmul.cu``)."""
    return e == 1 and not decode_form(fmt, e, m, k)


def prefill_rows(n: int, m: int) -> int:
    """Rows of x a block of the prefill form takes: 64 where 128-row
    tiles would be at most 8 (the smallest weights, e.g. qwen2's k and v
    at a 512-row chunk: more blocks, each half the products), else 128
    (``pf_rows_for`` in ``csrc/qmatmul.cu``)."""
    few = -(-n // _COLS) * -(-m // _PF_ROWS) <= _PF_FEW_TILES
    return 64 if few else _PF_ROWS


def prefill_ksplit(n: int, m: int, k: int, sms: int) -> int:
    """Blocks of a cluster that split the ``2 ceil(k / 256)`` half
    superblocks of the prefill form, from host integers: the most, up to
    8 (the portable cluster size) and the halves, with which the output
    tiles' (:func:`prefill_rows` x 128) clusters are all resident at once,
    a block an SM (its shared memory takes one), on GPCs of 16 SMs (an
    H100's hold 16-18), and, for clusters of more than 2 blocks, fill at
    most four fifths of the SMs; else 1.  On an H100 SXM it was the
    fastest split at every shape scanned (``PERF.md``): clusters of 8
    filling 128 SMs ran 1.8x slower than clusters of 6 filling 96, while
    clusters of 2 filling 128 SMs (7168->2048) ran 1.9x faster than one
    block a tile filling 64."""
    halves = 2 * -(-k // _TILE)
    tiles = -(-n // _COLS) * -(-m // prefill_rows(n, m))
    gpcs = max(1, sms // _GPC_SMS)
    return next((ks for ks in range(min(_MAX_KSPLIT, halves), 1, -1)
                 if tiles <= gpcs * (_GPC_SMS // ks)
                 and (ks == 2 or tiles * ks <= sms * 4 // 5)), 1)


def _field_ptrs(qt: QTensor, device: torch.device) -> ctypes.Array:
    """The C entry point's field pointers, as a C array."""
    ptrs = []
    for name in FIELDS[qt.fmt]:
        f = qt.fields[name]
        if f.device != device or not f.is_contiguous() or f.data_ptr() % 16:
            raise ValueError("B1 fields must be contiguous, 16-byte "
                             "aligned and on x's device")
        ptrs.append(f.data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


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
    # one launch of one kernel; a K split merges inside its cluster
    if decode_form(qt.fmt, e, m, k):
        splits = DECODE_KSPLIT[qt.fmt](n, k, build.sm_count(dev))
    elif prefill_form(qt.fmt, e, m, k):
        splits = prefill_ksplit(n, m, k, build.sm_count(dev))
    else:
        # an expert stack: qmatmul_experts_kernel's row tiles of 1 or 20
        # rows, all experts' along the grid's y
        splits = 1
        if -(-m // _XROWS) * e > _MAX_GRID_Y:
            raise ValueError(f"B1 grid too tall: {e} experts x "
                             f"{-(-m // _XROWS)} row tiles")
    err = _entry(qt.fmt)(_FMT_ID[qt.fmt], _DTYPE_ID[x.dtype], x3.data_ptr(),
                         ptrs, len(ptrs), out.data_ptr(), e, m, k, n, splits,
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


def _wrapper(fmt: str, experts: bool):
    """B1's wrapper for one format and form, with its ``launches`` count."""
    def fn(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
        return _qmatmul(x, qt, fmt, experts)
    fn.__name__ = fn.__qualname__ = (
        f"qmatmul_experts_{fmt}" if experts else f"qmatmul_{fmt}")
    fn.__doc__ = (f"B1 for {'expert weights' if experts else 'one weight'} "
                  f"of format {fmt} (see :func:`_qmatmul`).")
    fn.launches = 0
    return fn


KERNELS = {fmt: _wrapper(fmt, experts=False) for fmt in FIELDS}
EXPERT_KERNELS = {fmt: _wrapper(fmt, experts=True) for fmt in FIELDS}
qmatmul_q4_k = KERNELS["q4_k"]
qmatmul_q6_k = KERNELS["q6_k"]
qmatmul_q3_k = KERNELS["q3_k"]
qmatmul_q5_k = KERNELS["q5_k"]
qmatmul_q2_k = KERNELS["q2_k"]
qmatmul_q8_0 = KERNELS["q8_0"]
qmatmul_experts_q4_k = EXPERT_KERNELS["q4_k"]
qmatmul_experts_q6_k = EXPERT_KERNELS["q6_k"]
qmatmul_experts_q3_k = EXPERT_KERNELS["q3_k"]
qmatmul_experts_q5_k = EXPERT_KERNELS["q5_k"]
qmatmul_experts_q2_k = EXPERT_KERNELS["q2_k"]
qmatmul_experts_q8_0 = EXPERT_KERNELS["q8_0"]


@functools.lru_cache(maxsize=None)
def _entry(fmt: str):
    """The C entry point of ``fmt``'s library (one per format)."""
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.bind(f"qmatmul_{fmt}", "qmatmul",
                      [i, i, v, ctypes.POINTER(v), i, v, i, i, i, i, i, v])


def library_launches(fmt: str, kernel: str = "experts") -> int:
    """Launches made by ``fmt``'s library of ``qmatmul_experts_kernel``
    (``kernel="experts"``), its decode form (``"decode"``) or its prefill
    form (``"prefill"``): which kernel a call ran, for the card tests and
    ``chip_smoke.py``."""
    name = {"experts": "qmatmul_experts_kernel_launches",
            "decode": "qmatmul_decode_kernel_launches",
            "prefill": "qmatmul_prefill_kernel_launches"}[kernel]
    f = getattr(build.library(f"qmatmul_{fmt}"), name)
    f.restype = ctypes.c_longlong
    f.argtypes = []
    return int(f())
