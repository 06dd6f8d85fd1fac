"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; ``tests/conftest.py`` imports JAX, so run it there with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Inputs are made with numpy from fixed seeds.  Tolerances: f32 outputs
1e-5 (absolute for attention's O(1) outputs, relative to max|y| for the
matmul) — summation order and the online softmax differ, nothing else;
bf16 matmul outputs one bf16 step (2^-8) of max|y|, since both sides
round an f32 accumulator to bf16 (the prefill form's test: ``B1_TOL_BF16``,
one step of the top binade).  The attention kernels' q4_0 loaders
(B5) dequantize each element bitwise as the plain version does, so they
are held to the same 1e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import tree_to
from repro_torch.core import get_policy, init_quantized_params
from repro_torch.core.qtensor import quantize
from repro_torch.kernels import build, paged_attn, qmatmul
from repro_torch.models import paged
from repro_torch.models.model import Model

TOL = 1e-5
# bf16 outputs of B1 forms whose f32 sums run in another order than the
# plain version's (the tensor-core forms at M > 4): chip_smoke.py's
# B1_TOL, one bf16 step of the top binade of max|y| (2^-8 of max|y| is
# less than one step when max|y| lies low in its binade, so a sum that
# rounds to the neighbouring bf16 value there would exceed it)
B1_TOL_BF16 = 8e-3

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q5_k", "q2_k", "q8_0"])
@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("k", [1280, 1000, 700])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_kernel_matches_plain(cuda, fmt, m, k, dtype):
    """K = 1000 and 700 are not multiples of 256; K = 700 is 22 q8_0
    blocks, so the last 256-row tile has 6 of its 8 blocks."""
    rng = np.random.default_rng(m * 7 + k)
    qt = quantize(torch.from_numpy(_np(rng, (k, 384))).to(cuda), fmt)
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda).to(dtype)
    before = qmatmul.KERNELS[fmt].launches
    y = qmatmul.KERNELS[fmt](x, qt)
    torch.cuda.synchronize()
    assert qmatmul.KERNELS[fmt].launches == before + 1
    assert y.dtype == dtype and y.shape == (m, 384)
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else 2 ** -8
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_q3_k_kernel_matches_plain(cuda, m, dtype):
    rng = np.random.default_rng(m + 3)
    qt = quantize(torch.from_numpy(_np(rng, (1000, 256))).to(cuda), "q3_k")
    x = torch.from_numpy(_np(rng, (m, 1000))).to(cuda).to(dtype)
    before = qmatmul.qmatmul_q3_k.launches
    y = qmatmul.qmatmul_q3_k(x, qt)
    torch.cuda.synchronize()
    assert qmatmul.qmatmul_q3_k.launches == before + 1
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else 2 ** -8
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()


# the formats whose expert form is qmatmul_experts_kernel, which skips
# experts whose rows of x are all zero: every format
SKIPS_EMPTY = ("q3_k", "q2_k", "q4_k", "q6_k", "q5_k", "q8_0")


@pytest.mark.parametrize("fmt", ["q3_k", "q4_k", "q6_k", "q5_k", "q2_k",
                                 "q8_0"])
@pytest.mark.parametrize("c", [1, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_experts_kernel_matches_plain(cuda, fmt, c, dtype):
    """x (E, C, K) against (E, K, N) expert weights in one launch, K not a
    multiple of the superblock (q8_0: 22 blocks, so an expert's slab is
    not a whole number of 4-block stages), one expert's rows all zero;
    every expert reads its own fields (its own d and dmin too), which E = 5
    with distinct weights shows."""
    rng = np.random.default_rng(c * 5 + len(fmt))
    e, k, n = 5, 700, 136
    qt = quantize(torch.from_numpy(_np(rng, (e, k, n))).to(cuda), fmt)
    x = torch.from_numpy(_np(rng, (e, c, k))).to(cuda)
    x[2] = 0.0
    x = x.to(dtype)
    kern = qmatmul.EXPERT_KERNELS[fmt]
    before = kern.launches
    own = qmatmul.library_launches(fmt)
    y = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    # every format runs qmatmul_experts_kernel (here with 4-byte copies: N
    # is not a multiple of 16)
    assert qmatmul.library_launches(fmt) == own + 1
    assert y.dtype == dtype and y.shape == (e, c, n)
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else 2 ** -8
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    assert bool((y[2] == 0).all())


@pytest.mark.parametrize("fmt", SKIPS_EMPTY)
@pytest.mark.parametrize("c", [1, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n", [(1024, 256), (512, 768), (544, 256)],
                         ids=["k>n", "k<n", "ragged"])
def test_qmatmul_experts_kernel_skips_empty_experts(cuda, fmt, c, dtype, k,
                                                    n):
    """E = 16 experts of which 3 are live (at C = 20 one of them has zero
    rows too), in both orientations of the DeepSeek expert weights (K > N:
    gate/up; K < N: down), and with K = 544, a multiple of 32 but not of
    256 (q8_0: 17 blocks, four stages of 4 and a last one of 1, which the
    16-byte copies of N = 256 meet): one launch of qmatmul_experts_kernel
    per call; the empty experts' outputs are bitwise the plain version's
    +0, the zero rows of a live expert exactly 0, and the live rows within
    the tolerance.  Expert 11's x is zero outside elements 128..255, so a
    test for empty tiles that looked at part of each stage would call it
    empty."""
    rng = np.random.default_rng(c * 3 + k + len(fmt))
    e, live = 16, [2, 7, 11]
    qt = quantize(torch.from_numpy(_np(rng, (e, k, n))).to(cuda), fmt)
    x = torch.zeros((e, c, k), device=cuda)
    x[live] = torch.from_numpy(_np(rng, (3, c, k))).to(cuda)
    if c == 20:
        x[7, 3:9] = 0.0
    x[11, :, :128] = 0.0
    x[11, :, 256:] = 0.0
    x = x.to(dtype)
    kern = qmatmul.EXPERT_KERNELS[fmt]
    before, own = kern.launches, qmatmul.library_launches(fmt)
    y = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert qmatmul.library_launches(fmt) == own + 1
    ref = qmatmul.qmatmul_plain(x, qt)
    empty = [i for i in range(e) if i not in live]
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y[empty].view(bits), ref[empty].view(bits))
    assert not bool(y[empty].view(bits).any())          # +0, not -0
    if c == 20:
        assert bool((y[7, 3:9] == 0).all())
    tol = TOL if dtype == torch.float32 else 2 ** -8
    err = (y[live].float() - ref[live].float()).abs().max()
    assert err <= tol * ref.float().abs().max()


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k,n", [(1000, 388), (700, 260), (1536, 1536),
                                 (1536, 8960)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_q4k_decode_form(cuda, m, k, n, dtype):
    """q4_k's 2-D form at M <= 4 runs qmatmul_q4k_decode_kernel: one device
    launch a call and no other form's, two calls bitwise equal, within
    B1's limits of the plain version; ragged K (1000, 700), N % 16 != 0
    (388, 260: 4-byte copies), the split shapes N = 1536 and 8960 (K
    split over a cluster), and a zero row (a padded lane) gives +0."""
    rng = np.random.default_rng(m * 13 + k + n)
    qt = quantize(torch.from_numpy(_np(rng, (k, n))).to(cuda), "q4_k")
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda).to(dtype)
    if m > 1:
        x[m - 2] = 0
    kern = qmatmul.qmatmul_q4_k
    before = kern.launches
    dec, pre = (qmatmul.library_launches("q4_k", w)
                for w in ("decode", "prefill"))
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert qmatmul.library_launches("q4_k", "decode") == dec + 2
    assert qmatmul.library_launches("q4_k", "prefill") == pre
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else 2 ** -8
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    if m > 1:
        assert torch.equal(y[m - 2].view(bits),
                           torch.zeros_like(y[m - 2]).view(bits))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k,n", [(1000, 388), (700, 260), (1536, 256),
                                 (8960, 1536), (7168, 576), (18432, 7168)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_q6k_decode_form(cuda, m, k, n, dtype):
    """q6_k's 2-D form at M <= 4 runs qmatmul_mma_decode_kernel on tensor
    cores: one device launch a call and no other form's, two calls
    bitwise equal, within B1's limits of the plain version (f32 x as three
    bf16 terms: 1e-5 of max|y|); ragged K (1000, 700), N % 16 != 0 (388,
    260: 4-byte copies), the shapes of qwen2 (attn_k/v 1536->256, down
    8960->1536) and DeepSeek (attn_kv_a_mqa 7168->576, dense down
    18432->7168), K split over a cluster, and a zero row gives +0."""
    rng = np.random.default_rng(m * 17 + k + n)
    qt = quantize(torch.from_numpy(_np(rng, (k, n))).to(cuda), "q6_k")
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda).to(dtype)
    if m > 1:
        x[m - 2] = 0
    kern = qmatmul.qmatmul_q6_k
    before = kern.launches
    dec, pre = (qmatmul.library_launches("q6_k", w)
                for w in ("decode", "prefill"))
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert qmatmul.library_launches("q6_k", "decode") == dec + 2
    assert qmatmul.library_launches("q6_k", "prefill") == pre
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else 2 ** -8
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    if m > 1:
        assert torch.equal(y[m - 2].view(bits),
                           torch.zeros_like(y[m - 2]).view(bits))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k,n", [(1000, 388), (700, 260), (7168, 576),
                                 (7168, 2048), (2048, 7168), (18432, 7168)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_q3k_decode_form(cuda, m, k, n, dtype):
    """q3_k's 2-D form at M <= 4 runs qmatmul_mma_decode_kernel on tensor
    cores, as q6_k's does: one device launch a call and no other form's,
    two calls bitwise equal, within B1's limits of the
    plain version (f32 x as three bf16 terms: 1e-5 of max|y|; bf16:
    B1_TOL_BF16); ragged K (1000, 700), N % 16 != 0 (388, 260: 4-byte
    copies), DeepSeek's served shapes (attn_kv_a_mqa 7168->576, shexp
    gate/up 7168->2048 and down 2048->7168, dense down 18432->7168), K split
    over a cluster, and a zero row gives +0."""
    rng = np.random.default_rng(m * 29 + k + n)
    qt = quantize(torch.from_numpy(_np(rng, (k, n))).to(cuda), "q3_k")
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda).to(dtype)
    if m > 1:
        x[m - 2] = 0
    kern = qmatmul.qmatmul_q3_k
    before = kern.launches
    counts = {w: qmatmul.library_launches("q3_k", w)
              for w in ("decode", "prefill", "experts")}
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert {w: qmatmul.library_launches("q3_k", w) - c
            for w, c in counts.items()} == {
        "decode": 2, "prefill": 0, "experts": 0}
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else B1_TOL_BF16
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    if m > 1:
        assert torch.equal(y[m - 2].view(bits),
                           torch.zeros_like(y[m - 2]).view(bits))


# q2_k's and q8_0's shapes of the tensor-core decode form: ragged K (1000,
# 700: q8_0's 22 blocks leave its last 4-block stage 2 of 4), N % 16 != 0
# (388, 260: 4-byte copies), and the DeepSeek cut's served shapes (q2_k
# under Q2_K_L: attn_q_a, attn_q_b, shexp and dense gate/up; q8_0 under
# Q8_0: attn_kv_a_mqa, attn_output, shexp and dense down, the output head)
Q2_Q8_DECODE = [("q2_k", 1000, 388), ("q2_k", 700, 260),
                ("q2_k", 7168, 1536), ("q2_k", 1536, 24576),
                ("q2_k", 7168, 2048), ("q2_k", 7168, 18432),
                ("q8_0", 1000, 388), ("q8_0", 700, 260),
                ("q8_0", 7168, 576), ("q8_0", 16384, 7168),
                ("q8_0", 2048, 7168), ("q8_0", 18432, 7168),
                ("q8_0", 7168, 129280)]


@functools.cache
def _decode_weight(fmt, k, n, device):
    """A (k, n) weight of ``fmt`` from numpy's seeded normal draws, made
    once for all the cases of its shape (~2.5 GB on the card in all)."""
    rng = np.random.default_rng(k + n + len(fmt))
    return quantize(torch.from_numpy(rng.standard_normal(
        (k, n), dtype=np.float32)).to(device), fmt)


@pytest.mark.parametrize("fmt,k,n", Q2_Q8_DECODE)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_q2k_q8_0_decode_form(cuda, fmt, k, n, m, dtype):
    """q2_k's and q8_0's 2-D forms at M <= 4 run qmatmul_mma_decode_kernel
    on tensor cores, as q6_k's and q3_k's do: one device launch a call and
    no other form's, two calls bitwise equal, within
    B1's limits of the plain version (f32 x as three bf16 terms: 1e-5 of
    max|y|; bf16: B1_TOL_BF16), at ``Q2_Q8_DECODE``'s shapes (the served
    ones with the K split their rule gives, the 7168 -> 129280 head), and
    a zero row gives +0."""
    qt = _decode_weight(fmt, k, n, cuda)
    rng = np.random.default_rng(m * 31 + k + n)
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda).to(dtype)
    if m > 1:
        x[m - 2] = 0
    kern = qmatmul.KERNELS[fmt]
    before = kern.launches
    counts = {w: qmatmul.library_launches(fmt, w)
              for w in ("decode", "prefill", "experts")}
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert {w: qmatmul.library_launches(fmt, w) - c
            for w, c in counts.items()} == {
        "decode": 2, "prefill": 0, "experts": 0}
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else B1_TOL_BF16
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    if m > 1:
        assert torch.equal(y[m - 2].view(bits),
                           torch.zeros_like(y[m - 2]).view(bits))


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q3_k", "q5_k", "q2_k",
                                 "q8_0"])
@pytest.mark.parametrize("m", [5, 16, 77, 512, 600])
@pytest.mark.parametrize("k,n", [(700, 260), (1536, 384), (8960, 1536)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_prefill_form(cuda, fmt, m, k, n, dtype):
    """The 2-D form at M > 4 of every format runs qmatmul_prefill_kernel
    on tensor cores: one launch of it a call and no other form's, two calls
    bitwise equal, within
    B1's limits of the plain version (f32 x as three bf16 terms: 1e-5 of
    max|y|; bf16: B1_TOL_BF16); rows past a 128-row tile (M = 5, 77, 600),
    ragged K (700: x's bf16 rows are not 16-byte aligned; q8_0's 22 blocks
    leave its last superblock 6 of 8), N % 16 != 0 (260: 4-byte copies), a
    K split over a cluster (1536 -> 384, 8960 -> 1536), and zero rows give
    +0."""
    rng = np.random.default_rng(m * 19 + k + n + len(fmt))
    qt = quantize(torch.from_numpy(_np(rng, (k, n))).to(cuda), fmt)
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda)
    zero = [1, m - 2]
    x[zero] = 0
    x = x.to(dtype)
    kern = qmatmul.KERNELS[fmt]
    before = kern.launches
    pre, dec, exp = (qmatmul.library_launches(fmt, w)
                     for w in ("prefill", "decode", "experts"))
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert qmatmul.library_launches(fmt, "prefill") == pre + 2
    assert qmatmul.library_launches(fmt, "decode") == dec
    assert qmatmul.library_launches(fmt, "experts") == exp
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else B1_TOL_BF16
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    assert not y[zero].view(bits).any()                  # +0, not -0


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k,n", [(1000, 388), (700, 260), (18432, 7168),
                                 (8960, 1536)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_q5k_decode_form(cuda, m, k, n, dtype):
    """q5_k's 2-D form at M <= 4 runs qmatmul_mma_decode_kernel on tensor
    cores, as every other format but q4_k does: one device launch a call
    and no other form's, two calls bitwise equal, within B1's limits of
    the plain version (f32 x as three bf16 terms: 1e-5 of max|y|; bf16:
    B1_TOL_BF16); ragged K (1000, 700), N % 16 != 0 (388, 260: 4-byte
    copies), the served shapes (under Q3_K_M the DeepSeek cut's dense down
    18432 -> 7168 and qwen2's down 8960 -> 1536) with the K split their
    rule gives, and a zero row gives +0."""
    qt = _decode_weight("q5_k", k, n, cuda)
    rng = np.random.default_rng(m * 37 + k + n)
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda).to(dtype)
    if m > 1:
        x[m - 2] = 0
    kern = qmatmul.qmatmul_q5_k
    before = kern.launches
    counts = {w: qmatmul.library_launches("q5_k", w)
              for w in ("decode", "prefill", "experts")}
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert {w: qmatmul.library_launches("q5_k", w) - c
            for w, c in counts.items()} == {
        "decode": 2, "prefill": 0, "experts": 0}
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else B1_TOL_BF16
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    if m > 1:
        assert torch.equal(y[m - 2].view(bits),
                           torch.zeros_like(y[m - 2]).view(bits))


def test_qmatmul_kernel_raises_on_what_it_does_not_take(cuda):
    """Every 2-D form (M = 2: q4_k's decode form; M = 8: the prefill form)
    raises on N % 4 != 0 and on x that is neither f32 nor bf16."""
    for m in (2, 8):
        qt = quantize(torch.randn(256, 130, device=cuda), "q4_k")
        with pytest.raises(ValueError, match="N % 4"):
            qmatmul.qmatmul_q4_k(torch.randn(m, 256, device=cuda), qt)
        qt = quantize(torch.randn(256, 128, device=cuda), "q4_k")
        with pytest.raises(TypeError):
            qmatmul.qmatmul_q4_k(torch.randn(m, 256, device=cuda,
                                             dtype=torch.float16), qt)


def _pools(rng, b, n_lp, page_size, hkv, d, live):
    """Pools + block tables with ``live[i]`` written tokens per lane (partial
    last pages whenever ``live % P != 0``) and NULL-page tails."""
    n_pages = paged.RESERVED_PAGES + b * n_lp
    k = _np(rng, (n_pages, page_size, hkv, d))
    v = _np(rng, (n_pages, page_size, hkv, d))
    pos_pool = np.full((n_pages, page_size), -1, np.int32)
    bt = np.full((b, n_lp), paged.NULL_PAGE, np.int32)
    nxt = paged.RESERVED_PAGES
    for i in range(b):
        for lp in range(-(-live[i] // page_size)):
            bt[i, lp] = nxt
            for o in range(page_size):
                if lp * page_size + o < live[i]:
                    pos_pool[nxt, o] = lp * page_size + o
            nxt += 1
    return k, v, pos_pool, bt


DECODE_CASES = [
    # page_size, window, softcap, active_pages, lane_pages
    (3, 0, 0.0, None, None),
    (5, 0, 0.0, 4, None),            # active_pages < table width
    (7, 6, 20.0, None, None),        # sliding window + softcap
    (4, 0, 0.0, 5, [2, 5, 1]),       # per-lane bound short of nj
    (16, 0, 0.0, None, [3, 1, 2]),   # the serving page size
]


QUANTIZE = {"q8_0": paged_attn.quantize_kv_page_pool,
            "q4_0": paged_attn.quantize_kv_page_pool_q4}


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("d", [16, 128])
def test_paged_decode_kernel_matches_plain(cuda, kv, case, d):
    """q4_0 pools take B3's q4_0 loader (B5): ragged last pages, lane
    bounds short of the bucket (``lane_pages < active_pages``)."""
    page_size, window, softcap, active, lanes = case
    rng = np.random.default_rng(page_size * 3 + d)
    b, h, hkv, n_lp = 3, 12, 2, 6
    live = [page_size * 2 + 1, page_size * 4, 2]
    if lanes is not None:
        live = [min(x, lp * page_size) for x, lp in zip(live, lanes)]
    k, v, pos_pool, bt = (torch.from_numpy(a).to(cuda) for a in _pools(
        rng, b, n_lp, page_size, hkv, d, live))
    pos = torch.tensor([x - 1 for x in live], dtype=torch.int32, device=cuda)
    q = torch.from_numpy(_np(rng, (b, h, d))).to(cuda)
    lp = None if lanes is None else torch.tensor(lanes, dtype=torch.int32,
                                                 device=cuda)
    kw = dict(window=window, softcap=softcap, active_pages=active,
              lane_pages=lp)
    quant = kv if kv in QUANTIZE else None
    if quant:
        pools = (*QUANTIZE[kv](k), *QUANTIZE[kv](v))
        fn = paged_attn.paged_attn_decode_quant
        counter = fn.loaders[kv]
        kw["mode"] = kv
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        pools = (k.to(dt), v.to(dt))
        fn = counter = paged_attn.paged_attn_decode
    before = counter.launches
    y = fn(q, *pools, pos_pool, bt, pos, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    nj = paged_attn._n_active(bt, active)
    ref = paged_attn.attn_decode_plain(
        q, pools, pos_pool, bt, pos, paged_attn._lane_bound(lp, b, nj, cuda),
        window=window, softcap=softcap, scale=d ** -0.5, nj=nj, quant=quant)
    assert y.shape == (b, h, d)
    assert (y - ref).abs().max() < TOL


# 4 lanes, 16-token pages and a 64-page bucket, as the engine decodes at
# max_len 1024: lanes of 44-45 pages split over the cluster's blocks,
# ragged last pages, a lane of 1 token (its later splits hold no page), and
# lane bounds short of the bucket; then a window and a softcap
LONG_DECODE_CASES = [
    # live tokens per lane, lane_pages, window, softcap
    ([16 * 44 + 5, 16 * 40, 1, 16 * 41 + 9], [45, 41, 1, 43], 0, 0.0),
    ([16 * 44 + 5, 16 * 40, 1, 16 * 41 + 9], None, 100, 30.0),
]


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", LONG_DECODE_CASES, ids=["bounded", "window"])
def test_paged_decode_kernel_splits_long_lanes(cuda, kv, case):
    """The decode kernel splits each lane's walk over a cluster of blocks
    and merges their partial softmax states in a fixed order: one launch a
    call, two calls bitwise equal, and the plain version's result within
    TOL for every pool kind."""
    live, lanes, window, softcap = case
    rng = np.random.default_rng(len(kv) + window)
    b, h, hkv, d, page_size, n_lp = 4, 12, 2, 128, 16, 64
    k, v, pos_pool, bt = (torch.from_numpy(a).to(cuda) for a in _pools(
        rng, b, n_lp, page_size, hkv, d, live))
    pos = torch.tensor([x - 1 for x in live], dtype=torch.int32, device=cuda)
    q = torch.from_numpy(_np(rng, (b, h, d))).to(cuda)
    lp = None if lanes is None else torch.tensor(lanes, dtype=torch.int32,
                                                 device=cuda)
    kw = dict(window=window, softcap=softcap, active_pages=n_lp,
              lane_pages=lp)
    quant = kv if kv in QUANTIZE else None
    if quant:
        pools = (*QUANTIZE[kv](k), *QUANTIZE[kv](v))
        fn = paged_attn.paged_attn_decode_quant
        counter = fn.loaders[kv]
        kw["mode"] = kv
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        pools = (k.to(dt), v.to(dt))
        fn = counter = paged_attn.paged_attn_decode
    splits, pps = paged_attn.decode_splits(
        n_lp, b * hkv, build.sm_count(cuda))
    assert splits > 1 and pps > 2      # several splits of several tiles
    before = counter.launches
    y = fn(q, *pools, pos_pool, bt, pos, **kw)
    y2 = fn(q, *pools, pos_pool, bt, pos, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(y.view(torch.int32), y2.view(torch.int32))
    ref = paged_attn.attn_decode_plain(
        q, pools, pos_pool, bt, pos,
        paged_attn._lane_bound(lp, b, n_lp, cuda), window=window,
        softcap=softcap, scale=d ** -0.5, nj=n_lp, quant=quant)
    assert y.shape == (b, h, d) and torch.isfinite(y).all()
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8_0", "q4_0"])
def test_paged_decode_kernel_row_tiles(cuda, kv):
    """20 query heads over 2 kv heads (10 a kv head: two row tiles of the
    decode kernel's 8) and D = 96, not a power of two."""
    rng = np.random.default_rng(len(kv))
    b, h, hkv, d, page_size, n_lp = 2, 20, 2, 96, 16, 8
    live = [16 * 5 + 3, 40]
    k, v, pos_pool, bt = (torch.from_numpy(a).to(cuda) for a in _pools(
        rng, b, n_lp, page_size, hkv, d, live))
    pos = torch.tensor([x - 1 for x in live], dtype=torch.int32, device=cuda)
    q = torch.from_numpy(_np(rng, (b, h, d))).to(cuda)
    quant = kv if kv in QUANTIZE else None
    if quant:
        pools = (*QUANTIZE[kv](k), *QUANTIZE[kv](v))
        y = paged_attn.paged_attn_decode_quant(q, *pools, pos_pool, bt, pos,
                                               mode=kv)
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        pools = (k.to(dt), v.to(dt))
        y = paged_attn.paged_attn_decode(q, *pools, pos_pool, bt, pos)
    ref = paged_attn.attn_decode_plain(
        q, pools, pos_pool, bt, pos, paged_attn._lane_bound(None, b, n_lp,
                                                            cuda),
        window=0, softcap=0.0, scale=d ** -0.5, nj=n_lp, quant=quant)
    assert y.shape == (b, h, d)
    assert (y - ref).abs().max() < TOL


PREFILL_CASES = [
    # page_size, active_pages, C, H, Hkv, table width, window, softcap
    (3, None, 5, 12, 2, 6, 0, 0.0),
    (5, 3, 5, 12, 2, 6, 0, 0.0),        # active_pages < table width
    (16, None, 40, 12, 2, 6, 0, 0.0),
    (16, None, 40, 4, 4, 6, 0, 0.0),    # rep 1: a group of one
    (7, None, 33, 12, 2, 8, 20, 30.0),  # window + softcap
    (16, None, 128, 12, 2, 64, 0, 0.0),  # a 64-page lane, a full chunk
]


@pytest.mark.parametrize("mode", ["q8_0", "q4_0"])
@pytest.mark.parametrize("case", PREFILL_CASES, ids=[
    "p3", "p5-active", "p16", "rep1", "window-softcap", "64-pages"])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_prefill_kernel_matches_plain(cuda, case, mode, qdt):
    """Write-then-attend prefill over q8_0 (B4) and q4_0 (B5) pools on
    tensor cores: f32 queries (three bf16 terms) and bf16 ones read as
    passed, rep 6 and 1, a window with a softcap, a 64-page lane (its key
    walk split over a cluster), padded query rows (qpos = -1 -> zeros) and
    stale rows past a lane's frontier; one launch a call, two calls
    bitwise equal, the plain version's result within 1e-5."""
    page_size, active, c, h, hkv, n_lp, window, softcap = case
    rng = np.random.default_rng(page_size + c + h + hkv + window)
    b, d = 2, 128
    live = [min(page_size * 2 + 2 + c, page_size * n_lp), page_size + c]
    if n_lp == 64:
        live[0] = page_size * n_lp - 5
    k, v, pos_pool, bt = (torch.from_numpy(a).to(cuda) for a in _pools(
        rng, b, n_lp, page_size, hkv, d, live))
    qpos = torch.stack([torch.arange(x - c, x) for x in live]).to(
        torch.int32)
    qpos[1, -2:] = -1
    qpos = qpos.to(cuda)
    q = torch.from_numpy(_np(rng, (b, c, h, d))).to(cuda).to(qdt)
    pools = (*QUANTIZE[mode](k), *QUANTIZE[mode](v))
    counter = paged_attn.paged_attn_prefill_quant.loaders[mode]
    kw = dict(mode=mode, active_pages=active, window=window,
              softcap=softcap)
    before = counter.launches
    y = paged_attn.paged_attn_prefill_quant(q, *pools, pos_pool, bt, qpos,
                                            **kw)
    y2 = paged_attn.paged_attn_prefill_quant(q, *pools, pos_pool, bt, qpos,
                                             **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(y.view(torch.int32), y2.view(torch.int32))
    ref = paged_attn.attn_prefill_plain(
        q, pools, pos_pool, bt, qpos, window=window, softcap=softcap,
        scale=d ** -0.5, nj=paged_attn._n_active(bt, active), quant=mode)
    assert y.shape == (b, c, h, d) and torch.isfinite(y).all()
    assert bool((y[1, -2:] == 0).all())
    assert (y - ref).abs().max() < TOL


def _latent_pools(rng, b, n_lp, page_size, r, dr, live):
    """f32 latent / rope pools and block tables with ``live[i]`` tokens per
    lane and NULL-page tails."""
    n_pages = paged.RESERVED_PAGES + b * n_lp
    ckv = _np(rng, (n_pages, page_size, r))
    kr = _np(rng, (n_pages, page_size, dr))
    bt = np.full((b, n_lp), paged.NULL_PAGE, np.int32)
    nxt = paged.RESERVED_PAGES
    for i in range(b):
        for lp in range(-(-live[i] // page_size)):
            bt[i, lp] = nxt
            nxt += 1
    return ckv, kr, bt


MLA_DECODE_CASES = [
    # page_size, active_pages, lane_pages, live
    (3, None, None, [7, 12, 1]),
    (5, 4, [2, 4, 1], [9, 20, 1]),       # bounds short of the table width
    (16, None, [3, 1, 2], [33, 1, 17]),  # the serving page size
]


# MLA pool kinds: model-dtype, or the (latent, rope) modes of the quantized
# pools (B6's q8_0 and q4_0 loaders, and dq's mixed pair)
MLA_KV = {"f32": None, "bf16": None, "q8_0": ("q8_0", "q8_0"),
          "q4_0": ("q4_0", "q4_0"), "q8_0+q4_0": ("q8_0", "q4_0")}


def _mla_quant_pools(ckv, kr, modes):
    return (*QUANTIZE[modes[0]](ckv), *QUANTIZE[modes[1]](kr))


@pytest.mark.parametrize("kv", list(MLA_KV))
@pytest.mark.parametrize("case", MLA_DECODE_CASES)
@pytest.mark.parametrize("r,dr,h", [(32, 16, 5), (32, 14, 5), (512, 64, 12)])
def test_paged_mla_decode_kernel_matches_plain(cuda, kv, case, r, dr, h):
    """Dr = 14: a q4_0 rope row is an odd 7 bytes."""
    page_size, active, lanes, live = case
    rng = np.random.default_rng(page_size + r)
    b, n_lp = 3, 6
    ckv, kr, bt = (torch.from_numpy(a).to(cuda) for a in _latent_pools(
        rng, b, n_lp, page_size, r, dr, live))
    pos = torch.tensor([x - 1 for x in live], dtype=torch.int32, device=cuda)
    q_eff = torch.from_numpy(_np(rng, (b, h, r))).to(cuda)
    q_rope = torch.from_numpy(_np(rng, (b, h, dr))).to(cuda)
    lp = None if lanes is None else torch.tensor(lanes, dtype=torch.int32,
                                                 device=cuda)
    scale = 192 ** -0.5
    modes, kw = MLA_KV[kv], {}
    if modes:
        pools = _mla_quant_pools(ckv, kr, modes)
        fn = paged_attn.paged_mla_decode_quant
        counter = fn.loaders[modes]
        kw = dict(latent_mode=modes[0], rope_mode=modes[1])
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        pools = (ckv.to(dt), kr.to(dt))
        fn = counter = paged_attn.paged_mla_decode
    before = counter.launches
    y = fn(q_eff, q_rope, *pools, bt, pos, scale=scale, active_pages=active,
           lane_pages=lp, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = paged_attn.mla_decode_plain(
        q_eff, q_rope, pools, bt, pos, scale=scale,
        nj=paged_attn._n_active(bt, active), quant=modes)
    assert y.shape == (b, h, r)
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("kv", list(MLA_KV))
@pytest.mark.parametrize("h", [5, 12])
def test_paged_mla_decode_kernel_splits_long_lanes(cuda, kv, h):
    """The MLA decode kernel splits each lane's tokens over a cluster of
    blocks and merges their partial softmax states in a fixed order: 4
    lanes in a 64-page bucket (44-45-page lanes, a 1-token lane whose
    later blocks hold no token, lane bounds short of the bucket), H not a
    multiple of the 16-head tile, f32 and bf16 queries; one launch a call,
    two calls bitwise equal, the plain version's result within TOL for
    every loader pair."""
    rng = np.random.default_rng(len(kv) + h)
    b, r, dr, page_size, n_lp = 4, 512, 64, 16, 64
    live = [16 * 44 + 5, 16 * 40, 1, 16 * 41 + 9]
    lanes = torch.tensor([45, 41, 1, 43], dtype=torch.int32, device=cuda)
    ckv, kr, bt = (torch.from_numpy(a).to(cuda) for a in _latent_pools(
        rng, b, n_lp, page_size, r, dr, live))
    pos = torch.tensor([x - 1 for x in live], dtype=torch.int32, device=cuda)
    # bf16 queries (as the model passes them) at H = 12, f32 at H = 5
    qdt = torch.bfloat16 if h == 12 else torch.float32
    q_eff = torch.from_numpy(_np(rng, (b, h, r))).to(cuda).to(qdt)
    q_rope = torch.from_numpy(_np(rng, (b, h, dr))).to(cuda).to(qdt)
    modes, kw = MLA_KV[kv], {}
    if modes:
        pools = _mla_quant_pools(ckv, kr, modes)
        fn = paged_attn.paged_mla_decode_quant
        counter = fn.loaders[modes]
        kw = dict(latent_mode=modes[0], rope_mode=modes[1])
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        pools = (ckv.to(dt), kr.to(dt))
        fn = counter = paged_attn.paged_mla_decode
    splits = paged_attn.mla_decode_splits(n_lp, b, h,
                                          build.sm_count(cuda))
    assert splits > 1      # several blocks a lane, several tiles each
    before = counter.launches
    y = fn(q_eff, q_rope, *pools, bt, pos, scale=0.1, active_pages=n_lp,
           lane_pages=lanes, **kw)
    y2 = fn(q_eff, q_rope, *pools, bt, pos, scale=0.1, active_pages=n_lp,
            lane_pages=lanes, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(y.view(torch.int32), y2.view(torch.int32))
    ref = paged_attn.mla_decode_plain(q_eff, q_rope, pools, bt, pos,
                                      scale=0.1, nj=n_lp, quant=modes)
    assert y.shape == (b, h, r) and torch.isfinite(y).all()
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("kv", ["q8_0", "q4_0", "q8_0+q4_0"])
@pytest.mark.parametrize("page_size,active,c", [(3, None, 5), (5, 3, 5),
                                                (16, None, 40)])
def test_paged_mla_prefill_kernel_matches_plain(cuda, page_size, active, c,
                                                kv):
    """Write-then-attend MLA prefill over quantized latent pools (B7 and
    its q4_0 loaders), with padded query rows (qpos = -1 -> zeros) and
    stale tokens past a lane's frontier."""
    rng = np.random.default_rng(page_size * 2 + c)
    b, h, r, dr, n_lp = 2, 6, 512, 64, 6
    live = [min(page_size * 2 + 2 + c, page_size * n_lp), page_size + c]
    ckv, kr, bt = (torch.from_numpy(a).to(cuda) for a in _latent_pools(
        rng, b, n_lp, page_size, r, dr, [page_size * n_lp] * b))
    qpos = torch.stack([torch.arange(x - c, x) for x in live]).to(
        torch.int32)
    qpos[1, -2:] = -1
    qpos = qpos.to(cuda)
    q_eff = torch.from_numpy(_np(rng, (b, c, h, r))).to(cuda)
    q_rope = torch.from_numpy(_np(rng, (b, c, h, dr))).to(cuda)
    modes = MLA_KV[kv]
    pools = _mla_quant_pools(ckv, kr, modes)
    counter = paged_attn.paged_mla_prefill_quant.loaders[modes]
    before = counter.launches
    y = paged_attn.paged_mla_prefill_quant(
        q_eff, q_rope, *pools, bt, qpos, scale=0.1, active_pages=active,
        latent_mode=modes[0], rope_mode=modes[1])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = paged_attn.mla_prefill_plain(
        q_eff, q_rope, pools, bt, qpos, scale=0.1,
        nj=paged_attn._n_active(bt, active), quant=modes)
    assert bool((y[1, -2:] == 0).all())
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("kv", ["q8_0", "q4_0", "q8_0+q4_0"])
@pytest.mark.parametrize("page_size", [16, 64])
@pytest.mark.parametrize("c,h,qdt", [(20, 12, torch.bfloat16),
                                     (20, 12, torch.float32),
                                     (128, 70, torch.bfloat16),
                                     (128, 70, torch.float32)],
                         ids=["short-bf16", "short-f32", "full-bf16",
                              "full-f32"])
def test_paged_mla_prefill_tensor_cores(cuda, kv, page_size, c, h, qdt):
    """The tensor-core MLA prefill kernel over every loader pair, page
    sizes 16 and 64, a short chunk (20 tokens, its last rows padded) and a
    full one (128), bf16 queries read as passed and f32 ones as three bf16
    terms, 70 heads (two or three head tiles): one launch a call, padded
    rows zero, two calls bitwise equal, the plain version's result within
    1e-5."""
    rng = np.random.default_rng(page_size + c + h + len(kv))
    b, r, dr = 2, 512, 64
    n_lp = -(-(400 + c) // page_size)
    live = [400, 137]
    ckv, kr, bt = (torch.from_numpy(a).to(cuda) for a in _latent_pools(
        rng, b, n_lp, page_size, r, dr, [page_size * n_lp] * b))
    qpos = torch.stack([torch.arange(x - c, x) for x in live]).to(
        torch.int32)
    qpos[1, -3:] = -1
    qpos = qpos.to(cuda)
    q_eff = torch.from_numpy(_np(rng, (b, c, h, r))).to(cuda).to(qdt)
    q_rope = torch.from_numpy(_np(rng, (b, c, h, dr))).to(cuda).to(qdt)
    modes = MLA_KV[kv]
    pools = _mla_quant_pools(ckv, kr, modes)
    counter = paged_attn.paged_mla_prefill_quant.loaders[modes]
    kw = dict(scale=192 ** -0.5, latent_mode=modes[0], rope_mode=modes[1])
    before = counter.launches
    y = paged_attn.paged_mla_prefill_quant(q_eff, q_rope, *pools, bt, qpos,
                                           **kw)
    y2 = paged_attn.paged_mla_prefill_quant(q_eff, q_rope, *pools, bt, qpos,
                                            **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(y.view(torch.int32), y2.view(torch.int32))
    ref = paged_attn.mla_prefill_plain(q_eff, q_rope, pools, bt, qpos,
                                       scale=kw["scale"], nj=n_lp,
                                       quant=modes)
    assert y.shape == (b, c, h, r) and torch.isfinite(y).all()
    assert bool((y[1, -3:] == 0).all())
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("kv", ["q4_0", "q8_0+q4_0"])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_mla_prefill_tensor_cores_odd_rows(cuda, kv, qdt):
    """Widths that are not multiples of 16 (R = 48, Dr = 14: a q4_0 rope
    row is 7 bytes, copied byte by byte) and a page size of 5."""
    rng = np.random.default_rng(len(kv) + (qdt == torch.float32))
    b, c, h, r, dr, page_size, n_lp = 2, 9, 5, 48, 14, 5, 8
    live = [33, 12]
    ckv, kr, bt = (torch.from_numpy(a).to(cuda) for a in _latent_pools(
        rng, b, n_lp, page_size, r, dr, [page_size * n_lp] * b))
    qpos = torch.stack([torch.arange(x - c, x) for x in live]).to(
        torch.int32)
    qpos[1, -2:] = -1
    qpos = qpos.to(cuda)
    q_eff = torch.from_numpy(_np(rng, (b, c, h, r))).to(cuda).to(qdt)
    q_rope = torch.from_numpy(_np(rng, (b, c, h, dr))).to(cuda).to(qdt)
    modes = MLA_KV[kv]
    pools = _mla_quant_pools(ckv, kr, modes)
    counter = paged_attn.paged_mla_prefill_quant.loaders[modes]
    before = counter.launches
    y = paged_attn.paged_mla_prefill_quant(
        q_eff, q_rope, *pools, bt, qpos, scale=0.1, active_pages=7,
        latent_mode=modes[0], rope_mode=modes[1])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = paged_attn.mla_prefill_plain(q_eff, q_rope, pools, bt, qpos,
                                       scale=0.1, nj=7, quant=modes)
    assert bool((y[1, -2:] == 0).all())
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_model_on_card_matches_cpu(cuda, kv_quant):
    """qwen2-1.5b reduced, DQ3_K_M, f32: a prefill chunk and two decode
    steps through the kernels give the CPU's logits (1e-4 of max|logit|;
    q8_0 codes may sit one step apart where the summation order moves a
    value across a rounding boundary, hence 1e-3 there, as
    ``paged.parity_limit`` sets it)."""
    _model_on_card_matches_cpu(cuda, "qwen2-1.5b", kv_quant)


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_deepseek_model_on_card_matches_cpu(cuda, kv_quant):
    """deepseek-v3 reduced (MLA + MoE, all three expert formats), the same
    check as the qwen2 case."""
    _model_on_card_matches_cpu(cuda, "deepseek-v3-671b", kv_quant)


@pytest.mark.parametrize("kv_quant", ["q4_0", "dq"])
@pytest.mark.parametrize("arch,n_layers", [("qwen2-1.5b", 3),
                                           ("deepseek-v3-671b", None)])
def test_q4_model_on_card_matches_cpu(cuda, arch, n_layers, kv_quant):
    """q4_0 and dq pools (qwen2 at 3 layers, so dq packs layer 1; deepseek
    reduced, dq packs the rope keys of layers 1-3): the same check.  A
    q4_0 code apart in the first layer whose codes differ fails it
    (``paged.parity_limit``: a q4_0 step is 18x a q8_0 step, and its
    effect on the logits is not bounded)."""
    _model_on_card_matches_cpu(cuda, arch, kv_quant, n_layers=n_layers)


def test_paged_kernels_raise_on_what_they_do_not_take(cuda):
    """Packed widths that do not match the queries, a decode head width
    that is not a multiple of 8, and an MLA mode pair no kernel
    instantiates (q4_0 latent beside q8_0 rope), raise before any
    launch."""
    z = torch.zeros((4, 2, 2, 8), dtype=torch.int8, device=cuda)
    d = torch.zeros((4, 2, 2), device=cuda)
    idx = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    pos_pool = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="wide"):
        paged_attn.paged_attn_decode_quant(
            torch.zeros(1, 4, 8, device=cuda), z, d, z, d, pos_pool, idx,
            one, mode="q4_0")
    # the decode kernel takes head widths that are multiples of 8
    k12 = torch.zeros((4, 2, 2, 12), device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        paged_attn.paged_attn_decode(torch.zeros(1, 4, 12, device=cuda), k12,
                                     k12, pos_pool, idx, one)
    lat = torch.zeros((4, 2, 16), dtype=torch.int8, device=cuda)
    sc = torch.zeros((4, 2), device=cuda)
    with pytest.raises(ValueError, match="no MLA kernel"):
        paged_attn.paged_mla_decode_quant(
            torch.zeros(1, 2, 32, device=cuda),
            torch.zeros(1, 2, 16, device=cuda), lat, sc, lat, sc, idx, one,
            scale=1.0, latent_mode="q4_0", rope_mode="q8_0")


@pytest.mark.parametrize("policy", ["Q4_K_M", "Q3_K_M", "Q2_K_L",
                                    "UD_Q2_K_XL", "Q8_0"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_policy_model_on_card_matches_cpu(cuda, arch, policy):
    """The paper's other policies (q4_k, q6_k, q5_k, q2_k and q8_0 weights
    through B1), model-dtype pools, the same check as the DQ3_K_M cases."""
    _model_on_card_matches_cpu(cuda, arch, None, policy)


def _model_on_card_matches_cpu(cuda, arch, kv_quant, policy="DQ3_K_M",
                               n_layers=None):
    cfg = get_config(arch).reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_quantized_params(cfg, get_policy(policy), 0,
                                   dtype=torch.float32, device=cuda)
    model = Model(cfg, dtype=torch.float32)
    P, max_len, b, c = 4, 32, 2, 6
    n = paged.pages_for(max_len, P)
    bt = torch.tensor([[2 + i * n + j for j in range(n)] for i in range(b)],
                      dtype=torch.int32)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab_size, (b, c)).astype(
        np.int32))
    dec = torch.from_numpy(rng.integers(4, cfg.vocab_size, (2, b)).astype(
        np.int32))
    out, caches = {}, {}
    for dev, prm in ((cuda, params), (torch.device("cpu"),
                                      tree_to(params, "cpu"))):
        cache = model.init_paged_cache(2 + b * n, P, b, dtype=torch.float32,
                                       kv_quant=kv_quant, device=dev)
        tables = {"full": bt.to(dev)}
        clen = torch.tensor([c, c - 2], dtype=torch.int32, device=dev)
        lg, cache = model.prefill_chunk(
            prm, cache, toks.to(dev), torch.zeros(b, dtype=torch.int32,
                                                  device=dev), clen,
            max_len=max_len, block_tables=tables, kv_quant=kv_quant)
        steps = [lg]
        pos = clen.clone()
        for i in range(2):
            lg, cache = model.decode_step_paged(
                prm, cache, dec[i].to(dev), pos, tables, page_size=P,
                max_len=max_len, kv_quant=kv_quant,
                lane_pages={"full": (pos // P + 1).to(torch.int32)})
            steps.append(lg)
            pos = pos + 1
        out[dev.type] = torch.stack(steps).cpu()
        caches[dev.type] = {k: v.cpu() for k, v in cache.items()}
    a, r = out["cuda"], out["cpu"]
    tol, _ = paged.parity_limit(cfg, kv_quant, caches["cuda"], caches["cpu"],
                                exact=1e-4, stepped=1e-3)
    assert torch.isfinite(a).all()
    assert (a - r).abs().max() <= tol * r.abs().max()


# the 2-D weights of deepseek-r1-distill-qwen-32b, qwen2-72b, phi3-mini-3.8b
# and llama4-scout-17b-a16e (their DQ3_K_M formats, and Q4_K_M's q4_k k/v
# of distill-32B), and qwen2-72b's down (K = 29568, 115.5 superblocks) in
# every format
MODEL_SHAPES = [("q4_k", 5120, 5120), ("q6_k", 5120, 1024),
                ("q4_k", 5120, 1024), ("q4_k", 5120, 27648),
                ("q6_k", 27648, 5120), ("q6_k", 5120, 152064),
                ("q4_k", 8192, 8192), ("q6_k", 8192, 1024),
                ("q4_k", 8192, 29568), ("q6_k", 8192, 152064),
                ("q4_k", 3072, 3072), ("q6_k", 3072, 3072),
                ("q4_k", 3072, 8192), ("q6_k", 8192, 3072),
                ("q6_k", 3072, 32256), ("q4_k", 5120, 8192),
                ("q6_k", 8192, 5120), ("q6_k", 5120, 202240)] + [
    (fmt, 29568, 8192) for fmt in ("q4_k", "q6_k", "q3_k", "q5_k", "q2_k",
                                   "q8_0")]


@pytest.mark.parametrize("fmt,k,n", MODEL_SHAPES,
                         ids=[f"{f}-{k}-{n}" for f, k, n in MODEL_SHAPES])
@pytest.mark.parametrize("m", [1, 4, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_served_model_shapes(cuda, fmt, k, n, m, dtype):
    """Every 2-D weight shape of the four other full-attention models, and
    the ragged K = 29568 in all six formats, at a decode step's 1 and 4
    rows (the decode form) and a chunk's 512 (the prefill form): one
    launch of the form a call and no other's, two calls bitwise equal,
    within B1's limits of the plain version, a zero row +0."""
    qt = _decode_weight(fmt, k, n, cuda)
    rng = np.random.default_rng(m * 13 + k + n)
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda)
    zero = [m - 2] if m > 1 else []
    x[zero] = 0
    x = x.to(dtype)
    kern = qmatmul.KERNELS[fmt]
    form = "decode" if m <= 4 else "prefill"
    counts = {w: qmatmul.library_launches(fmt, w)
              for w in ("decode", "prefill", "experts")}
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert {w: qmatmul.library_launches(fmt, w) - c
            for w, c in counts.items()} == {
        w: 2 if w == form else 0 for w in counts}
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else B1_TOL_BF16
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    assert not y[zero].view(bits).any()


@functools.cache
def _expert_weight(fmt, e, k, n, device):
    rng = np.random.default_rng(e + k + n + len(fmt))
    return quantize(torch.from_numpy(rng.standard_normal(
        (e, k, n), dtype=np.float32)).to(device), fmt)


@pytest.mark.parametrize("fmt,k,n", [("q3_k", 5120, 8192),
                                     ("q3_k", 8192, 5120),
                                     ("q4_k", 8192, 5120),
                                     ("q6_k", 8192, 5120)])
@pytest.mark.parametrize("c,live", [(1, 16), (1, 4), (40, 16)],
                         ids=["c1", "c1-4-live", "c40"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_experts_llama4_scout(cuda, fmt, k, n, c, live, dtype):
    """llama4-scout's expert weights under DQ3_K_M, E = 16, in one launch
    of qmatmul_experts_kernel: C = 1 (a decode step; all live, and the 4
    of a 4-lane top-1 step, the rest zero) and C = 40 (a 4 x 128 chunk's
    capacity, two 20-row tiles); empty experts +0 bitwise, live rows
    within the tolerance."""
    e = 16
    qt = _expert_weight(fmt, e, k, n, cuda)
    rng = np.random.default_rng(c * 7 + live + k)
    on = sorted(rng.choice(e, live, replace=False).tolist())
    x = torch.zeros((e, c, k), device=cuda)
    x[on] = torch.from_numpy(_np(rng, (live, c, k))).to(cuda)
    x = x.to(dtype)
    kern = qmatmul.EXPERT_KERNELS[fmt]
    own = qmatmul.library_launches(fmt)
    y = kern(x, qt)
    torch.cuda.synchronize()
    assert qmatmul.library_launches(fmt) == own + 1
    ref = qmatmul.qmatmul_plain(x, qt)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    empty = [i for i in range(e) if i not in on]
    assert torch.equal(y[empty].view(bits), ref[empty].view(bits))
    tol = TOL if dtype == torch.float32 else 2 ** -8
    err = (y[on].float() - ref[on].float()).abs().max()
    assert err <= tol * ref.float().abs().max()


# the served models' attention: (H, Hkv, D) of distill-32B and llama4
# (group 5), qwen2-72b (group 8) and phi3 (a group of 1, head_dim 96), at
# 4 lanes of 16-token pages in a 64-page table, as the engine serves them
SERVED_ATTN = [(40, 8, 128), (64, 8, 128), (32, 32, 96)]


def _served_lanes(rng, hkv, d, cuda):
    live = [100, 217, 333, 400]
    k, v, pos_pool, bt = (torch.from_numpy(a).to(cuda) for a in _pools(
        rng, 4, 64, 16, hkv, d, live))
    return live, k, v, pos_pool, bt


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("h,hkv,d", SERVED_ATTN,
                         ids=[f"{h}-{g}-{d}" for h, g, d in SERVED_ATTN])
def test_paged_decode_served_heads(cuda, kv, h, hkv, d):
    """The GQA decode (B2, B3, B5a) at the served models' heads: one
    launch, the plain version's result within 1e-5."""
    rng = np.random.default_rng(h + hkv + d)
    live, k, v, pos_pool, bt = _served_lanes(rng, hkv, d, cuda)
    pos = torch.tensor([x - 1 for x in live], dtype=torch.int32, device=cuda)
    lp = torch.tensor([-(-x // 16) for x in live], dtype=torch.int32,
                      device=cuda)
    q = torch.from_numpy(_np(rng, (4, h, d))).to(cuda)
    kw = dict(active_pages=32, lane_pages=lp)
    if kv in QUANTIZE:
        pools = (*QUANTIZE[kv](k), *QUANTIZE[kv](v))
        fn = paged_attn.paged_attn_decode_quant
        counter = fn.loaders[kv]
        kw["mode"] = kv
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        pools = (k.to(dt), v.to(dt))
        fn = counter = paged_attn.paged_attn_decode
    before = counter.launches
    y = fn(q, *pools, pos_pool, bt, pos, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = paged_attn.attn_decode_plain(
        q, pools, pos_pool, bt, pos, lp, window=0, softcap=0.0,
        scale=d ** -0.5, nj=32, quant=kv if kv in QUANTIZE else None)
    assert y.shape == (4, h, d)
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("mode", ["q8_0", "q4_0"])
@pytest.mark.parametrize("h,hkv,d", SERVED_ATTN,
                         ids=[f"{h}-{g}-{d}" for h, g, d in SERVED_ATTN])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_prefill_served_heads(cuda, mode, h, hkv, d, qdt):
    """The GQA chunk prefill (B4, B5b) at the served models' heads: a
    128-token chunk a lane ending at its frontier, lane 0's short (padded
    rows give zeros); one launch, the plain version's result within
    1e-5."""
    rng = np.random.default_rng(h + hkv + d + 1)
    live, k, v, pos_pool, bt = _served_lanes(rng, hkv, d, cuda)
    c = 128
    qpos = torch.stack([torch.arange(x - c, x) for x in live]).to(
        torch.int32)
    qpos[0, :c - 60] = -1
    qpos = qpos.to(cuda)
    q = torch.from_numpy(_np(rng, (4, c, h, d))).to(cuda).to(qdt)
    pools = (*QUANTIZE[mode](k), *QUANTIZE[mode](v))
    counter = paged_attn.paged_attn_prefill_quant.loaders[mode]
    before = counter.launches
    y = paged_attn.paged_attn_prefill_quant(q, *pools, pos_pool, bt, qpos,
                                            mode=mode)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = paged_attn.attn_prefill_plain(
        q, pools, pos_pool, bt, qpos, window=0, softcap=0.0,
        scale=d ** -0.5, nj=64, quant=mode)
    assert y.shape == (4, c, h, d) and torch.isfinite(y).all()
    assert bool((y[0, :c - 60] == 0).all())
    assert (y - ref).abs().max() < TOL


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
@pytest.mark.parametrize("arch", ["deepseek-r1-distill-qwen-32b",
                                  "qwen2-72b", "phi3-mini-3.8b",
                                  "llama4-scout-17b-a16e"])
def test_served_model_on_card_matches_cpu(cuda, arch, kv_quant):
    """The four other full-attention models, reduced, DQ3_K_M: the same
    check as the qwen2 case."""
    _model_on_card_matches_cpu(cuda, arch, kv_quant)


# -- the preempt scheduler's swap and the fault plane's poison --------------

POOL_KINDS = [None, "q8_0", "q4_0", "dq"]


@pytest.mark.parametrize("kv_quant", POOL_KINDS)
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_extract_inject_pages_on_card(cuda, arch, kv_quant):
    """Every leaf kind of both families (bf16 payloads, int8 codes and f32
    scales of q8_0 and nibble-packed q4_0, ``pos`` rows, MLA latent and
    rope leaves): a lane's pages out to the host and back in at other ids,
    as a swap moves them, byte for byte."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, dtype=torch.bfloat16)
    cache = model.init_paged_cache(12, 4, 2, dtype=torch.bfloat16,
                                   kv_quant=kv_quant, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for v in cache.values():
        b = v.view(torch.uint8)
        b.copy_(torch.randint(0, 256, b.shape, dtype=torch.uint8,
                              device=cuda, generator=gen))
    src, dst = [5, 2, 3, 9], [4, 6, 7, 11]
    for k, v in cache.items():
        rows = paged.extract_pages(v, src).cpu()
        twin = torch.zeros_like(v)
        paged.inject_pages(twin, dst, rows)
        assert torch.equal(twin[dst].view(torch.uint8),
                           v[src].view(torch.uint8)), k
        rest = [i for i in range(12) if i not in dst]
        assert not twin[rest].view(torch.uint8).any(), k


def _poison(cache, page):
    """``corrupt_page``'s fill: +inf in float leaves, the dtype max in
    integer ones (the scales of q8_0/q4_0 pages carry the inf)."""
    for k, v in cache.items():
        if k.endswith("/pos"):
            continue
        v[page] = (float("inf") if v.dtype.is_floating_point
                   else torch.iinfo(v.dtype).max)


@pytest.mark.parametrize("kv_quant", POOL_KINDS)
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_poisoned_page_reaches_only_its_lane(cuda, arch, kv_quant):
    """A poisoned page of lane 1 turns lane 1's logits non-finite through
    the prefill kernel (a second chunk attends the page) and the decode
    kernel, and no other lane's: theirs equal an unpoisoned run's.  (The
    split merge's ``fmaxf`` drops a NaN maximum; the NaN must still reach
    the lane's sums.)"""
    cfg = get_config(arch).reduced()
    params = init_quantized_params(cfg, get_policy("DQ3_K_M"), 0,
                                   dtype=torch.bfloat16, device=cuda)
    model = Model(cfg, dtype=torch.bfloat16)
    P, max_len, b, c = 4, 32, 3, 6
    n = paged.pages_for(max_len, P)
    bt = torch.tensor([[2 + i * n + j for j in range(n)] for i in range(b)],
                      dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab_size, (2, b, c)).astype(
        np.int32)).to(cuda)
    dec = torch.from_numpy(rng.integers(4, cfg.vocab_size, b).astype(
        np.int32)).to(cuda)
    out = []
    for poison in (False, True):
        cache = model.init_paged_cache(2 + b * n, P, b, dtype=torch.bfloat16,
                                       kv_quant=kv_quant, device=cuda)
        tables = {"full": bt}
        clen = torch.full((b,), c, dtype=torch.int32, device=cuda)
        zero = torch.zeros(b, dtype=torch.int32, device=cuda)
        _, cache = model.prefill_chunk(params, cache, toks[0], zero, clen,
                                       max_len=max_len, block_tables=tables,
                                       kv_quant=kv_quant)
        if poison:
            _poison(cache, int(bt[1, 0]))
        lg1, cache = model.prefill_chunk(params, cache, toks[1], clen, clen,
                                         max_len=max_len, block_tables=tables,
                                         kv_quant=kv_quant)
        lg2, cache = model.decode_step_paged(
            params, cache, dec, 2 * clen, tables, page_size=P,
            max_len=max_len, kv_quant=kv_quant,
            lane_pages={"full": (2 * clen // P + 1).to(torch.int32)})
        out.append(torch.stack([lg1, lg2]).float().cpu())
    clean, bad = out
    assert torch.isfinite(clean).all()
    finite = torch.isfinite(bad).all(dim=-1)        # (2, b)
    assert finite[:, 1].logical_not().all(), finite
    assert finite[:, [0, 2]].all(), finite
    assert torch.equal(bad[:, [0, 2]], clean[:, [0, 2]])


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_preempt_serve_on_card(cuda, kv_quant):
    """qwen2 reduced on an oversubscribed pool: lanes are evicted and
    swapped back in through the card's pools, the swap bytes balance, no
    page leaks, every request completes."""
    from repro_torch.serving import Engine, SamplerConfig
    from repro_torch.serving.engine import Request

    cfg = get_config("qwen2-1.5b").reduced()
    params = init_quantized_params(cfg, get_policy("DQ3_K_M"), 0,
                                   dtype=torch.bfloat16, device=cuda)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
                4, cfg.vocab_size, int(rng.integers(6, 14)))],
                    max_new=8, priority=i % 3) for i in range(6)]
    eng = Engine(Model(cfg, dtype=torch.bfloat16), params, device=cuda,
                 max_len=48, page_size=4, kv_quant=kv_quant,
                 scheduler="preempt", num_pages=12,
                 sampler=SamplerConfig(greedy=True))
    done = eng.serve(reqs, slots=4)
    st = eng.last_stats
    assert all(r.status == "ok" and len(r.out) == 8 for r in done)
    assert st.preemptions >= 2 and st.swap_in_bytes > 0
    assert st.swap_out_bytes == st.swap_in_bytes + st.swap_dropped_bytes
    assert st.pages_leaked == 0 and st.swap_held_end_bytes == 0


# -- the one-shot forward's shapes (2 x 1024 tokens) and the dense cache -----

# the 2-D weights of qwen2-1.5b and the DeepSeek-V3 cut that the forward
# multiplies at M = B x T rows, each format taken there at these shapes
FORWARD_SHAPES = [(1536, 8960, "qwen2 gate, up"), (8960, 1536, "qwen2 down"),
                  (1536, 256, "qwen2 k_proj, v_proj"),
                  (7168, 18432, "DeepSeek dense gate, up"),
                  (16384, 7168, "DeepSeek attn_output"),
                  (7168, 576, "DeepSeek attn_kv_a_mqa")]
# the output heads over every row of the forward, in their DQ3_K_M formats
FORWARD_HEADS = [("q4_k", 1536, 152064), ("q6_k", 7168, 129280)]


@functools.cache
def _dense_weight(fmt, k, n, device):
    rng = np.random.default_rng(k + 3 * n + len(fmt))
    return quantize(torch.from_numpy(rng.standard_normal(
        (k, n), dtype=np.float32) / np.sqrt(k)).to(device), fmt)


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q3_k", "q5_k", "q2_k",
                                 "q8_0"])
@pytest.mark.parametrize("k,n", [s[:2] for s in FORWARD_SHAPES],
                         ids=[f"{k}-{n}" for k, n, _ in FORWARD_SHAPES])
@pytest.mark.parametrize("m", [2000, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_prefill_form_forward_rows(cuda, fmt, k, n, m, dtype):
    """The prefill form at the one-shot forward's rows: 2 x 1024 (128-row
    tiles, the cluster split ``prefill_ksplit`` takes there) and a ragged
    2000 (the last tile 80 rows); one launch of it a call, two calls
    bitwise equal, within B1's limits of the plain version, zero rows
    +0."""
    qt = _dense_weight(fmt, k, n, cuda)
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(_np(rng, (m, k))).to(cuda)
    zero = [3, m - 1]
    x[zero] = 0
    x = x.to(dtype)
    kern = qmatmul.KERNELS[fmt]
    counts = {w: qmatmul.library_launches(fmt, w)
              for w in ("decode", "prefill", "experts")}
    y = kern(x, qt)
    y2 = kern(x, qt)
    torch.cuda.synchronize()
    assert {w: qmatmul.library_launches(fmt, w) - c
            for w, c in counts.items()} == {
        "decode": 0, "prefill": 2, "experts": 0}
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), y2.view(bits))
    ref = qmatmul.qmatmul_plain(x, qt).float()
    tol = TOL if dtype == torch.float32 else B1_TOL_BF16
    assert (y.float() - ref).abs().max() <= tol * ref.abs().max()
    assert not y[zero].view(bits).any()


@pytest.mark.parametrize("fmt,k,n", FORWARD_HEADS,
                         ids=[f"{f}-{k}-{n}" for f, k, n in FORWARD_HEADS])
def test_qmatmul_prefill_form_forward_heads(cuda, fmt, k, n):
    """The output heads at 2 x 1024 bf16 rows (the loss's logits): the
    prefill form within B1_TOL_BF16 of the plain version."""
    qt = _dense_weight(fmt, k, n, cuda)
    x = torch.from_numpy(_np(np.random.default_rng(k), (2048, k))).to(
        cuda).to(torch.bfloat16)
    before = qmatmul.library_launches(fmt, "prefill")
    y = qmatmul.KERNELS[fmt](x, qt)
    torch.cuda.synchronize()
    assert qmatmul.library_launches(fmt, "prefill") == before + 1
    ref = qmatmul.qmatmul_plain(x, qt).float()
    assert (y.float() - ref).abs().max() <= B1_TOL_BF16 * ref.abs().max()


@functools.cache
def _deepseek_experts(fmt, k, n, device):
    from repro_torch.core.apply import quantize_in_groups
    gen = torch.Generator(device=device).manual_seed(k + n + len(fmt))
    return quantize_in_groups(
        lambda r: torch.randn((len(r), k, n), generator=gen,
                              device=device) / np.sqrt(k),
        256, fmt, group=16, dim=0)


@pytest.mark.parametrize("fmt,k,n", [("q3_k", 7168, 2048),
                                     ("q4_k", 2048, 7168),
                                     ("q6_k", 2048, 7168),
                                     ("q2_k", 7168, 2048),
                                     ("q8_0", 7168, 2048)],
                         ids=["q3_k-gate", "q4_k-down", "q6_k-down",
                              "q2_k-gate", "q8_0-gate"])
@pytest.mark.parametrize("c", [78, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qmatmul_experts_forward_capacity(cuda, fmt, k, n, c, dtype):
    """DeepSeek's expert weights (E = 256) at the forward's capacity, C =
    1.25 x 2048 x 8 / 256 = 80 (four 20-row tiles), and a ragged 78: one
    launch of qmatmul_experts_kernel, 5 experts empty and +0 bitwise, the
    rest within the tolerance of the plain version (bf16: B1_TOL_BF16, one
    step of the top binade: the row tiles sum in another order than the
    plain version, and 2^-8 of max|y| is less than a step where max|y|
    lies low in its binade)."""
    e = 256
    qt = _deepseek_experts(fmt, k, n, cuda)
    gen = torch.Generator(device=cuda).manual_seed(c + k)
    x = torch.randn((e, c, k), generator=gen, device=cuda)
    empty = [0, 17, 100, 101, 255]
    x[empty] = 0
    x[5, c - 3:] = 0                   # a partly filled expert
    x = x.to(dtype)
    kern = qmatmul.EXPERT_KERNELS[fmt]
    own = qmatmul.library_launches(fmt)
    y = kern(x, qt)
    torch.cuda.synchronize()
    assert qmatmul.library_launches(fmt) == own + 1
    assert y.shape == (e, c, n) and y.dtype == dtype
    ref = qmatmul.qmatmul_plain(x, qt)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y[empty].view(bits), ref[empty].view(bits))
    assert not y[5, c - 3:].view(bits).any()
    tol = TOL if dtype == torch.float32 else B1_TOL_BF16
    assert (y.float() - ref.float()).abs().max() <= (
        tol * ref.float().abs().max())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_dense_decode_masked_write_on_card(cuda, arch):
    """The dense layout on the card (reduced, DQ3_K_M, f32): a prefill of
    two right-padded prompts and three decode steps with lane 1 not live;
    lane 1's cache rows stay bitwise as the prefill wrote them, lane 0's
    take each step, and the logits are the CPU's within 1e-4 of
    max|logit|."""
    cfg = get_config(arch).reduced()
    params = init_quantized_params(cfg, get_policy("DQ3_K_M"), 0,
                                   dtype=torch.float32, device=cuda)
    model = Model(cfg, dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab_size, (2, 9)).astype(
        np.int32))
    dec = torch.from_numpy(rng.integers(4, cfg.vocab_size, (3, 2)).astype(
        np.int32))
    lengths = torch.tensor([9, 6], dtype=torch.int32)
    live = torch.tensor([True, False])
    out = {}
    for dev, prm in ((cuda, params), (torch.device("cpu"),
                                      tree_to(params, "cpu"))):
        last, cache = model.prefill(prm, {"tokens": toks.to(dev)}, 24,
                                    lengths=lengths.to(dev))
        before = {k: v.clone() for k, v in cache.items()}
        steps = [last[:, 0]]
        pos = lengths.to(dev)
        for tok in dec:
            lg, cache = model.decode_step(prm, cache, tok.to(dev), pos,
                                          live=live.to(dev))
            steps.append(lg)
            pos = pos + 1
        for k, v in cache.items():
            assert torch.equal(v[1], before[k][1]), k
            assert not torch.equal(v[0, 9:12], before[k][0, 9:12]), k
        out[dev.type] = torch.stack(steps).cpu()
    a, r = out["cuda"], out["cpu"]
    assert torch.isfinite(a).all()
    assert (a - r).abs().max() <= 1e-4 * r.abs().max()
