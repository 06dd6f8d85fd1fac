"""The port's kernel modules against the JAX reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
build and run only on the card: ``python3 chip_smoke.py`` and the
``gpu``-marked tests of ``tests/test_torch_gpu.py`` hold them against
these same plain versions there).  The reference's Pallas kernels run as
its own tests run them, ``impl="pallas"`` in interpret mode.

Tolerances: 1e-5 (absolute, on O(1)-scaled f32 outputs) everywhere — both
sides are f32; only the summation order and the online-softmax folding
differ.  Quantizers (``quantize_kv_page_pool``) and the column gather are
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jax_quantize
from repro.kernels import ops as jax_ops
from repro.kernels import paged_attn as jax_pa

from repro_torch.convert import from_jax_params
from repro_torch.core.formats import FORMATS
from repro_torch.core.qtensor import QTensor, quantize
from repro_torch.kernels import build, ops, paged_attn, qmatmul
from repro_torch.models import paged
from bf16_terms import bf16_terms
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _qt_pair(fmt, k, n, seed):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    jq = jax_quantize(jnp.asarray(w), fmt)
    tq = from_jax_params({"w": {"fmt": jq.fmt, "shape": jq.shape, "fields": {
        a: np.asarray(b) for a, b in jq.fields.items()}}})["w"]
    return jq, tq


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q5_k", "q2_k", "q8_0"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (4, 512, 256),
                                   (8, 300, 128), (13, 768, 128)])
def test_qmatmul_plain_matches_pallas(fmt, m, k, n):
    """Plain B1 vs the reference's fused Pallas kernel (interpret mode), in
    f32, including K that is not a multiple of the superblock (K = 300 is
    10 q8_0 blocks: a last 256-row tile with 2 of its 8 blocks)."""
    jq, tq = _qt_pair(fmt, k, n, seed=m * 1000 + k)
    x = np.random.default_rng(k + n).normal(size=(m, k)).astype(np.float32)
    ref = np.asarray(jax_ops.qmatmul(jnp.asarray(x), jq, impl="pallas"))
    before = qmatmul.KERNELS[fmt].launches
    got = ops.qmatmul(torch.from_numpy(x), tq)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # CPU tensors take the plain version: no kernel launch is counted
    assert qmatmul.KERNELS[fmt].launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


def test_qmatmul_bf16_rows_and_leading_dims():
    jq, tq = _qt_pair("q4_k", 512, 128, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 3, 512)).astype(np.float32)
    y = ops.qmatmul(torch.from_numpy(x).to(torch.bfloat16), tq)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3, 128)
    ref = np.asarray(jax_ops.qmatmul(
        jnp.asarray(x).astype(jnp.bfloat16), jq, impl="pallas"),
        np.float32)
    # bf16 output: both round an f32 accumulator to bf16 (1 ulp = 2^-8)
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(ref).max())


def test_qmatmul_rejects_unported_weights():
    """Every packed format has B1; what is not a packed (K, N) or
    (E, K, N) weight raises."""
    w = torch.randn(256, 128)
    with pytest.raises(ValueError, match="packed"):
        ops.qmatmul(torch.randn(4, 256), QTensor({"w": w}, "bf16", w.shape))
    with pytest.raises(ValueError, match=r"\(K, N\) or \(E, K, N\)"):
        ops.qmatmul(torch.randn(2, 2, 4, 256),
                    quantize(torch.randn(2, 2, 256, 128), "q8_0"))


def test_qmatmul_builds_one_library_per_format():
    """csrc/qmatmul.cu is compiled once per format; each wrapper binds the
    library built for its own format id."""
    for fmt, fid in qmatmul._FMT_ID.items():
        assert build.LIBRARIES[f"qmatmul_{fmt}"] == (
            "qmatmul", (f"-DQMATMUL_FMT={fid}",))
    assert sorted(qmatmul._FMT_ID.values()) == list(range(len(
        qmatmul.FIELDS)))
    assert set(qmatmul.KERNELS) == set(qmatmul.EXPERT_KERNELS) == set(
        qmatmul.FIELDS)


def _q4k_factored(x, fields, ks):
    """q4_k's decode form written out (``qmatmul_q4k_decode_kernel``): a
    code as 0.5 + q/32, the sums of x per 32-element sub-block, y = sum_sb
    (32 d sum_sub sc (sum x (0.5 + q/32) - sum x / 2) - dmin sum_sub m sum
    x), and the superblocks split over ``ks`` blocks whose sums are added
    in rank order.  x (M, K) f32; zeros past K."""
    qs, sc, mn, d, dmin = (fields[n].to(torch.float32) if n in ("d", "dmin")
                           else fields[n].to(torch.int32)
                           for n in qmatmul.FIELDS["q4_k"])
    s_blocks, _, n = qs.shape
    m, k = x.shape
    xp = torch.zeros(m, s_blocks * 256)
    xp[:, :k] = x
    xs = xp.reshape(m, s_blocks, 8, 32)
    # sub-block j: the low nibbles of byte rows 32 j .. (j < 4), the high
    # ones of rows 32 (j - 4) .. (j >= 4)
    codes = torch.cat([qs & 15, qs >> 4], dim=1).reshape(s_blocks, 8, 32, n)
    part = torch.einsum("msji,sjin->msjn", xs,
                        0.5 + codes.to(torch.float32) / 32)
    xsum = xs.sum(-1)[..., None]
    a1 = (sc.to(torch.float32) * (part - 0.5 * xsum)).sum(2)
    a2 = (mn.to(torch.float32) * xsum).sum(2)
    per_sb = 32 * d * a1 - dmin * a2                       # (M, S, N)
    out = torch.zeros(m, n)
    for r in range(ks):                                    # rank order
        out = out + per_sb[:, s_blocks * r // ks:
                           s_blocks * (r + 1) // ks].sum(1)
    return out


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_q4k_factored_decode_matches_pallas(m):
    """The factored sum and the K-split merge of q4_k's decode form, with
    a ragged K (700: the last superblock holds 188 rows) and 1, 2 and 3
    blocks along K, against the reference's fused Pallas kernel
    (interpret mode) within 1e-5 of max|y|; the wrapper sizes the split
    from host integers, at most 8 blocks and the superblocks."""
    k, n = 700, 256
    jq, tq = _qt_pair("q4_k", k, n, seed=m + 40)
    x = np.random.default_rng(m + 50).normal(size=(m, k)).astype(np.float32)
    ref = np.asarray(jax_ops.qmatmul(jnp.asarray(x), jq, impl="pallas"))
    for ks in (1, 2, 3):
        got = _q4k_factored(torch.from_numpy(x), tq.fields, ks).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=TOL * np.abs(ref).max())
    assert qmatmul.decode_form("q4_k", 1, m, k)
    assert not qmatmul.decode_form("q4_k", 1, 5, k)
    assert qmatmul.decode_form("q6_k", 1, m, k)
    assert not qmatmul.decode_form("q4_k", 8, m, k)
    for kk, nn in ((700, 256), (1536, 8960), (7168, 18432), (65536, 7168)):
        s = -(-kk // 256)
        ks = qmatmul.decode_ksplit(nn, kk, 132)
        assert 1 <= ks <= min(8, s) and -(-s // ks) <= 32


def _mma_decode(x, fields, fmt, ks):
    """The tensor-core decode form written out
    (``qmatmul_mma_decode_kernel``).  q6_k, q3_k, q5_k, q2_k: per
    16-element piece and column, the exact products of bf16 x terms (one
    for bf16 x, three for f32) and the codes (q6_k q - 32; q3_k q - 4, q a
    bit-pair of qs and a bit of hmask; q5_k q, a nibble of qs and a bit of
    qh; q2_k q, a bit-pair of qs), summed (the tensor core; f64 here) and
    rounded to f32, scaled by the piece's scale (q6_k's and q3_k's int8
    sub-block scale; q5_k the u8 scale of its 32-element sub-block, the
    piece's index halved; q2_k the low nibble of sm) and summed over the
    four pieces a warp takes (j, j + 4, j + 8, j + 12), times the
    superblock's d into the warp's accumulator; q2_k also less dmin times
    the sum over those pieces of m (sm's high nibble) times the piece's sum
    of x (the x terms' sum, f64 here, f32 shuffles on the card).  q5_k's
    min term is taken apart from the warps: per superblock and half h of
    its eight 32-element sub-blocks (4h .. 4h + 3), dmin times the sum of
    the u8 min times x's f32 sum over the sub-block, added over the
    block's superblocks; the block's sum is the warps' less both halves.
    q8_0: per 32-element block and column the products summed (f64) and
    rounded to f32, times the block's d into the accumulator of warp ``b %
    4`` (a stage holds 4 blocks; none past the field's last).  The four
    warps' sums are added in order, and the stages (a superblock; 4 q8_0
    blocks) split over ``ks`` blocks whose sums are added in rank order.
    (The card's q3_k and q2_k codes carry a factor 2^q3_shift(p) that their
    scale takes back exactly: no value changes.)  x (M, K), zeros past K."""
    f = {a: fields[a] for a in qmatmul.FIELDS[fmt]}
    m, k = x.shape
    nt = 3 if x.dtype == torch.float32 else 1
    if fmt == "q8_0":
        nblk, _, n = f["qs"].shape
        xp = torch.zeros(m, nblk * 32)
        xp[:, :k] = x.to(torch.float32)
        xs = sum(t.to(torch.float64) for t in bf16_terms(xp, nt))
        prod = torch.einsum("mbi,bin->mbn", xs.reshape(m, nblk, 32),
                            f["qs"].to(torch.float64)).to(torch.float32)
        dd = f["d"].to(torch.float32)                      # (S, N)
        stages = -(-nblk // 4)
        out = torch.zeros(m, n)
        for r in range(ks):                                # rank order
            blk = torch.zeros(m, n)
            for j0 in range(4):                            # warp order
                acc = torch.zeros(m, n)
                for st in range(stages * r // ks, stages * (r + 1) // ks):
                    b = 4 * st + j0
                    if b < nblk:
                        acc = acc + dd[b] * prod[:, b]
                blk = blk + acc
            out = out + blk
        return out.to(x.dtype)
    s_blocks, n = f["d"].shape
    e = torch.arange(256)
    mins = None
    if fmt == "q6_k":
        ql, qh = f["ql"].to(torch.int32), f["qh"].to(torch.int32)
        # element e of a superblock: ql row e % 128's nibble e // 128 (row
        # e % 64 + 64 ((e // 64) % 2)), qh row e % 64's bit-pair e // 64
        lo = (ql[:, e % 128] >> (4 * (e // 128))[None, :, None]) & 15
        hi = (qh[:, e % 64] >> (2 * (e // 64))[None, :, None]) & 3
        codes = (lo | (hi << 4)) - 32
        scale = f["scales"].to(torch.float32)              # (S, 16, N)
    elif fmt == "q3_k":
        # element e: qs row e % 64's bit-pair e // 64, hmask row e % 32's
        # bit e // 32
        qs, hm = f["qs"].to(torch.int32), f["hmask"].to(torch.int32)
        lo = (qs[:, e % 64] >> (2 * (e // 64))[None, :, None]) & 3
        hi = (hm[:, e % 32] >> (e // 32)[None, :, None]) & 1
        codes = (lo | (hi << 2)) - 4
        scale = f["scales"].to(torch.float32)
    elif fmt == "q5_k":
        # element e: qs row e % 128's nibble e // 128, qh row e % 32's bit
        # e // 32 above it; piece i (16 elements) takes the scale and min
        # rows i // 2 of its 32-element sub-block
        qs, qh = f["qs"].to(torch.int32), f["qh"].to(torch.int32)
        lo = (qs[:, e % 128] >> (4 * (e // 128))[None, :, None]) & 15
        hi = (qh[:, e % 32] >> (e // 32)[None, :, None]) & 1
        codes = lo | (hi << 4)
        scale = f["scales"].to(torch.float32).repeat_interleave(2, dim=1)
    else:
        # q2_k: element e is qs row e % 64's bit-pair e // 64; sm row i the
        # scale (low nibble) and min (high nibble) of sub-block i
        qs, sm = f["qs"].to(torch.int32), f["sm"].to(torch.int32)
        codes = (qs[:, e % 64] >> (2 * (e // 64))[None, :, None]) & 3
        scale = (sm & 15).to(torch.float32)
        mins = (sm >> 4).to(torch.float64)
    w = codes.to(torch.float64)                            # (S, 256, N)
    xp = torch.zeros(m, s_blocks * 256)
    xp[:, :k] = x.to(torch.float32)
    xs = sum(t.to(torch.float64) for t in bf16_terms(xp, nt)).reshape(
        m, s_blocks, 16, 16)
    prod = torch.einsum("msji,sjin->msjn", xs,
                        w.reshape(s_blocks, 16, 16, n)).to(torch.float32)
    xsum = xs.sum(-1)                                      # (M, S, 16)
    dd = f["d"].to(torch.float32)                          # (S, N)
    out = torch.zeros(m, n)
    for r in range(ks):                                    # rank order
        blk = torch.zeros(m, n)
        own = range(s_blocks * r // ks, s_blocks * (r + 1) // ks)
        for j0 in range(4):                                # warp order
            acc = torch.zeros(m, n)
            for sb in own:
                part = torch.zeros(m, n)
                for p in range(4):
                    i = j0 + 4 * p
                    part = part + scale[sb, i] * prod[:, sb, i]
                acc = acc + dd[sb] * part
                if mins is not None:
                    pmin = sum(mins[sb, j0 + 4 * p] * xsum[:, sb, j0 + 4 * p,
                                                          None]
                               for p in range(4)).to(torch.float32)
                    acc = acc - f["dmin"][sb].to(torch.float32) * pmin
            blk = blk + acc
        if fmt == "q5_k":
            # x's f32 sums over the 32-element sub-blocks (from x itself)
            xs32 = xp.reshape(m, s_blocks, 8, 32).sum(-1)    # (M, S, 8)
            mn = f["mins"].to(torch.float32)                # (S, 8, N)
            dmin = f["dmin"].to(torch.float32)
            pm = [torch.zeros(m, n), torch.zeros(m, n)]
            for sb in own:
                for h in range(2):
                    part = sum(mn[sb, i] * xs32[:, sb, i, None]
                               for i in range(4 * h, 4 * h + 4))
                    pm[h] = pm[h] + dmin[sb] * part
            blk = blk - (pm[0] + pm[1])
        out = out + blk
    return out.to(x.dtype)


def _mma_decode_matches_pallas(fmt, m, dtype, seed):
    """``_mma_decode`` with a ragged K (700: the last superblock holds 188
    rows) split over 1, 2 and 3 blocks and merged in rank order, against
    the reference's fused Pallas kernel (interpret mode): f32 within 1e-5
    of max|y|, bf16 within one bf16 step (2^-8) of max|y|; a zero row of x
    gives +0."""
    k, n = 700, 256
    jq, tq = _qt_pair(fmt, k, n, seed=m + seed)
    x = np.random.default_rng(m + seed + 10).normal(size=(m, k)).astype(
        np.float32)
    if m > 1:
        x[m - 2] = 0
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.to(torch.float32).numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    ref = np.asarray(jax_ops.qmatmul(xj, jq, impl="pallas"), np.float32)
    tol = TOL if dtype == torch.float32 else 2 ** -8
    assert qmatmul.decode_form(fmt, 1, m, k)
    assert not qmatmul.prefill_form(fmt, 1, m, k)
    for ks in (1, 2, 3):
        got = _mma_decode(xt, tq.fields, fmt, ks)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), ref,
                                   rtol=0, atol=tol * np.abs(ref).max())
        if m > 1:
            assert not got[m - 2].to(torch.float32).numpy().view(
                np.int32).any()                            # +0, not -0


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q6k_tensor_core_decode_matches_pallas(m, dtype):
    """The arithmetic of q6_k's tensor-core decode form (bf16 codes, f32
    per-sub-block scales, f32 x as three bf16 terms, the rank-order K
    split) against the Pallas reference (``_mma_decode_matches_pallas``)."""
    _mma_decode_matches_pallas("q6_k", m, dtype, seed=60)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q3k_tensor_core_decode_matches_pallas(m, dtype):
    """The same decode form with q3_k's codes (a bit-pair of qs and a bit
    of hmask, less 4) and int8 scales, against the Pallas reference
    (``_mma_decode_matches_pallas``)."""
    _mma_decode_matches_pallas("q3_k", m, dtype, seed=160)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q2k_tensor_core_decode_matches_pallas(m, dtype):
    """The same decode form with q2_k's codes (a bit-pair of qs), the
    scale of sm's low nibble and the min term (sm's high nibble times the
    sub-block's sum of x), against the Pallas reference
    (``_mma_decode_matches_pallas``)."""
    _mma_decode_matches_pallas("q2_k", m, dtype, seed=260)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q8_0_tensor_core_decode_matches_pallas(m, dtype):
    """The same decode form with q8_0's int8 codes, each 32-element block's
    products scaled once by its d, the blocks in stages of 4 (K = 700 is
    22 blocks: the last stage holds 2), against the Pallas reference
    (``_mma_decode_matches_pallas``)."""
    _mma_decode_matches_pallas("q8_0", m, dtype, seed=360)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q5k_tensor_core_decode_matches_pallas(m, dtype):
    """The same decode form with q5_k's codes (a nibble of qs and a bit of
    qh), each 16-element piece scaled by its 32-element sub-block's u8
    scale and q2_k's min term taken per piece with the sub-block's u8 min,
    against the Pallas reference (``_mma_decode_matches_pallas``)."""
    _mma_decode_matches_pallas("q5_k", m, dtype, seed=460)


# every 2-D q3_k weight the DeepSeek cut multiplies at a decode step (K,
# N): under Q3_K_M attn_kv_a_mqa, attn_q_a, attn_q_b, shared and dense
# gate/up; under Q2_K_L shared down, attn_output and dense down; and the
# CPU tests' (700, 256)
Q3K_DECODE_SHAPES = [(7168, 576), (7168, 1536), (1536, 24576), (7168, 2048),
                     (2048, 7168), (7168, 18432), (16384, 7168),
                     (18432, 7168), (700, 256)]


@pytest.mark.parametrize("k,n", Q3K_DECODE_SHAPES)
def test_q3k_decode_ksplit_from_host_integers(k, n):
    """q3_k's K split, from host integers only: 1..16 blocks (a
    non-portable cluster size), at most the superblocks; about 8/11 of the
    SMs' worth of blocks where the column tiles are at most a quarter of
    the SMs, else 4, 2 or 1 by the superblocks a block keeps; at the
    DeepSeek shapes the fastest split timed on an H100 SXM (PERF.md)."""
    s, tiles = -(-k // 256), -(-n // 128)
    assert qmatmul.decode_form("q3_k", 1, 4, k)
    assert not qmatmul.decode_form("q3_k", 1, 5, k)
    assert not qmatmul.decode_form("q3_k", 2, 1, k)
    for sms in (132, 114, 8):
        ks = qmatmul.decode_ksplit_q3k(n, k, sms)
        assert 1 <= ks <= min(16, s)
        if 4 * tiles <= sms:
            assert ks == min(16, s, max(1, (8 * sms // 11) // tiles))
        else:
            assert ks == min(s, 4 if s >= 16 else
                             2 if s >= 8 and tiles < sms else 1)
    fastest = {(7168, 576): 16, (7168, 1536): 8, (1536, 24576): 1,
               (7168, 2048): 6, (2048, 7168): 2, (7168, 18432): 4,
               (16384, 7168): 4, (18432, 7168): 4}
    if (k, n) in fastest:
        assert qmatmul.decode_ksplit_q3k(n, k, 132) == fastest[k, n]


# every 2-D weight of the DeepSeek cut under Q2_K_L that is q2_k (K, N):
# attn_q_a, attn_q_b, dense gate/up, shared gate/up; and the CPU tests'
Q2K_DECODE_SHAPES = [(7168, 1536), (1536, 24576), (7168, 18432),
                     (7168, 2048), (700, 256)]


@pytest.mark.parametrize("k,n", Q2K_DECODE_SHAPES)
def test_q2k_decode_ksplit_from_host_integers(k, n):
    """q2_k's K split, from host integers only: q3_k's rule (its stage is
    latency-bound as q3_k's is), at the DeepSeek shapes the fastest split
    timed on an H100 SXM (PERF.md)."""
    assert qmatmul.decode_form("q2_k", 1, 4, k)
    assert not qmatmul.decode_form("q2_k", 1, 5, k)
    assert not qmatmul.decode_form("q2_k", 2, 1, k)
    assert not qmatmul.prefill_form("q2_k", 1, 4, k)
    for sms in (132, 114, 8):
        assert (qmatmul.decode_ksplit_q2k(n, k, sms)
                == qmatmul.decode_ksplit_q3k(n, k, sms))
    fastest = {(7168, 1536): 8, (1536, 24576): 1, (7168, 18432): 4,
               (7168, 2048): 6}
    if (k, n) in fastest:
        assert qmatmul.decode_ksplit_q2k(n, k, 132) == fastest[k, n]


# every 2-D weight of the DeepSeek cut under Q8_0 (K, N): attn_q_a,
# attn_q_b, attn_kv_a_mqa, attn_output, dense gate/up and down, shared
# gate/up and down, the output head; and the CPU tests' (22 blocks)
Q8_0_DECODE_SHAPES = [(7168, 1536), (1536, 24576), (7168, 576),
                      (16384, 7168), (7168, 18432), (18432, 7168),
                      (7168, 2048), (2048, 7168), (7168, 129280),
                      (700, 256)]


@pytest.mark.parametrize("k,n", Q8_0_DECODE_SHAPES)
def test_q8_0_decode_ksplit_from_host_integers(k, n):
    """q8_0's K split over its 128-row stages (4 blocks), from host
    integers only: 1..16 blocks, at most the stages; about 8/11 of the SMs'
    worth of blocks where the column tiles are at most a quarter of the
    SMs, else 2, 3 or 1 by the tiles and K; at the DeepSeek shapes the
    fastest split timed on an H100 SXM (PERF.md)."""
    s, tiles = -(-k // 128), -(-n // 128)
    assert qmatmul.decode_stages("q8_0", k) == s
    assert qmatmul.decode_form("q8_0", 1, 4, k)
    assert not qmatmul.decode_form("q8_0", 1, 5, k)
    assert not qmatmul.decode_form("q8_0", 2, 1, k)
    assert not qmatmul.prefill_form("q8_0", 1, 4, k)
    for sms in (132, 114, 8):
        ks = qmatmul.decode_ksplit_q8_0(n, k, sms)
        assert 1 <= ks <= min(16, s)
        if 4 * tiles <= sms:
            want = (8 * sms // 11) // tiles
        elif tiles < sms:
            want = 2
        else:
            want = 3 if tiles < 2 * sms and s >= 32 else 1
        assert ks == max(1, min(16, s, want))
    fastest = {(7168, 1536): 8, (1536, 24576): 1, (7168, 576): 16,
               (16384, 7168): 2, (7168, 18432): 3, (18432, 7168): 2,
               (7168, 2048): 6, (2048, 7168): 2, (7168, 129280): 1}
    if (k, n) in fastest:
        assert qmatmul.decode_ksplit_q8_0(n, k, 132) == fastest[k, n]


# every 2-D q5_k weight a decode step multiplies (K, N): under Q3_K_M the
# DeepSeek cut's dense down and qwen2's down; and the CPU tests' (700, 256)
Q5K_DECODE_SHAPES = [(18432, 7168), (8960, 1536), (700, 256)]


@pytest.mark.parametrize("k,n", Q5K_DECODE_SHAPES)
def test_q5k_decode_ksplit_from_host_integers(k, n):
    """q5_k's K split, from host integers only: q3_k's rule (its stage is
    latency-bound as q3_k's is), 1..16 blocks, at most the superblocks; at
    the served shapes the fastest of the 16 splits timed on an H100 SXM
    (PERF.md)."""
    s = -(-k // 256)
    assert qmatmul.decode_form("q5_k", 1, 4, k)
    assert qmatmul.decode_form("q5_k", 1, 1, k)
    assert not qmatmul.decode_form("q5_k", 1, 5, k)
    assert not qmatmul.decode_form("q5_k", 2, 1, k)
    assert not qmatmul.prefill_form("q5_k", 1, 4, k)
    assert qmatmul.decode_stages("q5_k", k) == s
    for sms in (132, 114, 8):
        ks = qmatmul.decode_ksplit_q5k(n, k, sms)
        assert 1 <= ks <= min(16, s)
        assert ks == qmatmul.decode_ksplit_q3k(n, k, sms)
    fastest = {(18432, 7168): 4, (8960, 1536): 8}
    if (k, n) in fastest:
        assert qmatmul.decode_ksplit_q5k(n, k, 132) == fastest[k, n]


def _q5k_experts_c1(x, fields):
    """q5_k's expert form at C = 1 written out (``q5k_stage_c1`` of
    ``qmatmul_experts_kernel``), in f32: an expert whose row of x is all
    zero is not read and gives +0; else per superblock, warp w's
    sub-blocks w (low nibbles) and 4 + w (high nibbles) take the sums
    ``part`` of x times the code as 0.5 + q/64 (q a nibble of qs and a bit
    of qh), the sums of x per sub-block ``xsum``, and y += 64 d sum_sub sc
    (part - xsum / 2) - dmin sum_sub m xsum; the four warps' sums are added
    in order.  x (E, 1, K), zeros past K."""
    qs, qh, sc, mn, d, dmin = (
        fields[a].to(torch.float32) if a in ("d", "dmin")
        else fields[a].to(torch.int32) for a in qmatmul.FIELDS["q5_k"])
    e_n, s_blocks, _, n = qs.shape
    k = x.shape[-1]
    e = torch.arange(256)
    lo = (qs[:, :, e % 128] >> (4 * (e // 128))[None, None, :, None]) & 15
    hi = (qh[:, :, e % 32] >> (e // 32)[None, None, :, None]) & 1
    code = 0.5 + (lo | (hi << 4)).to(torch.float32) / 64   # (E, S, 256, N)
    out = torch.zeros(e_n, 1, n)
    for ex in range(e_n):
        if not x[ex].any():
            continue                                       # +0, not read
        xp = torch.zeros(s_blocks * 256)
        xp[:k] = x[ex, 0]
        xs = xp.reshape(s_blocks, 8, 32)
        part = torch.einsum("sji,sjin->sjn", xs,
                            code[ex].reshape(s_blocks, 8, 32, n))
        xsum = xs.sum(-1)[..., None]                        # (S, 8, 1)
        t = part - 0.5 * xsum
        acc = torch.zeros(n)
        for w in range(4):                                 # warp order
            aw = torch.zeros(n)
            for sb in range(s_blocks):
                a1 = (sc[ex, sb, w] * t[sb, w]
                      + sc[ex, sb, 4 + w] * t[sb, 4 + w])
                a2 = (mn[ex, sb, w] * xsum[sb, w]
                      + mn[ex, sb, 4 + w] * xsum[sb, 4 + w])
                aw = aw + 64 * d[ex, sb] * a1 - dmin[ex, sb] * a2
            acc = acc + aw
        out[ex, 0] = acc
    return out


@pytest.mark.parametrize("e,k,n", [(3, 700, 256), (4, 512, 128),
                                   (2, 1280, 384)])
def test_q5k_experts_c1_factored_matches_reference(e, k, n):
    """The factored arithmetic of q5_k's expert form at C = 1 (a code as
    0.5 + q/64, the sums of x per 32-element sub-block, each sub-block's
    scale and min factored out) against the reference's expert path
    (``impl="xla"``) within 1e-5 of max|y|; an expert whose row of x is
    all zero (no token routed to it) gives +0."""
    w = np.random.default_rng(e * k + n).normal(size=(e, k, n)).astype(
        np.float32)
    jq = jax_quantize(jnp.asarray(w), "q5_k")
    tq = from_jax_params({"w": {"fmt": jq.fmt, "shape": jq.shape, "fields": {
        a: np.asarray(b) for a, b in jq.fields.items()}}})["w"]
    x = np.random.default_rng(k + n).normal(size=(e, 1, k)).astype(
        np.float32)
    x[1] = 0
    ref = np.asarray(jax_ops.qmatmul(jnp.asarray(x), jq, impl="xla"))
    got = _q5k_experts_c1(torch.from_numpy(x), tq.fields).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())
    assert not got[1].view(np.int32).any()                 # +0, not -0


@pytest.mark.parametrize("k,n", [(700, 256), (1536, 256), (8960, 1536),
                                 (7168, 576), (18432, 7168), (7168, 129280),
                                 (65536, 128)])
def test_q6k_decode_ksplit_sizes_the_cluster(k, n):
    """q6_k's K split, from host integers only: 1..16 blocks (a
    non-portable cluster size), at most the superblocks, the most with
    which the ``ceil(n / 128)`` column tiles' clusters all fit at once, a
    block an SM, on GPCs of 16 SMs."""
    s, tiles = -(-k // 256), -(-n // 128)
    assert qmatmul.decode_form("q6_k", 1, 4, k)
    assert not qmatmul.decode_form("q6_k", 1, 5, k)
    assert not qmatmul.decode_form("q6_k", 2, 1, k)
    for sms in (132, 114, 8):
        ks = qmatmul.decode_ksplit_q6k(n, k, sms)
        gpcs = max(1, sms // 16)
        assert 1 <= ks <= min(16, s)
        assert ks == 1 or tiles <= gpcs * (16 // ks)
        assert ks == min(16, s) or tiles > gpcs * (16 // (ks + 1))
    # the fastest splits timed on an H100 SXM (PERF.md)
    assert qmatmul.decode_ksplit_q6k(1536, 8960, 132) == 8
    assert qmatmul.decode_ksplit_q6k(576, 7168, 132) == 16
    assert qmatmul.decode_ksplit_q6k(7168, 18432, 132) == 2
    assert qmatmul.decode_ksplit_q6k(7168, 2048, 132) == 2


def _fma32(a, b, c):
    """fmaf(a, b, c) on f32 tensors: one rounding (the f64 product of two
    f32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _prefill_tensor_core(x, fields, fmt, ks):
    """The prefill form of every format written out
    (``qmatmul_prefill_kernel``).  Rows padded to 128-row tiles (zeros).
    A superblock (q8_0: 8 blocks of 32, those past the field's last zero)
    is staged in parts (2 for bf16 x, 4 for f32), each a whole number of
    sub-blocks taken in the stage's order: q4_k and q5_k part q sub-blocks
    4 j + q * 4 / parts + i (j = 0, 1: low, high nibbles), q6_k, q3_k and
    q2_k 4 p +
    q * 4 / parts + i (p = 0..3), q8_0 blocks q * 8 / parts + i.  bf16 x:
    per sub-block the tensor cores sum 16 exact products of x and the codes
    (q4_k q, q6_k q - 32, q3_k q - 4 with q a bit-pair of qs and a bit of
    hmask, q5_k q a nibble of qs and a bit of qh, q2_k q a bit-pair of qs,
    q8_0 its int8 q) a k16 step (q4_k, q5_k, q8_0 two) into a sum zeroed
    for the sub-block; the sum times sc * d (q8_0 d; f32) is added into the
    accumulator by one FMA, and for q4_k, q5_k and q2_k -m
    * dmin times the sum of x over the sub-block (32 or 16 elements: the
    tensor cores' f32 sum against a B of ones; in order here) by
    another.  f32 x: per k16 step of the stage, the six products
    of x's and the plain version's dequantized weights' three bf16 terms
    whose sum carries f32 precision, smallest first, summed into a zeroed
    f32 sum that is added into the accumulator.  The half superblocks split
    over ``ks`` blocks whose accumulators are added in rank order.  x (M,
    K), zeros past K; a zero row gives +0."""
    names = qmatmul.FIELDS[fmt]
    f = {n: fields[n] for n in names}
    n = f["d"].shape[-1]
    if fmt == "q8_0":
        # blocks past the field's last (K % 256 != 0) staged as zeros
        nblk = f["d"].shape[0]
        s_blocks = -(-nblk // 8)
        f = {a: torch.cat([b, torch.zeros((s_blocks * 8 - nblk, *b.shape[1:]),
                                          dtype=b.dtype)])
             for a, b in f.items()}
    else:
        s_blocks = f["d"].shape[0]
    m, k = x.shape
    mp = -(-m // 128) * 128
    xp = torch.zeros(mp, s_blocks * 256)
    xp[:m, :k] = x.to(torch.float32)
    e = torch.arange(256)
    if fmt == "q4_k":
        qs = f["qs"].to(torch.int32)
        codes = (qs[:, e % 128] >> (4 * (e // 128))[None, :, None]) & 15
        scale = f["d"].float()[:, None] * f["scales"].float()   # (S, 8, N)
        nmin = -(f["dmin"].float()[:, None] * f["mins"].float())
        sub_len, runs = 32, 2
    elif fmt == "q5_k":
        # element e: qs row e % 128's nibble e // 128, qh row e % 32's bit
        # e // 32 above it
        qs, qh = f["qs"].to(torch.int32), f["qh"].to(torch.int32)
        lo = (qs[:, e % 128] >> (4 * (e // 128))[None, :, None]) & 15
        hi = (qh[:, e % 32] >> (e // 32)[None, :, None]) & 1
        codes = lo | (hi << 4)
        scale = f["d"].float()[:, None] * f["scales"].float()   # (S, 8, N)
        nmin = -(f["dmin"].float()[:, None] * f["mins"].float())
        sub_len, runs = 32, 2
    elif fmt == "q6_k":
        ql, qh = f["ql"].to(torch.int32), f["qh"].to(torch.int32)
        lo = (ql[:, e % 128] >> (4 * (e // 128))[None, :, None]) & 15
        hi = (qh[:, e % 64] >> (2 * (e // 64))[None, :, None]) & 3
        codes = (lo | (hi << 4)) - 32
        scale = f["d"].float()[:, None] * f["scales"].float()   # (S, 16, N)
        sub_len, runs = 16, 4
    elif fmt == "q3_k":
        qs, hm = f["qs"].to(torch.int32), f["hmask"].to(torch.int32)
        lo = (qs[:, e % 64] >> (2 * (e // 64))[None, :, None]) & 3
        hi = (hm[:, e % 32] >> (e // 32)[None, :, None]) & 1
        codes = (lo | (hi << 2)) - 4
        scale = f["d"].float()[:, None] * f["scales"].float()   # (S, 16, N)
        sub_len, runs = 16, 4
    elif fmt == "q2_k":
        qs, sm = f["qs"].to(torch.int32), f["sm"].to(torch.int32)
        codes = (qs[:, e % 64] >> (2 * (e // 64))[None, :, None]) & 3
        scale = f["d"].float()[:, None] * (sm & 15).float()    # (S, 16, N)
        nmin = -(f["dmin"].float()[:, None] * (sm >> 4).float())
        sub_len, runs = 16, 4
    else:
        codes = f["qs"].to(torch.int32).reshape(s_blocks, 256, n)
        scale = f["d"].float().reshape(s_blocks, 8, n)          # (S, 8, N)
        sub_len, runs = 32, 1
    codes = codes.double()                                  # (S, 256, N)
    if x.dtype == torch.float32:
        # the plain version's weights (each product and difference rounded
        # to f32), as three bf16 terms; x as three
        w = FORMATS[fmt].dequantize(f).reshape(s_blocks * 256, n)
        wt = [t.double() for t in bf16_terms(w, 3)]
        xt = [t.double() for t in bf16_terms(xp, 3)]
        pairs = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
    parts = 2 if x.dtype == torch.bfloat16 else 4
    run_len = 256 // sub_len // runs    # sub-blocks a run
    per = run_len // parts              # sub-blocks of a run a part takes
    # half superblock h: superblock h // 2, parts q with q // (parts / 2)
    # == h % 2, each its sub-blocks run by run
    halves = [[(h // 2, r * run_len + q * per + i)
               for q in range(parts) if q // (parts // 2) == h % 2
               for r in range(runs) for i in range(per)]
              for h in range(2 * s_blocks)]
    out = torch.zeros(mp, n)
    for r in range(ks):                                     # rank order
        acc = torch.zeros(mp, n)
        for h in range(2 * s_blocks * r // ks, 2 * s_blocks * (r + 1) // ks):
            for sb, sub in halves[h]:
                if x.dtype == torch.float32:
                    for kk in range(sub_len // 16):
                        k0 = sb * 256 + sub * sub_len + 16 * kk
                        d = torch.zeros(mp, n)
                        for i, j in pairs:
                            d = (d.double() + xt[i][:, k0:k0 + 16]
                                 @ wt[j][k0:k0 + 16]).float()
                        acc = acc + d
                    continue
                d = torch.zeros(mp, n)
                for kk in range(sub_len // 16):
                    k0 = sb * 256 + sub * sub_len + 16 * kk
                    w = codes[sb, k0 - sb * 256:k0 - sb * 256 + 16]
                    d = (d.double() + xp[:, k0:k0 + 16].double() @ w).float()
                acc = _fma32(scale[sb, sub][None], d, acc)
                if fmt in ("q4_k", "q5_k", "q2_k"):
                    xs = torch.zeros(mp)
                    k0 = sb * 256 + sub * sub_len
                    for j in range(sub_len):                # in order, f32
                        xs = xs + xp[:, k0 + j]
                    acc = _fma32(nmin[sb, sub][None], xs[:, None], acc)
        out = out + acc if ks > 1 else acc
    return out[:m].to(x.dtype)


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q3_k", "q5_k", "q2_k",
                                 "q8_0"])
@pytest.mark.parametrize("m,k,n", [(5, 700, 256), (77, 1536, 384),
                                   (128, 700, 384), (300, 1536, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q4k_q6k_prefill_tensor_core_rule_matches_pallas(fmt, m, k, n,
                                                         dtype):
    """The arithmetic of the prefill form, for each of its formats (bf16
    x: exact bf16 codes in the fragments' K order, design (a): each
    sub-block's (q8_0: block's) tensor-core sum scaled in f32 by sc * d (q8_0
    d), the min term of q4_k, q5_k and q2_k from x's sums per 32- or
    16-element sub-block; f32 x: the plain
    version's weights and x as three bf16 terms each, six products a k16
    step; row tiles of 128 with padded rows, ragged K = 700 (q8_0: 22
    blocks, so its last superblock has 6 of its 8), the half superblocks
    split over 1, 2 and 3 blocks merged in rank order) against the
    reference's fused Pallas kernel (interpret mode, which takes N % 128 ==
    0; the card test has N = 260): f32 within 1e-5 of max|y|, bf16 within
    one bf16 step (2^-8) of max|y|; zero rows give +0."""
    jq, tq = _qt_pair(fmt, k, n, seed=m + k + len(fmt))
    x = np.random.default_rng(m + n).normal(size=(m, k)).astype(np.float32)
    x[[1, m - 2]] = 0
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.to(torch.float32).numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    ref = np.asarray(jax_ops.qmatmul(xj, jq, impl="pallas"), np.float32)
    tol = TOL if dtype == torch.float32 else 2 ** -8
    assert qmatmul.prefill_form(fmt, 1, m, k)
    for ks in (1, 2, 3):
        got = _prefill_tensor_core(xt, tq.fields, fmt, ks)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), ref,
                                   rtol=0, atol=tol * np.abs(ref).max())
        assert not got[[1, m - 2]].to(torch.float32).numpy().view(
            np.int32).any()                                # +0, not -0


# every 2-D weight of the prefill form's formats a prefill chunk of the
# served models multiplies (K, N): qwen2-1.5b's q/o, gate/up, k/v, down;
# DeepSeek-V3's attn_q_a, attn_q_b, attn_kv_a_mqa, attn_output, dense
# gate/up and down, shared experts (under DQ3_K_M and Q4_K_M q4_k and q6_k;
# under Q3_K_M q3_k on attn_q_a, attn_q_b, attn_kv_a_mqa, dense and shared
# gate/up, q5_k on the dense down (and qwen2's down); under Q2_K_L q3_k on attn_output, dense and shared down, q2_k on
# attn_q_a, attn_q_b, dense and shared gate/up; under Q8_0 q8_0 on all of
# them)
PREFILL_SHAPES = [(1536, 1536), (1536, 8960), (1536, 256), (8960, 1536),
                  (7168, 1536), (1536, 24576), (7168, 576), (16384, 7168),
                  (7168, 18432), (18432, 7168), (7168, 2048), (2048, 7168)]


@pytest.mark.parametrize("k,n", PREFILL_SHAPES)
def test_prefill_ksplit_from_host_integers(k, n):
    """The prefill form's tiles and K split, from host integers only: 64-row
    tiles where 128-row ones would be at most 8; 1..8 blocks a cluster (the
    portable size), at most the half superblocks, the most with which the
    tiles' clusters are all resident at once (a block an SM, GPCs of 16
    SMs) and, for clusters of more than 2 blocks, fill at most four fifths
    of the SMs."""
    halves = 2 * -(-k // 256)
    for fmt in ("q4_k", "q6_k", "q3_k", "q5_k", "q2_k", "q8_0"):
        assert qmatmul.prefill_form(fmt, 1, 512, k)
        assert qmatmul.prefill_form(fmt, 1, 5, k)
        assert not qmatmul.prefill_form(fmt, 1, 4, k)
        assert not qmatmul.prefill_form(fmt, 1, 1, k)
        assert not qmatmul.prefill_form(fmt, 8, 512, k)
    # every format, q5_k included, takes its decode form at M <= 4 and only
    # there
    for fmt in ("q4_k", "q6_k", "q3_k", "q5_k", "q2_k", "q8_0"):
        for m in (1, 4):
            assert qmatmul.decode_form(fmt, 1, m, k)
        for m in (5, 512):
            assert not qmatmul.decode_form(fmt, 1, m, k)

    def fits(tiles, ks, sms):
        return (tiles <= max(1, sms // 16) * (16 // ks)
                and (ks == 2 or tiles * ks <= sms * 4 // 5))
    for m in (5, 512, 600):
        rows = qmatmul.prefill_rows(n, m)
        assert rows == (64 if -(-n // 128) * -(-m // 128) <= 8 else 128)
        tiles = -(-n // 128) * -(-m // rows)
        for sms in (132, 114, 8):
            ks = qmatmul.prefill_ksplit(n, m, k, sms)
            assert 1 <= ks <= min(8, halves)
            assert ks == 1 or fits(tiles, ks, sms)
            assert ks == min(8, halves) or not any(
                fits(tiles, c, sms) for c in range(ks + 1, min(8, halves) + 1))
    # the fastest splits scanned on an H100 SXM (PERF.md, PR 20)
    assert qmatmul.prefill_rows(256, 512) == 64
    assert qmatmul.prefill_ksplit(256, 512, 1536, 132) == 6
    assert qmatmul.prefill_ksplit(1536, 512, 1536, 132) == 2
    assert qmatmul.prefill_ksplit(1536, 512, 8960, 132) == 2
    assert qmatmul.prefill_ksplit(576, 512, 7168, 132) == 5
    assert qmatmul.prefill_ksplit(18432, 512, 7168, 132) == 1
    # clusters of 2 may fill the card (PERF.md): 64 tiles at 7168->2048
    assert qmatmul.prefill_ksplit(2048, 512, 7168, 132) == 2


def test_qgather_columns_bitwise():
    jq, tq = _qt_pair("q4_k", 512, 64, seed=2)
    idx = np.array([[3, 7], [63, 0]], np.int32)
    ref = np.asarray(jax_ops.qgather_columns(jq, jnp.asarray(idx)))
    got = ops.qgather_columns(tq, torch.from_numpy(idx).long()).numpy()
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("shape", [(5, 3, 2, 16), (4, 7, 2, 64)])
def test_quantize_kv_page_pool_bitwise(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: d = 0
    qs_j, d_j = jax_pa.quantize_kv_page_pool(jnp.asarray(x))
    qs_t, d_t = paged_attn.quantize_kv_page_pool(torch.from_numpy(x))
    assert qs_t.dtype == torch.int8 and d_t.dtype == torch.float32
    assert qs_t.numpy().tobytes() == np.asarray(qs_j).tobytes()
    assert d_t.numpy().tobytes() == np.asarray(d_j).tobytes()


# ---------------------------------------------------------------------------
# paged attention: B2 (f32), B3 (q8_0) decode, B4 (q8_0) prefill
# ---------------------------------------------------------------------------

def _pools(rng, b, n_lp, page_size, hkv, d, live):
    """Pools + block tables with ``live[i]`` written tokens per lane (partial
    last pages whenever ``live % P != 0``) and NULL-page tails."""
    n_pages = paged.RESERVED_PAGES + b * n_lp
    k = rng.normal(size=(n_pages, page_size, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, page_size, hkv, d)).astype(np.float32)
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
    k[paged.NULL_PAGE] = 0.0
    v[paged.NULL_PAGE] = 0.0
    return k, v, pos_pool, bt


DECODE_CASES = [
    # page_size, window, softcap, active_pages, lane_pages
    (3, 0, 0.0, None, None),
    (5, 0, 0.0, 4, None),            # active_pages < table width
    (7, 6, 20.0, None, None),        # sliding window + softcap
    (4, 0, 0.0, 5, [2, 5, 1]),       # per-lane bound short of nj
]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q8_0"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_paged_decode_plain_matches_pallas(quant, case):
    page_size, window, softcap, active, lanes = case
    rng = np.random.default_rng(page_size * 7 + window)
    b, h, hkv, d, n_lp = 3, 4, 2, 16, 6
    live = [page_size * 2 + 1, page_size * 4, 2]
    if lanes is not None:
        live = [min(x, lp * page_size) for x, lp in zip(live, lanes)]
    k, v, pos_pool, bt = _pools(rng, b, n_lp, page_size, hkv, d, live)
    pos = np.array([x - 1 for x in live], np.int32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lp = None if lanes is None else np.array(lanes, np.int32)
    kw = dict(window=window, softcap=softcap, active_pages=active)
    tk = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    jk = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    if quant:
        kq, kd = jax_pa.quantize_kv_page_pool(jnp.asarray(k))
        vq, vd = jax_pa.quantize_kv_page_pool(jnp.asarray(v))
        ref = jax_pa.paged_attn_decode_quant(
            jnp.asarray(q), kq, kd, vq, vd, jk(pos_pool), jk(bt), jk(pos),
            mode="q8_0", lane_pages=jk(lp), impl="pallas", interpret=True,
            **kw)
        got = paged_attn.paged_attn_decode_quant(
            tk(q), *(torch.from_numpy(np.asarray(a)) for a in (kq, kd, vq,
                                                               vd)),
            tk(pos_pool), tk(bt), tk(pos), mode="q8_0", lane_pages=tk(lp),
            **kw)
    else:
        ref = jax_pa.paged_attn_decode(
            jnp.asarray(q), jk(k), jk(v), jk(pos_pool), jk(bt), jk(pos),
            lane_pages=jk(lp), impl="pallas", interpret=True, **kw)
        got = paged_attn.paged_attn_decode(
            tk(q), tk(k), tk(v), tk(pos_pool), tk(bt), tk(pos),
            lane_pages=tk(lp), **kw)
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) < TOL


def _split_decode(q, k, v, pos_pool, bt, pos, lane_pages, *, pps, window,
                  softcap, scale, nj):
    """The decode kernel's rule written out: lane i's first ``min(lane
    pages, nj)`` logical pages go in runs of ``pps``, each run folded page
    by page into its own (m, l, acc), and the runs merged in run order
    (the cluster's rank 0).  A run wholly past the lane's bound keeps the
    empty (NEG_INF, 0, 0)."""
    b, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    rep = h // hkv
    neg = paged_attn.NEG_INF
    out = torch.zeros(b, h, dv)
    for i in range(b):
        jmax = min(max(int(lane_pages[i]), 1), nj)
        qi = (q[i] * scale).reshape(hkv, rep, d)
        runs = []
        for js in range(0, nj, pps):
            m = torch.full((hkv, rep, 1), neg)
            l = torch.zeros(hkv, rep, 1)
            acc = torch.zeros(hkv, rep, dv)
            for j in range(js, min(js + pps, jmax)):
                page = int(bt[i, j])
                s = torch.einsum("krd,pkd->krp", qi, k[page])
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                tp = pos_pool[page]
                ok = (tp >= 0) & (tp <= pos[i])
                if window:
                    ok &= tp > pos[i] - window
                s = torch.where(ok, s, torch.full_like(s, neg))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("krp,pkd->krd", p, v[page])
                m = m_new
            runs.append((m, l, acc))
        mx = torch.stack([r[0] for r in runs]).amax(0)
        lsum = torch.zeros(hkv, rep, 1)
        osum = torch.zeros(hkv, rep, dv)
        for m, l, acc in runs:                  # fixed run order
            e = torch.exp(m - mx)
            lsum = lsum + l * e
            osum = osum + acc * e
        out[i] = (osum / torch.clamp(lsum, min=1e-30)).reshape(h, dv)
    return out


SPLIT_CASES = [
    # page_size, live per lane, lane_pages, window, softcap
    (3, [16, 12, 2], None, 0, 0.0),
    (4, [7, 22, 3], [2, 6, 1], 0, 0.0),     # runs wholly past lane_pages
    (5, [0, 17, 9], None, 0, 0.0),          # lane 0 has no valid key
    (7, [13, 30, 2], None, 6, 20.0),        # window + softcap
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=["plain", "lane_pages", "no_key", "window"])
def test_split_decode_rule_matches_pallas(case):
    """Runs of 1, 2 and 3 pages, each with its own (m, l, acc), merged in
    order, give the reference's ``_attn_core`` (Pallas, interpret mode)."""
    page_size, live, lanes, window, softcap = case
    rng = np.random.default_rng(page_size * 5 + window)
    b, h, hkv, d, n_lp = 3, 4, 2, 16, 6
    k, v, pos_pool, bt = _pools(rng, b, n_lp, page_size, hkv, d, live)
    pos = np.array([x - 1 for x in live], np.int32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lp = None if lanes is None else np.array(lanes, np.int32)
    ref = np.asarray(jax_pa.paged_attn_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos_pool), jnp.asarray(bt), jnp.asarray(pos),
        lane_pages=None if lp is None else jnp.asarray(lp), window=window,
        softcap=softcap, impl="pallas", interpret=True))
    lane_pages = [n_lp] * b if lanes is None else lanes
    if live[0] == 0:
        assert np.all(ref[0] == 0.0)
    for pps in (1, 2, 3):
        got = _split_decode(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(pos_pool), torch.from_numpy(bt),
            torch.from_numpy(pos), lane_pages, pps=pps, window=window,
            softcap=softcap, scale=d ** -0.5, nj=n_lp).numpy()
        assert np.max(np.abs(got - ref)) < TOL, pps
        if live[0] == 0:
            assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_decode_splits_cover_every_page(sms):
    """``decode_splits`` (host integers only): at most 8 blocks a cluster
    (the portable size), at most one block per page, and the runs cover
    the ``nj`` pages with none left empty of them."""
    for nj in range(1, 130):
        for blocks in (1, 3, 8, 24, 200):
            splits, pps = paged_attn.decode_splits(nj, blocks, sms)
            assert 1 <= splits <= 8 and splits <= nj
            assert (splits - 1) * pps < nj <= splits * pps
            if blocks * 8 <= sms and nj % 8 == 0:
                assert splits == 8        # enough blocks to fill the SMs


@pytest.mark.parametrize("page_size,active", [(3, None), (5, 3), (4, 6)])
def test_paged_prefill_plain_matches_pallas(page_size, active):
    """Write-then-attend chunk prefill over q8_0 pools, with a padded query
    row (qpos = -1 -> zeros) and stale rows past a lane's frontier."""
    rng = np.random.default_rng(page_size + 11)
    b, c, h, hkv, d, n_lp = 2, 5, 4, 2, 16, 6
    live = [page_size * 2 + 2, page_size + 1]
    k, v, pos_pool, bt = _pools(rng, b, n_lp, page_size, hkv, d, live)
    qpos = np.stack([np.arange(x - c, x) for x in live]).astype(np.int32)
    qpos[1, -2:] = -1                        # padded rows of a short chunk
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    kq, kd = jax_pa.quantize_kv_page_pool(jnp.asarray(k))
    vq, vd = jax_pa.quantize_kv_page_pool(jnp.asarray(v))
    ref = np.asarray(jax_pa.paged_attn_prefill_quant(
        jnp.asarray(q), kq, kd, vq, vd, jnp.asarray(pos_pool),
        jnp.asarray(bt), jnp.asarray(qpos), mode="q8_0", active_pages=active,
        impl="pallas", interpret=True))
    got = paged_attn.paged_attn_prefill_quant(
        torch.from_numpy(q),
        *(torch.from_numpy(np.asarray(a)) for a in (kq, kd, vq, vd)),
        torch.from_numpy(pos_pool), torch.from_numpy(bt),
        torch.from_numpy(qpos), mode="q8_0", active_pages=active).numpy()
    assert got.shape == (b, c, h, d)
    assert np.all(got[1, -2:] == 0.0)
    assert np.max(np.abs(got - ref)) < TOL


def _gqa_prefill_tensor_cores(q, pools, pos_pool, bt, qpos, *, mode, scale,
                              nj, page_size, window, softcap, splits):
    """The GQA prefill kernel's arithmetic written out
    (``paged_attn_prefill_kernel``): per (lane, kv head), its (query, rep
    head) rows laid out (c, r) in blocks of 64; a block's keys (logical
    index <= its rows' largest position, within the first ``nj`` pages) in
    32-key tiles, split evenly over ``splits`` runs; per tile, bf16
    queries: the scores as exact products of the queries and the stored
    codes (f64 here, the tensor core), times each key's row scale, then
    ``scale``; P times each key's value scale, split into three bf16
    terms, times the value codes.  f32 queries: q * scale and the keys and
    values dequantized as the plain version rounds them, each as three
    bf16 terms, the six term products whose sum carries f32 precision, for
    S and for P . V (P as three terms).  Then the softcap, the mask
    (written, causal, window, logical index) and the online softmax.  The
    runs' (m, l, acc) are merged in run order.  A padded row (qpos = -1)
    gives zeros."""
    kq, kd, vq, vd = pools
    kc = paged_attn.unpack_q4_rows(kq) if mode == "q4_0" else kq
    vc = paged_attn.unpack_q4_rows(vq) if mode == "q4_0" else vq
    b, c, h, d = q.shape
    hkv, dv = kc.shape[2], vc.shape[-1]
    rep, nq = h // hkv, 1 if q.dtype == torch.bfloat16 else 3
    rows_a_block = paged_attn._PREFILL_ROWS
    keys_a_tile = paged_attn._PREFILL_KEYS
    neg = paged_attn.NEG_INF
    kc = kc.reshape(-1, hkv, d).to(torch.float32)
    vc = vc.reshape(-1, hkv, dv).to(torch.float32)
    kd, vd = kd.reshape(-1, hkv), vd.reshape(-1, hkv)
    pairs = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]

    def prod(a, b):
        """a @ b.T as the tensor cores give it: bf16 queries, exact; f32,
        the six products of the two operands' three bf16 terms."""
        if nq == 1:
            return (a.double() @ b.double().T).to(torch.float32)
        at, bt_ = bf16_terms(a, 3), bf16_terms(b, 3)
        return sum(at[i].double() @ bt_[j].double().T
                   for i, j in pairs).to(torch.float32)
    tpos = pos_pool.reshape(-1)
    out = torch.zeros(b, c, h, dv)
    for i in range(b):
        for hk in range(hkv):
            for r0 in range(0, c * rep, rows_a_block):
                rows = torch.arange(r0, min(r0 + rows_a_block, c * rep))
                rc, rh = rows // rep, hk * rep + rows % rep
                qp = qpos[i, rc].to(torch.int64)
                qmax = int(qp.max())
                n_valid = 0 if qmax < 0 else min(qmax + 1, nj * page_size)
                ntiles = -(-n_valid // keys_a_tile)
                qe = q[i, rc, rh].to(torch.float32)
                if nq == 3:
                    qe = qe * scale
                runs = []
                for sp in range(splits):
                    m = torch.full((len(rows),), neg)
                    l = torch.zeros(len(rows))
                    acc = torch.zeros(len(rows), dv)
                    for tile in range(ntiles * sp // splits,
                                      ntiles * (sp + 1) // splits):
                        u = torch.arange(tile * keys_a_tile,
                                         min((tile + 1) * keys_a_tile,
                                             n_valid))
                        tok = (bt[i, u // page_size].to(torch.int64)
                               * page_size + u % page_size)
                        if nq == 1:
                            s = prod(qe, kc[tok, hk]) * kd[tok, hk] * scale
                        else:
                            s = prod(qe, kc[tok, hk] * kd[tok, hk][:, None])
                        if softcap:
                            s = softcap * torch.tanh(s / softcap)
                        tp = tpos[tok]
                        ok = ((tp >= 0) & (tp <= qp[:, None])
                              & (u <= qp[:, None]))
                        if window:
                            ok &= tp > qp[:, None] - window
                        mx = torch.where(ok, s, torch.full_like(
                            s, neg)).amax(-1)
                        m_new = torch.maximum(m, mx)
                        corr = torch.exp(m - m_new)
                        p = torch.where(ok, torch.exp(s - m_new[:, None]),
                                        torch.zeros_like(s))
                        l = l * corr + p.sum(-1)
                        if nq == 1:
                            pv = sum(t.double() for t in bf16_terms(
                                p * vd[tok, hk], 3))
                            pv = (pv @ vc[tok, hk].double()).to(torch.float32)
                        else:
                            pv = prod(p, (vc[tok, hk]
                                          * vd[tok, hk][:, None]).T)
                        acc = acc * corr[:, None] + pv
                        m = m_new
                    runs.append((m, l, acc))
                mx = torch.stack([r[0] for r in runs]).amax(0)
                lsum = torch.zeros(len(rows))
                osum = torch.zeros(len(rows), dv)
                for m, l, acc in runs:                  # fixed run order
                    e = torch.exp(m - mx)
                    lsum = lsum + l * e
                    osum = osum + acc * e[:, None]
                out[i, rc, rh] = osum / torch.clamp(lsum, min=1e-30)[:, None]
    return out


GQA_PREFILL_CASES = [
    # mode, query dtype, H, Hkv, page size, window, softcap
    ("q8_0", torch.float32, 12, 2, 4, 0, 0.0),
    ("q8_0", torch.bfloat16, 12, 2, 4, 0, 0.0),
    ("q4_0", torch.float32, 12, 2, 16, 0, 0.0),
    ("q4_0", torch.bfloat16, 12, 2, 16, 0, 0.0),
    ("q8_0", torch.bfloat16, 3, 3, 5, 0, 0.0),       # rep 1: a group of one
    ("q4_0", torch.float32, 3, 3, 5, 0, 0.0),
    ("q8_0", torch.float32, 12, 2, 4, 9, 20.0),      # window + softcap
]


@pytest.mark.parametrize("case", GQA_PREFILL_CASES, ids=[
    "q8_0-f32", "q8_0-bf16", "q4_0-f32", "q4_0-bf16", "q8_0-rep1",
    "q4_0-rep1", "window-softcap"])
def test_gqa_prefill_tensor_core_rule_matches_pallas(case):
    """The tensor-core GQA prefill's arithmetic (bf16 queries: 32-key
    tiles of exact bf16 codes, per-key row scales on S and folded into P,
    P as three bf16 terms; f32 queries: the plain version's dequantized
    values and q * scale as three bf16 terms, six products a k16 step; the
    online softmax per tile, blocks of 64 (query, rep head) rows that stop
    at their rows' last visible tile, the tiles split over 1, 2 and 3 runs
    merged in order) with padded rows and stale rows past a lane's
    frontier, against the reference's ``paged_attn_prefill_quant``
    (Pallas, interpret mode) within 1e-5."""
    mode, qdt, h, hkv, page_size, window, softcap = case
    rng = np.random.default_rng(h + hkv + page_size + window)
    b, c, d, n_lp = 2, 12, 16, -(-80 // page_size) + 1
    live = [75, c + 2]                       # 3 key tiles, and 1
    k, v, pos_pool, bt = _pools(rng, b, n_lp, page_size, hkv, d, live)
    qpos = np.stack([np.arange(x - c, x) for x in live]).astype(np.int32)
    qpos[1, -3:] = -1                        # padded rows of a short chunk
    q = torch.from_numpy(rng.normal(size=(b, c, h, d)).astype(
        np.float32)).to(qdt)
    jq = {"q8_0": jax_pa.quantize_kv_page_pool,
          "q4_0": jax_pa.quantize_kv_page_pool_q4}[mode]
    jpools = (*jq(jnp.asarray(k)), *jq(jnp.asarray(v)))
    qj = jnp.asarray(q.to(torch.float32).numpy())
    ref = np.asarray(jax_pa.paged_attn_prefill_quant(
        qj.astype(jnp.bfloat16) if qdt == torch.bfloat16 else qj, *jpools,
        jnp.asarray(pos_pool), jnp.asarray(bt), jnp.asarray(qpos), mode=mode,
        window=window, softcap=softcap, impl="pallas", interpret=True))
    assert np.all(ref[1, -3:] == 0.0)
    for splits in (1, 2, 3):
        got = _gqa_prefill_tensor_cores(
            q, [torch.from_numpy(np.array(a)) for a in jpools],
            torch.from_numpy(pos_pool), torch.from_numpy(bt),
            torch.from_numpy(qpos), mode=mode, scale=d ** -0.5, nj=n_lp,
            page_size=page_size, window=window, softcap=softcap,
            splits=splits).numpy()
        assert np.all(got[1, -3:] == 0.0)
        assert np.max(np.abs(got - ref)) < TOL, splits


def test_attn_prefill_tiles_from_host_integers():
    """``attn_prefill_tiles``: 64 (query, rep head) rows a block, and a
    cluster of 1..8 blocks, at most the key tiles of ``nj`` pages, enough
    for about two blocks per SM (qwen2's 4 x 128-token chunk: 12 row tiles
    a kv head, 96 clusters, 3 blocks each on 132 SMs, the fastest split an
    H100 80GB HBM3 at 700 W ran but for 6, 2 % faster; PERF.md)."""
    assert paged_attn.attn_prefill_tiles(4, 128, 12, 2, nj=64, page_size=16,
                                         sms=132) == (12, 3)
    for b, c, h, hkv in ((1, 5, 12, 2), (2, 40, 3, 3), (4, 128, 12, 2),
                         (1, 1, 1, 1), (3, 77, 28, 4)):
        for nj, page_size in ((1, 3), (6, 16), (64, 16), (2, 128)):
            for sms in (1, 8, 132):
                tiles, splits = paged_attn.attn_prefill_tiles(
                    b, c, h, hkv, nj=nj, page_size=page_size, sms=sms)
                assert tiles == -(-c * (h // hkv) // 64)
                blocks = b * hkv * tiles
                assert 1 <= splits <= min(8, -(-nj * page_size // 32))
                assert splits == min(8, -(-nj * page_size // 32),
                                     max(1, -(-2 * sms // blocks)))


def test_paged_q8_rows_and_scatters_bitwise():
    """The q8_0 page helpers against ``repro.models.paged``: quantize-on-
    write token and chunk scatters (with GARBAGE routing and a
    last-writer-wins plan), the round trip and the dequantizing gather."""
    from repro.models import paged as jpaged

    rng = np.random.default_rng(9)
    n_pages, p, hkv, d = 8, 3, 2, 16
    bt = np.array([[2, 3, 4], [5, 6, 7]], np.int32)
    qs0 = np.zeros((n_pages, p, hkv, d), np.int8)
    d0 = np.zeros((n_pages, p, hkv), np.float32)
    tq = [torch.from_numpy(qs0.copy()), torch.from_numpy(d0.copy())]
    jq = [jnp.asarray(qs0), jnp.asarray(d0)]

    val = rng.normal(size=(2, hkv, d)).astype(np.float32)
    idx, ok = np.array([4, 7], np.int32), np.array([True, False])
    jq = list(jpaged.scatter_token_quant(*jq, jnp.asarray(bt), jnp.asarray(idx),
                                         jnp.asarray(val), ok=jnp.asarray(ok)))
    paged.scatter_token_quant(*tq, torch.from_numpy(bt), torch.from_numpy(idx),
                              torch.from_numpy(val), ok=torch.from_numpy(ok))

    chunk = rng.normal(size=(2, 4, hkv, d)).astype(np.float32)
    cidx = np.array([[0, 1, 2, 1], [5, 6, 7, 8]], np.int32)
    valid = np.array([[True, True, True, True], [True, True, False, False]])
    jok = jpaged.chunk_write_plan(jnp.asarray(cidx), jnp.asarray(valid), 9)
    tok = paged.chunk_write_plan(torch.from_numpy(cidx),
                                 torch.from_numpy(valid), 9)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    jqs, jd, jdq = jpaged.roundtrip_quant(jnp.asarray(chunk))
    tqs, td, tdq = paged.roundtrip_quant(torch.from_numpy(chunk))
    for a, b in ((jqs, tqs), (jd, td), (jdq, tdq)):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()
    jq = [jpaged.scatter_chunk(pool, jnp.asarray(bt), jnp.asarray(cidx), v,
                               jok) for pool, v in zip(jq, (jqs, jd))]
    for pool, v in zip(tq, (tqs, td)):
        paged.scatter_chunk(pool, torch.from_numpy(bt), torch.from_numpy(cidx),
                            v, tok)
    # GARBAGE takes duplicate writes in an unspecified order; never read
    read = [i for i in range(n_pages) if i != paged.GARBAGE_PAGE]
    for a, b in zip(jq, tq):
        assert b.numpy()[read].tobytes() == np.asarray(a)[read].tobytes()
    got = paged.gather_pages_quant(*tq, torch.from_numpy(bt), 8)
    ref = jpaged.gather_pages_quant(*jq, jnp.asarray(bt), 8)
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()
