"""The port's absorbed-MLA kernels (B6 decode, B7 prefill) against the JAX
reference's.

On the CPU each wrapper runs its plain PyTorch version, the reference's
bounded-gather twin (the CUDA kernel ``csrc/paged_mla.cu`` is held against
that same plain version on the card by ``chip_smoke.py`` and the
``gpu``-marked tests of ``tests/test_torch_gpu.py``).  The reference runs
its XLA twin (``impl="xla"``) except for one tiny case per kernel through
the Pallas kernel in interpret mode.

Latent pools hold ``live[i]`` tokens per lane (partial last pages, a
NULL-page tail); ``active_pages`` and ``lane_pages`` bound the page loops
short of the table width.  Tolerance: 1e-5 absolute on O(1)-scaled f32
outputs — both sides are f32 and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attn as jax_pa

from repro_torch.kernels import paged_attn
from repro_torch.models import paged
from bf16_terms import bf16_terms
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
SCALE = 48 ** -0.5


def _latent_pools(rng, b, n_lp, page_size, r, dr, live):
    """f32 latent / rope pools and block tables: lane i has ``live[i]``
    tokens, its unallocated logical pages map to the NULL page."""
    n_pages = paged.RESERVED_PAGES + b * n_lp
    ckv = rng.normal(size=(n_pages, page_size, r)).astype(np.float32)
    kr = rng.normal(size=(n_pages, page_size, dr)).astype(np.float32)
    ckv[paged.NULL_PAGE] = 0.0
    kr[paged.NULL_PAGE] = 0.0
    bt = np.full((b, n_lp), paged.NULL_PAGE, np.int32)
    nxt = paged.RESERVED_PAGES
    for i in range(b):
        for lp in range(-(-live[i] // page_size)):
            bt[i, lp] = nxt
            nxt += 1
    return ckv, kr, bt


def _quant(ckv, kr):
    """q8_0 pools from the reference's quantizer, as numpy."""
    return [np.array(a) for a in (*jax_pa.quantize_kv_page_pool(
        jnp.asarray(ckv)), *jax_pa.quantize_kv_page_pool(jnp.asarray(kr)))]


DECODE_CASES = [
    # page_size, active_pages, lane_pages, live
    (3, None, None, [7, 12, 2]),
    (5, 4, None, [11, 20, 1]),          # active_pages < table width
    (4, 5, [2, 5, 1], [7, 19, 3]),      # per-lane bound short of nj
    (16, None, [3, 1, 2], [33, 1, 17]),  # the serving page size
]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q8_0"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_mla_decode_plain_matches_reference(quant, case):
    page_size, active, lanes, live = case
    rng = np.random.default_rng(page_size * 11 + len(live))
    b, h, r, dr, n_lp = 3, 4, 32, 16, 6
    ckv, kr, bt = _latent_pools(rng, b, n_lp, page_size, r, dr, live)
    pos = np.array([x - 1 for x in live], np.int32)
    q_eff = rng.normal(size=(b, h, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, h, dr)).astype(np.float32)
    lp = None if lanes is None else np.array(lanes, np.int32)
    tk = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    jk = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    kw = dict(scale=SCALE, active_pages=active)
    if quant:
        pools = _quant(ckv, kr)
        ref = jax_pa.paged_mla_decode_quant(
            jk(q_eff), jk(q_rope), *map(jk, pools), jk(bt), jk(pos),
            lane_pages=jk(lp), impl="xla", **kw)
        counter = paged_attn.paged_mla_decode_quant
        before = counter.launches
        got = counter(tk(q_eff), tk(q_rope), *map(tk, pools), tk(bt),
                      tk(pos), lane_pages=tk(lp), **kw)
    else:
        ref = jax_pa.paged_mla_decode(
            jk(q_eff), jk(q_rope), jk(ckv), jk(kr), jk(bt), jk(pos),
            lane_pages=jk(lp), impl="xla", **kw)
        counter = paged_attn.paged_mla_decode
        before = counter.launches
        got = counter(tk(q_eff), tk(q_rope), tk(ckv), tk(kr), tk(bt),
                      tk(pos), lane_pages=tk(lp), **kw)
    # CPU tensors take the plain version: no kernel launch is counted
    assert counter.launches == before
    assert got.shape == (b, h, r) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) < TOL


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q8_0"])
def test_mla_decode_plain_matches_pallas_kernel(quant):
    """One tiny case through the reference's Pallas kernel (interpret
    mode), with a lane bound and a NULL-page tail."""
    rng = np.random.default_rng(3)
    b, h, r, dr, n_lp, page_size = 2, 2, 16, 8, 4, 3
    live = [5, 8]
    ckv, kr, bt = _latent_pools(rng, b, n_lp, page_size, r, dr, live)
    pos = np.array([x - 1 for x in live], np.int32)
    lp = np.array([2, 3], np.int32)
    q_eff = rng.normal(size=(b, h, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, h, dr)).astype(np.float32)
    kw = dict(scale=SCALE, active_pages=3)
    if quant:
        pools = _quant(ckv, kr)
        ref = jax_pa.paged_mla_decode_quant(
            jnp.asarray(q_eff), jnp.asarray(q_rope), *map(jnp.asarray, pools),
            jnp.asarray(bt), jnp.asarray(pos), lane_pages=jnp.asarray(lp),
            impl="pallas", interpret=True, **kw)
        got = paged_attn.paged_mla_decode_quant(
            torch.from_numpy(q_eff), torch.from_numpy(q_rope),
            *map(torch.from_numpy, pools), torch.from_numpy(bt),
            torch.from_numpy(pos), lane_pages=torch.from_numpy(lp), **kw)
    else:
        ref = jax_pa.paged_mla_decode(
            jnp.asarray(q_eff), jnp.asarray(q_rope), jnp.asarray(ckv),
            jnp.asarray(kr), jnp.asarray(bt), jnp.asarray(pos),
            lane_pages=jnp.asarray(lp), impl="pallas", interpret=True, **kw)
        got = paged_attn.paged_mla_decode(
            *map(torch.from_numpy, (q_eff, q_rope, ckv, kr, bt, pos)),
            lane_pages=torch.from_numpy(lp), **kw)
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) < TOL


@pytest.mark.parametrize("page_size,active,impl", [
    (3, None, "xla"), (5, 3, "xla"), (16, None, "xla"), (4, None, "pallas")])
def test_mla_prefill_plain_matches_reference(page_size, active, impl):
    """Write-then-attend chunk prefill over q8_0 latent pools, with padded
    query rows (qpos = -1 -> zeros) and stale tokens past a lane's
    frontier."""
    rng = np.random.default_rng(page_size + 31)
    b, c, h, r, dr, n_lp = 2, 5, 4, 32, 16, 6
    live = [page_size * 2 + 2, page_size + 1]
    ckv, kr, bt = _latent_pools(rng, b, n_lp, page_size, r, dr,
                                [page_size * n_lp] * b)
    qpos = np.stack([np.arange(x - c, x) for x in live]).astype(np.int32)
    qpos[1, -2:] = -1                        # padded rows of a short chunk
    q_eff = rng.normal(size=(b, c, h, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, c, h, dr)).astype(np.float32)
    pools = _quant(ckv, kr)
    ref = np.asarray(jax_pa.paged_mla_prefill_quant(
        jnp.asarray(q_eff), jnp.asarray(q_rope), *map(jnp.asarray, pools),
        jnp.asarray(bt), jnp.asarray(qpos), scale=SCALE, active_pages=active,
        impl=impl, interpret=True))
    before = paged_attn.paged_mla_prefill_quant.launches
    got = paged_attn.paged_mla_prefill_quant(
        torch.from_numpy(q_eff), torch.from_numpy(q_rope),
        *map(torch.from_numpy, pools), torch.from_numpy(bt),
        torch.from_numpy(qpos), scale=SCALE, active_pages=active).numpy()
    assert paged_attn.paged_mla_prefill_quant.launches == before
    assert got.shape == (b, c, h, r)
    assert np.all(got[1, -2:] == 0.0)
    assert np.max(np.abs(got - ref)) < TOL



def _split_tiles(n_valid, splits):
    """The runs of tokens ``[u0, u1)`` the MLA decode kernel's blocks take
    of a lane's ``n_valid`` valid tokens (``csrc/paged_mla.cu``): its
    16-token tiles split evenly over ``splits`` blocks, in rank order."""
    ntt = -(-n_valid // 16)
    return [(ntt * r // splits * 16,
             max(ntt * r // splits * 16,
                 min(ntt * (r + 1) // splits * 16, n_valid)))
            for r in range(splits)]


def _split_mla_decode(q_eff, q_rope, ckv, kr, bt, pos, lane_pages, *,
                      splits, scale, nj, page_size):
    """The MLA decode kernel's rule written out: lane i's valid tokens (its
    first ``min(lane pages, nj)`` logical pages, cut after the query
    position) go in 16-token tiles, split evenly over ``splits`` runs
    (``_split_tiles``: a run may start or end inside a page), each run
    folded tile by tile into its own (m, l, acc), and the runs merged in
    run order (the cluster's rank order).  A run with no token keeps the
    empty (NEG_INF, 0, 0).  ``ckv`` / ``kr``: the pools as f32
    (dequantized)."""
    b, h, r = q_eff.shape
    neg = paged_attn.NEG_INF
    out = torch.zeros(b, h, r)
    for i in range(b):
        jmax = min(max(int(lane_pages[i]), 1), nj)
        n_valid = max(0, min(jmax * page_size, int(pos[i]) + 1))
        rows = [int(bt[i, u // page_size]) * page_size + u % page_size
                for u in range(n_valid)]
        cs = ckv.reshape(-1, r)[rows]
        ks = kr.reshape(-1, kr.shape[-1])[rows]
        runs = []
        for t0, t1 in _split_tiles(n_valid, splits):
            m = torch.full((h, 1), neg)
            l = torch.zeros(h, 1)
            acc = torch.zeros(h, r)
            for u in range(t0, t1, 16):
                c, k = cs[u:min(u + 16, t1)], ks[u:min(u + 16, t1)]
                s = (q_eff[i] @ c.T + q_rope[i] @ k.T) * scale
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p @ c
                m = m_new
            runs.append((m, l, acc))
        mx = torch.stack([x[0] for x in runs]).amax(0)
        lsum = torch.zeros(h, 1)
        osum = torch.zeros(h, r)
        for m, l, acc in runs:                  # fixed run order
            e = torch.exp(m - mx)
            lsum = lsum + l * e
            osum = osum + acc * e
        out[i] = osum / torch.clamp(lsum, min=1e-30)
    return out


# the reference's quantizers by mode, and the pool kinds of the split test:
# f32, and the (latent, rope) modes of the quantized pools
JAX_QUANTIZE = {"q8_0": jax_pa.quantize_kv_page_pool,
                "q4_0": jax_pa.quantize_kv_page_pool_q4}
SPLIT_KV = {"f32": None, "q8_0": ("q8_0", "q8_0"), "q4_0": ("q4_0", "q4_0"),
            "q8_0+q4_0": ("q8_0", "q4_0")}


@pytest.mark.parametrize("kv", list(SPLIT_KV))
def test_mla_split_decode_rule_matches_pallas(kv):
    """A lane's valid tokens split in 16-token tiles over 1, 2, 3 and 5
    runs (6-token pages, so runs and tiles start inside pages; more runs
    than tiles leave some empty), each with its own (m, l, acc), merged in
    order, give the reference's ``_mla_core`` (Pallas, interpret mode);
    lane bounds short of the bucket and a 1-token lane included."""
    modes = SPLIT_KV[kv]
    rng = np.random.default_rng(len(kv))
    b, h, r, dr, n_lp, page_size = 3, 4, 16, 8, 5, 6
    live = [27, 1, 14]
    lanes = [5, 1, 3]
    ckv, kr, bt = _latent_pools(rng, b, n_lp, page_size, r, dr, live)
    pos = np.array([x - 1 for x in live], np.int32)
    q_eff = rng.normal(size=(b, h, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, h, dr)).astype(np.float32)
    kw = dict(scale=SCALE, lane_pages=jnp.asarray(np.array(lanes, np.int32)),
              impl="pallas", interpret=True)
    if modes:
        jpools = (*JAX_QUANTIZE[modes[0]](jnp.asarray(ckv)),
                  *JAX_QUANTIZE[modes[1]](jnp.asarray(kr)))
        ref = np.asarray(jax_pa.paged_mla_decode_quant(
            jnp.asarray(q_eff), jnp.asarray(q_rope), *jpools,
            jnp.asarray(bt), jnp.asarray(pos), latent_mode=modes[0],
            rope_mode=modes[1], **kw))
        tp = [torch.from_numpy(np.array(a)) for a in jpools]
        cf = paged_attn._dequant(tp[0], tp[1], modes[0])
        kf = paged_attn._dequant(tp[2], tp[3], modes[1])
    else:
        ref = np.asarray(jax_pa.paged_mla_decode(
            jnp.asarray(q_eff), jnp.asarray(q_rope), jnp.asarray(ckv),
            jnp.asarray(kr), jnp.asarray(bt), jnp.asarray(pos), **kw))
        cf, kf = torch.from_numpy(ckv), torch.from_numpy(kr)
    for splits in (1, 2, 3, 5):
        got = _split_mla_decode(
            torch.from_numpy(q_eff), torch.from_numpy(q_rope), cf, kf,
            torch.from_numpy(bt), torch.from_numpy(pos), lanes,
            splits=splits, scale=SCALE, nj=n_lp,
            page_size=page_size).numpy()
        assert np.max(np.abs(got - ref)) < TOL, splits


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_mla_decode_splits_cover_every_page(sms):
    """``mla_decode_splits`` (host integers only): 1 to 8 blocks a cluster,
    at most one per page of the bucket; the kernel's runs
    (``_split_tiles``) cover a lane's valid tokens in order, whole 16-token tiles but the
    last, none overlapping, and differ by at most one tile.  The serve
    case (4 lanes x 128 heads: 32 clusters on 132 SMs, two blocks an SM)
    takes 7 blocks a cluster, so that all 224 blocks are resident at
    once."""
    for nj in range(1, 130):
        for b, h in ((1, 5), (4, 128), (3, 12), (32, 128)):
            splits = paged_attn.mla_decode_splits(nj, b, h, sms)
            assert 1 <= splits <= min(8, nj)
    for n_valid in range(0, 300):
        for splits in range(1, 9):
            runs = _split_tiles(n_valid, splits)
            assert runs[0][0] == 0 and runs[-1][1] == n_valid
            tiles = []
            for (a, b_), (c, _) in zip(runs, runs[1:] + [(n_valid, 0)]):
                assert a <= b_ and b_ == c and a % 16 == 0
                tiles.append(-(-(b_ - a) // 16))
            assert max(tiles) - min(tiles) <= 1
    assert paged_attn.mla_decode_splits(32, 4, 128, 132) == 7
    assert paged_attn.mla_decode_splits(64, 4, 128, 132) == 7


def _mla_prefill_tensor_cores(q_eff, q_rope, pools, bt, qpos, *, modes,
                              scale, nj, page_size):
    """The MLA prefill kernel's arithmetic written out
    (``paged_mla_prefill_kernel``): per query token, its keys (logical
    index <= qpos, within the first ``nj`` pages) in 32-key tiles; the
    scores' latent and rope parts as exact products of bf16 query terms
    (one for bf16 queries, three for f32) and the stored codes (f64 here,
    the tensor core), each times its token's scale, then ``scale``; the
    online softmax over the tiles; P times each key's latent scale, split
    into three bf16 terms, times the latent codes.  A padded row (qpos =
    -1) gives zeros."""
    cq, cd, kq, kd = pools
    cc = (paged_attn.unpack_q4_rows(cq) if modes[0] == "q4_0" else cq)
    kc = (paged_attn.unpack_q4_rows(kq) if modes[1] == "q4_0" else kq)
    b, c, h, r = q_eff.shape
    nq = 1 if q_eff.dtype == torch.bfloat16 else 3
    neg = paged_attn.NEG_INF
    out = torch.zeros(b, c, h, r)
    _, key_tiles = paged_attn.mla_prefill_tiles(
        qpos, h, page_size=page_size, nj=nj, q_dtype=q_eff.dtype)
    for i in range(b):
        for ci in range(c):
            qp = int(qpos[i, ci])
            if qp < 0:
                continue
            n_valid = min(qp + 1, nj * page_size)
            assert int(key_tiles[i, ci]) == -(-n_valid // 32)
            rows = [int(bt[i, u // page_size]) * page_size + u % page_size
                    for u in range(n_valid)]
            codes_c = cc.reshape(-1, r)[rows].to(torch.float64)
            codes_k = kc.reshape(-1, q_rope.shape[-1])[rows].to(
                torch.float64)
            dc = cd.reshape(-1)[rows].to(torch.float32)
            dk = kd.reshape(-1)[rows].to(torch.float32)
            qe = sum(t.to(torch.float64) for t in bf16_terms(
                q_eff[i, ci].to(torch.float32), nq))
            qr = sum(t.to(torch.float64) for t in bf16_terms(
                q_rope[i, ci].to(torch.float32), nq))
            m = torch.full((h, 1), neg)
            l = torch.zeros(h, 1)
            acc = torch.zeros(h, r)
            for u in range(0, n_valid, 32):
                sl = slice(u, min(u + 32, n_valid))
                s_c = (qe @ codes_c[sl].T).to(torch.float32)
                s_r = (qr @ codes_k[sl].T).to(torch.float32)
                s = (dc[sl] * s_c + dk[sl] * s_r) * scale
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                pv = sum(t.to(torch.float64) for t in bf16_terms(
                    p * dc[sl], 3))
                acc = acc * corr + (pv @ codes_c[sl]).to(torch.float32)
                m = m_new
            out[i, ci] = acc / torch.clamp(l, min=1e-30)
    return out


@pytest.mark.parametrize("modes", [("q8_0", "q8_0"), ("q4_0", "q4_0"),
                                   ("q8_0", "q4_0")],
                         ids=["q8_0", "q4_0", "q8_0+q4_0"])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_mla_prefill_tensor_core_rule_matches_pallas(modes, qdt):
    """The tensor-core prefill's arithmetic (per-token scales on S and
    folded into P, P as three bf16 terms, f32 queries as three, the online
    softmax over 32-key tiles: up to three tiles here), with padded rows,
    every (latent, rope) mode pair and a bounded page loop, against the
    reference's ``_mla_prefill_core`` (Pallas, interpret mode) within
    1e-5."""
    rng = np.random.default_rng(len(modes[0]) + len(modes[1]) + (
        qdt == torch.float32))
    b, c, h, r, dr, n_lp, page_size = 2, 4, 3, 32, 16, 20, 4
    live = [75, 37]
    ckv, kr, bt = _latent_pools(rng, b, n_lp, page_size, r, dr,
                                [page_size * n_lp] * b)
    qpos = np.stack([np.arange(x - c, x) for x in live]).astype(np.int32)
    qpos[1, -2:] = -1
    q_eff = torch.from_numpy(rng.normal(size=(b, c, h, r)).astype(
        np.float32)).to(qdt)
    q_rope = torch.from_numpy(rng.normal(size=(b, c, h, dr)).astype(
        np.float32)).to(qdt)
    jpools = (*JAX_QUANTIZE[modes[0]](jnp.asarray(ckv)),
              *JAX_QUANTIZE[modes[1]](jnp.asarray(kr)))
    ref = np.asarray(jax_pa.paged_mla_prefill_quant(
        jnp.asarray(q_eff.to(torch.float32).numpy()),
        jnp.asarray(q_rope.to(torch.float32).numpy()), *jpools,
        jnp.asarray(bt), jnp.asarray(qpos), scale=SCALE, active_pages=18,
        latent_mode=modes[0], rope_mode=modes[1], impl="pallas",
        interpret=True))
    got = _mla_prefill_tensor_cores(
        q_eff, q_rope, [torch.from_numpy(np.array(a)) for a in jpools],
        torch.from_numpy(bt), torch.from_numpy(qpos), modes=modes,
        scale=SCALE, nj=18, page_size=page_size).numpy()
    assert np.all(got[1, -2:] == 0.0) and np.all(ref[1, -2:] == 0.0)
    assert np.max(np.abs(got - ref)) < TOL


def test_mla_prefill_tiles_from_host_integers():
    """``mla_prefill_tiles``: a block per 64 heads of a token with bf16
    queries (32 with f32), and ceil(min(qpos + 1, nj P) / 32) key tiles a
    token, 0 for a padded row."""
    qpos = torch.tensor([[-1, 0, 31, 32], [99, 399, 1000, 5]])
    for dt, rows in ((torch.bfloat16, 64), (torch.float32, 32)):
        for h in (1, 5, 64, 65, 128):
            ht, kt = paged_attn.mla_prefill_tiles(qpos, h, page_size=16,
                                                  nj=40, q_dtype=dt)
            assert ht == -(-h // rows)
            assert kt.tolist() == [[0, 1, 1, 2], [4, 13, 20, 1]]
