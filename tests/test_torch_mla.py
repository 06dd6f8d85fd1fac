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

