"""The port's q4_0 and "dq" KV pages against the JAX reference.

  * nibble packing and the q4_0 quantizer are bitwise the reference's,
    over all 256 byte values and seeded rows (half-to-even ties and
    all-zero rows included);
  * ``q4_packed_dim``, ``dq_sensitive_layers``, ``resolve_layer_quant``
    and the cache leaf shapes equal the reference's for qwen2-1.5b (28
    layers, 3, reduced) and deepseek-v3 (61, 7, reduced);
  * the decode and prefill plain versions (the kernels' twins) agree with
    the reference's Pallas kernels in interpret mode, or its XLA twins,
    for GQA q4_0 and MLA (q4_0, q4_0) and (q8_0, q4_0) leaves;
  * model logits, greedy ``Engine.serve`` streams and the byte accounting
    agree with ``repro`` under q4_0 and dq pools (qwen2 reduced to 3
    layers, so dq has a q4_0 layer, and deepseek-v3 reduced);
  * ``Engine(quant_probe=True)`` compares as many steps and lanes as the
    reference engine, with the same gaps, and raises its ``ValueError``s.

Tolerances.  Kernel twins: 1e-5 absolute on O(1) f32 outputs (summation
order only).  Logits: both sides are f32 and differ in summation order;
where that order moves a value across a rounding boundary the two store
codes one step apart.  ``paged.parity_limit`` holds the logits to 1e-4 of
max|logit| where no code is apart (as the q8_0 cases of
``test_torch_model.py``), to 1e-3 where the first layer whose codes
differ has q8_0 codes one step apart (as the q8_0 card tests), and fails
the case where that layer has a q4_0 code apart (a step of 2/14 of the
row's max|x|, whose effect on the logits is not bounded) or any code two
steps apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import paged_attn as jax_pa
from repro.models import paged as jpaged
from repro.models.model import Model as JaxModel
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.sampler import SamplerConfig as JaxSamplerConfig

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attn
from repro_torch.models import paged
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.sampler import SamplerConfig

from test_torch_engine import MAX_NEW, PROMPTS, _greedy_serve_both
from test_torch_kernels import DECODE_CASES, _pools
from test_torch_mla import SCALE, _latent_pools
from test_torch_model import REL_TOL, _run_both, reference_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
MIXED = ("q8_0", "q4_0")      # "dq"'s MLA leaves: q8_0 latent, q4_0 rope


def tk(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def jk(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# packing and the quantizer, bitwise
# ---------------------------------------------------------------------------

def test_q4_unpack_and_repack_every_byte_bitwise():
    """All 256 byte values unpack to the reference's nibbles (the low one
    sign-extended by ``(b << 4) >> 4``, the high one by ``b >> 4``), and
    packing them again gives the bytes back (int8 ``<<`` wraps)."""
    b = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    got = paged_attn.unpack_q4_rows(torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_pa.unpack_q4_rows(jnp.asarray(b)))
    assert got.dtype == np.int8 and got.shape == (4, 128)
    assert got.tobytes() == ref.tobytes()
    assert got.min() == -8 and got.max() == 7
    again = paged_attn.pack_q4_rows(torch.from_numpy(got)).numpy()
    assert again.tobytes() == b.tobytes()
    assert again.tobytes() == np.asarray(jax_pa.pack_q4_rows(
        jnp.asarray(ref))).tobytes()
    with pytest.raises(ValueError, match="even"):
        paged_attn.pack_q4_rows(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("shape", [(5, 3, 2, 16), (4, 7, 64), (2, 3, 6)])
def test_quantize_kv_page_pool_q4_bitwise(shape):
    """Seeded rows at several magnitudes, an all-zero row (d = 0) and a
    row of exact half-steps (x / d = k + 1/2: both round half to even)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape)
         * 10.0 ** rng.integers(-3, 3, size=shape[:-1])[..., None]
         ).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    rows[1] = np.resize(np.float32([7.0, 0.5, 1.5, 2.5, -3.5, -0.5]),
                        shape[-1])
    qs_j, d_j = jax_pa.quantize_kv_page_pool_q4(jnp.asarray(x))
    qs_t, d_t = paged_attn.quantize_kv_page_pool_q4(torch.from_numpy(x))
    assert qs_t.dtype == torch.int8 and qs_t.shape[-1] == shape[-1] // 2
    assert qs_t.numpy().tobytes() == np.asarray(qs_j).tobytes()
    assert d_t.numpy().tobytes() == np.asarray(d_j).tobytes()
    for mode in ("q8_0", "q4_0"):
        jq, jd, jdq = jpaged.roundtrip_quant(jnp.asarray(x), mode)
        tq, td, tdq = paged.roundtrip_quant(torch.from_numpy(x), mode)
        for a, b in ((jq, tq), (jd, td), (jdq, tdq)):
            assert b.numpy().tobytes() == np.asarray(a).tobytes(), mode


def test_q4_scatters_and_gather_bitwise():
    """Quantize-on-write token and chunk scatters of q4_0 rows (GARBAGE
    routing, a last-writer-wins plan) and the dequantizing gather."""
    rng = np.random.default_rng(4)
    n_pages, p, hkv, d = 8, 3, 2, 16
    bt = np.array([[2, 3, 4], [5, 6, 7]], np.int32)
    pools = [np.zeros((n_pages, p, hkv, d // 2), np.int8),
             np.zeros((n_pages, p, hkv), np.float32)]
    tq = [torch.from_numpy(a.copy()) for a in pools]
    jq = [jnp.asarray(a) for a in pools]
    val = rng.normal(size=(2, hkv, d)).astype(np.float32)
    idx, ok = np.array([4, 7], np.int32), np.array([True, False])
    jq = list(jpaged.scatter_token_quant(*jq, jk(bt), jk(idx), jk(val),
                                         ok=jk(ok), mode="q4_0"))
    paged.scatter_token_quant(*tq, tk(bt), tk(idx), tk(val), ok=tk(ok),
                              mode="q4_0")
    chunk = rng.normal(size=(2, 4, hkv, d)).astype(np.float32)
    cidx = np.array([[0, 1, 2, 1], [5, 6, 7, 8]], np.int32)
    valid = np.array([[True, True, True, True], [True, True, False, False]])
    jok = jpaged.chunk_write_plan(jk(cidx), jk(valid), 9)
    tok = paged.chunk_write_plan(tk(cidx), tk(valid), 9)
    jq = list(jpaged.scatter_chunk_quant(*jq, jk(bt), jk(cidx),
                                         jk(chunk), jok, mode="q4_0"))
    qs, dd = paged.quantize_rows(tk(chunk), "q4_0")
    for pool, v in zip(tq, (qs, dd)):
        paged.scatter_chunk(pool, tk(bt), tk(cidx), v, tok)
    read = [i for i in range(n_pages) if i != paged.GARBAGE_PAGE]
    for a, b in zip(jq, tq):
        assert b.numpy()[read].tobytes() == np.asarray(a)[read].tobytes()
    got = paged.gather_pages_quant(*tq, tk(bt), 8, mode="q4_0")
    ref = jpaged.gather_pages_quant(*jq, jk(bt), 8, mode="q4_0")
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()


# ---------------------------------------------------------------------------
# the per-layer policy and the cache layouts
# ---------------------------------------------------------------------------

def test_q4_packed_dim_and_dq_sensitive_layers():
    for w in (2, 64, 128, 512):
        assert paged.q4_packed_dim(w) == jpaged.q4_packed_dim(w) == w // 2
    for w in (1, 63):
        with pytest.raises(ValueError, match="even"):
            paged.q4_packed_dim(w)
    for n in range(1, 70):
        assert paged.dq_sensitive_layers(n) == jpaged.dq_sensitive_layers(n)
    assert paged.dq_sensitive_layers(2) == {0, 1}
    assert paged.dq_sensitive_layers(3) == {0, 2}
    assert paged.dq_sensitive_layers(28) == {0, 1, 2, 25, 26, 27}
    with pytest.raises(ValueError, match="unknown kv_quant"):
        paged.check_kv_quant("q2_0")


@pytest.mark.parametrize("arch,n_layers", [
    ("qwen2-1.5b", 28), ("qwen2-1.5b", 3), ("qwen2-1.5b", None),
    ("deepseek-v3-671b", 61), ("deepseek-v3-671b", 7),
    ("deepseek-v3-671b", None)])
def test_layer_modes_and_cache_leaves_match_reference(arch, n_layers):
    """``resolve_layer_quant`` per layer and every cache leaf's shape and
    dtype (packed q4_0 widths included), at full width (``None``: the
    reduced config)."""
    import dataclasses

    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if n_layers is None:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    else:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jm, tm = JaxModel(jcfg, dtype=jnp.bfloat16), Model(cfg)
    for kv in (None, "q8_0", "q4_0", "dq"):
        for layer in range(cfg.n_layers):
            assert (paged.resolve_layer_quant(kv, cfg, layer)
                    == jpaged.resolve_layer_quant(kv, jcfg, layer))
        specs = jm.paged_cache_specs(5, 4, 2, dtype=jnp.bfloat16,
                                     kv_quant=kv)
        meta = tm.init_paged_cache(5, 4, 2, dtype=torch.bfloat16,
                                   kv_quant=kv, device="meta")
        assert sorted(meta) == sorted(specs), kv
        for key, spec in specs.items():
            assert tuple(meta[key].shape) == tuple(spec.shape), (kv, key)
            assert str(meta[key].dtype).endswith(str(spec.dtype)), (kv, key)
    if cfg.n_layers == 3 and not cfg.mla:
        # dq at depth 3: layer 1 alone packs q4_0
        leaves = tm.init_paged_cache(3, 2, 1, kv_quant="dq", device="meta")
        assert [leaves[f"dec/L{i:03d}/k_qs"].shape[-1] for i in range(3)] == [
            cfg.head_dim, cfg.head_dim // 2, cfg.head_dim]


# ---------------------------------------------------------------------------
# the kernels' plain versions (B5's q4_0 loaders) against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", DECODE_CASES)
def test_q4_decode_plain_matches_pallas(case):
    """GQA decode over q4_0 pools (B3's q4_0 loader) vs the Pallas kernel
    in interpret mode: ragged last pages, window + softcap, active and
    per-lane page bounds."""
    page_size, window, softcap, active, lanes = case
    rng = np.random.default_rng(page_size * 5 + window)
    b, h, hkv, d, n_lp = 3, 4, 2, 16, 6
    live = [page_size * 2 + 1, page_size * 4, 2]
    if lanes is not None:
        live = [min(x, lp * page_size) for x, lp in zip(live, lanes)]
    k, v, pos_pool, bt = _pools(rng, b, n_lp, page_size, hkv, d, live)
    pos = np.array([x - 1 for x in live], np.int32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lp = None if lanes is None else np.array(lanes, np.int32)
    pools = [np.asarray(a) for a in (
        *jax_pa.quantize_kv_page_pool_q4(jnp.asarray(k)),
        *jax_pa.quantize_kv_page_pool_q4(jnp.asarray(v)))]
    assert pools[0].shape[-1] == d // 2
    kw = dict(window=window, softcap=softcap, active_pages=active)
    ref = jax_pa.paged_attn_decode_quant(
        jk(q), *map(jk, pools), jk(pos_pool), jk(bt), jk(pos), mode="q4_0",
        lane_pages=jk(lp), impl="pallas", interpret=True, **kw)
    before = paged_attn.paged_attn_decode_quant.loaders["q4_0"].launches
    got = paged_attn.paged_attn_decode_quant(
        tk(q), *map(tk, pools), tk(pos_pool), tk(bt), tk(pos), mode="q4_0",
        lane_pages=tk(lp), **kw)
    assert paged_attn.paged_attn_decode_quant.loaders[
        "q4_0"].launches == before
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) < TOL


@pytest.mark.parametrize("page_size,active", [(3, None), (5, 3), (4, 6)])
def test_q4_prefill_plain_matches_pallas(page_size, active):
    """Write-then-attend chunk prefill over q4_0 pools (B4's q4_0 loader),
    with padded query rows (qpos = -1 -> zeros) and stale rows past a
    lane's frontier."""
    rng = np.random.default_rng(page_size + 17)
    b, c, h, hkv, d, n_lp = 2, 5, 4, 2, 16, 6
    live = [page_size * 2 + 2, page_size + 1]
    k, v, pos_pool, bt = _pools(rng, b, n_lp, page_size, hkv, d, live)
    qpos = np.stack([np.arange(x - c, x) for x in live]).astype(np.int32)
    qpos[1, -2:] = -1
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    pools = [np.asarray(a) for a in (
        *jax_pa.quantize_kv_page_pool_q4(jnp.asarray(k)),
        *jax_pa.quantize_kv_page_pool_q4(jnp.asarray(v)))]
    ref = np.asarray(jax_pa.paged_attn_prefill_quant(
        jk(q), *map(jk, pools), jk(pos_pool), jk(bt), jk(qpos), mode="q4_0",
        active_pages=active, impl="pallas", interpret=True))
    got = paged_attn.paged_attn_prefill_quant(
        tk(q), *map(tk, pools), tk(pos_pool), tk(bt), tk(qpos), mode="q4_0",
        active_pages=active).numpy()
    assert got.shape == (b, c, h, d)
    assert np.all(got[1, -2:] == 0.0)
    assert np.max(np.abs(got - ref)) < TOL


def _mla_pools(ckv, kr, modes):
    quant = {"q8_0": jax_pa.quantize_kv_page_pool,
             "q4_0": jax_pa.quantize_kv_page_pool_q4}
    return [np.asarray(a) for a in (*quant[modes[0]](jnp.asarray(ckv)),
                                     *quant[modes[1]](jnp.asarray(kr)))]


@pytest.mark.parametrize("modes", [("q4_0", "q4_0"), MIXED])
@pytest.mark.parametrize("case,impl", [
    ((3, None, None, [7, 12, 2]), "xla"),
    ((4, 5, [2, 5, 1], [7, 19, 3]), "xla"),      # bounds short of nj
    ((16, None, [3, 1, 2], [33, 1, 17]), "xla"),  # the serving page size
    ((3, 3, [2, 3, 1], [5, 8, 1]), "pallas")])
def test_mla_q4_decode_plain_matches_reference(modes, case, impl):
    """Absorbed MLA decode over (q4_0, q4_0) and dq's (q8_0, q4_0) leaves
    (B6's q4_0 loaders); rope width 14 packs to an odd 7 bytes."""
    page_size, active, lanes, live = case
    rng = np.random.default_rng(page_size * 13 + len(modes[0]))
    b, h, r, dr, n_lp = 3, 4, 32, 14, 6
    ckv, kr, bt = _latent_pools(rng, b, n_lp, page_size, r, dr, live)
    pools = _mla_pools(ckv, kr, modes)
    pos = np.array([x - 1 for x in live], np.int32)
    q_eff = rng.normal(size=(b, h, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, h, dr)).astype(np.float32)
    lp = None if lanes is None else np.array(lanes, np.int32)
    kw = dict(scale=SCALE, active_pages=active, latent_mode=modes[0],
              rope_mode=modes[1])
    ref = jax_pa.paged_mla_decode_quant(
        jk(q_eff), jk(q_rope), *map(jk, pools), jk(bt), jk(pos),
        lane_pages=jk(lp), impl=impl, interpret=True, **kw)
    got = paged_attn.paged_mla_decode_quant(
        tk(q_eff), tk(q_rope), *map(tk, pools), tk(bt), tk(pos),
        lane_pages=tk(lp), **kw)
    assert got.shape == (b, h, r)
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) < TOL


@pytest.mark.parametrize("modes", [("q4_0", "q4_0"), MIXED])
@pytest.mark.parametrize("page_size,active,impl", [
    (3, None, "xla"), (16, None, "xla"), (4, None, "pallas")])
def test_mla_q4_prefill_plain_matches_reference(modes, page_size, active,
                                                impl):
    """Write-then-attend MLA prefill over q4_0-bearing latent pools (B7's
    q4_0 loaders), padded rows and stale tokens past a lane's frontier."""
    rng = np.random.default_rng(page_size + 37)
    b, c, h, r, dr, n_lp = 2, 5, 4, 32, 16, 6
    live = [page_size * 2 + 2, page_size + 1]
    ckv, kr, bt = _latent_pools(rng, b, n_lp, page_size, r, dr,
                                [page_size * n_lp] * b)
    pools = _mla_pools(ckv, kr, modes)
    qpos = np.stack([np.arange(x - c, x) for x in live]).astype(np.int32)
    qpos[1, -2:] = -1
    q_eff = rng.normal(size=(b, c, h, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, c, h, dr)).astype(np.float32)
    kw = dict(scale=SCALE, active_pages=active, latent_mode=modes[0],
              rope_mode=modes[1])
    ref = np.asarray(jax_pa.paged_mla_prefill_quant(
        jk(q_eff), jk(q_rope), *map(jk, pools), jk(bt), jk(qpos),
        impl=impl, interpret=True, **kw))
    got = paged_attn.paged_mla_prefill_quant(
        tk(q_eff), tk(q_rope), *map(tk, pools), tk(bt), tk(qpos),
        **kw).numpy()
    assert np.all(got[1, -2:] == 0.0)
    assert np.max(np.abs(got - ref)) < TOL


# ---------------------------------------------------------------------------
# the model and the engine against the reference
# ---------------------------------------------------------------------------

# (arch, reduced depth, weight seed): qwen2 at 3 layers so that dq packs
# layer 1 in q4_0; deepseek-v3 reduced (5 layers: dq packs the rope keys
# of layers 1-3)
MODELS = [("qwen2-1.5b", 3, 0), ("deepseek-v3-671b", None, 1)]


@pytest.mark.parametrize("kv_quant", ["q4_0", "dq"])
@pytest.mark.parametrize("arch,n_layers,seed", MODELS)
def test_q4_logits_match_reference(arch, n_layers, seed, kv_quant):
    """Two prefill chunks at one fixed chunk size and three decode steps
    (the reference itself is not chunk-size invariant under q4_0/dq)."""
    pairs, jc, tc = _run_both("DQ3_K_M", kv_quant, arch=arch, seed=seed,
                              n_layers=n_layers)
    cfg = reference_weights("DQ3_K_M", seed, arch, n_layers)[1]
    assert sorted(tc) == sorted(jc)
    for key, v in jc.items():
        ref, got = np.asarray(v), tc[key].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, key
        if key.endswith("/pos"):
            assert np.array_equal(got, ref), key
    tol, _ = paged.parity_limit(
        cfg, kv_quant, tc, {k: torch.from_numpy(np.array(v))
                            for k, v in jc.items()},
        exact=REL_TOL, stepped=1e-3)
    for i, (ref, got) in enumerate(pairs):
        assert np.isfinite(got).all()
        err = np.max(np.abs(got - ref))
        assert err <= tol * np.max(np.abs(ref)), (i, err, tol)


@pytest.mark.parametrize("kv_quant", ["q4_0", "dq"])
@pytest.mark.parametrize("arch,n_layers,seed", MODELS)
def test_q4_greedy_serve_matches_reference_engine(arch, n_layers, seed,
                                                  kv_quant):
    """Greedy streams, the scheduler's counts and the byte accounting
    (page bytes, bytes per live token, KV bytes per decoded token) equal
    the reference engine's."""
    _greedy_serve_both(reference_weights("DQ3_K_M", seed, arch, n_layers),
                       kv_quant)


def _reqs(cls, rids):
    return [cls(rid=i, prompt=list(PROMPTS[i]), max_new=MAX_NEW[i])
            for i in rids]


@pytest.mark.parametrize("kv_quant", ["q4_0", "dq"])
def test_quant_probe_matches_reference_engine(kv_quant):
    """Two requests in two slots: the probe compares the same steps and
    lanes as the reference's, and each lane's gap agrees to 1e-3 of
    itself (both sides f32: summation order, and the codes it may move).
    With a slot per request no page is handed to a second owner, where the
    reference's shadow pools keep the previous owner's positions (see
    the next test)."""
    jcfg, cfg, jparams, params = reference_weights("DQ3_K_M", 0,
                                                   "qwen2-1.5b", 3)
    kw = dict(max_len=32, page_size=4, prefill_chunk=4, kv_quant=kv_quant,
              quant_probe=True)
    jeng = JaxEngine(JaxModel(jcfg, dtype=jnp.float32), jparams, jit=False,
                     sampler=JaxSamplerConfig(greedy=True), kernel="fused",
                     **kw)
    jeng.serve(_reqs(JaxRequest, range(2)), slots=2, seed=0)
    teng = Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
                  sampler=SamplerConfig(greedy=True), **kw)
    teng.serve(_reqs(Request, range(2)), slots=2, seed=0)
    js, ts = jeng.last_stats, teng.last_stats
    assert ts.quant_probe_steps == js.quant_probe_steps > 0
    assert len(ts.quant_logit_gap_per_lane) == len(
        js.quant_logit_gap_per_lane) == 2
    got = np.asarray(ts.quant_logit_gap_per_lane)
    ref = np.asarray(js.quant_logit_gap_per_lane)
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    assert "quant probe (%s)" % kv_quant in ts.report()


def test_quant_probe_gap_does_not_depend_on_page_reuse():
    """Two slots for four requests, so lanes and pages pass to new owners:
    the worst lane's gap equals the worst of the requests' gaps served one
    at a time.  The engine scrubs freed pages' positions in the shadow
    pools as in the served ones, so no request attends its page's
    previous owner's rows."""
    _, cfg, _, params = reference_weights("DQ3_K_M", 0, "qwen2-1.5b", 3)
    eng = Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
                 max_len=32, page_size=4, prefill_chunk=4, kv_quant="q4_0",
                 quant_probe=True, sampler=SamplerConfig(greedy=True))
    eng.serve(_reqs(Request, range(4)), slots=2, seed=0)
    shared = eng.last_stats.quant_logit_gap_max
    alone = []
    for rid in range(4):
        eng.serve(_reqs(Request, [rid]), slots=1, seed=0)
        alone.append(eng.last_stats.quant_logit_gap_max)
    assert shared == pytest.approx(max(alone), rel=1e-3)


def test_quant_probe_validation():
    """The probe needs a quantized cache and the reserve scheduler (it
    shadows every step one for one), as the reference's."""
    _, cfg, _, params = reference_weights("DQ3_K_M", 0, "qwen2-1.5b", 3)
    model = Model(cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_quant"):
        Engine(model, params, device="cpu", page_size=4, quant_probe=True)
    for kw in ({"scheduler": "preempt"}, {"faults": object()},
               {"mesh": object()}):
        with pytest.raises(ValueError, match="scheduler"):
            Engine(model, params, device="cpu", page_size=4, kv_quant="dq",
                   quant_probe=True, **kw)
    eng = Engine(model, params, device="cpu", page_size=4, max_len=32,
                 kv_quant="q8_0", sampler=SamplerConfig(greedy=True))
    eng.serve([Request(rid=0, prompt=[5, 6, 7], max_new=3)], slots=1)
    st = eng.last_stats
    assert st.quant_probe_steps == 0 and st.quant_logit_gap_per_lane == []
    assert st.quant_logit_gap_max == 0.0 and "quant probe" not in st.report()
