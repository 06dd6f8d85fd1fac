"""The port's model (qwen2-1.5b reduced) against the JAX reference.

Weights are made once by the reference (``repro.models.spec.init_params``,
f32) and carried across with ``repro_torch.convert.from_jax_params``, so
both packages compute the same function:

  * quantizing under DQ3_K_M in both packages gives bitwise-equal QTensor
    fields (and the same float leaves);
  * ``prefill_chunk`` (two chunks, the second over the first's pages) and
    three ``decode_step_paged`` steps give the same logits as
    ``repro.models.model.Model(cfg, dtype=f32)``, for model-dtype and q8_0
    pools, under DQ3_K_M and unquantized F32 weights.

Tolerance: max|d logits| <= 1e-4 * max|logit|.  Both sides are f32; they
differ in summation order, in f32 ``pow``/``cos``/``sin`` for RoPE, and
the reference's decode runs its XLA twin where the port runs the plain
version (the same algorithm).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import get_policy as jax_get_policy
from repro.core import quantize_params as jax_quantize_params
from repro.core.qtensor import QTensor as JaxQTensor
from repro.models.model import Model as JaxModel
from repro.models.spec import init_params as jax_init_params

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core import QTensor, get_policy, quantize_params
from repro_torch.models import paged
from repro_torch.models.model import Model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_TOL = 1e-4


def export(params) -> dict:
    """The reference's parameter tree as numpy (the convert format)."""
    out = {}
    for path, v in params.items():
        if isinstance(v, JaxQTensor):
            out[path] = {"fmt": v.fmt, "shape": v.shape,
                         "fields": {k: np.asarray(a)
                                    for k, a in v.fields.items()}}
        else:
            out[path] = np.asarray(v)
    return out


def reference_weights(policy: str, seed: int = 0, arch: str = "qwen2-1.5b",
                      n_layers: int | None = None, widths: tuple = ()):
    """(jax cfg, port cfg, jax params, port params) for ``arch`` reduced
    (to ``n_layers`` layers when given, and with the ``(field, value)``
    pairs of ``widths`` replaced in both configs), quantized under
    ``policy`` by the reference (made once per process: the reference
    quantizes deepseek-v3 reduced in ~30 s here).  Nothing mutates them:
    the models write only their caches."""
    return _reference_weights(policy, seed, arch, n_layers, tuple(widths))


@functools.lru_cache(maxsize=None)
def _reference_weights(policy, seed, arch, n_layers, widths):
    over = dict(widths)
    if n_layers is not None:
        over["n_layers"] = n_layers
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    raw = jax_init_params(jcfg, seed, dtype=jnp.float32)
    jparams = jax_quantize_params(jcfg, raw, jax_get_policy(policy))
    return jcfg, cfg, jparams, from_jax_params(export(jparams))


def test_quantize_params_bitwise():
    jcfg = jax_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    raw = jax_init_params(jcfg, 0, dtype=jnp.float32)
    ref = jax_quantize_params(jcfg, raw, jax_get_policy("DQ3_K_M"))
    got = quantize_params(cfg, from_jax_params(export(raw)),
                          get_policy("DQ3_K_M"))
    assert sorted(got) == sorted(ref)
    n_q = 0
    for path, r in ref.items():
        g = got[path]
        if isinstance(r, JaxQTensor):
            n_q += 1
            assert isinstance(g, QTensor) and g.fmt == r.fmt
            assert g.shape == r.shape
            for k, a in r.fields.items():
                assert g.fields[k].numpy().tobytes() == np.asarray(
                    a).tobytes(), (path, k)
        else:
            assert str(g.dtype).endswith(str(r.dtype)), (path, g.dtype)
            assert np.array_equal(g.float().numpy(),
                                  np.asarray(r, np.float32))
    assert n_q == 1 + 7 * cfg.n_layers


def _run_both(policy, kv_quant, arch="qwen2-1.5b", seed=0, n_layers=None,
              widths=()):
    jcfg, cfg, jparams, params = reference_weights(policy, seed, arch,
                                                   n_layers, widths)
    P, max_len, b, c = 3, 24, 2, 5
    n = paged.pages_for(max_len, P)
    num_pages = paged.RESERVED_PAGES + b * n
    bt = np.array([[paged.RESERVED_PAGES + i * n + j for j in range(n)]
                   for i in range(b)], np.int32)
    rng = np.random.default_rng(5)
    toks = rng.integers(4, cfg.vocab_size, (2, b, c)).astype(np.int32)
    clens = [np.array([c, c], np.int32), np.array([c, 3], np.int32)]
    starts = [np.array([0, 0], np.int32), np.array([c, c], np.int32)]

    jm = JaxModel(jcfg, dtype=jnp.float32)
    tm = Model(cfg, dtype=torch.float32)
    jc = jm.init_paged_cache(num_pages, P, b, dtype=jnp.float32,
                             kv_quant=kv_quant)
    tc = tm.init_paged_cache(num_pages, P, b, dtype=torch.float32,
                             kv_quant=kv_quant)
    jt, tt = {"full": jnp.asarray(bt)}, {"full": torch.from_numpy(bt)}
    kw = dict(max_len=max_len, page_size=P, kv_quant=kv_quant)
    pairs = []
    for step in range(2):
        active = (paged.pages_for(int((starts[step] + clens[step]).max()), P),
                  0)
        jl, jc = jm.prefill_chunk(
            jparams, jc, jnp.asarray(toks[step]), jnp.asarray(starts[step]),
            jnp.asarray(clens[step]), block_tables=jt, kernel="fused",
            active_pages=active, **kw)
        tl, tc = tm.prefill_chunk(
            params, tc, torch.from_numpy(toks[step]),
            torch.from_numpy(starts[step]), torch.from_numpy(clens[step]),
            block_tables=tt, active_pages=active, **kw)
        pairs.append((np.asarray(jl), tl.numpy()))
    pos = starts[1] + clens[1]
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(3):
        lane = np.array([paged.pages_for(int(p) + 1, P) for p in pos],
                        np.int32)
        active = (int(lane.max()), 0)
        jl, jc = jm.decode_step_paged(
            jparams, jc, jnp.asarray(tok), jnp.asarray(pos), jt,
            kernel="fused", active_pages=active,
            lane_pages={"full": jnp.asarray(lane)}, **kw)
        tl, tc = tm.decode_step_paged(
            params, tc, torch.from_numpy(tok), torch.from_numpy(pos), tt,
            active_pages=active, lane_pages={"full": torch.from_numpy(lane)},
            **kw)
        pairs.append((np.asarray(jl), tl.numpy()))
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        pos = pos + 1
    return pairs, jc, tc


def _check_logits_and_caches(pairs, jc, tc, leaf_max_rel=False,
                             rel_tol=REL_TOL):
    """Logits within ``rel_tol`` of max|logit|; cache positions bitwise, q8_0
    codes at most one step apart, float leaves elementwise (rtol 1e-4,
    atol 1e-5) or, with ``leaf_max_rel``, within REL_TOL of the leaf's
    max|x| like the logits (MLA latents pass through every layer of the
    model before they are stored)."""
    for i, (ref, got) in enumerate(pairs):
        assert got.shape == ref.shape == (2, 512)
        assert np.isfinite(got).all()
        err = np.max(np.abs(got - ref))
        assert err <= rel_tol * np.max(np.abs(ref)), (i, err)
    # the caches hold the same pages: positions bitwise, q8 payloads
    # agree except where a rounding tie flips one code
    assert sorted(tc) == sorted(jc)
    for key, v in jc.items():
        ref = np.asarray(v)
        got = tc[key].numpy()
        if key.endswith("/pos"):
            assert np.array_equal(got, ref), key
        elif key.endswith("_qs"):
            assert np.max(np.abs(got.astype(int) - ref.astype(int))) <= 1
        elif leaf_max_rel:
            assert np.max(np.abs(got - ref)) <= REL_TOL * np.max(
                np.abs(ref)), key
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
@pytest.mark.parametrize("policy", ["DQ3_K_M", "F32"])
def test_prefill_and_decode_logits_match_reference(policy, kv_quant):
    _check_logits_and_caches(*_run_both(policy, kv_quant))


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_deepseek_prefill_and_decode_logits_match_reference(kv_quant):
    """deepseek-v3 reduced: 1 dense + 4 MoE layers, so ``down_exps`` takes
    all three DQ3_K_M formats (q6_k, q6_k, q4_k, q3_k); absorbed-MLA decode
    and prefill, MoE dispatch and combine.  Weight seed 1: under seed 0
    one q8_0 latent value of layer 3 sits on a rounding boundary that the
    two packages' f32 summation orders put on opposite sides, and one code
    step (1/127 of the row's max) moves the later layers' logits by ~1e-3
    relative — a tie in the data, not a difference in the function."""
    _check_logits_and_caches(*_run_both("DQ3_K_M", kv_quant,
                                        arch="deepseek-v3-671b", seed=1),
                             leaf_max_rel=True)


def test_model_rejects_unported_paths():
    """Local-attention block families are not ported (D6).  The dense
    layout is (D5): a chunk over it refuses only what the reference
    refuses, quantized pools, which exist only paged."""
    _, cfg, _, params = reference_weights("F32")
    model = Model(cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_quant requires a paged cache"):
        model.prefill_chunk(params, model.init_cache(1, 8, torch.float32),
                            torch.zeros((1, 2), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32), max_len=8,
                            kv_quant="q8_0")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(get_config("qwen2-1.5b").__class__(
            name="local", family="hybrid", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=2, vocab_size=256, d_ff=64,
            block_pattern=("local_attn", "attn"), window=16))
