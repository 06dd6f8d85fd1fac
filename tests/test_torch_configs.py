"""The registry's four other full-attention models in the port, reduced,
against the JAX reference: deepseek-r1-distill-qwen-32b (dense GQA, QKV
bias, untied head), qwen2-72b (the same family at group 8), phi3-mini-3.8b
(MHA: a group of 1) and llama4-scout-17b-a16e (GQA beside 16 routed
experts, top-1, and a shared expert).  ``reduced()`` gives every dense one
head_dim 64 and d_ff 512 (two whole superblocks), so two width variants
are added to both packages' configs through ``dataclasses.replace``:
phi3 at its own head_dim 96, and qwen2-72b at d_ff 384 (down's K 1.5
superblocks: ragged, as the full model's 29568 = 115.5).

  * each config's fields equal the reference's, full and reduced, and its
    ``format_map`` equals the reference's path for path under every
    policy, full (all layers) and reduced;
  * the reference's DQ3_K_M weights, carried across with
    ``convert.from_jax_params``, pack to the bytes of the port's and the
    reference's size calculators;
  * two prefill chunks and three decode steps give the reference's logits
    within ``test_torch_model``'s tolerance, 1e-4 of max|logit| (both
    sides f32; summation order only), for model-dtype and q8_0 pools —
    unless a q8_0 code of the first layer whose codes differ sits one step
    from the reference's (a value on a rounding boundary that the two
    summation orders put on either side: qwen2-72b at d_ff 384 has one, in
    layer 1), where ``paged.parity_limit`` sets 1e-3, as the card tests
    do; the caches' positions bitwise, q8_0 codes at most one step apart,
    and float leaves elementwise (rtol 1e-4, atol 1e-5), but for the f32
    pools of distill-32b and qwen2-72b (``LEAF_MAX_REL``), held to 1e-4 of
    the leaf's max|x| as DeepSeek's are;
  * a greedy serve gives the reference engine's token streams and byte
    accounting.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import apply as jax_apply
from repro.core import get_policy as jax_get_policy
from repro.core import size as jax_size
from repro.core.policy import POLICIES as JAX_POLICIES

from repro_torch.configs import get_config
from repro_torch.core import QTensor, apply, get_policy, model_size
from repro_torch.models import paged

from test_torch_engine import _greedy_serve_both
from test_torch_model import (REL_TOL, _check_logits_and_caches, _run_both,
                              reference_weights)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("deepseek-r1-distill-qwen-32b", "qwen2-72b", "phi3-mini-3.8b",
         "llama4-scout-17b-a16e")
# (arch, width replacements of the reduced config), each a case id
VARIANTS = {
    "distill-32b": ("deepseek-r1-distill-qwen-32b", ()),
    "qwen2-72b": ("qwen2-72b", ()),
    "qwen2-72b-ragged-k": ("qwen2-72b", (("d_ff", 384),)),
    "phi3": ("phi3-mini-3.8b", ()),
    "phi3-head-dim-96": ("phi3-mini-3.8b", (("head_dim", 96),)),
    "llama4-scout": ("llama4-scout-17b-a16e", ()),
}
# where a float cache leaf is held to 1e-4 of the leaf's max|x| rather
# than elementwise: distill-32b and qwen2-72b reduce to the same shapes,
# and their f32 pools hold one K value of 3e-3 in layer 1, which takes
# layer 0's summation order, 1.04e-5 from the reference's (the elementwise
# limit there is 1.03e-5)
LEAF_MAX_REL = {("distill-32b", None), ("qwen2-72b", None)}
FIELDS = [f.name for f in dataclasses.fields(get_config("qwen2-72b"))]
# the limit where the first layer whose q8_0 codes differ holds one code a
# step apart (``paged.parity_limit``; the card tests' ``stepped``)
STEPPED_TOL = 1e-3


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for field in FIELDS:
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.padded_vocab == jcfg.padded_vocab


@pytest.mark.parametrize("policy", sorted(JAX_POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_format_map_matches_reference(arch, policy):
    for reduced in (False, True):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        got = apply.format_map(cfg, get_policy(policy))
        assert got == jax_apply.format_map(jcfg, jax_get_policy(policy))


def test_variants_keep_their_case():
    """The width variants hold what ``reduced()`` hides: a head of 96 at a
    group of 1, and a K of down that is not a whole superblock."""
    _, phi3, _, _ = reference_weights("DQ3_K_M", 0, "phi3-mini-3.8b", None,
                                      VARIANTS["phi3-head-dim-96"][1])
    assert (phi3.head_dim, phi3.n_heads // phi3.n_kv_heads) == (96, 1)
    _, qwen, _, params = reference_weights("DQ3_K_M", 0, "qwen2-72b", None,
                                           VARIANTS["qwen2-72b-ragged-k"][1])
    down = params["dec/L000/down"]
    assert down.shape[0] == 384 and down.shape[0] % down.format.block
    assert down.num_superblocks == 2


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_packed_bytes_match_size_calculators(variant):
    arch, widths = VARIANTS[variant]
    jcfg, cfg, _, params = reference_weights("DQ3_K_M", 0, arch, None, widths)
    packed = sum(v.packed_bytes() if isinstance(v, QTensor)
                 else v.numel() * v.element_size() for v in params.values())
    assert packed == model_size(cfg, get_policy("DQ3_K_M")).tpu_bytes
    assert packed == jax_size.model_size(
        jcfg, jax_get_policy("DQ3_K_M")).tpu_bytes


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_logits_match_reference(variant, kv_quant):
    arch, widths = VARIANTS[variant]
    pairs, jc, tc = _run_both("DQ3_K_M", kv_quant, arch=arch, widths=widths)
    cfg = reference_weights("DQ3_K_M", 0, arch, None, widths)[1]
    tol, _ = paged.parity_limit(
        cfg, kv_quant, tc, {k: torch.from_numpy(np.array(v))
                            for k, v in jc.items()},
        exact=REL_TOL, stepped=STEPPED_TOL)
    _check_logits_and_caches(pairs, jc, tc, rel_tol=tol,
                             leaf_max_rel=(variant, kv_quant) in LEAF_MAX_REL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_serve_matches_reference_engine(variant):
    arch, widths = VARIANTS[variant]
    _greedy_serve_both(reference_weights("DQ3_K_M", 0, arch, None, widths),
                       "q8_0")
