"""The port under the paper's other weight policies against the JAX reference.

Q3_K_M, Q2_K_L, UD_Q2_K_XL and Q8_0 put the q5_k, q2_k and q8_0 formats on
the serving path (kernel B1's forms for them are held against the
reference's Pallas kernels in ``test_torch_kernels.py`` and against its
batched path in ``test_torch_moe.py``):

  * ``format_map`` equals the reference path for path for every registered
    policy, on qwen2-1.5b (full and reduced) and deepseek-v3-671b (61
    layers and the 7-layer cut the card serves);
  * the seeded quantized init of deepseek-v3 reduced packs to the bytes of
    the reference's size calculator under each of those policies and under
    Q4_K_M, the paper's 4-bit baseline;
  * prefill + decode logits of deepseek-v3 reduced under Q2_K_L, Q3_K_M,
    Q4_K_M and Q8_0 and of qwen2-1.5b reduced under Q3_K_M and Q8_0,
    model-dtype pools, within ``test_torch_model``'s tolerance (1e-4 of
    max|logit|);
  * the greedy engine stream of deepseek-v3 reduced under Q2_K_L equals
    the reference engine's, with its byte accounting.
"""

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.core import apply as jax_apply
from repro.core import get_policy as jax_get_policy
from repro.core import size as jax_size
from repro.core.policy import POLICIES as JAX_POLICIES

from repro_torch.configs import get_config
from repro_torch.core import (QTensor, apply, get_policy,
                              init_quantized_params)
from repro_torch.core.policy import POLICIES

from test_torch_engine import _greedy_serve_both
from test_torch_model import (_check_logits_and_caches, _run_both,
                              reference_weights)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OTHER_POLICIES = ("Q3_K_M", "Q2_K_L", "UD_Q2_K_XL", "Q8_0")


def _configs(arch: str, variant: str):
    """(port cfg, reference cfg): ``full``, ``reduced`` or a layer count."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if variant == "reduced":
        return cfg.reduced(), jcfg.reduced()
    if variant == "full":
        return cfg, jcfg
    n = int(variant)
    return (dataclasses.replace(cfg, n_layers=n),
            dataclasses.replace(jcfg, n_layers=n))


def test_every_reference_policy_is_registered():
    assert sorted(POLICIES) == sorted(JAX_POLICIES)


@pytest.mark.parametrize("policy", sorted(JAX_POLICIES))
@pytest.mark.parametrize("arch,variant", [
    ("qwen2-1.5b", "full"), ("qwen2-1.5b", "reduced"),
    ("deepseek-v3-671b", "61"), ("deepseek-v3-671b", "7")])
def test_format_map_matches_reference(policy, arch, variant):
    cfg, jcfg = _configs(arch, variant)
    got = apply.format_map(cfg, get_policy(policy))
    assert got == jax_apply.format_map(jcfg, jax_get_policy(policy))


@pytest.mark.parametrize("policy", OTHER_POLICIES + ("Q4_K_M",))
def test_packed_bytes_match_reference_size_calculator(policy):
    cfg = get_config("deepseek-v3-671b").reduced()
    params = init_quantized_params(cfg, get_policy(policy), 0)
    packed = sum(v.packed_bytes() if isinstance(v, QTensor)
                 else v.numel() * v.element_size() for v in params.values())
    ref = jax_size.model_size(jax_get_config("deepseek-v3-671b").reduced(),
                              jax_get_policy(policy))
    assert packed == ref.tpu_bytes


@pytest.mark.parametrize("arch,policy", [
    ("deepseek-v3-671b", "Q2_K_L"), ("deepseek-v3-671b", "Q3_K_M"),
    ("deepseek-v3-671b", "Q4_K_M"), ("deepseek-v3-671b", "Q8_0"),
    ("qwen2-1.5b", "Q3_K_M"), ("qwen2-1.5b", "Q8_0")])
def test_prefill_and_decode_logits_match_reference(arch, policy):
    """Q2_K_L: q2_k 2-D and experts, q3_k 2-D and experts; Q3_K_M: q5_k
    dense down, q3_k and q4_k experts; Q4_K_M: q4_k and q6_k experts;
    Q8_0: q8_0 everywhere (on deepseek its experts too).  Weight seed 1,
    as the DQ3_K_M deepseek case."""
    _check_logits_and_caches(*_run_both(policy, None, arch=arch, seed=1),
                             leaf_max_rel=arch == "deepseek-v3-671b")


def test_deepseek_greedy_serve_matches_reference_engine_q2_k_l():
    _greedy_serve_both(reference_weights("Q2_K_L", 1, "deepseek-v3-671b"),
                       None)
