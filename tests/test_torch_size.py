"""The port's size calculator (``repro_torch.core.size``) against the
reference's (``repro.core.size``), and the reference's own Table 1 checks
(``tests/test_size_table1.py``) held against the port's copy.

  * ``model_size`` gives the reference's integers — ``total_params``,
    ``gguf_bytes``, ``tpu_bytes``, ``by_role`` and ``by_format`` — for each
    of the port's six configs under every policy the port registers;
  * ``kv_cache_bytes`` (MLA compressed and not) and ``serving_memory``
    equal the reference's;
  * DeepSeek-V3's Table 1 sizes and average bits, their ordering, DQ3_K_M
    fitting one 8-card machine, the compressed MLA cache and the small
    overhead of the stored layout;
  * each of the four other full-attention models fits one 80 GB card
    whole under DQ3_K_M, with a bf16 KV pool of 4 x 1024 tokens.
"""

import pytest

from repro.configs import get_config as jax_get_config
from repro.core import size as jax_size
from repro.core.policy import get_policy as jax_get_policy

from repro_torch.configs import CONFIGS, get_config
from repro_torch.core import (get_policy, kv_cache_bytes, model_size,
                              serving_memory)
from repro_torch.core.policy import POLICIES

ARCHS = sorted(CONFIGS)
# Table 1 (DeepSeek-R1 671B): policy -> (GiB, avg bits)
TABLE1 = {
    "Q4_K_M": (377, 4.82),
    "Q3_K_M": (298, 3.81),
    "DQ3_K_M": (281, 3.59),
    "Q2_K_L": (228, 2.91),
    "UD_Q2_K_XL": (212, 2.70),
}


def test_the_port_registers_six_models():
    assert ARCHS == sorted([
        "qwen2-1.5b", "qwen2-72b", "phi3-mini-3.8b",
        "deepseek-r1-distill-qwen-32b", "llama4-scout-17b-a16e",
        "deepseek-v3-671b"])


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_size_matches_reference(arch, policy):
    got = model_size(get_config(arch), get_policy(policy))
    ref = jax_size.model_size(jax_get_config(arch), jax_get_policy(policy))
    assert (got.arch, got.policy) == (ref.arch, ref.policy)
    assert got.total_params == ref.total_params
    assert got.gguf_bytes == ref.gguf_bytes
    assert got.tpu_bytes == ref.tpu_bytes
    assert got.by_role == {k: list(v) for k, v in ref.by_role.items()}
    assert got.by_format == ref.by_format


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_bytes_match_reference(arch, compressed):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for batch, seq, width in ((1, 32768, 2), (4, 1024, 2), (3, 100, 4)):
        assert kv_cache_bytes(cfg, batch, seq, width, compressed) == \
            jax_size.kv_cache_bytes(jcfg, batch, seq, width, compressed)


@pytest.mark.parametrize("policy", ["DQ3_K_M", "Q4_K_M", "Q8_0"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_memory_matches_reference(arch, policy):
    kw = dict(batch=2, context=8192, n_devices=1, aux_gb=2.0)
    assert serving_memory(get_config(arch), get_policy(policy), **kw) == \
        jax_size.serving_memory(jax_get_config(arch), jax_get_policy(policy),
                                **kw)


@pytest.fixture(scope="module")
def deepseek():
    return get_config("deepseek-v3-671b")


def test_param_count_671b(deepseek):
    n = model_size(deepseek, get_policy("DQ3_K_M")).total_params
    assert abs(n / 1e9 - 671.0) < 1.5, n


@pytest.mark.parametrize("policy,expected", list(TABLE1.items()))
def test_table1_sizes(deepseek, policy, expected):
    gib, bits = expected
    rep = model_size(deepseek, get_policy(policy))
    assert abs(rep.gib - gib) < 1.5, (policy, rep.gib, gib)
    assert abs(rep.avg_bits - bits) < 0.02, (policy, rep.avg_bits, bits)


def test_size_ordering(deepseek):
    sizes = [model_size(deepseek, get_policy(p)).gguf_bytes for p in
             ("Q8_0", "Q4_K_M", "Q3_K_M", "DQ3_K_M", "Q2_K_L", "UD_Q2_K_XL")]
    assert sizes == sorted(sizes, reverse=True)


def test_dq3_fits_single_machine(deepseek):
    """DQ3_K_M fits 8 x 64 GB and 8 x 80 GB; Q4_K_M only 8 x 80 GB."""
    dq3 = serving_memory(deepseek, get_policy("DQ3_K_M"), context=32768,
                         n_devices=8)
    q4 = serving_memory(deepseek, get_policy("Q4_K_M"), context=32768,
                        n_devices=8)
    assert dq3["per_device_gib"] < 64, dq3
    assert q4["per_device_gib"] < 80, q4
    assert q4["per_device_gib"] > dq3["per_device_gib"]


def test_mla_cache_is_compressed(deepseek):
    mla_bytes = kv_cache_bytes(deepseek, batch=1, seq=32768)
    full = (deepseek.n_layers * 2 * deepseek.n_kv_heads * deepseek.head_dim
            * 32768 * 2)
    assert mla_bytes * 8 < full


def test_stored_layout_overhead_small(deepseek):
    rep = model_size(deepseek, get_policy("DQ3_K_M"))
    overhead = rep.tpu_bytes / rep.gguf_bytes - 1.0
    assert 0.0 <= overhead < 0.05, overhead


@pytest.mark.parametrize("arch", ["deepseek-r1-distill-qwen-32b",
                                  "qwen2-72b", "phi3-mini-3.8b",
                                  "llama4-scout-17b-a16e"])
def test_served_whole_on_one_card(arch):
    """The stored weights under DQ3_K_M and a bf16 KV pool of 4 lanes x
    1024 tokens leave room on one 80 GB card (the serve phase of
    ``chip_smoke.py`` serves each at full depth)."""
    cfg = get_config(arch)
    rep = model_size(cfg, get_policy("DQ3_K_M"))
    kv = kv_cache_bytes(cfg, 4, 1024)
    assert (rep.tpu_bytes + kv) / 2 ** 30 < 60, (rep.tpu_gib, kv)
