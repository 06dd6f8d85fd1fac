"""The port's MoE layer, expert weights and kernel B1's new forms (q3_k,
expert-batched) against the JAX reference.

  * ``ops.qmatmul`` (the plain version of B1 on the CPU) for q3_k weights
    against the reference's Pallas q3_k kernel (interpret mode), and for
    expert weights (E, K, N) of every packed format against the
    reference's batched path, f32: within 1e-5 of max|y|;
  * expert weights quantize bitwise equal to the reference, and a group
    of experts at a time bitwise equal to the whole weight; the seeded
    quantized init (``init_quantized_params``) equals quantizing the seeded
    unquantized tree, bitwise;
  * ``moe_apply`` at reduced width, f32, drop-free (``capacity_factor``
    8.0) and dropping tokens (1.0): the same kept set, outputs and aux
    value within 1e-5;
  * at the decode shape (4 tokens, 256 experts, top-8, capacity 1) the
    same experts are empty in both packages' dispatch, and ``expert_ffn``
    gives them exact zeros — what lets B1 skip them on the card;
  * ``format_map`` equals the reference path for path for deepseek-v3-671b
    (61 layers and the 7-layer cut) under DQ3_K_M and Q4_K_M.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import apply as jax_apply
from repro.core import get_policy as jax_get_policy
from repro.core import quantize as jax_quantize
from repro.core import size as jax_size
from repro.kernels import ops as jax_ops
from repro.models import moe as jax_moe
from repro.models.spec import init_params as jax_init_params
from repro.models.spec import subview as jax_subview

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core import (apply, get_policy, init_quantized_params,
                              quantize_params)
from repro_torch.core.qtensor import QTensor, quantize
from repro_torch.kernels import ops, qmatmul
from repro_torch.models import moe
from repro_torch.models.spec import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _export(q) -> dict:
    return {"fmt": q.fmt, "shape": q.shape,
            "fields": {k: np.array(v) for k, v in q.fields.items()}}


def _qt_pair(fmt, shape, seed):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jq = jax_quantize(jnp.asarray(w), fmt)
    return w, jq, from_jax_params({"w": _export(jq)})["w"]


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (4, 512, 256),
                                   (13, 300, 128)])
def test_qmatmul_q3_k_plain_matches_pallas(m, k, n):
    _, jq, tq = _qt_pair("q3_k", (k, n), seed=m + k)
    x = np.random.default_rng(n).normal(size=(m, k)).astype(np.float32)
    ref = np.asarray(jax_ops.qmatmul(jnp.asarray(x), jq, impl="pallas"))
    before = qmatmul.qmatmul_q3_k.launches
    got = ops.qmatmul(torch.from_numpy(x), tq)
    assert qmatmul.qmatmul_q3_k.launches == before
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - ref)) <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("fmt", ["q3_k", "q4_k", "q6_k", "q5_k", "q2_k",
                                 "q8_0"])
@pytest.mark.parametrize("e,c,k,n", [(3, 4, 512, 128), (4, 1, 300, 64)])
def test_qmatmul_experts_plain_matches_reference(fmt, e, c, k, n):
    """x (E, C, K) against (E, K, N) expert weights; expert 1's rows are
    all zero (an expert no token was routed to)."""
    _, jq, tq = _qt_pair(fmt, (e, k, n), seed=e * k + n)
    x = np.random.default_rng(c + k).normal(size=(e, c, k)).astype(
        np.float32)
    x[1] = 0.0
    ref = np.asarray(jax_ops.qmatmul(jnp.asarray(x), jq, impl="xla"))
    kern = qmatmul.EXPERT_KERNELS[fmt]
    before = kern.launches
    got = ops.qmatmul(torch.from_numpy(x), tq)
    assert kern.launches == before
    assert got.shape == (e, c, n) and got.dtype == torch.float32
    assert np.all(got.numpy()[1] == 0.0)
    assert np.max(np.abs(got.numpy() - ref)) <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("fmt", ["q3_k", "q4_k", "q6_k", "q5_k", "q2_k",
                                 "q8_0"])
def test_expert_fields_bitwise_and_grouped(fmt):
    w, jq, tq = _qt_pair(fmt, (5, 300, 24), seed=7)
    got = quantize(torch.from_numpy(w), fmt)
    for name, ref in tq.fields.items():
        assert got.fields[name].numpy().tobytes() == ref.numpy().tobytes()
    grouped = apply.quantize_in_groups(
        lambda r: torch.from_numpy(w[r.start:r.stop]), 5, fmt, group=2,
        dim=0)
    assert grouped.shape == got.shape == (5, 300, 24)
    for name, ref in got.fields.items():
        assert grouped.fields[name].shape == ref.shape
        assert torch.equal(grouped.fields[name], ref), name


def test_init_quantized_params_bitwise():
    """Made and quantized one weight at a time (3 experts, or 100
    columns, at a time), bitwise the quantized seeded tree."""
    cfg = get_config("deepseek-v3-671b").reduced()
    policy = get_policy("DQ3_K_M")
    whole = quantize_params(cfg, init_params(cfg, 2, torch.float32), policy)
    streamed = init_quantized_params(cfg, policy, 2, torch.float32,
                                     expert_group=3, column_group=100)
    assert sorted(whole) == sorted(streamed)
    for path, ref in whole.items():
        got = streamed[path]
        if isinstance(ref, QTensor):
            assert got.fmt == ref.fmt and got.shape == ref.shape, path
            for name, f in ref.fields.items():
                assert torch.equal(got.fields[name], f), (path, name)
        else:
            assert got.dtype == ref.dtype and torch.equal(got, ref), path


def _moe_layer():
    """deepseek-v3 reduced, layer 1 (MoE): the reference's f32 weights with
    the routed and shared experts quantized as DQ3_K_M does the first MoE
    layer (q3_k gate/up, q6_k down; q4_k/q6_k shared)."""
    jcfg = jax_get_config("deepseek-v3-671b").reduced()
    raw = jax_subview(jax_init_params(jcfg, 4, dtype=jnp.float32), "dec/L001")
    fmts = {"gate_exps": "q3_k", "up_exps": "q3_k", "down_exps": "q6_k",
            "gate_shexp": "q4_k", "up_shexp": "q4_k", "down_shexp": "q6_k"}
    jp = {k: (jax_quantize(v, fmts[k]) if k in fmts else v)
          for k, v in raw.items()}
    tree = {k: (_export(v) if k in fmts else np.array(v))
            for k, v in jp.items()}
    return jcfg, get_config("deepseek-v3-671b").reduced(), jp, \
        from_jax_params(tree)


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_apply_matches_reference(cf):
    jcfg, cfg, jp, tp = _moe_layer()
    x = np.random.default_rng(11).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    ref_y, ref_aux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x),
                                       capacity_factor=cf)
    got_y, got_aux = moe.moe_apply(tp, cfg, torch.from_numpy(x),
                                   capacity_factor=cf)
    assert got_y.shape == (2, 16, cfg.d_model)
    ref_y = np.asarray(ref_y)
    assert np.max(np.abs(got_y.numpy() - ref_y)) <= TOL * np.abs(ref_y).max()
    assert abs(float(got_aux) - float(ref_aux)) <= TOL

    # the same assignments are kept (dropped past capacity in stable-sort
    # order) and land in the same slots
    xf = x.reshape(32, -1)
    logits = moe.router_probs(tp["router"], torch.from_numpy(xf))
    gates, idx = torch.topk(torch.softmax(logits, -1), cfg.top_k)
    capacity = max(1, int(cf * 32 * cfg.top_k / cfg.n_experts))
    _, (_, slot, _, keep) = moe.moe_dispatch(torch.from_numpy(xf), gates,
                                             idx, cfg.n_experts, capacity)
    _, (jslot, _, _, jkeep) = jax_moe.moe_dispatch(
        jnp.asarray(xf), jnp.asarray(gates.numpy()), jnp.asarray(idx.numpy()),
        cfg.n_experts, capacity)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    assert bool(keep.all()) == (cf == 8.0)      # 1.0 drops tokens


def test_decode_dispatch_leaves_empty_experts_zero():
    """The premise of B1's skip of empty experts, at the serve's decode
    shape (4 tokens, DeepSeek-V3's 256 experts, top-8, capacity 1; inputs
    from a numpy seed): ``moe_dispatch`` gives a non-zero buffer row to the
    same experts as the reference's (at most 32), and ``expert_ffn`` (q3_k
    gate/up, q2_k down) gives exact zeros for every other expert in both
    packages, and the same outputs within 1e-5 for the used ones."""
    cfg = get_config("deepseek-v3-671b")
    jcfg = jax_get_config("deepseek-v3-671b")
    t, d, ff, e = 4, 256, 64, cfg.n_experts
    rng = np.random.default_rng(15)
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    logits = moe.router_probs(torch.from_numpy(router), torch.from_numpy(x))
    gates, idx = torch.topk(torch.softmax(logits, -1), cfg.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    capacity = max(1, int(cfg.capacity_factor * t * cfg.top_k / e))
    assert (e, cfg.top_k, capacity) == (256, 8, 1)
    buf, _ = moe.moe_dispatch(torch.from_numpy(x), gates, idx, e, capacity)
    jbuf, _ = jax_moe.moe_dispatch(jnp.asarray(x), jnp.asarray(gates.numpy()),
                                   jnp.asarray(idx.numpy()), e, capacity)
    used = buf.reshape(e, -1).ne(0).any(1).numpy()
    assert np.array_equal(used, np.asarray(jbuf).reshape(e, -1).any(1))
    assert 0 < used.sum() <= t * cfg.top_k

    shapes = {"gate_exps": ((e, d, ff), "q3_k"),
              "up_exps": ((e, d, ff), "q3_k"),
              "down_exps": ((e, ff, d), "q2_k")}
    jp, tp = {}, {}
    for i, (name, (shape, fmt)) in enumerate(shapes.items()):
        _, jp[name], tp[name] = _qt_pair(fmt, shape, seed=30 + i)
    ref = np.asarray(jax_moe.expert_ffn(jp, jbuf))
    got = moe.expert_ffn(tp, buf).numpy()
    assert got.shape == ref.shape == (e, capacity, d)
    assert np.all(got[~used] == 0) and np.all(ref[~used] == 0)
    assert np.max(np.abs(got - ref)) <= TOL * np.abs(ref).max()


def test_moe_unported_options_name_roadmap_items():
    _, cfg, _, tp = _moe_layer()
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="ROADMAP D8"):
        moe.moe_apply(tp, cfg, x, data_shards=2)


@pytest.mark.parametrize("policy", ["DQ3_K_M", "Q4_K_M"])
@pytest.mark.parametrize("n_layers", [61, 7])
def test_deepseek_format_map_matches_reference(policy, n_layers):
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              n_layers=n_layers)
    jcfg = dataclasses.replace(jax_get_config("deepseek-v3-671b"),
                               n_layers=n_layers)
    got = apply.format_map(cfg, get_policy(policy))
    assert got == jax_apply.format_map(jcfg, jax_get_policy(policy))
    if policy == "DQ3_K_M":
        down = [f for p, f in got.items() if p.endswith("/down_exps")]
        counts = {f: down.count(f) for f in set(down)}
        assert counts == ({"q6_k": 2, "q4_k": 12, "q3_k": 44}
                          if n_layers == 61
                          else {"q6_k": 2, "q4_k": 1, "q3_k": 1})


def test_packed_bytes_match_reference_size_calculator():
    cfg = get_config("deepseek-v3-671b").reduced()
    params = init_quantized_params(cfg, get_policy("DQ3_K_M"), 0)
    packed = sum(v.packed_bytes() if isinstance(v, QTensor)
                 else v.numel() * v.element_size() for v in params.values())
    ref = jax_size.model_size(jax_get_config("deepseek-v3-671b").reduced(),
                              jax_get_policy("DQ3_K_M"))
    assert packed == ref.tpu_bytes
