"""The port's one-shot entry points against the JAX reference's.

qwen2-1.5b reduced (dense GQA) and deepseek-v3-671b reduced (MLA, 1 dense
+ 4 MoE layers), f32 weights from seed 0 made by the reference and carried
across with ``repro_torch.convert``; one right-padded batch of 3 prompts
(24, 17 and 9 tokens) through both ``Model``s (the reference's methods
compiled with ``jax.jit``):

  * ``forward``: the logits, and the MoE auxiliary loss;
  * ``loss`` with masked (-1) labels: ``nll`` and ``aux``;
  * ``prefill`` with ``lengths``: each row's last logits at its own
    length, and every leaf of the dense cache it builds;
  * three dense ``decode_step``s from that cache with lane 2 not live: the
    logits, every cache leaf, and lane 2's rows left bitwise as the
    prefill wrote them;
  * DeepSeek-V3's routed experts at the loss's 2 x 1024 tokens: the
    reference's capacity (80 slots an expert) and outputs;
  * ``paged.write_dense``'s dropped writes where indices are shared;
  * ``chip_smoke.dense_forced`` on the CPU: the card check's teacher-forced
    f32 runs hold here, and fail on a fault planted in the gather path or
    in ``prefill``'s lengths.

Tolerances: logits and float cache leaves within ``REL_TOL`` = 1e-4 of the
leaf's max|x| (``test_torch_model``'s rule: summation order, f32 RoPE);
``nll`` and ``aux`` within 1e-5 relative; positions bitwise.
"""

import dataclasses
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import Model as JaxModel

from repro_torch.models.model import Model

from test_torch_model import REL_TOL, reference_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["qwen2-1.5b", "deepseek-v3-671b"]
LENGTHS = np.array([24, 17, 9], np.int32)
MAX_LEN = 40
DEAD = 2            # the lane that is not live in the decode steps
LOSS_TOL = 1e-5


def _inputs(vocab: int) -> dict:
    rng = np.random.default_rng(7)
    b, t = len(LENGTHS), int(LENGTHS.max())
    toks = rng.integers(4, vocab, (b, t)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1                       # masked positions mid-row
    labels[1, LENGTHS[1] - 1:] = -1          # and a row's padded tail
    live = np.ones(b, bool)
    live[DEAD] = False
    return {"tokens": toks, "labels": labels, "live": live,
            "steps": rng.integers(4, vocab, (3, b)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _both(arch: str) -> dict:
    """Every output of both packages for ``arch``'s batch: ``ref`` and
    ``port``, each a dict of numpy arrays."""
    jcfg, cfg, jparams, params = reference_weights("F32", 0, arch)
    inp = _inputs(cfg.vocab_size)
    jm, tm = JaxModel(jcfg, dtype=jnp.float32), Model(cfg, dtype=torch.float32)
    # the reference compiled: its eager dispatch costs ~5x here
    ref = types.SimpleNamespace(
        forward=jax.jit(jm.forward), loss=jax.jit(jm.loss),
        prefill=jax.jit(jm.prefill, static_argnums=2),
        decode_step=jax.jit(jm.decode_step))
    out = {}
    for side, model, params_, conv in (
            ("ref", ref, jparams, jnp.asarray),
            ("port", tm, params, torch.from_numpy)):
        toks, labels = conv(inp["tokens"]), conv(inp["labels"])
        logits, aux = model.forward(params_, {"tokens": toks})
        total, parts = model.loss(params_, {"tokens": toks,
                                            "labels": labels})
        last, cache = model.prefill(params_, {"tokens": toks}, MAX_LEN,
                                    lengths=conv(LENGTHS))
        res = {"logits": logits, "aux": aux, "total": total,
               "nll": parts["nll"], "loss_aux": parts["aux"], "last": last}
        # copies: the port's decode steps write the cache in place
        res.update({f"prefill/{k}": np.array(v) for k, v in cache.items()})
        pos = LENGTHS.copy()
        for i, tok in enumerate(inp["steps"]):
            step, cache = model.decode_step(params_, cache, conv(tok),
                                            conv(pos), live=conv(inp["live"]))
            res[f"step{i}"] = step
            pos = pos + 1
        res.update({f"decode/{k}": v for k, v in cache.items()})
        out[side] = {k: np.array(v) for k, v in res.items()}
    return out


def _close(ref: np.ndarray, got: np.ndarray, what: str) -> None:
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    err = np.max(np.abs(got - ref))
    assert err <= REL_TOL * np.max(np.abs(ref)), (what, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    ref, got = _both(arch)["ref"], _both(arch)["port"]
    _close(ref["logits"], got["logits"], "logits")
    assert abs(got["aux"] - ref["aux"]) <= LOSS_TOL * max(abs(ref["aux"]),
                                                          1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    ref, got = _both(arch)["ref"], _both(arch)["port"]
    for k in ("nll", "loss_aux", "total"):
        assert abs(got[k] - ref[k]) <= LOSS_TOL * abs(ref[k]), (k, got[k],
                                                              ref[k])
    if arch == "deepseek-v3-671b":
        assert ref["loss_aux"] > 0      # the MoE layers' term is there


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_lengths_matches_reference(arch):
    ref, got = _both(arch)["ref"], _both(arch)["port"]
    _close(ref["last"], got["last"], "last logits")
    # each row's logits come from its own last prompt position
    for i, n in enumerate(LENGTHS):
        np.testing.assert_array_equal(
            np.argmax(got["last"][i, 0]), np.argmax(got["logits"][i, n - 1]))
    leaves = [k for k in ref if k.startswith("prefill/")]
    assert leaves and sorted(leaves) == sorted(k for k in got
                                               if k.startswith("prefill/"))
    for k in leaves:
        if k.endswith("/pos"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            _close(ref[k], got[k], k)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_decode_steps_match_reference(arch):
    ref, got = _both(arch)["ref"], _both(arch)["port"]
    for i in range(3):
        _close(ref[f"step{i}"], got[f"step{i}"], f"step {i}")
    for k in (k for k in ref if k.startswith("decode/")):
        if k.endswith("/pos"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            _close(ref[k], got[k], k)
        # the lane that was not live keeps the rows its prefill wrote
        before = got["prefill/" + k[len("decode/"):]]
        np.testing.assert_array_equal(got[k][DEAD], before[DEAD], err_msg=k)
    # the live lanes wrote their three steps
    pos_key = next((k for k in got if k.startswith("decode/")
                    and k.endswith("/pos")), None)
    if pos_key is not None:
        for lane in (0, 1):
            n = LENGTHS[lane]
            np.testing.assert_array_equal(got[pos_key][lane, n:n + 3],
                                          np.arange(n, n + 3))


def test_moe_capacity_at_forward_size_matches_reference(monkeypatch):
    """DeepSeek-V3's routed experts (256, top-8, capacity factor 1.25) over
    the loss's 2 x 1024 tokens take the reference's capacity, max(1,
    int(1.25 x 2048 x 8 / 256)) = 80 slots an expert, and give its
    outputs (f32, widths cut to 16 / 8, the expert counts kept)."""
    from repro.configs import get_config as jax_get_config
    from repro.models import moe as jax_moe

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    over = dict(d_model=16, d_expert=8, n_shared_experts=0)
    jcfg = dataclasses.replace(jax_get_config("deepseek-v3-671b"), **over)
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), **over)
    rng = np.random.default_rng(3)
    e, d, fe = cfg.n_experts, cfg.d_model, cfg.d_expert
    p = {"router": rng.normal(size=(d, e)),
         "gate_exps": rng.normal(size=(e, d, fe)) / 4,
         "up_exps": rng.normal(size=(e, d, fe)) / 4,
         "down_exps": rng.normal(size=(e, fe, d)) / 3}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 1024, d)).astype(np.float32)
    seen = {"ref": [], "port": []}
    for side, mod in (("ref", jax_moe), ("port", moe)):
        own = mod.moe_dispatch

        def spy(*args, _own=own, _side=side):
            seen[_side].append(args[-1])
            return _own(*args)
        monkeypatch.setattr(mod, "moe_dispatch", spy)
    jy, jaux = jax_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jcfg, jnp.asarray(x))
    ty, taux = moe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             cfg, torch.from_numpy(x))
    assert seen["ref"] == seen["port"] == [80]
    _close(np.asarray(jy), ty.numpy(), "moe output")
    assert abs(float(taux) - float(jaux)) <= LOSS_TOL * float(jaux)


@pytest.mark.parametrize("dtype", (torch.float32, torch.int32))
def test_write_dense_drops_masked_entries_at_shared_indices(dtype):
    """``paged.write_dense``: an entry with ``ok == False`` drops its write
    (the reference's ``mode="drop"``) even where it shares its index with
    an entry that writes, in either order, and the last of two entries
    written at one index wins; every other row stays as it was.  Held to
    the entries applied one by one in order."""
    from repro_torch.models import paged

    rng = np.random.default_rng(5)
    leaf = torch.from_numpy(rng.integers(-99, 99, (3, 6, 2))).to(dtype)
    idx = torch.tensor([[0, 0, 1, 4], [2, 2, 3, 3], [5, 1, 1, 5]])
    ok = torch.tensor([[True, False, True, False],
                       [False, True, True, True],
                       [False, False, False, True]])
    val = torch.from_numpy(rng.integers(100, 199, (3, 4, 2))).to(dtype)
    want = leaf.clone()
    for b in range(3):
        for c in range(4):
            if ok[b, c]:
                want[b, idx[b, c]] = val[b, c]
    got = paged.write_dense(leaf.clone(), idx, val, ok)
    assert torch.equal(got, want)
    # one entry a row (a decode step): rows not live keep their values
    one = paged.write_dense(leaf.clone(), idx[:, :1], val[:, :1],
                            ok[:, 1:2])
    want = leaf.clone()
    want[1, 2] = val[1, 0]
    assert torch.equal(one, want)


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("arch,fault", [("qwen2-1.5b", None),
                                        ("deepseek-v3-671b", None),
                                        ("qwen2-1.5b", "gather"),
                                        ("qwen2-1.5b", "lengths")])
def test_chip_smoke_forced_runs(arch, fault, monkeypatch):
    """``chip_smoke.dense_forced`` at reduced width on the CPU (the plain
    versions on both sides, DQ3_K_M, prompts of 8-40 tokens where the card
    takes 100-400, 8 forced tokens from seed 7): every run holds to its
    reference within PARITY_TOL, and the check fails where the dequantizing
    gather reads K/V 1 % large, or where ``prefill`` drops ``lengths`` (the
    shorter prompt's first token is then sampled past its end)."""
    from repro_torch.configs import get_config
    from repro_torch.core import get_policy, init_quantized_params
    from repro_torch.launch import serve
    from repro_torch.models import paged

    cs = _chip_smoke()
    own_requests = serve.build_requests
    monkeypatch.setattr(serve, "build_requests",
                        lambda n, vocab, lo, hi, *a, **kw: own_requests(
                            n, vocab, 8, 40, *a, **kw))
    cfg = get_config(arch).reduced()
    qparams = init_quantized_params(cfg, get_policy("DQ3_K_M"), 0,
                                    dtype=torch.float32)
    rng = np.random.default_rng(7)
    forced = {rid: [int(t) for t in rng.integers(4, cfg.vocab_size,
                                                 cs.DENSE_FORCED)]
              for rid in range(8)}
    if fault == "gather":
        own = paged.gather_pages_quant
        monkeypatch.setattr(paged, "gather_pages_quant",
                            lambda *a: own(*a) * 1.01)
    if fault == "lengths":
        own = Model.prefill
        monkeypatch.setattr(Model, "prefill", lambda self, *a, lengths=None,
                            **kw: own(self, *a, **kw))
    run = functools.partial(cs.dense_forced, torch, cfg, qparams, forced,
                            layers=cfg.n_layers, q8_layers=2,
                            device=torch.device("cpu"))
    if fault is None:
        run()
        return
    what = {"gather": "serve gather q8_0", "lengths": "generate"}[fault]
    with pytest.raises(SystemExit, match=f"forced {what}"):
        run()
