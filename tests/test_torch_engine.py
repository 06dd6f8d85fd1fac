"""The port's serving engine against the JAX reference engine.

  * a greedy serve of 4 requests (slots 2, page_size 4, prefill_chunk 4,
    f32 model dtype, DQ3_K_M weights carried across from the reference)
    gives token streams equal to ``repro.serving.engine.Engine`` with the
    same settings, zero leaked pages, and the reference's byte accounting
    (``bytes_per_live_token``, ``kv_bytes_per_decoded_token``) exactly, for
    model-dtype and q8_0 pools;
  * the dense layout (``page_size=0``) and the gather reference path
    (``kernel="gather"``, q8_0 pools), qwen2 and DeepSeek with unquantized
    f32 weights, against the reference engine the same way (its steps
    compiled, ``jit=True``);
    within the port, the dense and paged serves give bitwise-equal
    streams, as the reference claims of itself;
  * ``generate`` on prompts of unequal length, and ``serve_sequential``
    over the dense layout and q8_0 pools, give the reference engine's
    greedy streams;
  * stochastic streams do not depend on the batch mix (port only: the
    reference's threefry bits are not reproducible in PyTorch);
  * entry points run on the card unless asked for the CPU, options that
    are not ported yet raise naming their ROADMAP item, and the ported
    scheduler, lifecycle and layout options are checked as the reference
    checks them; the serve CLI runs the preempt scheduler under a chaos
    plan, and one request at a time over the dense layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import Model as JaxModel
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.sampler import SamplerConfig as JaxSamplerConfig

from repro_torch.launch import serve as serve_cli
from repro_torch.models import paged
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.sampler import SamplerConfig

from test_torch_model import reference_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPTS = [[5, 9, 13, 200, 17, 4, 8], [300, 2, 77], [41, 42, 43, 44, 45, 46,
                                                     47, 48, 49, 50, 51],
           [7, 8]]
MAX_NEW = [6, 5, 4, 6]


@pytest.fixture(scope="module")
def weights():
    return reference_weights("DQ3_K_M", seed=1)


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_greedy_serve_matches_reference_engine(weights, kv_quant):
    _greedy_serve_both(weights, kv_quant)


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_deepseek_greedy_serve_matches_reference_engine(kv_quant):
    """deepseek-v3 reduced (MLA latent pools, 1 dense + 4 MoE layers,
    DQ3_K_M): the same greedy streams, stats and byte accounting."""
    _greedy_serve_both(reference_weights("DQ3_K_M", 1, "deepseek-v3-671b"),
                       kv_quant)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_dense_cache_bytes_match_reference_engine(arch):
    """The contiguous ``slots x max_len`` layout's bytes come from the
    model's own cache leaves: K/V/pos for GQA, c_kv/k_rope for MLA."""
    jcfg, cfg, jparams, params = reference_weights("DQ3_K_M", 1, arch)
    kw = dict(max_len=48, page_size=4)
    jeng = JaxEngine(JaxModel(jcfg, dtype=jnp.float32), jparams, jit=False,
                     **kw)
    teng = Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
                  **kw)
    for slots in (1, 3):
        assert teng._dense_cache_bytes(slots) == jeng._dense_cache_bytes(
            slots)
    if cfg.mla:       # c_kv + k_rope per token and layer, no positions
        assert teng._dense_cache_bytes(1) == (
            cfg.n_layers * 48 * 4 * (cfg.kv_lora_rank + cfg.qk_rope_head_dim))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_dense_serve_matches_reference_engine(arch):
    """page_size=0: one (slots, max_len) cache row a lane; the streams,
    stats, ``dense_cache_bytes`` and ``decode_kv_bytes`` (every layer's
    whole dense cache a step) are the reference's."""
    ts = _greedy_serve_both(reference_weights("F32", 0, arch), None,
                            page_size=0, ref_jit=True)
    assert ts.decode_kv_bytes == ts.decode_iterations * ts.dense_cache_bytes


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_gather_serve_matches_reference_engine(arch):
    """kernel="gather" over q8_0 pools: the dequantizing gather prefill and
    decode; each step charges every lane's whole block table."""
    ts = _greedy_serve_both(reference_weights("F32", 0, arch), "q8_0",
                            kernel="gather", ref_jit=True)
    assert ts.decode_kv_bytes == (ts.decode_iterations * 2 * ts.page_bytes
                                  * paged.pages_for(32, 4))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_dense_and_paged_serves_are_bitwise_equal(arch):
    """Within the port on the CPU, the dense and the paged (fused or
    gather) serves of model-dtype caches give the same streams."""
    _, cfg, _, params = reference_weights("F32", 0, arch)
    outs = []
    for kw in (dict(page_size=0), dict(page_size=4),
               dict(page_size=4, kernel="gather")):
        eng = Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
                     sampler=SamplerConfig(greedy=True), max_len=32,
                     prefill_chunk=4, **kw)
        outs.append({r.rid: r.out for r in eng.serve(_requests(Request),
                                                      slots=2)})
    assert outs[0] == outs[1] == outs[2]


def test_generate_matches_reference_engine():
    """One-shot generate over prompts of 11 and 3 tokens: each row's
    first token from its own last position."""
    jeng, teng = _engines(reference_weights("F32", 0), page_size=0)
    prompts = [PROMPTS[2], PROMPTS[1]]
    want = jeng.generate(prompts, 5, seed=0)
    got = teng.generate(prompts, 5, seed=0)
    assert got == [[int(t) for t in row] for row in want]
    assert [len(row) for row in got] == [5, 5]


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_serve_sequential_matches_reference_engine(kv_quant):
    """One request at a time: generate over the dense layout (seed + rid),
    or each request alone through serve over q8_0 pools (seed)."""
    jeng, teng = _engines(reference_weights("F32", 0),
                          page_size=4 if kv_quant else 0,
                          prefill_chunk=4, kv_quant=kv_quant)
    jdone = jeng.serve_sequential(_requests(JaxRequest, (1, 3)), seed=0)
    tdone = teng.serve_sequential(_requests(Request, (1, 3)), seed=0)
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == [1, 3]
    for a, b in zip(tdone, jdone):
        assert a.out == [int(t) for t in b.out] and len(a.out) == MAX_NEW[
            a.rid]
    js, ts = jeng.last_stats, teng.last_stats
    for field in ("total_tokens", "decode_iterations", "decoded_tokens",
                  "decode_kv_bytes", "live_per_iteration", "pages_leaked"):
        assert getattr(ts, field) == getattr(js, field), field


def _requests(cls, ids=range(len(PROMPTS))):
    return [cls(rid=i, prompt=list(PROMPTS[i]), max_new=MAX_NEW[i])
            for i in ids]


def _engines(weights, *, ref_jit=True, **kw):
    """(reference engine, port engine) over ``weights``, greedy, f32,
    max_len 32.  ``ref_jit``: the reference's steps, and the one-shot
    prefill of its ``generate``, compiled (the same functions; its eager
    dispatch costs seconds a call here)."""
    jcfg, cfg, jparams, params = weights
    jmodel = JaxModel(jcfg, dtype=jnp.float32)
    if ref_jit:
        jmodel.prefill = jax.jit(jmodel.prefill, static_argnums=2)
    jeng = JaxEngine(jmodel, jparams, jit=ref_jit,
                     sampler=JaxSamplerConfig(greedy=True), max_len=32, **kw)
    teng = Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
                  sampler=SamplerConfig(greedy=True), max_len=32, **kw)
    return jeng, teng


def _greedy_serve_both(weights, kv_quant, *, page_size=4, kernel="fused",
                       ref_jit=False):
    jeng, teng = _engines(weights, ref_jit=ref_jit, page_size=page_size,
                          prefill_chunk=4, kv_quant=kv_quant, kernel=kernel)
    jdone = jeng.serve(_requests(JaxRequest), slots=2, seed=0)
    tdone = teng.serve(_requests(Request), slots=2, seed=0)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(tdone, jdone):
        assert a.out == [int(t) for t in b.out], a.rid
        assert a.status == "ok" and len(a.out) == MAX_NEW[a.rid]
    js, ts = jeng.last_stats, teng.last_stats
    assert ts.pages_leaked == js.pages_leaked == 0
    assert ts.page_bytes == js.page_bytes
    assert ts.dense_cache_bytes == js.dense_cache_bytes
    assert ts.bytes_per_live_token == js.bytes_per_live_token
    assert ts.kv_bytes_per_decoded_token == js.kv_bytes_per_decoded_token
    for field in ("decode_iterations", "prefill_iterations",
                  "overlap_iterations", "live_per_iteration",
                  "live_tokens_per_iteration", "pages_in_use_per_iteration",
                  "total_tokens", "peak_pages", "decoded_tokens"):
        assert getattr(ts, field) == getattr(js, field), field
    assert len(ts.decode_step_s) == ts.decode_iterations
    assert "leaked 0" in ts.report()
    return ts


def test_sampled_streams_do_not_depend_on_batch_mix(weights):
    _, cfg, _, params = weights
    eng = Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
                 max_len=32, page_size=4, prefill_chunk=4,
                 sampler=SamplerConfig(temperature=1.0, top_p=0.9))

    def reqs(ids):
        return [Request(rid=i, prompt=list(PROMPTS[i]), max_new=MAX_NEW[i])
                for i in ids]

    together = {r.rid: r.out for r in eng.serve(reqs([0, 1, 2, 3]), slots=2,
                                                 seed=3)}
    for rid in range(4):
        alone = eng.serve(reqs([rid]), slots=1, seed=3)[0]
        assert alone.out == together[rid], rid
    other_seed = {r.rid: r.out for r in eng.serve(reqs([0, 1, 2, 3]),
                                                   slots=2, seed=4)}
    assert other_seed != together


def test_engine_runs_on_the_card_unless_asked(weights, monkeypatch):
    _, cfg, _, params = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(Model(cfg, dtype=torch.float32), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--arch", "qwen2-1.5b", "--reduced"])


@pytest.mark.parametrize("kwargs", [{"mesh": object()}])
def test_unported_options_name_their_roadmap_item(weights, kwargs):
    _, cfg, _, params = weights
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
               **kwargs)


@pytest.mark.parametrize("kwargs,match", [
    ({"scheduler": "fifo"}, "unknown scheduler"),
    ({"scheduler": "preempt", "kv_quant": "q8_0", "quant_probe": True},
     "quant_probe"),
    ({"kv_quant": "q8_0", "quant_probe": True, "faults": object()},
     "quant_probe"),
    ({"swap_budget_bytes": 1 << 20}, "requires scheduler='preempt'"),
    ({"scheduler": "preempt", "swap_budget_bytes": -1}, ">= 0"),
    ({"swap_dir": "unused"}, "requires scheduler='preempt'"),
    ({"max_queue": -1}, "max_queue"),
    ({"class_queues": {0: -1}}, "class_queues"),
    ({"watchdog_factor": 1.0}, "watchdog_factor"),
    ({"page_size": 0, "kv_quant": "q8_0"}, "kv_quant requires the paged"),
    ({"page_size": 0, "scheduler": "preempt"}, "requires the paged cache"),
    ({"kernel": "flash"}, "unknown paged decode kernel")])
def test_lifecycle_options_are_checked_as_the_reference_does(weights, kwargs,
                                                            match):
    """The preempt scheduler, the fault plane, the lifecycle options and the
    dense layout and gather kernel are ported; their argument checks are
    the reference's."""
    _, cfg, _, params = weights
    with pytest.raises(ValueError, match=match):
        Engine(Model(cfg, dtype=torch.float32), params, device="cpu",
               **kwargs)


def test_serve_cli_on_cpu(capsys):
    done = serve_cli.main([
        "--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--dtype",
        "f32", "--requests", "3", "--slots", "2", "--prompt-min", "3",
        "--prompt-max", "9", "--page-size", "4", "--prefill-chunk", "4",
        "--max-new", "3", "--max-len", "32", "--kv-quant", "q8_0"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    assert "leaked 0" in capsys.readouterr().out


def test_serve_cli_deepseek_on_cpu(capsys):
    done = serve_cli.main([
        "--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu",
        "--dtype", "f32", "--requests", "3", "--slots", "2", "--prompt-min",
        "3", "--prompt-max", "9", "--page-size", "4", "--prefill-chunk", "4",
        "--max-new", "3", "--max-len", "32", "--kv-quant", "q8_0"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    assert "leaked 0" in capsys.readouterr().out


def test_serve_cli_preempt_chaos_on_cpu(capsys):
    """The CLI's D3 flags: two classes over half the worst-case pool, a
    seeded fault plan; every request ends in a terminal status and no page
    leaks."""
    done = serve_cli.main([
        "--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--dtype",
        "f32", "--requests", "4", "--slots", "3", "--prompt-min", "6",
        "--prompt-max", "13", "--page-size", "4", "--prefill-chunk", "4",
        "--max-new", "6", "--max-len", "32", "--greedy",
        "--scheduler", "preempt", "--priority-classes", "2",
        "--oversubscribe", "0.5", "--chaos", "0"])
    out = capsys.readouterr().out
    assert len(done) == 4 and all(r.done and r.status for r in done)
    assert [r.priority for r in sorted(done, key=lambda r: r.rid)] == [
        0, 1, 0, 1]
    assert "chaos mode: seed 0" in out and "oversubscribed pool" in out
    assert "scheduler preempt:" in out and "leaked 0" in out


def test_serve_cli_sequential_dense_on_cpu(capsys):
    """``--sequential --page-size 0``: one request at a time through
    one-shot generate over the dense layout."""
    done = serve_cli.main([
        "--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--dtype",
        "f32", "--requests", "3", "--prompt-min", "3", "--prompt-max", "9",
        "--page-size", "0", "--sequential", "--max-new", "3", "--max-len",
        "32", "--greedy"])
    assert [r.rid for r in done] == [0, 1, 2]
    assert all(r.status == "ok" and len(r.out) == 3 for r in done)
    assert "3 requests, 9 tokens" in capsys.readouterr().out
