"""The port's ``scheduler="preempt"`` engine against the JAX reference engine.

Every case serves the same seeded requests through the reference
``Engine(jit=False, kernel="fused")`` (``jit=True`` for DeepSeek: see
``run_both``) and the port's ``Engine(device="cpu")`` (reduced configs,
f32 weights from one seed, ``page_size`` 4,
``max_len`` 48, 4 slots over a pool too small for them) and holds equal
the greedy streams, the order of completion, each request's status, the
preemption and swap counters, every scheduler snapshot (``sched_trace``)
and the leaked pages:

  * qwen2 reduced under model-dtype (f32), q8_0, q4_0 and dq pools;
  * the DeepSeek reduced config (MLA latents, MoE) under f32 and q8_0,
    and under a ``corrupt_page`` fault at the published capacity factor,
    where the poisoned lane's NaN router row competes with the bystanders
    for expert slots;
  * ``swap_budget_bytes=0`` (every live eviction restarts, nothing moves)
    and the ``swap_dir`` spill (rows parked in files, read back);
  * the port's preempt serve against its own reserve serve, bitwise, with
    bf16 pools spilled to files.

``run_both`` is shared with ``tests/test_torch_chaos.py``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.spec import init_params as jax_init_params
from repro.serving import Engine as JaxEngine
from repro.serving import Fault as JaxFault
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import SamplerConfig as JaxSamplerConfig
from repro.serving.engine import Request as JaxRequest

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import paged
from repro_torch.models.model import Model
from repro_torch.serving import Engine, Fault, FaultPlan, SamplerConfig
from repro_torch.serving.engine import Request

from test_torch_model import export
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_LEN, PAGE = 48, 4
TIGHT_PAGES = paged.RESERVED_PAGES + 10    # 4 lanes need up to 4 x 6 pages

# the counters that must agree exactly between the two engines
EXACT = ("preemptions", "swap_out_bytes", "swap_in_bytes", "swap_restarts",
         "swap_held_bytes", "swap_dropped_bytes", "swap_spills",
         "swap_disk_bytes", "swap_failures", "swap_retries", "sched_trace",
         "pages_leaked", "fault_log", "faults_injected", "nan_quarantines",
         "alloc_stalls", "pages_corrupted", "decode_iterations",
         "prefill_iterations", "status_counts", "swap_held_end_bytes",
         "swap_disk_end_bytes")


@functools.lru_cache(maxsize=None)
def models(arch: str, widths: tuple = ()):
    """(reference model, its f32 params, port model, its params) for
    ``arch`` reduced (with the ``(field, value)`` pairs of ``widths``
    replaced in both configs), weights from seed 0."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **dict(widths))
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(widths))
    raw = jax_init_params(jcfg, 0, dtype=jnp.float32)
    return (JaxModel(jcfg, dtype=jnp.float32), raw,
            Model(cfg, dtype=torch.float32), from_jax_params(export(raw)))


def tight_requests(vocab: int, n: int = 6) -> list[dict]:
    """Prompts of 6..13 tokens, 8 new tokens each, classes 0..2."""
    rng = np.random.default_rng(3)
    return [dict(rid=i, prompt=[int(t) for t in rng.integers(
                     4, vocab, int(rng.integers(6, 14)))],
                 max_new=8, priority=i % 3) for i in range(n)]


def loose_requests(vocab: int, n: int = 4, max_new: int = 5) -> list[dict]:
    rng = np.random.default_rng(7)
    return [dict(rid=i, prompt=[int(t) for t in rng.integers(4, vocab, 9)],
                 max_new=max_new, priority=i % 2) for i in range(n)]


def plans(faults: list[dict]):
    """The same fault schedule as a reference and a port ``FaultPlan``."""
    return (JaxFaultPlan([JaxFault(**f) for f in faults]),
            FaultPlan([Fault(**f) for f in faults]))


def run_both(arch: str, reqs: list[dict], *, slots: int = 4,
             num_pages: int = TIGHT_PAGES, kv_quant=None, faults=None,
             cancel=(), deadlines=None, swap_dirs=None, widths=(),
             ref_jit=False, **kw):
    """Serve ``reqs`` through both engines (``scheduler="preempt"``, the
    keywords ``kw`` on both, ``faults`` a list of fault dicts) and hold
    the port to the reference.  Returns the port's (done, stats).
    ``ref_jit`` compiles the reference's steps (the DeepSeek cases: run
    eagerly, its f32 MLA prefill compiles a scan anew at every chunk and
    layer, which made a case take 36-92 s of CPU time; compiled, 7-13 s,
    with the same streams)."""
    jmodel, jparams, model, params = models(arch, widths)
    jplan, plan = plans(faults) if faults is not None else (None, None)
    jdir, tdir = swap_dirs or (None, None)
    common = dict(max_len=MAX_LEN, page_size=PAGE, kv_quant=kv_quant,
                  num_pages=num_pages, scheduler="preempt", **kw)
    jeng = JaxEngine(jmodel, jparams, jit=ref_jit, kernel="fused",
                     sampler=JaxSamplerConfig(greedy=True), faults=jplan,
                     swap_dir=jdir, **common)
    teng = Engine(model, params, device="cpu",
                  sampler=SamplerConfig(greedy=True), faults=plan,
                  swap_dir=tdir, **common)
    out = []
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        for rid in cancel:
            eng.cancel(rid)
        rs = [cls(**d) for d in reqs]
        for r in rs:
            r.deadline_s = (deadlines or {}).get(r.rid)
        out.append((eng.serve(rs, slots=slots, seed=0), eng.last_stats))
    (jdone, js), (tdone, ts) = out
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(tdone, jdone):
        assert a.out == [int(t) for t in b.out], a.rid
        assert a.status == b.status and a.stats.status == a.status, a.rid
        assert a.stats.preemptions == b.stats.preemptions, a.rid
        assert a.stats.priority == b.stats.priority, a.rid
    for field in EXACT:
        assert getattr(ts, field) == getattr(js, field), field
    assert ts.swap_out_bytes == ts.swap_in_bytes + ts.swap_dropped_bytes
    return tdone, ts


def check_conservation(stats) -> None:
    """Free pages plus pages held by active lanes equal the usable pool at
    every post-admission snapshot."""
    usable = stats.num_pages - paged.RESERVED_PAGES
    for snap in stats.sched_trace:
        assert snap["free_pages"] + sum(
            h for *_, h in snap["active"]) == usable, snap


@pytest.mark.parametrize("kv_quant", [None, "q8_0", "q4_0", "dq"])
def test_qwen2_preempt_matches_reference(kv_quant):
    done, st = run_both("qwen2-1.5b", tight_requests(512),
                        kv_quant=kv_quant, swap_budget_bytes=1 << 30)
    assert all(r.status == "ok" and len(r.out) == 8 for r in done)
    assert st.preemptions >= 2 and st.swap_in_bytes > 0
    assert len(st.swap_out_s) >= 1 and len(st.swap_in_s) >= 1
    check_conservation(st)


@pytest.mark.parametrize("kv_quant", [None, "q8_0"])
def test_deepseek_preempt_matches_reference(kv_quant):
    """MLA latent and rope pools swap verbatim; the MoE lanes' routing sees
    the same batches on both sides."""
    done, st = run_both("deepseek-v3-671b", tight_requests(512),
                        kv_quant=kv_quant, swap_budget_bytes=1 << 30,
                        ref_jit=True)
    assert all(r.status == "ok" for r in done)
    assert st.preemptions >= 2 and st.swap_in_bytes > 0
    check_conservation(st)


def test_deepseek_corrupt_page_routes_nan_row_as_reference():
    """DeepSeek reduced at the published capacity factor (1.25: two slots
    an expert at decode, so assignments can drop): the poisoned lane's NaN
    router row claims the experts ``jax.lax.top_k`` gives it (NaN above
    every number, ties to the lower index), so the bystanders keep the
    reference's slots and streams."""
    done, st = run_both("deepseek-v3-671b", loose_requests(512),
                        num_pages=24, kv_quant="q8_0",
                        widths=(("capacity_factor", 1.25),),
                        faults=[dict(kind="corrupt_page", step=2, rid=1)],
                        swap_budget_bytes=1 << 30, ref_jit=True)
    assert {r.rid: r.status for r in done} == {0: "ok", 1: "failed",
                                               2: "ok", 3: "ok"}
    assert st.nan_quarantines == 1 and st.pages_corrupted == 1


def test_swap_budget_zero_restarts_bitwise():
    """``swap_budget_bytes=0``: every live eviction restarts its prefill,
    no byte moves, and the streams equal an unpreempted reserve serve."""
    reqs = tight_requests(512)
    done, st = run_both("qwen2-1.5b", reqs, kv_quant="q8_0",
                        swap_budget_bytes=0)
    assert st.swap_restarts > 0
    assert st.swap_out_bytes == st.swap_in_bytes == st.swap_held_bytes == 0
    _, _, model, params = models("qwen2-1.5b")
    ref = Engine(model, params, device="cpu", max_len=MAX_LEN,
                 page_size=PAGE, kv_quant="q8_0",
                 sampler=SamplerConfig(greedy=True))
    want = {r.rid: r.out for r in ref.serve(
        [Request(**d) for d in reqs], slots=4)}
    assert {r.rid: r.out for r in done} == want


def test_swap_spill_to_disk(tmp_path):
    """Past the budget the rows spill to ``swap_dir`` files (byte-viewed),
    read back losslessly; the files are gone once consumed."""
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    _, st = run_both("qwen2-1.5b", tight_requests(512), kv_quant="q4_0",
                     swap_budget_bytes=0, swap_dirs=(str(jdir), str(tdir)))
    assert st.swap_spills > 0 and st.swap_disk_bytes > 0
    assert st.swap_disk_end_bytes == 0 and list(tdir.iterdir()) == []


@pytest.mark.parametrize("kv_quant", [None, "dq"])
def test_preempt_equals_own_reserve_bitwise_bf16(tmp_path, kv_quant):
    """The port alone, bf16 model and pools: an oversubscribed preempt
    serve whose swaps spill to files (bf16 rows byte-viewed into numpy)
    gives the reserve serve's streams bit for bit."""
    _, _, model, params = models("qwen2-1.5b")
    bf16 = dataclasses.replace(model, dtype=torch.bfloat16)
    reqs = tight_requests(512)
    kw = dict(device="cpu", max_len=MAX_LEN, page_size=PAGE,
              kv_quant=kv_quant, sampler=SamplerConfig(greedy=True))
    ref = Engine(bf16, params, **kw)
    want = {r.rid: r.out for r in ref.serve(
        [Request(**d) for d in reqs], slots=4)}
    eng = Engine(bf16, params, scheduler="preempt", num_pages=TIGHT_PAGES,
                 swap_budget_bytes=1 << 12, swap_dir=str(tmp_path), **kw)
    got = {r.rid: r.out for r in eng.serve(
        [Request(**d) for d in reqs], slots=4)}
    st = eng.last_stats
    assert got == want
    assert st.preemptions >= 2 and st.swap_in_bytes > 0
    assert st.swap_spills > 0 and st.pages_leaked == 0
    assert st.swap_out_bytes == st.swap_in_bytes


def test_extract_inject_pages_roundtrip_every_leaf():
    """Each leaf kind (f32 payloads, int8 codes and f32 scales of q8_0 and
    nibble-packed q4_0, ``pos`` rows, MLA latent and rope leaves) survives
    extract -> inject at other page ids byte for byte."""
    for arch, kv in (("qwen2-1.5b", None), ("qwen2-1.5b", "dq"),
                     ("deepseek-v3-671b", "q8_0"),
                     ("deepseek-v3-671b", "q4_0")):
        model = models(arch)[2]
        cache = model.init_paged_cache(8, PAGE, 2, dtype=torch.float32,
                                       kv_quant=kv, device="cpu")
        gen = torch.Generator().manual_seed(0)
        for v in cache.values():
            v.copy_(torch.randint(-100, 100, v.shape, generator=gen))
        kinds = set()
        for k, v in cache.items():
            rows = paged.extract_pages(v, [5, 2, 3])
            dst = torch.zeros_like(v)
            paged.inject_pages(dst, [4, 6, 7], rows)
            for src, new in zip([5, 2, 3], [4, 6, 7]):
                assert dst[new].numpy().tobytes() == v[src].numpy().tobytes()
            kinds.add((k.split("/")[-1], v.dtype))
        assert len(kinds) >= 3, kinds

