"""The port's fault plane and request lifecycle against the JAX reference.

The port keeps its own copy of ``repro.serving.faults``; its
``FaultPlan.random`` must give the reference's schedule for every seed.
Every serve case runs the same seeded requests and the same fault
schedule through the reference ``Engine(jit=False, kernel="fused")`` and
the port's ``Engine(device="cpu")`` over q8_0 pools unless the case names
its pools (``run_both`` of
``tests/test_torch_scheduler.py``) and holds equal the greedy streams, the
completion order, every status, the swap counters, ``sched_trace``,
``fault_log``, ``nan_quarantines`` and ``alloc_stalls``:

  * seeded random plans (the reference suite's ``REPRO_CHAOS_SEED`` is a
    parameter here) under f32, q8_0 and dq pools;
  * ``corrupt_page`` and ``nan_logits`` quarantines under every pool kind
    (the DeepSeek ``corrupt_page`` case lives in
    ``tests/test_torch_scheduler.py``, whose process already holds the
    DeepSeek reference);
  * swap-out failures, allocator stalls, swap-in retries ``(1, False)``
    and ``(50, True)``, a cancel while swapped out;
  * deadline ``0``, cancel before serve, ``max_queue`` and
    ``class_queues`` shedding, the watchdog under a large latency spike.
"""

import pytest

from repro.serving import FaultPlan as JaxFaultPlan

from repro_torch.checkpoint.fault_tolerance import straggler_threshold
from repro_torch.serving import Engine, Fault, FaultPlan, SamplerConfig
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import DIRTY_KINDS, KINDS

from test_torch_scheduler import (MAX_LEN, PAGE, TIGHT_PAGES, loose_requests,
                                  models, run_both, tight_requests)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOOSE_PAGES = 24
TERMINAL = ("ok", "timeout", "cancelled", "failed", "shed")


def _fields(f) -> dict:
    return {k: getattr(f, k) for k in ("kind", "step", "rid", "count",
                                       "value", "remaining")}


@pytest.mark.parametrize("seed", [0, 1, 2, 11, 1000, 2001])
def test_fault_plan_random_is_the_references(seed):
    for rids, kw in (([0, 1, 2], {}), (list(range(6)), {}),
                     ([3, 5], dict(steps=8, max_faults=7)),
                     ([], dict(kinds=("latency", "alloc_fail")))):
        ref = JaxFaultPlan.random(seed, rids=rids, **kw)
        got = FaultPlan.random(seed, rids=rids, **kw)
        assert [_fields(f) for f in got.faults] == [
            _fields(f) for f in ref.faults]


def test_fault_plan_fire_reset_and_dirty():
    assert KINDS[-1] == "cancel" and set(DIRTY_KINDS) < set(KINDS)
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("oom")
    with pytest.raises(ValueError, match="cancel faults must name"):
        Fault("cancel")
    plan = FaultPlan([Fault("swap_in_fail", step=5, rid=2, count=2),
                      Fault("nan_logits", step=0, rid=1)])
    assert plan.fire("swap_in_fail", 4, 2) is None      # not armed yet
    assert plan.fire("swap_in_fail", 5, 2) is not None
    assert plan.fire("swap_in_fail", 9, 0) is None      # pinned to rid 2
    assert plan.fire("swap_in_fail", 9) is not None     # rid-less: any
    assert plan.fire("swap_in_fail", 9, 2) is None      # charges spent
    assert plan.fire("nan_logits", 3, 1) is not None
    assert plan.dirty_rids() == {1} and plan.pending == []
    plan.reset()
    assert plan.injected == [] and len(plan.pending) == 2


def test_straggler_threshold():
    assert straggler_threshold([], 4.0) == 0.0
    assert straggler_threshold([0.0, -1.0], 4.0) == 0.0
    assert straggler_threshold([1.0, 2.0, 3.0], 2.0) == 4.0
    assert straggler_threshold([5.0, 1.0], 3.0) == 15.0


def _statuses(done) -> dict:
    assert all(r.status in TERMINAL for r in done)
    return {r.rid: r.status for r in done}


@pytest.mark.parametrize("kv_quant,seed", [(None, 0), ("q8_0", 1),
                                           ("dq", 2)])
def test_random_plan_matches_reference(kv_quant, seed):
    reqs = tight_requests(512)
    plan = FaultPlan.random(seed, rids=[d["rid"] for d in reqs])
    _, st = run_both("qwen2-1.5b", reqs, kv_quant=kv_quant,
                     faults=[_fields(f) for f in plan.faults],
                     swap_budget_bytes=1 << 30)
    assert st.faults_injected == len(st.fault_log) >= 1
    assert st.pages_leaked == 0 and st.swap_held_end_bytes == 0


@pytest.mark.parametrize("kv_quant", [None, "q8_0", "q4_0", "dq"])
def test_poisoned_lanes_quarantined(kv_quant):
    """A poisoned page (rid 0: +inf in float leaves, 127 in int8 codes)
    and a NaN logits row (rid 2) each retire only their own lane; the
    freed pages are scrubbed before reuse."""
    done, st = run_both("qwen2-1.5b", loose_requests(512),
                        num_pages=LOOSE_PAGES, kv_quant=kv_quant,
                        faults=[dict(kind="corrupt_page", step=2, rid=0),
                                dict(kind="nan_logits", step=3, rid=2)],
                        swap_budget_bytes=1 << 30)
    assert _statuses(done) == {0: "failed", 1: "ok", 2: "failed", 3: "ok"}
    assert st.nan_quarantines == 2 and st.pages_corrupted == 1


def test_swap_failures_and_alloc_stalls_keep_streams():
    """Swap-out failures fall back to restarts and an allocator outage
    stalls whole steps; no output bit changes."""
    done, st = run_both("qwen2-1.5b", tight_requests(512),
                        kv_quant="q8_0",
                        faults=[dict(kind="swap_out_fail", step=0, count=2),
                                dict(kind="alloc_fail", step=2, count=2)],
                        swap_budget_bytes=1 << 30)
    assert all(r.status == "ok" for r in done)
    assert st.swap_failures == 2 and st.swap_restarts >= 2
    assert st.alloc_stalls == 2


@pytest.mark.parametrize("charges,expect_restart", [(1, False), (50, True)])
def test_swap_in_retry_then_restart(charges, expect_restart):
    done, st = run_both("qwen2-1.5b", tight_requests(512),
                        kv_quant="q8_0",
                        faults=[dict(kind="swap_in_fail", step=0,
                                     count=charges)],
                        swap_budget_bytes=1 << 30)
    assert all(r.status == "ok" for r in done) and st.swap_retries >= 1
    assert (st.swap_dropped_bytes > 0) == expect_restart
    if expect_restart:
        assert st.swap_restarts >= 1


def test_cancel_while_swapped_out():
    """A cancel aimed at an iteration where a victim sits swapped out in
    the queue frees its host rows; it is never readmitted."""
    _, _, model, params = models("qwen2-1.5b")
    reqs = tight_requests(512)
    dry = Engine(model, params, device="cpu", max_len=MAX_LEN,
                 page_size=PAGE, num_pages=TIGHT_PAGES, scheduler="preempt",
                 kv_quant="q8_0", swap_budget_bytes=1 << 30,
                 sampler=SamplerConfig(greedy=True))
    dry.serve([Request(**d) for d in reqs], slots=4)
    it, victim = next((i, snap["swapped"][0]) for i, snap in
                      enumerate(dry.last_stats.sched_trace)
                      if snap["swapped"])
    done, st = run_both("qwen2-1.5b", reqs,
                        kv_quant="q8_0",
                        faults=[dict(kind="cancel", step=it + 1,
                                     rid=victim)],
                        swap_budget_bytes=1 << 30)
    assert _statuses(done)[victim] == "cancelled"
    assert st.swap_dropped_bytes > 0 and st.swap_held_end_bytes == 0
    for snap in st.sched_trace[it + 1:]:
        assert victim not in [rid for _, _, rid, _ in snap["active"]]


def test_deadline_and_cancel_before_serve():
    done, st = run_both("qwen2-1.5b", loose_requests(512),
                        kv_quant="q8_0", num_pages=LOOSE_PAGES, cancel=(3,),
                        deadlines={2: 0.0}, swap_budget_bytes=1 << 30)
    got = _statuses(done)
    assert got == {0: "ok", 1: "ok", 2: "timeout", 3: "cancelled"}
    assert [r.out for r in done if r.rid in (2, 3)] == [[], []]


def test_load_shedding():
    """``max_queue=2`` and a class-1 cap of 0: earlier arrivals win."""
    done, st = run_both("qwen2-1.5b", loose_requests(512, n=5),
                        kv_quant="q8_0", num_pages=LOOSE_PAGES, max_queue=2,
                        class_queues={1: 0}, swap_budget_bytes=1 << 30)
    assert _statuses(done) == {0: "ok", 1: "shed", 2: "ok", 3: "shed",
                               4: "shed"}
    assert st.class_stats[1]["statuses"] == {"shed": 2}


def test_watchdog_counts_latency_spike():
    """A 1 s spike is far above both engines' step times: each counts it
    in ``slow_steps`` through the straggler rule."""
    done, st = run_both("qwen2-1.5b", loose_requests(512, max_new=10),
                        kv_quant="q8_0", num_pages=LOOSE_PAGES,
                        watchdog_factor=2.0,
                        faults=[dict(kind="latency", step=6, value=1.0)],
                        swap_budget_bytes=1 << 30)
    assert all(r.status == "ok" for r in done)
    assert st.slow_steps >= 1 and max(st.decode_step_s) >= 1.0


def test_every_fault_kind_in_one_plan():
    """The plan ``chip_smoke.py`` serves on the card, at the reduced size:
    one of each kind."""
    done, st = run_both("qwen2-1.5b", tight_requests(512),
                        kv_quant="q8_0", faults=CHIP_PLAN,
                        swap_budget_bytes=1 << 30)
    got = _statuses(done)
    assert (got[0], got[1], got[5]) == ("failed", "failed", "cancelled")
    assert st.nan_quarantines == 2
    assert {f["kind"] for f in st.fault_log} == set(KINDS)


CHIP_PLAN = [dict(kind="swap_out_fail", step=0),
             dict(kind="swap_in_fail", step=0),
             dict(kind="alloc_fail", step=4),
             dict(kind="latency", step=5, value=0.05),
             dict(kind="corrupt_page", step=2, rid=0),
             dict(kind="nan_logits", step=3, rid=1),
             dict(kind="cancel", step=6, rid=5)]


def test_plan_replays_identically():
    """One engine and one plan, served twice: the same streams and log."""
    _, _, model, params = models("qwen2-1.5b")
    eng = Engine(model, params, device="cpu", max_len=MAX_LEN,
                 page_size=PAGE, num_pages=TIGHT_PAGES, scheduler="preempt",
                 swap_budget_bytes=1 << 30, sampler=SamplerConfig(greedy=True),
                 faults=FaultPlan.random(0, rids=list(range(6))))
    runs = []
    for _ in range(2):
        done = eng.serve([Request(**d) for d in tight_requests(512)])
        runs.append(({r.rid: (r.out, r.status) for r in done},
                     eng.last_stats.fault_log))
    assert runs[0] == runs[1]
