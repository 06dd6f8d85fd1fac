"""Deterministic fault-injection plane for the serving engine (the port's
own copy of ``repro.serving.faults``: pure numpy, so near verbatim).

A :class:`FaultPlan` is a *seeded, replayable* schedule of failures the
engine volunteers to suffer: the plan is handed to
``Engine(faults=...)`` and every :meth:`Engine.serve` call replays the
same schedule (the engine resets the plan at the top of each call), so a
chaos run that found a bug reproduces from its seed alone.

Coordinates
-----------

Each :class:`Fault` names a *kind*, an engine iteration ``step`` it is
armed from, and optionally a target request ``rid``.  A fault does not
fire *at* its step — it is **armed** at that step and fires on the next
matching engine event (a swap-in attempt for its rid, a decode step with
its lane live, an allocation attempt, ...), consuming one of its
``count`` charges per event.  That makes schedules robust to scheduler
timing: "fail rid 3's swap-in twice, any time from step 5 on" is
expressible without knowing the exact iteration the scheduler will
attempt it.

Kinds (and the engine's graceful-degradation contract for each):

``swap_out_fail``
    A preemption victim's KV swap-out to host fails.  The engine falls
    back to evict-to-restart: the lane's KV is discarded and the request
    re-runs its (deterministic) chunked prefill — bit-exact, latency
    lost, never correctness.
``swap_in_fail``
    A swapped-out lane's re-admission fails.  The engine retries with
    bounded exponential backoff (``engine.SWAP_IN_RETRIES``); when
    retries exhaust it drops the host copy and restarts the request via
    chunked prefill.
``alloc_fail``
    Transient page-allocator exhaustion: every allocation attempt in the
    matching iteration reports "no pages".  Prefilling lanes skip their
    chunk and retry; decoding lanes *stall* for the step (they are
    masked out of the batched decode and retry next iteration) — no
    preemption, no crash, bitwise-identical outputs, just added latency.
``latency``
    A step-latency spike: the engine sleeps ``value`` seconds (default
    0.02) inside the timed decode step.  The step watchdog
    (``checkpoint.fault_tolerance.straggler_threshold``) must count it in
    ``EngineStats.slow_steps``.
``corrupt_page``
    One of the target lane's held physical pages is overwritten in every
    non-``pos`` pool leaf (``value`` fill; default +inf for float
    leaves, the dtype max for int8 leaves).  Poisoned K/V turns the
    lane's logits non-finite, which the per-step NaN/Inf detector
    quarantines — only that lane; freed pages are scrubbed so the
    poison cannot leak into the free list.
``nan_logits``
    The target lane's decode logits row is overwritten with ``value``
    (default NaN) before sampling.  The detector retires the lane with
    ``status="failed"``; unaffected lanes are bitwise equal to a
    fault-free run.
``cancel``
    Schedules ``Engine.cancel(rid)`` at the fault's step (``rid`` is
    required) — the deterministic way to exercise mid-flight
    cancellation, including of swapped-out requests.

The engine logs every firing in :attr:`FaultPlan.injected` (mirrored to
``EngineStats.fault_log``), so a chaos report can say exactly which
faults actually landed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("swap_out_fail", "swap_in_fail", "alloc_fail", "latency",
         "corrupt_page", "nan_logits", "cancel")

# kinds whose injection targets one request and (if they land) may change
# that request's output/status — everything else must be output-invariant
DIRTY_KINDS = ("corrupt_page", "nan_logits", "cancel")


@dataclasses.dataclass
class Fault:
    """One injectable failure: armed from ``step``, fires on up to
    ``count`` matching events, optionally pinned to request ``rid``.
    ``value`` is the kind-specific payload (sleep seconds for
    ``latency``, fill value for ``corrupt_page``/``nan_logits``)."""

    kind: str
    step: int = 0
    rid: int | None = None
    count: int = 1
    value: float | None = None
    remaining: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"supported: {KINDS}")
        if self.kind == "cancel" and self.rid is None:
            raise ValueError("cancel faults must name the rid to cancel")
        if self.count < 1:
            raise ValueError("Fault.count must be >= 1")
        self.remaining = self.count


class FaultPlan:
    """An ordered set of :class:`Fault` injections plus the firing log.

    ``FaultPlan([...])`` builds an explicit schedule;
    :meth:`FaultPlan.random` derives one deterministically from a seed.
    The engine calls :meth:`reset` at the start of every serve call, so
    one plan object replays identically across calls.
    """

    def __init__(self, faults: list[Fault] | None = None):
        self.faults: list[Fault] = list(faults or [])
        self.injected: list[dict] = []

    def __repr__(self):
        return f"FaultPlan({self.faults!r})"

    def reset(self) -> None:
        """Re-arm every fault and clear the firing log (called by the
        engine at the top of each serve so chaos runs are replayable)."""
        for f in self.faults:
            f.remaining = f.count
        self.injected = []

    def fire(self, kind: str, step: int, rid: int | None = None
             ) -> Fault | None:
        """Consume one charge of the first armed fault matching this
        event, or return None.  An event with ``rid=None`` (engine-wide:
        allocation, latency, cancel sweep) matches any fault of the
        kind; an event naming a rid matches faults pinned to that rid or
        to no rid."""
        for f in self.faults:
            if (f.kind == kind and f.remaining > 0 and f.step <= step
                    and (f.rid is None or rid is None or f.rid == rid)):
                f.remaining -= 1
                self.injected.append({
                    "kind": kind, "step": step,
                    "rid": f.rid if f.rid is not None else rid,
                    "value": f.value})
                return f
        return None

    @property
    def pending(self) -> list[Fault]:
        """Faults with charges left (armed but not yet matched)."""
        return [f for f in self.faults if f.remaining > 0]

    def dirty_rids(self) -> set[int]:
        """Rids whose *fired* faults may legitimately change their output
        or terminal status (``DIRTY_KINDS``).  Every other request must
        be bitwise identical to a fault-free run — the chaos suite's
        bystander-parity oracle."""
        return {f["rid"] for f in self.injected
                if f["kind"] in DIRTY_KINDS and f["rid"] is not None}

    @classmethod
    def random(cls, seed: int, *, rids: list[int],
               steps: int = 24, kinds: tuple[str, ...] = KINDS,
               max_faults: int = 4) -> "FaultPlan":
        """Deterministic fuzz schedule: 1..max_faults faults with random
        kinds, arming steps in ``[0, steps)`` and targets drawn from
        ``rids``.  Same seed, same plan — the chaos suite's generator."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(int(rng.integers(1, max_faults + 1))):
            kind = kinds[int(rng.integers(len(kinds)))]
            rid = int(rng.choice(rids)) if rids else None
            if kind in ("alloc_fail", "latency") and rng.random() < 0.7:
                rid = None  # usually engine-wide
            value = None
            if kind == "latency":
                value = float(rng.uniform(0.01, 0.03))
            faults.append(Fault(
                kind=kind, step=int(rng.integers(0, steps)), rid=rid,
                count=int(rng.integers(1, 4)), value=value))
        return cls(faults)
