"""Continuous-batching serving engine over a paged or dense KV cache, the
port of ``repro.serving.engine``: the ``reserve`` and ``preempt``
schedulers, the request lifecycle, the fault plane, and the one-shot
``generate`` / ``serve_sequential`` baseline.

  * **Slots.**  ``slots`` decode lanes share one paged cache; a lane is
    FREE, PREFILLING (its prompt streams in chunk by chunk) or LIVE.
  * **Paged KV cache.**  Positional leaves are page pools; each lane owns a
    block-table row mapping its logical pages to physical ones, allocated
    from a host-side free list (:class:`PagePool`).  ``kv_quant`` stores
    the pools as int8 + per-row f32 scales: "q8_0", "q4_0" (two int4
    codes a byte) or "dq" (per layer: q8_0 on the first/last layers and
    MLA latents, q4_0 elsewhere).  ``page_size=0`` keeps the dense layout
    instead: one ``(slots, max_len)`` cache row a lane, model-dtype leaves
    only, ``reserve`` admission only.
  * **Admission.**  ``reserve``: a request is admitted only when the pool
    can hold its worst case, so allocation never fails mid-serve.
    ``preempt``: priority classes (``Request.priority``, smaller = more
    urgent, FIFO within a class) over a pool that may be oversubscribed;
    when pages run out the lowest-class / youngest lane is evicted, a LIVE
    one with its pages copied to host memory (every leaf verbatim) and
    copied back bit-exactly on resume, a PREFILLING one restarting its
    deterministic chunked prefill.  ``swap_budget_bytes`` caps the host
    swap store (past it a victim restarts instead, or spills to
    ``swap_dir``).  Prompts stream in ``prefill_chunk``-token chunks
    through ONE batched ``Model.prefill_chunk`` call per iteration.
  * **Decode.**  One batched fused decode step per iteration over all
    slots; the kernels' page loops are bounded by the batch's bucketed
    live horizon (``active_pages``) and each lane's own page count
    (``lane_pages``).  ``kernel="gather"`` runs the reference path
    instead: every layer attends the dense view of each lane's whole block
    table.  Free lanes compute throwaway rows whose writes go to the
    GARBAGE page (the dense layout drops them).  One device-to-host copy
    per step carries the sampled tokens and each lane's non-finite-logits
    flag.
  * **Retirement.**  A lane frees on ``eos_id``, ``max_new`` or the
    ``max_len`` horizon; its pages return to the pool the same iteration
    (and their ``pos`` rows are scrubbed to -1).
  * **Lifecycle and faults.**  Every request ends in one terminal status:
    ``ok``, ``timeout`` (``Request.deadline_s``), ``cancelled``
    (:meth:`Engine.cancel`), ``failed`` (non-finite logits quarantine the
    lane, or the request can never fit) or ``shed`` (``max_queue`` /
    ``class_queues``).  ``faults`` takes a :class:`~.faults.FaultPlan`
    whose injections the loop degrades through; a step watchdog counts
    decode steps slower than ``watchdog_factor`` x the rolling median.
  * **Stats.**  :class:`EngineStats` uses the reference's formulas for
    throughput, TTFT, decode tok/s, page occupancy, leaked pages,
    bytes-per-live-token, KV bytes per decoded token and the scheduler's
    counters, and adds the per-step decode times and per-swap times.
  * **One-shot.**  :meth:`Engine.generate` prefills a right-padded batch
    into a dense cache in one forward and decodes it; :meth:`Engine.
    serve_sequential` runs requests one at a time through it (or, with
    ``kv_quant``, each alone through :meth:`Engine.serve`): the
    throughput baseline and the stream oracle of a batched serve.
  * **Quantization probe.**  ``quant_probe=True`` serves a shadow
    model-dtype cache through the same steps (the same block tables,
    teacher-forced with the served tokens) and reports each lane's
    largest quantized-vs-unquantized logit gap; the gap stays on the
    card until the serve ends.

The engine runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import time
import warnings
from collections import deque
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.fault_tolerance import straggler_threshold
from ..convert import tree_to
from ..models import paged
from ..models.model import Model
from .sampler import SamplerConfig, sample_per_slot, stream_seed

# swap-in failure handling (scheduler="preempt"): a failed re-admission of
# a swapped-out lane is retried with exponential backoff; once the retries
# are spent the host copy is dropped and the request restarts from its
# (deterministic) chunked prefill instead
SWAP_IN_RETRIES = 3
SWAP_IN_BACKOFF_S = 0.002

# step watchdog: a decode step is "slow" past watchdog_factor x the rolling
# median of recent steps; the median needs a few samples first, and the
# window is bounded so the baseline tracks drift
WATCHDOG_MIN_SAMPLES = 4
WATCHDOG_WINDOW = 64

# scheduler="preempt" host swap-store cap when swap_budget_bytes is not
# given: this fraction of physical RAM (an unbounded store can exhaust the
# host under sustained preemption)
SWAP_BUDGET_FRACTION = 0.25


def _default_swap_budget() -> int | None:
    """SWAP_BUDGET_FRACTION of host RAM, or ``None`` (unbounded) when the
    platform cannot report physical memory."""
    try:
        return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
                   * SWAP_BUDGET_FRACTION)
    except (ValueError, OSError, AttributeError):
        return None


def _bucket_pages(n: int, cap: int) -> int:
    """Round a live page count up to a power of two, clamped to the block
    table width — the page-loop bound handed to the fused kernels."""
    if cap <= 0:
        return 0
    n = max(1, min(n, cap))
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PagePool:
    """Host-side free-list allocator over physical page ids
    ``[RESERVED_PAGES, num_pages)`` of one shared page pool."""

    def __init__(self, num_pages: int):
        if num_pages < paged.RESERVED_PAGES:
            raise ValueError(f"num_pages={num_pages} < the "
                             f"{paged.RESERVED_PAGES} reserved pages")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, paged.RESERVED_PAGES - 1, -1))
        self._held: set[int] = set()
        self.peak_in_use = 0

    @property
    def capacity(self) -> int:
        return self.num_pages - paged.RESERVED_PAGES

    @property
    def in_use(self) -> int:
        return len(self._held)

    def alloc(self) -> int:
        return self.alloc_many(1)[0]

    def alloc_many(self, n: int) -> list[int]:
        """One allocator call for ``n`` pages."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted ({self.capacity} pages in use, "
                f"{n} requested)")
        pids = [self._free.pop() for _ in range(n)]
        self._held.update(pids)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pids

    def free(self, pages) -> None:
        for pid in pages:
            if pid not in self._held:
                raise ValueError(f"double/foreign free of page {pid}")
            self._held.remove(pid)
            self._free.append(pid)


@dataclasses.dataclass
class RequestStats:
    """Per-request timing collected by :meth:`Engine.serve`."""

    rid: int
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_tokens: int = 0
    priority: int = 0
    preemptions: int = 0         # times this request was swapped/kicked out
    # terminal status: "ok" | "timeout" | "cancelled" | "failed" | "shed"
    status: str = "ok"

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def admission_s(self) -> float:
        """Submit to first token (queue wait + prefill wall time): TTFT."""
        return self.queue_wait_s + self.prefill_s


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    priority: int = 0            # request class: smaller = more urgent
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    stats: RequestStats | None = None
    # wall-clock SLO from the serve call's start: past it the request
    # retires with status="timeout" wherever it sits.  None = no deadline.
    deadline_s: float | None = None
    status: str = ""             # terminal status once done


@dataclasses.dataclass
class EngineStats:
    """Aggregate report for one :meth:`Engine.serve` call."""

    requests: list[RequestStats] = dataclasses.field(default_factory=list)
    decode_iterations: int = 0
    prefill_iterations: int = 0
    overlap_iterations: int = 0
    live_per_iteration: list[int] = dataclasses.field(default_factory=list)
    live_tokens_per_iteration: list[int] = dataclasses.field(
        default_factory=list)
    pages_in_use_per_iteration: list[int] = dataclasses.field(
        default_factory=list)
    decode_step_s: list[float] = dataclasses.field(default_factory=list)
    total_tokens: int = 0
    wall_s: float = 0.0
    page_size: int = 0
    num_pages: int = 0
    page_bytes: int = 0                  # bytes per page across all leaves
    kv_quant: str = ""
    peak_pages: int = 0
    pages_leaked: int = 0                # pages still held after the call
    dense_cache_bytes: int = 0           # slots x max_len layout, to compare
    decode_kv_bytes: int = 0             # KV bytes the decode kernels read
    decoded_tokens: int = 0
    # Engine(quant_probe=True): per slot, the largest max|l - ref| /
    # max|ref| between the served logits and the shadow cache's, over the
    # steps the slot was live; empty when the probe is off
    quant_probe_steps: int = 0
    quant_logit_gap_per_lane: list[float] = dataclasses.field(
        default_factory=list)
    # preemption scheduler (scheduler="preempt"; all zero under "reserve")
    scheduler: str = "reserve"
    preemptions: int = 0                 # lanes swapped/kicked out, total
    swap_out_bytes: int = 0              # KV bytes copied to the host
    swap_in_bytes: int = 0               # KV bytes copied back on resume
    swap_held_bytes: int = 0             # peak host bytes of swapped lanes
    swap_restarts: int = 0               # LIVE lanes restarted: swap over cap
    # wall time of each swap-out (device pages to host rows) and swap-in
    # (host rows back into fresh pages), in seconds
    swap_out_s: list[float] = dataclasses.field(default_factory=list)
    swap_in_s: list[float] = dataclasses.field(default_factory=list)
    # request lifecycle + fault plane (Engine(faults=...), deadline_s,
    # cancel(), load shedding): all zero on a fault-free, unshed run
    faults_injected: int = 0             # FaultPlan firings this serve call
    fault_log: list[dict] = dataclasses.field(default_factory=list)
    alloc_stalls: int = 0                # decode steps stalled by alloc_fail
    nan_quarantines: int = 0             # lanes retired on non-finite logits
    pages_corrupted: int = 0             # corrupt_page faults landed
    slow_steps: int = 0                  # watchdog: steps > factor x median
    swap_failures: int = 0               # injected swap-out failures (restart)
    swap_retries: int = 0                # failed swap-in attempts retried
    swap_dropped_bytes: int = 0          # swap rows discarded, never resumed
    swap_spills: int = 0                 # lanes spilled to disk (swap_dir)
    swap_disk_bytes: int = 0             # total bytes written to spill files
    swap_disk_held_bytes: int = 0        # peak bytes held in spill files
    swap_held_end_bytes: int = 0         # host swap bytes still held at return
    swap_disk_end_bytes: int = 0         # spill bytes still held at return
    # per-iteration scheduler snapshots, recorded after admission:
    # {"queued": [(prio, seq, rid, pages_needed)], "active": [(prio, seq,
    # rid, pages_held)], "free_pages": int, "free_slots": int, "swapped":
    # [rid]}
    sched_trace: list[dict] = dataclasses.field(default_factory=list)

    @property
    def max_concurrency(self) -> int:
        return max(self.live_per_iteration, default=0)

    @property
    def mean_concurrency(self) -> float:
        if not self.live_per_iteration:
            return 0.0
        return sum(self.live_per_iteration) / len(self.live_per_iteration)

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_live_tokens(self) -> float:
        if not self.live_tokens_per_iteration:
            return 0.0
        return (sum(self.live_tokens_per_iteration)
                / len(self.live_tokens_per_iteration))

    @property
    def mean_admission_s(self) -> float:
        if not self.requests:
            return 0.0
        return sum(r.admission_s for r in self.requests) / len(self.requests)

    @property
    def cache_bytes_mean(self) -> float:
        """Mean positional-cache footprint over the serve call."""
        if self.page_size and self.pages_in_use_per_iteration:
            mean_pages = (sum(self.pages_in_use_per_iteration)
                          / len(self.pages_in_use_per_iteration))
            return mean_pages * self.page_bytes
        return float(self.dense_cache_bytes)

    @property
    def bytes_per_live_token(self) -> float:
        return self.cache_bytes_mean / max(self.mean_live_tokens, 1e-9)

    @property
    def kv_bytes_per_decoded_token(self) -> float:
        return self.decode_kv_bytes / max(self.decoded_tokens, 1)

    @property
    def quant_logit_gap_max(self) -> float:
        """The worst lane's probe gap (0.0 when the probe was off)."""
        return max(self.quant_logit_gap_per_lane, default=0.0)

    @property
    def decode_tok_s(self) -> float:
        """Decoded tokens over the summed decode-step wall time."""
        total = sum(self.decode_step_s)
        return self.decoded_tokens / total if total > 0 else 0.0

    def decode_step_ms(self, q: float) -> float:
        """The ``q`` quantile (0..1) of the decode-step wall times, in ms."""
        if not self.decode_step_s:
            return 0.0
        return float(np.quantile(np.asarray(self.decode_step_s), q)) * 1e3

    @property
    def status_counts(self) -> dict[str, int]:
        """Terminal-status histogram over the call's requests."""
        out: dict[str, int] = {}
        for r in self.requests:
            out[r.status] = out.get(r.status, 0) + 1
        return out

    @property
    def class_stats(self) -> dict[int, dict[str, Any]]:
        """Per-priority-class aggregates: mean queue wait, mean admission
        (TTFT), preemptions and the terminal-status histogram."""
        by: dict[int, list[RequestStats]] = {}
        for r in self.requests:
            by.setdefault(r.priority, []).append(r)
        return {
            prio: {
                "n": len(rs),
                "mean_queue_wait_s": sum(r.queue_wait_s for r in rs) / len(rs),
                "mean_admission_s": sum(r.admission_s for r in rs) / len(rs),
                "preemptions": sum(r.preemptions for r in rs),
                "statuses": {st: sum(1 for r in rs if r.status == st)
                             for st in sorted({r.status for r in rs})},
            }
            for prio, rs in sorted(by.items())
        }

    def report(self) -> str:
        lines = [
            f"{len(self.requests)} requests, {self.total_tokens} tokens in "
            f"{self.wall_s:.2f}s ({self.throughput_tok_s:.1f} tok/s)",
            f"decode iterations: {self.decode_iterations}  "
            f"prefill chunks: {self.prefill_iterations} "
            f"({self.overlap_iterations} overlapping decode)  "
            f"concurrency max/mean: {self.max_concurrency}/"
            f"{self.mean_concurrency:.2f}",
            f"decode steps: {self.decode_tok_s:.1f} tok/s, median "
            f"{self.decode_step_ms(0.5):.2f} ms, p90 "
            f"{self.decode_step_ms(0.9):.2f} ms",
            f"pages: {self.peak_pages}/"
            f"{self.num_pages - paged.RESERVED_PAGES} peak "
            f"({self.page_size} tok/page, {self.page_bytes} B/page"
            f"{', ' + self.kv_quant if self.kv_quant else ''}, "
            f"leaked {self.pages_leaked})  cache "
            f"{self.bytes_per_live_token:.0f} B/live-token vs dense "
            f"{self.dense_cache_bytes / max(self.mean_live_tokens, 1e-9):.0f}",
        ]
        if self.decoded_tokens:
            lines.append(
                f"decode reads {self.kv_bytes_per_decoded_token:.0f} "
                f"KV-B/decoded-token over {self.decoded_tokens} tokens")
        if self.quant_probe_steps:
            lines.append(
                f"quant probe ({self.kv_quant}): max per-lane logit gap "
                f"{self.quant_logit_gap_max:.3e} over "
                f"{self.quant_probe_steps} compared steps")
        sc = self.status_counts
        if set(sc) - {"ok"}:
            lines.append("status: " + "  ".join(
                f"{st}={n}" for st, n in sorted(sc.items())))
        if self.faults_injected:
            lines.append(
                f"chaos: {self.faults_injected} faults injected — "
                f"{self.alloc_stalls} alloc stalls, "
                f"{self.nan_quarantines} quarantined, "
                f"{self.pages_corrupted} pages corrupted, "
                f"{self.swap_failures} swap-out failures, "
                f"{self.swap_retries} swap-in retries, "
                f"{self.slow_steps} slow steps")
        if self.swap_spills:
            lines.append(
                f"swap spill: {self.swap_spills} lanes to disk, "
                f"{self.swap_disk_bytes} B written (peak held "
                f"{self.swap_disk_held_bytes} B, end "
                f"{self.swap_disk_end_bytes} B)")
        if self.preemptions or self.scheduler == "preempt":
            lines.append(
                f"scheduler {self.scheduler}: {self.preemptions} preemptions, "
                f"swapped out {self.swap_out_bytes} B / in "
                f"{self.swap_in_bytes} B (peak held {self.swap_held_bytes} B, "
                f"{self.swap_restarts} budget restarts)")
            for prio, cs in self.class_stats.items():
                st = " ".join(f"{k}:{v}"
                              for k, v in cs["statuses"].items())
                lines.append(
                    f"  class {prio}: {cs['n']} reqs, queue "
                    f"{cs['mean_queue_wait_s'] * 1e3:.1f}ms, TTFT "
                    f"{cs['mean_admission_s'] * 1e3:.1f}ms, "
                    f"{cs['preemptions']:.0f} preemptions  [{st}]")
        for r in sorted(self.requests, key=lambda r: r.rid):
            tag = "" if r.status == "ok" else f"  [{r.status}]"
            lines.append(
                f"  req {r.rid}: wait {r.queue_wait_s * 1e3:.1f}ms  "
                f"prefill {r.prefill_s * 1e3:.1f}ms  "
                f"decode {r.decode_tokens} tok @ {r.decode_tok_s:.1f} tok/s"
                f"{tag}")
        return "\n".join(lines)


_FREE, _PREFILL, _LIVE = 0, 1, 2


class _Slot:
    """Host-side bookkeeping for one decode lane."""

    __slots__ = ("req", "tok", "pos", "n_out", "state", "prefill_pos",
                 "pages", "reserve_remaining", "seq")

    def __init__(self):
        self.req: Request | None = None
        self.state = _FREE
        self.tok = 0          # last sampled token (next decode input)
        self.pos = 0          # absolute position of ``tok``
        self.n_out = 0        # tokens emitted so far
        self.prefill_pos = 0  # prompt tokens already in the cache
        self.pages: list[int] = []
        self.reserve_remaining = 0
        self.seq = 0          # admission sequence (FIFO rank within a class)

    @property
    def live(self) -> bool:
        return self.state == _LIVE

    @property
    def key(self) -> tuple[int, int]:
        """Scheduling rank: (class, arrival seq) — smaller runs first;
        preemption evicts the largest key (lowest class, youngest)."""
        return (self.req.priority, self.seq)


@dataclasses.dataclass
class _Swapped:
    """Host-side copy of a preempted LIVE lane (scheduler="preempt").

    Holds what resumes the lane bit-exactly on any slot: the request
    scalars, the block-table row (old physical ids, remapped to freshly
    allocated pages on swap-in) and the lane's page rows of every pool
    leaf, copied verbatim (payloads, int8 codes and f32 scales, ``pos``
    rows) before the release scrub.  Every leaf of the port's caches is a
    page pool, so there are no per-slot rows to carry.
    """

    req: Request
    seq: int
    tok: int
    pos: int
    n_out: int
    pages: list[int]                     # old physical ids, allocation order
    bt_full: np.ndarray                  # old block-table row (logical map)
    pool_rows: dict[str, torch.Tensor]   # leaf -> (n_pages_held, P, ...)
    spill_path: str | None = None        # rows parked on disk (swap_dir)
    saved_bytes: int = 0                 # row bytes at spill time
    retries: int = 0                     # failed swap-in attempts so far

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    @property
    def nbytes(self) -> int:
        if self.saved_bytes:   # spilled: the rows live on disk, not in RAM
            return self.saved_bytes
        return sum(_nbytes(a) for a in self.pool_rows.values())


class Engine:
    """Single-card continuous-batching engine.

    ``page_size`` tokens per KV page (``num_pages`` caps the pool; default:
    the worst case for ``slots x max_len``), or 0 for the dense layout;
    ``prefill_chunk`` admission chunk length (default: whole prompts);
    ``kernel`` ``"fused"`` (default) or ``"gather"``, the paged decode's
    reference path; ``kv_quant`` (paged only) None (model-dtype pools),
    ``"q8_0"``, ``"q4_0"`` or ``"dq"``; ``quant_probe`` (needs
    ``kv_quant``, the ``reserve`` scheduler and no fault plan) shadows
    every step with a model-dtype cache and reports the logit gap in
    :class:`EngineStats`.  ``scheduler`` is ``"reserve"`` (admit on the
    worst case) or ``"preempt"`` (priority classes, preemption and KV
    swap-out over a paged, oversubscribed pool; ``swap_budget_bytes`` caps
    the host store, default ``SWAP_BUDGET_FRACTION`` of host RAM, and
    ``swap_dir`` spills past it to files).  ``faults`` takes a
    :class:`~.faults.FaultPlan`; ``max_queue`` / ``class_queues`` shed
    requests past their bounds; ``watchdog_factor`` sets the slow-step
    cutoff.  ``device=None`` means the card; params are moved to the
    engine's device.
    """

    SCHEDULERS = ("reserve", "preempt")

    def __init__(self, model: Model, params, *, max_len: int = 512,
                 eos_id: int = -1, sampler: SamplerConfig = SamplerConfig(),
                 page_size: int = 16, num_pages: int = 0,
                 prefill_chunk: int = 0, kernel: str | None = None,
                 kv_quant: str | None = None, scheduler: str = "reserve",
                 device=None, quant_probe: bool = False,
                 swap_budget_bytes: int | None = None, swap_dir=None,
                 mesh=None, faults=None, max_queue: int | None = None,
                 class_queues: dict[int, int] | None = None,
                 watchdog_factor: float = 4.0):
        self.device = resolve_device(device)
        self.kv_quant = paged.check_kv_quant(kv_quant)
        if self.kv_quant and not page_size:
            raise ValueError("kv_quant requires the paged cache "
                             "(page_size > 0)")
        self.quant_probe = bool(quant_probe)
        if self.quant_probe:
            if not self.kv_quant:
                raise ValueError("quant_probe measures the quantized-vs-f32 "
                                 "logit gap and requires kv_quant")
            if scheduler != "reserve" or faults is not None or (
                    mesh is not None):
                raise ValueError("quant_probe shadows the serve call with "
                                 "an unquantized cache and supports only "
                                 "the default scheduler with no fault plan "
                                 "and no mesh")
        if scheduler not in self.SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             f"supported: {self.SCHEDULERS}")
        if scheduler == "preempt" and not page_size:
            raise ValueError("scheduler='preempt' swaps KV pages and "
                             "requires the paged cache (page_size > 0)")
        if mesh is not None:
            raise NotImplementedError("Engine(mesh=...) is not ported yet "
                                      "(ROADMAP D8)")
        if swap_budget_bytes is not None:
            if scheduler != "preempt":
                raise ValueError("swap_budget_bytes caps the preemption "
                                 "scheduler's host swap store; it requires "
                                 "scheduler='preempt'")
            if swap_budget_bytes < 0:
                raise ValueError("swap_budget_bytes must be >= 0")
        self._swap_budget_defaulted = False
        if scheduler == "preempt" and swap_budget_bytes is None:
            swap_budget_bytes = _default_swap_budget()
            self._swap_budget_defaulted = swap_budget_bytes is not None
        self._warned_swap_budget = False
        self.swap_budget_bytes = swap_budget_bytes
        self.faults = faults
        if max_queue is not None and max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self.max_queue = max_queue
        self.class_queues = dict(class_queues) if class_queues else None
        if self.class_queues and any(v < 0
                                     for v in self.class_queues.values()):
            raise ValueError("class_queues caps must be >= 0")
        if swap_dir is not None:
            if scheduler != "preempt":
                raise ValueError("swap_dir spills the preemption "
                                 "scheduler's host swap store to disk; it "
                                 "requires scheduler='preempt'")
            os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        if watchdog_factor <= 1.0:
            raise ValueError("watchdog_factor must be > 1 (it multiplies "
                             "the median step time)")
        self.watchdog_factor = watchdog_factor
        self._cancel_rids: set[int] = set()
        self.model = model
        self.params = tree_to(params, self.device)
        self.max_len = max_len
        self.eos_id = eos_id
        self.sampler = sampler
        self.page_size = page_size
        self.num_pages = num_pages
        self.scheduler = scheduler
        self.kernel = kernel or "fused"
        if self.kernel not in Model.KERNELS:
            raise ValueError(f"unknown paged decode kernel {self.kernel!r}")
        self.prefill_chunk = min(prefill_chunk, max_len) or max_len
        self.last_stats: EngineStats | None = None
        self._page_bytes = self._one_page_bytes() if page_size else 0

    def cancel(self, rid: int) -> None:
        """Cancel request ``rid``: the serve loop's per-iteration sweep
        retires it with ``status="cancelled"`` wherever it sits (a running
        lane releases its pages, a queued entry drops, a swapped-out lane
        frees its host rows or spill file).  Callable before or during
        :meth:`serve`; unknown rids are a no-op."""
        self._cancel_rids.add(rid)

    # -- byte accounting (the reference's formulas) ---------------------------
    def _meta_cache(self, num_pages: int, slots: int = 1) -> dict:
        return self.model.init_paged_cache(
            num_pages, self.page_size, slots, dtype=self.model.dtype,
            kv_quant=self.kv_quant, device="meta")

    def _one_page_bytes(self) -> int:
        """Bytes one physical page holds across every layer's pool leaves."""
        return sum(_nbytes(t) for t in self._meta_cache(1).values())

    def _dense_cache_bytes(self, slots: int) -> int:
        """The dense ``slots x max_len`` layout's bytes, from the model's
        own cache leaves (K/V/pos for GQA, ``c_kv``/``k_rope`` for MLA) in
        the model dtype."""
        meta = self.model.init_cache(slots, self.max_len,
                                     dtype=self.model.dtype, device="meta")
        return sum(_nbytes(t) for t in meta.values())

    def _dense_kv_read_bytes(self, slots: int) -> int:
        """Bytes one dense decode step reads from the attention / MLA
        caches: every leaf of every layer (the port has no recurrent
        passthrough state), so ``decode_kv_bytes`` compares with what the
        paged modes charge."""
        return self._dense_cache_bytes(slots)

    # -- continuous batching -------------------------------------------------
    def serve(self, requests: list[Request], slots: int = 4,
              seed: int = 0) -> list[Request]:
        """Admit (chunked) -> batched decode -> retire, until every request
        is terminal.  Returns the requests in completion order;
        ``self.last_stats`` holds the call's :class:`EngineStats`.

        Every request ends in exactly one status (see the module
        docstring); ``serve`` never raises for a per-request condition, and
        with ``Engine(faults=...)`` every injected failure degrades the same
        way (``EngineStats.fault_log`` records what landed)."""
        t_start = time.perf_counter()
        stats = EngineStats()
        stats.scheduler = self.scheduler
        preempt = self.scheduler == "preempt"
        plan = self.faults
        if plan is not None:
            plan.reset()   # each serve call replays the same fault schedule
        it = -1            # engine iteration: the fault plan's step axis

        def fire(kind: str, rid: int | None = None):
            return plan.fire(kind, it, rid) if plan is not None else None

        dev, model, params = self.device, self.model, self.params
        lanes = [_Slot() for _ in range(slots)]
        done: list[Request] = []
        P, C = self.page_size, self.prefill_chunk
        greedy = self.sampler.is_greedy

        def terminate(req: Request, status: str,
                      queue_wait: float = 0.0) -> None:
            """Retire a request with a non-"ok" terminal status from
            wherever it sits (shedding, a queue reap, lane quarantine)."""
            if req.stats is None:
                req.stats = RequestStats(rid=req.rid, priority=req.priority,
                                         queue_wait_s=queue_wait)
            req.stats.status = status
            req.status = status
            req.done = True
            self._cancel_rids.discard(req.rid)
            stats.requests.append(req.stats)
            stats.total_tokens += len(req.out)
            done.append(req)

        # -- admission-side load shedding: requests past max_queue or their
        # class's cap retire at once with status="shed"; earlier arrivals win
        admitted: list[Request] = []
        class_n: dict[int, int] = {}
        for req in requests:
            req.done, req.status, req.stats, req.out = False, "", None, []
            over = (self.max_queue is not None
                    and len(admitted) >= self.max_queue)
            cap = (self.class_queues or {}).get(req.priority)
            over = over or (cap is not None
                            and class_n.get(req.priority, 0) >= cap)
            if over:
                terminate(req, "shed")
            else:
                class_n[req.priority] = class_n.get(req.priority, 0) + 1
                admitted.append(req)

        # reserve: a FIFO deque.  preempt: a (priority, seq, tick) heap —
        # seq is the arrival rank, so FIFO within a class, and a preempted
        # request re-enters at its ORIGINAL rank
        queue: deque[Request] = deque()
        pqueue: list[tuple[int, int, int, Any]] = []
        enq_t: dict[int, float] = {}     # seq -> last time it was enqueued
        tick = 0

        def requeue(item: Any, prio: int, seq: int) -> None:
            nonlocal tick
            tick += 1
            heapq.heappush(pqueue, (prio, seq, tick, item))
            enq_t[seq] = time.perf_counter()

        if preempt:
            for i, req in enumerate(admitted):
                requeue(req, req.priority, i)
                enq_t[i] = t_start
        else:
            queue = deque(admitted)

        def pending() -> bool:
            return bool(pqueue) if preempt else bool(queue)

        # page_size=0: the dense layout, one (slots, max_len) cache row a
        # lane and no page pool (no kv_quant, reserve scheduler only)
        use_paged = P > 0
        n_full = paged.pages_for(self.max_len, P) if use_paged else 0
        shadow, probe_gap, pool = None, None, None
        if use_paged:
            num_pages = (self.num_pages
                         or paged.RESERVED_PAGES + slots * n_full)
            pool = PagePool(num_pages)
            cache = model.init_paged_cache(num_pages, P, slots,
                                           dtype=model.dtype,
                                           kv_quant=self.kv_quant, device=dev)
            if self.quant_probe:
                # model-dtype pools sharing the slots' block tables, fed
                # the served token and position streams
                shadow = model.init_paged_cache(num_pages, P, slots,
                                                dtype=model.dtype, device=dev)
                probe_gap = torch.zeros(slots, dtype=torch.float32,
                                        device=dev)
            stats.page_size, stats.num_pages = P, num_pages
            stats.page_bytes = self._page_bytes
            stats.kv_quant = self.kv_quant or ""
        else:
            cache = model.init_cache(slots, self.max_len, dtype=model.dtype,
                                     device=dev)
        pos_keys = [k for k in cache if k.endswith("/pos")]
        bt_full = np.full((slots, max(n_full, 1)), paged.GARBAGE_PAGE,
                          np.int32)
        stats.dense_cache_bytes = self._dense_cache_bytes(slots)
        dense_kv_read = 0 if use_paged else self._dense_kv_read_bytes(slots)

        # the leaves a swap copies and a fault may poison: the page pools,
        # i.e. the leaves whose shape follows num_pages (every leaf of the
        # port's caches; per-slot recurrent state waits for ROADMAP D6)
        pool_leaves: list[str] = []
        if use_paged and (preempt or plan is not None):
            lo = self._meta_cache(paged.RESERVED_PAGES, slots)
            hi = self._meta_cache(paged.RESERVED_PAGES + 1, slots)
            pool_leaves = sorted(k for k in lo if lo[k].shape != hi[k].shape)

        # host swap-store cap: a lane's swap size is exactly pages_held x
        # per-page bytes, so the budget check runs BEFORE any copy — an
        # over-budget victim discards its KV and restarts instead
        swap_held = 0
        disk_held = 0                    # bytes parked in swap_dir files
        step_times: list[float] = []     # rolling decode-step watchdog window
        swap_page_b = sum(_nbytes(cache[k]) // num_pages
                          for k in pool_leaves) if preempt else 0

        def swap_size(lane: _Slot) -> int:
            return len(lane.pages) * swap_page_b

        def tables():
            return {"full": torch.from_numpy(bt_full).to(dev)}

        def free_pages() -> int:
            return (pool.capacity - pool.in_use) if use_paged else 0

        def first_chunk_pages(plen: int) -> int:
            """Pages the first prefill chunk of a ``plen``-token prompt
            allocates: the admission bar under scheduler="preempt"."""
            return paged.pages_for(min(C, plen), P) if use_paged else 0

        def need_now(item: Any) -> int:
            return (item.n_pages if isinstance(item, _Swapped)
                    else first_chunk_pages(len(item.prompt)))

        def worst_pages(plen: int, max_new: int) -> int:
            """Pages one request can ever hold: reserve admission holds
            this headroom, so ``pool.alloc`` never fails mid-serve."""
            if not use_paged:
                return 0
            return paged.pages_for(plen + min(max_new, self.max_len - plen), P)

        def ensure_pages(lane: _Slot, s: int, lo: int, hi: int) -> bool:
            """Allocate the pages covering logical positions [lo, hi).
            Under scheduler="preempt" a dry pool first evicts worse-ranked
            lanes; if that cannot cover the span, THIS lane goes back to
            the queue (returns False: skip its chunk)."""
            if not use_paged or hi <= lo:
                return True
            targets = [lp for lp in range(lo // P, (hi - 1) // P + 1)
                       if bt_full[s, lp] < paged.RESERVED_PAGES]
            if targets and not alloc_ok:
                # injected allocator outage: skip this chunk, retry next
                # iteration (the lane stays PREFILLING)
                return False
            if preempt and len(targets) > free_pages():
                if not free_up(len(targets), lane.key):
                    preempt_lane(s)
                    return False
            for lp in targets:
                bt_full[s, lp] = pool.alloc()
                lane.pages.append(int(bt_full[s, lp]))
                lane.reserve_remaining -= 1
            return True

        def alloc_decode_pages(live_s: np.ndarray) -> bool:
            """Each live lane writes one token this step: claim the pages
            of every lane crossing a page boundary in ONE allocator call.
            Under scheduler="preempt" a dry pool evicts the worst-ranked
            active lane and retries.  Returns True when an injected
            allocator outage blocked the step's claims (the caller stalls
            the whole decode step)."""
            if not use_paged or live_s.size == 0:
                return False
            while True:
                live_s = np.array([s for s in live_s if lanes[s].live],
                                  np.int32)
                if live_s.size == 0:
                    return False
                lp = np.array([lanes[s].pos for s in live_s], np.int32) // P
                need = bt_full[live_s, lp] < paged.RESERVED_PAGES
                want = list(zip(live_s[need], lp[need]))
                if want and not alloc_ok:
                    return True
                if not preempt or len(want) <= free_pages():
                    break
                active = [s for s, l in enumerate(lanes) if l.state != _FREE]
                preempt_lane(max(active, key=lambda s: lanes[s].key))
            for (s, lp), pid in zip(want, pool.alloc_many(len(want))):
                bt_full[s, lp] = pid
                lanes[s].pages.append(pid)
                lanes[s].reserve_remaining -= 1
            return False

        def release(lane: _Slot, s: int) -> None:
            if lane.pages:
                # scrub the freed pages' positions to -1 (in place), so a
                # recycled page never leaks its previous owner's positions
                # into the validity mask of its next owner; the id list is
                # padded with GARBAGE to the table width, as the
                # reference's fixed-shape scrub is
                ids = np.full(n_full, paged.GARBAGE_PAGE, np.int64)
                ids[:len(lane.pages)] = lane.pages
                ids = torch.from_numpy(ids).to(dev)
                if plan is not None and pool_leaves:
                    # a fault plan can poison payloads (Inf/NaN): zero
                    # every leaf of the freed pages, since a masked read
                    # still multiplies the stale payload (0 * inf = nan)
                    for k in pool_leaves:
                        cache[k].index_fill_(
                            0, ids, -1 if k.endswith("/pos") else 0)
                else:
                    for k in pos_keys:
                        cache[k].index_fill_(0, ids, -1)
                if shadow is not None:
                    for k in pos_keys:
                        shadow[k].index_fill_(0, ids, -1)
                pool.free(lane.pages)
            bt_full[s, :] = paged.GARBAGE_PAGE
            lane.pages = []
            lane.reserve_remaining = 0
            lane.req, lane.state = None, _FREE

        def finish(req: Request, rst: RequestStats) -> None:
            req.done = True
            req.status = rst.status = "ok"
            self._cancel_rids.discard(req.rid)
            req.stats = rst
            stats.requests.append(rst)
            stats.total_tokens += len(req.out)
            done.append(req)

        def preempt_lane(s: int) -> None:
            """Evict lane ``s`` back to the queue at its original rank.
            A LIVE lane copies every pool leaf's rows at its pages to the
            host (``pos`` rows included, captured before the release
            scrub); past the budget it spills them to ``swap_dir`` or, with
            no spill dir or on an injected swap-out failure, restarts.  A
            PREFILLING lane holds no sampled state and restarts its
            (deterministic) chunked prefill."""
            nonlocal swap_held, disk_held
            lane = lanes[s]
            req, seq = lane.req, lane.seq
            stats.preemptions += 1
            req.stats.preemptions += 1
            over_budget = (
                lane.state == _LIVE and self.swap_budget_bytes is not None
                and swap_held + swap_size(lane) > self.swap_budget_bytes)
            spill = over_budget and self.swap_dir is not None
            swap_fail = (lane.state == _LIVE
                         and fire("swap_out_fail", req.rid) is not None)
            if swap_fail:
                stats.swap_failures += 1
            restart = (lane.state != _LIVE or swap_fail
                       or (over_budget and not spill))
            if lane.state == _LIVE and restart:
                # evict-to-restart: chunk boundaries and the per-request
                # sample streams are deterministic, so the restarted run
                # re-emits the same tokens; only latency is lost
                stats.swap_restarts += 1
                if (over_budget and not swap_fail
                        and self._swap_budget_defaulted
                        and not self._warned_swap_budget):
                    self._warned_swap_budget = True
                    warnings.warn(
                        "preemption fell back to evict-to-restart because "
                        "the DEFAULT swap budget "
                        f"({self.swap_budget_bytes} B = "
                        f"{SWAP_BUDGET_FRACTION:.0%} of host RAM) is full; "
                        "pass Engine(swap_budget_bytes=...) to raise the "
                        "cap (restarts stay bit-exact but cost latency)",
                        stacklevel=2)
            if not restart:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)  # time the copy alone
                t0 = time.perf_counter()
                # a host-blocking copy of each leaf's rows
                sw = _Swapped(
                    req=req, seq=seq, tok=lane.tok, pos=lane.pos,
                    n_out=lane.n_out, pages=list(lane.pages),
                    bt_full=bt_full[s].copy(),
                    pool_rows={k: paged.extract_pages(cache[k],
                                                      lane.pages).cpu()
                               for k in pool_leaves})
                if spill:
                    # park the rows in a file: byte-viewed, since numpy
                    # has no bf16; swap-in views them back with the leaf's
                    # dtype, so the round trip is lossless
                    fn = os.path.join(
                        self.swap_dir,
                        f"swap-{req.rid}-{seq}-{stats.swap_spills}.npz")
                    np.savez(fn, **{
                        f"p::{k}": v.contiguous().view(torch.uint8).numpy()
                        for k, v in sw.pool_rows.items()})
                    sw.saved_bytes = sw.nbytes
                    sw.pool_rows = {}
                    sw.spill_path = fn
                    stats.swap_spills += 1
                    stats.swap_disk_bytes += sw.saved_bytes
                    disk_held += sw.saved_bytes
                    stats.swap_disk_held_bytes = max(
                        stats.swap_disk_held_bytes, disk_held)
                else:
                    swap_held += sw.nbytes
                    stats.swap_held_bytes = max(stats.swap_held_bytes,
                                                swap_held)
                stats.swap_out_bytes += sw.nbytes
                stats.swap_out_s.append(time.perf_counter() - t0)
                item: Any = sw
            else:
                req.out = []
                item = req
            release(lane, s)
            requeue(item, req.priority, seq)

        def swap_in(lane: _Slot, s: int, sw: _Swapped, seq: int) -> None:
            """Resume a swapped-out lane on slot ``s``: allocate fresh
            pages (all or nothing), remap the saved block-table row old id
            -> new id, and write the saved rows back.  Attention reads
            pages only through the block table, so the new physical layout
            is invisible."""
            nonlocal swap_held, disk_held
            t0 = time.perf_counter()
            if sw.spill_path is not None:
                with np.load(sw.spill_path) as z:
                    sw.pool_rows = {
                        k[3:]: torch.from_numpy(z[k]).view(
                            cache[k[3:]].dtype)
                        for k in z.files if k.startswith("p::")}
                os.remove(sw.spill_path)
                disk_held -= sw.nbytes
                sw.spill_path = None
            else:
                swap_held -= sw.nbytes
            new_ids = pool.alloc_many(sw.n_pages)
            m = dict(zip(sw.pages, new_ids))
            bt_full[s, :] = [m.get(int(x), int(x)) for x in sw.bt_full]
            for k, rows in sw.pool_rows.items():
                paged.inject_pages(cache[k], new_ids, rows)
            req = sw.req
            lane.req, lane.state = req, _LIVE
            lane.tok, lane.pos, lane.n_out = sw.tok, sw.pos, sw.n_out
            lane.seq = seq
            lane.prefill_pos = len(req.prompt)
            lane.pages = [m[p] for p in sw.pages]
            lane.reserve_remaining = 0
            stats.swap_in_bytes += sw.nbytes
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stats.swap_in_s.append(time.perf_counter() - t0)
            req.stats.queue_wait_s += time.perf_counter() - enq_t[seq]

        def free_up(need: int, key: tuple[int, int]) -> bool:
            """Make ``need`` pages available for a request ranked ``key``
            by evicting strictly worse-ranked lanes, worst first.  All or
            nothing: if they cannot cover the shortfall nothing is
            evicted."""
            if free_pages() >= need:
                return True
            victims = sorted(
                (s for s, l in enumerate(lanes)
                 if l.state != _FREE and l.key > key),
                key=lambda s: lanes[s].key, reverse=True)
            held = sum(len(lanes[s].pages) for s in victims)
            if free_pages() + held < need:
                return False
            for s in victims:
                if free_pages() >= need:
                    break
                preempt_lane(s)
            return True

        def drop_item(item: Any) -> None:
            """Discard a queued ``_Swapped``'s host rows or spill file (its
            request was cancelled, timed out or spent its swap-in
            retries): the bytes count as dropped, so ``swap_out ==
            swap_in + swap_dropped`` balances."""
            nonlocal swap_held, disk_held
            if not isinstance(item, _Swapped):
                return
            stats.swap_dropped_bytes += item.nbytes
            if item.spill_path is not None:
                disk_held -= item.nbytes
                os.remove(item.spill_path)
                item.spill_path = None
            else:
                swap_held -= item.nbytes
            item.pool_rows = {}

        def doomed(req: Request, now: float) -> str | None:
            if req.rid in self._cancel_rids:
                return "cancelled"
            if (req.deadline_s is not None
                    and now - t_start > req.deadline_s):
                return "timeout"
            return None

        def reap(now: float) -> None:
            """Per-iteration lifecycle sweep: retire cancelled or past-
            deadline requests wherever they sit."""
            for s, lane in enumerate(lanes):
                if lane.state == _FREE:
                    continue
                status = doomed(lane.req, now)
                if status:
                    req = lane.req
                    release(lane, s)
                    terminate(req, status)
            if preempt:
                keep = []
                for entry in pqueue:
                    _, seq, _, item = entry
                    req = item.req if isinstance(item, _Swapped) else item
                    status = doomed(req, now)
                    if status:
                        drop_item(item)
                        terminate(req, status,
                                  queue_wait=now - enq_t.get(seq, now))
                    else:
                        keep.append(entry)
                if len(keep) != len(pqueue):
                    pqueue[:] = keep
                    heapq.heapify(pqueue)
            else:
                for req in [r for r in queue if doomed(r, now)]:
                    queue.remove(req)
                    terminate(req, doomed(req, now),
                              queue_wait=now - t_start)

        while pending() or any(s.state != _FREE for s in lanes):
            it += 1
            # scheduled cancellations fire as real cancel() calls
            while True:
                f = fire("cancel")
                if f is None:
                    break
                self.cancel(f.rid)
            reap(time.perf_counter())
            # one injected allocator outage blocks every allocation this
            # iteration (prefill chunks skip, decode stalls)
            alloc_ok = fire("alloc_fail") is None
            if not alloc_ok:
                stats.alloc_stalls += 1
            # -- admission: claim free slots for queued requests -------------
            if preempt:
                # slot preemption: a queued request of a strictly better
                # CLASS may bump a running lane off its slot
                while pqueue and not any(l.state == _FREE for l in lanes):
                    worst = max(range(slots), key=lambda s: lanes[s].key)
                    if pqueue[0][0] >= lanes[worst].req.priority:
                        break
                    preempt_lane(worst)
                for s, lane in enumerate(lanes):
                    if lane.state != _FREE or not pqueue:
                        continue
                    prio, seq, _, item = pqueue[0]
                    req = item.req if isinstance(item, _Swapped) else item
                    n = len(req.prompt)
                    if (n + 1 > self.max_len
                            or worst_pages(n, req.max_new) > pool.capacity):
                        # can never run within max_len / the pool: retire
                        # THIS request, keep serving the rest
                        heapq.heappop(pqueue)
                        drop_item(item)
                        terminate(req, "failed",
                                  queue_wait=time.perf_counter()
                                  - enq_t.get(seq, t_start))
                        continue
                    # no worst-case reservation: admit when the request's
                    # IMMEDIATE need fits (evicting worse lanes if it must)
                    if not free_up(need_now(item), (prio, seq)):
                        break  # pages held by better-ranked lanes
                    heapq.heappop(pqueue)
                    now = time.perf_counter()
                    if isinstance(item, _Swapped):
                        if fire("swap_in_fail", req.rid) is not None:
                            # injected swap-in failure: bounded retry with
                            # backoff, then drop the host copy and restart
                            item.retries += 1
                            stats.swap_retries += 1
                            if item.retries < SWAP_IN_RETRIES:
                                time.sleep(SWAP_IN_BACKOFF_S
                                           * 2 ** (item.retries - 1))
                                requeue(item, prio, seq)
                            else:
                                drop_item(item)
                                stats.swap_restarts += 1
                                req.out = []
                                requeue(req, prio, seq)
                            continue
                        swap_in(lane, s, item, seq)
                        continue
                    req.out = []  # (re)start: output accumulates from zero
                    if req.stats is None:
                        req.stats = RequestStats(
                            rid=req.rid, priority=req.priority,
                            queue_wait_s=now - enq_t[seq])
                    else:  # restarted prefill: accumulate the re-queue wait
                        req.stats.queue_wait_s += now - enq_t[seq]
                    bt_full[s, :] = paged.NULL_PAGE
                    lane.req, lane.state = req, _PREFILL
                    lane.prefill_pos, lane.n_out = 0, 0
                    lane.seq = seq
            else:
                for s, lane in enumerate(lanes):
                    if lane.state != _FREE or not queue:
                        continue
                    n = len(queue[0].prompt)
                    need = worst_pages(n, queue[0].max_new)
                    if n + 1 > self.max_len or (use_paged
                                                and need > pool.capacity):
                        terminate(queue.popleft(), "failed",
                                  queue_wait=time.perf_counter() - t_start)
                        continue
                    outstanding = sum(l.reserve_remaining for l in lanes)
                    if use_paged and (pool.capacity - pool.in_use
                                      - outstanding < need):
                        break        # wait for retirements to free pages
                    req = queue.popleft()
                    lane.reserve_remaining = need
                    req.out = []
                    req.stats = RequestStats(
                        rid=req.rid, priority=req.priority,
                        queue_wait_s=time.perf_counter() - t_start)
                    # unallocated logical pages read the never-written NULL
                    # page
                    bt_full[s, :] = paged.NULL_PAGE
                    lane.req, lane.state = req, _PREFILL
                    lane.prefill_pos, lane.n_out = 0, 0

            if preempt:
                # post-admission snapshot of the scheduler's state
                stats.sched_trace.append({
                    "queued": [(p, q, (e.req if isinstance(e, _Swapped)
                                       else e).rid, need_now(e))
                               for p, q, _, e in sorted(pqueue)],
                    "active": [(l.req.priority, l.seq, l.req.rid,
                                len(l.pages))
                               for l in lanes if l.state != _FREE],
                    "free_pages": free_pages(),
                    "free_slots": sum(l.state == _FREE for l in lanes),
                    "swapped": sorted(e[3].req.rid for e in pqueue
                                      if isinstance(e[3], _Swapped)),
                })

            # -- one batched prefill chunk over all admitting lanes ----------
            prefilling = [s for s, l in enumerate(lanes)
                          if l.state == _PREFILL]
            toks = np.zeros((slots, C), np.int32)
            start = np.zeros(slots, np.int32)
            clen = np.zeros(slots, np.int32)
            for s in prefilling:
                lane = lanes[s]
                if lane.state != _PREFILL:
                    continue         # evicted by an earlier lane's free_up
                prompt = lane.req.prompt
                n = min(C, len(prompt) - lane.prefill_pos)
                if not ensure_pages(lane, s, lane.prefill_pos,
                                    lane.prefill_pos + n):
                    continue         # no pages (requeued or stalled): skip
                toks[s, :n] = prompt[lane.prefill_pos:lane.prefill_pos + n]
                start[s] = lane.prefill_pos
                clen[s] = n
            for s in prefilling:
                if lanes[s].state != _PREFILL:
                    clen[s] = 0      # evicted after its chunk was assembled
            if clen.any():
                chunk = (torch.from_numpy(toks).to(dev),
                         torch.from_numpy(start).to(dev),
                         torch.from_numpy(clen).to(dev))
                bts = tables() if use_paged else None
                logits, cache = model.prefill_chunk(
                    params, cache, *chunk, max_len=self.max_len,
                    block_tables=bts, page_size=P, kv_quant=self.kv_quant,
                    kernel=self.kernel)
                if shadow is not None:
                    _, shadow = model.prefill_chunk(
                        params, shadow, *chunk, max_len=self.max_len,
                        block_tables=bts, page_size=P, kernel=self.kernel)
                stats.prefill_iterations += 1
                first_toks = first_bad = None
                for s in prefilling:
                    lane = lanes[s]
                    if lane.state != _PREFILL or not clen[s]:
                        continue
                    lane.prefill_pos += int(clen[s])
                    if lane.prefill_pos < len(lane.req.prompt):
                        continue     # more chunks to stream
                    if first_toks is None:
                        # the non-finite-logits flags ride the same copy
                        # as the sampled tokens (quarantine detector)
                        seeds = [None if greedy or l.state != _PREFILL
                                 else stream_seed(seed, l.req.rid, 0)
                                 for l in lanes]
                        first_toks, first_bad = self._sample_host(
                            logits, seeds)
                    req = lane.req
                    req.stats.prefill_s = (time.perf_counter() - t_start
                                           - req.stats.queue_wait_s)
                    if first_bad[s]:
                        # non-finite prefill logits: quarantine this lane
                        stats.nan_quarantines += 1
                        release(lane, s)
                        terminate(req, "failed")
                        continue
                    tok = int(first_toks[s])
                    req.out.append(tok)
                    budget = min(req.max_new, self.max_len - len(req.prompt))
                    if tok == self.eos_id or len(req.out) >= budget:
                        finish(req, req.stats)
                        release(lane, s)
                        continue
                    lane.state = _LIVE
                    lane.tok, lane.pos, lane.n_out = tok, len(req.prompt), 1

            # decode-time allocation may itself preempt lanes, so allocate
            # BEFORE freezing the live set
            if alloc_decode_pages(np.array(
                    [s for s, l in enumerate(lanes) if l.live], np.int32)):
                # allocator fault: this step's write targets are missing,
                # so the whole decode step stalls one iteration
                continue
            live = [l for l in lanes if l.live]
            if not live:
                continue
            if prefilling:
                stats.overlap_iterations += 1

            # -- one batched decode step over ALL slots ------------------------
            stats.decode_iterations += 1
            stats.live_per_iteration.append(len(live))
            stats.live_tokens_per_iteration.append(
                sum(l.pos + 1 for l in live)
                + sum(l.prefill_pos for l in lanes if l.state == _PREFILL))
            if use_paged:
                stats.pages_in_use_per_iteration.append(pool.in_use)
            if plan is not None and use_paged:
                # corrupt_page: poison one held page of the target lane in
                # every payload leaf (+inf in float leaves, the dtype max in
                # integer ones, so q8_0/q4_0 pages carry it in their
                # scales); pos rows stay, so the page still reads as valid
                for s, lane in enumerate(lanes):
                    if not lane.live or not lane.pages:
                        continue
                    f = fire("corrupt_page", lane.req.rid)
                    if f is None:
                        continue
                    stats.pages_corrupted += 1
                    pid = lane.pages[0]
                    for k in pool_leaves:
                        if k.endswith("/pos"):
                            continue
                        v = cache[k]
                        if v.dtype.is_floating_point:
                            fill = (f.value if f.value is not None
                                    else float("inf"))
                        else:
                            fill = torch.iinfo(v.dtype).max
                        v[pid] = fill
            toks = torch.tensor([l.tok for l in lanes], dtype=torch.int32,
                                device=dev)
            pos = torch.tensor([l.pos if l.live else 0 for l in lanes],
                               dtype=torch.int32, device=dev)
            live_mask = torch.tensor([l.live for l in lanes], device=dev)
            t0 = time.perf_counter()
            lat = fire("latency")
            if lat is not None:
                # injected latency spike, inside the timed step so the
                # watchdog sees it like a real stall
                time.sleep(lat.value if lat.value is not None else 0.02)
            if not use_paged:
                # every layer's whole dense cache is read
                stats.decode_kv_bytes += dense_kv_read
                logits, cache = model.decode_step(params, cache, toks, pos,
                                                  live=live_mask)
            else:
                active = lane_pages = None
                if self.kernel == "fused":
                    horizon = max(l.pos + 1 for l in live)
                    active = (_bucket_pages(paged.pages_for(horizon, P),
                                            n_full), 0)
                    # per-lane page counts: each lane's page loop stops at
                    # its OWN live pages (free lanes charge their single
                    # page)
                    lf = np.array([min(paged.pages_for(l.pos + 1, P),
                                       active[0]) if l.live else 1
                                   for l in lanes], np.int32)
                    stats.decode_kv_bytes += int(lf.sum()) * self._page_bytes
                    lane_pages = {"full": torch.from_numpy(lf).to(dev)}
                else:
                    # the gather reference reads every lane's whole table
                    stats.decode_kv_bytes += slots * n_full * self._page_bytes
                step_kw = dict(page_size=P, max_len=self.max_len,
                               live=live_mask, active_pages=active,
                               lane_pages=lane_pages, kernel=self.kernel)
                bts = tables()
                logits, cache = model.decode_step_paged(
                    params, cache, toks, pos, bts, kv_quant=self.kv_quant,
                    **step_kw)
            if shadow is not None:
                # the same step over the shadow pools, teacher-forced with
                # the served tokens: the gap is the cache quantization's
                # alone, at identical context
                ref, shadow = model.decode_step_paged(
                    params, shadow, toks, pos, bts, **step_kw)
                ref = ref.to(torch.float32)
                gap = (torch.amax(torch.abs(logits.to(torch.float32) - ref),
                                  dim=-1)
                       / torch.clamp(torch.amax(torch.abs(ref), dim=-1),
                                     min=1e-6))
                probe_gap = torch.where(
                    live_mask, torch.maximum(probe_gap, gap), probe_gap)
                stats.quant_probe_steps += 1
            stats.decoded_tokens += len(live)
            if plan is not None:
                # nan_logits: overwrite the target lane's logits row before
                # sampling; the detector must catch it
                for s, lane in enumerate(lanes):
                    if not lane.live:
                        continue
                    f = fire("nan_logits", lane.req.rid)
                    if f is not None:
                        logits[s] = (f.value if f.value is not None
                                     else float("nan"))
            seeds = [stream_seed(seed, l.req.rid, l.n_out)
                     if l.live and not greedy else None for l in lanes]
            # one device-to-host copy per step (tokens and flags); it also
            # ends the timing
            host_tok, host_bad = self._sample_host(logits, seeds)
            dt = time.perf_counter() - t0
            stats.decode_step_s.append(dt)
            # step watchdog: the straggler rule over recent decode steps
            step_times.append(dt)
            del step_times[:-WATCHDOG_WINDOW]
            if len(step_times) >= WATCHDOG_MIN_SAMPLES:
                cut = straggler_threshold(step_times[:-1],
                                          self.watchdog_factor)
                if dt > cut > 0:
                    stats.slow_steps += 1

            # -- emit + retire ------------------------------------------------
            for s, lane in enumerate(lanes):
                if not lane.live:
                    continue
                req = lane.req
                rst = req.stats
                rst.decode_s += dt
                if host_bad[s]:
                    # non-finite logits: quarantine ONLY this lane (pages
                    # scrubbed and freed, status="failed")
                    stats.nan_quarantines += 1
                    release(lane, s)
                    terminate(req, "failed")
                    continue
                rst.decode_tokens += 1
                tok = int(host_tok[s])
                req.out.append(tok)
                lane.tok, lane.pos, lane.n_out = tok, lane.pos + 1, \
                    lane.n_out + 1
                budget = min(req.max_new, self.max_len - len(req.prompt))
                if (tok == self.eos_id or lane.n_out >= budget
                        or lane.pos + 1 >= self.max_len):
                    finish(req, rst)
                    release(lane, s)

        if use_paged:
            stats.peak_pages = pool.peak_in_use
            stats.pages_leaked = pool.in_use
        if probe_gap is not None:
            stats.quant_logit_gap_per_lane = probe_gap.cpu().tolist()
        if plan is not None:
            stats.faults_injected = len(plan.injected)
            stats.fault_log = list(plan.injected)
        stats.swap_held_end_bytes = swap_held
        stats.swap_disk_end_bytes = disk_held
        # every request is terminal now; cancels of unknown or finished
        # rids must not leak into the next serve call
        self._cancel_rids.clear()
        stats.wall_s = time.perf_counter() - t_start
        self.last_stats = stats
        return done

    # -- one-shot batch generation -------------------------------------------
    def generate(self, prompts: list[list[int]], max_new: int,
                 seed: int = 0) -> list[list[int]]:
        """Batched one-shot generation over a dense cache: one
        ``Model.prefill`` of the right-padded prompts, then ``max_new - 1``
        decode steps.  Exact for mixed lengths: each row's first token is
        sampled at ``length - 1``, and decode overwrites every padded
        position before it attends it.  Row ``i``'s ``j``-th token draws
        from the generator seeded ``stream_seed(seed, i, j)``.  A row stops
        emitting at ``eos_id``; the steps stop when every row has."""
        dev, b = self.device, len(prompts)
        lengths = [len(p) for p in prompts]
        toks = np.zeros((b, max(lengths)), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p     # right-padded with 0
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(dev)},
            self.max_len, lengths=torch.tensor(lengths, device=dev))
        logits = logits[:, -1]
        pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
        outs: list[list[int]] = [[] for _ in range(b)]
        live = np.ones(b, bool)
        for step in range(max_new):
            seeds = [stream_seed(seed, i, step) for i in range(b)]
            next_tok = sample_per_slot(logits, seeds, self.sampler)
            host_tok = next_tok.cpu().numpy()  # one copy a step
            for i in range(b):
                if live[i]:
                    outs[i].append(int(host_tok[i]))
                    live[i] = int(host_tok[i]) != self.eos_id
            if not live.any() or step == max_new - 1:
                break
            logits, cache = self.model.decode_step(self.params, cache,
                                                   next_tok, pos)
            pos = pos + 1
        return outs

    def serve_sequential(self, requests: list[Request],
                         seed: int = 0) -> list[Request]:
        """Baseline: one request at a time through one-shot
        :meth:`generate` (seed ``seed + rid``), generation clamped to the
        ``max_len`` horizon as :meth:`serve` retires lanes there.  With
        ``kv_quant`` the dense one-shot path does not exist, so each
        request instead runs alone through :meth:`serve` (seed ``seed``):
        the same quantized cache path and per-request sample streams, with
        no batching or preemption effects."""
        if self.kv_quant:
            return self._serve_sequential_paged(requests, seed)
        t_start = time.perf_counter()
        stats = EngineStats()
        done = []
        for req in requests:
            t0 = time.perf_counter()
            rst = RequestStats(rid=req.rid, queue_wait_s=t0 - t_start)
            budget = min(req.max_new, self.max_len - len(req.prompt))
            req.out = self.generate([req.prompt], budget,
                                    seed=seed + req.rid)[0]
            rst.decode_s = time.perf_counter() - t0
            rst.decode_tokens = max(len(req.out) - 1, 0)
            req.done, req.status = True, "ok"
            req.stats = rst
            stats.requests.append(rst)
            stats.total_tokens += len(req.out)
            stats.decode_iterations += rst.decode_tokens
            stats.live_per_iteration.extend([1] * rst.decode_tokens)
            done.append(req)
        stats.wall_s = time.perf_counter() - t_start
        self.last_stats = stats
        return done

    def _serve_sequential_paged(self, requests: list[Request],
                                seed: int) -> list[Request]:
        """One request at a time through the whole :meth:`serve` path on
        one slot, aggregating the per-call :class:`EngineStats`."""
        t_start = time.perf_counter()
        agg = EngineStats()
        agg.scheduler = self.scheduler
        done = []
        for req in requests:
            done.extend(self.serve([req], slots=1, seed=seed))
            s = self.last_stats
            agg.requests.extend(s.requests)
            agg.total_tokens += s.total_tokens
            agg.decode_iterations += s.decode_iterations
            agg.prefill_iterations += s.prefill_iterations
            agg.live_per_iteration.extend(s.live_per_iteration)
            agg.live_tokens_per_iteration.extend(s.live_tokens_per_iteration)
            agg.pages_in_use_per_iteration.extend(
                s.pages_in_use_per_iteration)
            agg.decode_step_s.extend(s.decode_step_s)
            agg.decode_kv_bytes += s.decode_kv_bytes
            agg.decoded_tokens += s.decoded_tokens
            agg.page_size, agg.num_pages = s.page_size, s.num_pages
            agg.page_bytes = s.page_bytes
            agg.kv_quant = s.kv_quant
            agg.quant_probe_steps += s.quant_probe_steps
            agg.quant_logit_gap_per_lane.extend(s.quant_logit_gap_per_lane)
            agg.dense_cache_bytes = s.dense_cache_bytes
            agg.peak_pages = max(agg.peak_pages, s.peak_pages)
            agg.pages_leaked += s.pages_leaked
        agg.wall_s = time.perf_counter() - t_start
        self.last_stats = agg
        return done

    def _sample_host(self, logits: torch.Tensor, seeds: list) -> tuple:
        """Sample each row and flag rows with a non-finite logit; both come
        to the host in ONE copy.  Flagged rows are sampled from zeros when
        sampling is stochastic (a non-finite row has no distribution; its
        lane is quarantined and the token dropped)."""
        bad = ~torch.isfinite(logits.to(torch.float32)).all(dim=-1)
        if not self.sampler.is_greedy:
            logits = torch.where(bad[:, None], torch.zeros_like(logits),
                                 logits)
        tok = sample_per_slot(logits, seeds, self.sampler)
        host = torch.cat([tok.to(torch.int32),
                          bad.to(torch.int32)]).cpu().numpy()
        n = logits.shape[0]
        return host[:n], host[n:]
