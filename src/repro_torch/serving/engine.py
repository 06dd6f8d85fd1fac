"""Continuous-batching serving engine over a paged KV cache (``reserve``
scheduler), the port of ``repro.serving.engine``'s main path.

  * **Slots.**  ``slots`` decode lanes share one paged cache; a lane is
    FREE, PREFILLING (its prompt streams in chunk by chunk) or LIVE.
  * **Paged KV cache.**  Positional leaves are page pools; each lane owns a
    block-table row mapping its logical pages to physical ones, allocated
    from a host-side free list (:class:`PagePool`).  ``kv_quant`` stores
    the pools as int8 + per-row f32 scales: "q8_0", "q4_0" (two int4
    codes a byte) or "dq" (per layer: q8_0 on the first/last layers and
    MLA latents, q4_0 elsewhere).
  * **Admission (reserve).**  A request is admitted only when the pool can
    hold its worst case, so allocation never fails mid-serve; prompts
    stream in ``prefill_chunk``-token chunks through ONE batched
    ``Model.prefill_chunk`` call per iteration.
  * **Decode.**  One batched fused decode step per iteration over all
    slots; the kernels' page loops are bounded by the batch's bucketed
    live horizon (``active_pages``) and each lane's own page count
    (``lane_pages``).  Free lanes compute throwaway rows whose writes go to
    the GARBAGE page.  One device-to-host copy of the sampled tokens per
    step.
  * **Retirement.**  A lane frees on ``eos_id``, ``max_new`` or the
    ``max_len`` horizon; its pages return to the pool the same iteration
    (and their ``pos`` rows are scrubbed to -1).
  * **Stats.**  :class:`EngineStats` uses the reference's formulas for
    throughput, TTFT, decode tok/s, page occupancy, leaked pages,
    bytes-per-live-token and KV bytes per decoded token, and adds the
    per-step decode times.
  * **Quantization probe.**  ``quant_probe=True`` serves a shadow
    model-dtype cache through the same steps (the same block tables,
    teacher-forced with the served tokens) and reports each lane's
    largest quantized-vs-unquantized logit gap; the gap stays on the
    card until the serve ends.

The engine runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from .. import resolve_device
from ..convert import tree_to
from ..models import paged
from ..models.model import Model
from .sampler import SamplerConfig, sample_per_slot, stream_seed


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
    status: str = "ok"       # "ok" | "failed"

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
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    stats: RequestStats | None = None
    deadline_s: float | None = None
    status: str = ""


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
                 "pages", "reserve_remaining")

    def __init__(self):
        self.req: Request | None = None
        self.state = _FREE
        self.tok = 0          # last sampled token (next decode input)
        self.pos = 0          # absolute position of ``tok``
        self.n_out = 0        # tokens emitted so far
        self.prefill_pos = 0  # prompt tokens already in the cache
        self.pages: list[int] = []
        self.reserve_remaining = 0

    @property
    def live(self) -> bool:
        return self.state == _LIVE


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class Engine:
    """Single-card continuous-batching engine (``reserve`` scheduler).

    ``page_size`` tokens per KV page (``num_pages`` caps the pool; default:
    the worst case for ``slots x max_len``); ``prefill_chunk`` admission
    chunk length (default: whole prompts); ``kv_quant`` None (model-dtype
    pools), ``"q8_0"``, ``"q4_0"`` or ``"dq"``; ``quant_probe`` (needs
    ``kv_quant`` and the ``reserve`` scheduler) shadows every step with a
    model-dtype cache and reports the logit gap in :class:`EngineStats`.
    ``device=None`` means the card; params are moved to the engine's
    device.
    """

    SCHEDULERS = ("reserve",)

    def __init__(self, model: Model, params, *, max_len: int = 512,
                 eos_id: int = -1, sampler: SamplerConfig = SamplerConfig(),
                 page_size: int = 16, num_pages: int = 0,
                 prefill_chunk: int = 0, kernel: str | None = None,
                 kv_quant: str | None = None, scheduler: str = "reserve",
                 device=None, quant_probe: bool = False,
                 swap_budget_bytes: int | None = None, swap_dir=None,
                 mesh=None, faults=None, max_queue: int | None = None,
                 class_queues=None):
        self.device = resolve_device(device)
        self.kv_quant = paged.check_kv_quant(kv_quant)
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
        if scheduler == "preempt":
            _not_ported("scheduler='preempt'", "D3")
        if scheduler not in self.SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}")
        for name, val, item in (("swap_budget_bytes", swap_budget_bytes, "D3"),
                                ("swap_dir", swap_dir, "D3"),
                                ("faults", faults, "D3"),
                                ("max_queue", max_queue, "D3"),
                                ("class_queues", class_queues, "D3"),
                                ("mesh", mesh, "D8")):
            if val:
                _not_ported(f"Engine({name}=...)", item)
        if not page_size:
            _not_ported("the dense (page_size=0) cache layout", "D5")
        if kernel not in (None, "fused"):
            _not_ported(f"kernel={kernel!r}", "D5")
        self.model = model
        self.params = tree_to(params, self.device)
        self.max_len = max_len
        self.eos_id = eos_id
        self.sampler = sampler
        self.page_size = page_size
        self.num_pages = num_pages
        self.scheduler = scheduler
        self.prefill_chunk = min(prefill_chunk, max_len) or max_len
        self.last_stats: EngineStats | None = None
        self._page_bytes = self._one_page_bytes()

    # -- byte accounting (the reference's formulas) ---------------------------
    def _one_page_bytes(self) -> int:
        """Bytes one physical page holds across every layer's pool leaves."""
        meta = self.model.init_paged_cache(
            1, self.page_size, 1, dtype=self.model.dtype,
            kv_quant=self.kv_quant, device="meta")
        return sum(t.numel() * t.element_size() for t in meta.values())

    def _dense_cache_bytes(self, slots: int) -> int:
        """The contiguous ``slots x max_len`` layout's bytes, derived from
        the model's own cache leaves (K/V/pos for GQA, ``c_kv``/``k_rope``
        for MLA) in the model dtype: ``slots`` pages of ``max_len``
        tokens."""
        meta = self.model.init_paged_cache(
            slots, self.max_len, slots, dtype=self.model.dtype,
            device="meta")
        return sum(t.numel() * t.element_size() for t in meta.values())

    # -- continuous batching -------------------------------------------------
    def serve(self, requests: list[Request], slots: int = 4,
              seed: int = 0) -> list[Request]:
        """Admit (chunked) -> batched decode -> retire, until every request
        is done.  Returns the requests in completion order;
        ``self.last_stats`` holds the call's :class:`EngineStats`."""
        if any(r.deadline_s is not None for r in requests):
            _not_ported("Request.deadline_s", "D3")
        t_start = time.perf_counter()
        stats = EngineStats()
        dev, model, params = self.device, self.model, self.params
        lanes = [_Slot() for _ in range(slots)]
        done: list[Request] = []
        P, C = self.page_size, self.prefill_chunk
        greedy = self.sampler.is_greedy

        for req in requests:
            req.done, req.status, req.stats, req.out = False, "", None, []
        queue: deque[Request] = deque(requests)

        n_full = paged.pages_for(self.max_len, P)
        num_pages = self.num_pages or paged.RESERVED_PAGES + slots * n_full
        pool = PagePool(num_pages)
        cache = model.init_paged_cache(num_pages, P, slots,
                                       dtype=model.dtype,
                                       kv_quant=self.kv_quant, device=dev)
        pos_keys = [k for k in cache if k.endswith("/pos")]
        shadow, probe_gap = None, None
        if self.quant_probe:
            # model-dtype pools sharing the slots' block tables, fed the
            # served token and position streams
            shadow = model.init_paged_cache(num_pages, P, slots,
                                            dtype=model.dtype, device=dev)
            probe_gap = torch.zeros(slots, dtype=torch.float32, device=dev)
        bt_full = np.full((slots, n_full), paged.GARBAGE_PAGE, np.int32)
        stats.page_size, stats.num_pages = P, num_pages
        stats.page_bytes = self._page_bytes
        stats.kv_quant = self.kv_quant or ""
        stats.dense_cache_bytes = self._dense_cache_bytes(slots)

        def tables():
            return {"full": torch.from_numpy(bt_full).to(dev)}

        def worst_pages(plen: int, max_new: int) -> int:
            """Pages one request can ever hold: admission reserves this, so
            ``pool.alloc`` never fails mid-serve."""
            return paged.pages_for(plen + min(max_new, self.max_len - plen), P)

        def ensure_pages(lane: _Slot, s: int, lo: int, hi: int) -> None:
            """Allocate the pages covering logical positions [lo, hi)."""
            for lp in range(lo // P, (hi - 1) // P + 1):
                if bt_full[s, lp] < paged.RESERVED_PAGES:
                    bt_full[s, lp] = pool.alloc()
                    lane.pages.append(int(bt_full[s, lp]))
                    lane.reserve_remaining -= 1

        def alloc_decode_pages() -> None:
            """Each live lane writes one token this step: claim the pages of
            every lane crossing a page boundary in ONE allocator call."""
            live_s = [s for s, l in enumerate(lanes) if l.live]
            want = [(s, lanes[s].pos // P) for s in live_s
                    if bt_full[s, lanes[s].pos // P] < paged.RESERVED_PAGES]
            for (s, lp), pid in zip(want, pool.alloc_many(len(want))):
                bt_full[s, lp] = pid
                lanes[s].pages.append(pid)
                lanes[s].reserve_remaining -= 1

        def release(lane: _Slot, s: int) -> None:
            if lane.pages:
                # scrub the freed pages' positions to -1 (in place), so a
                # recycled page never leaks its previous owner's positions
                # into the validity mask of its next owner
                ids = torch.tensor(lane.pages, dtype=torch.long, device=dev)
                for k in pos_keys:
                    cache[k].index_fill_(0, ids, -1)
                    if shadow is not None:
                        shadow[k].index_fill_(0, ids, -1)
                pool.free(lane.pages)
            bt_full[s, :] = paged.GARBAGE_PAGE
            lane.pages = []
            lane.reserve_remaining = 0
            lane.req, lane.state = None, _FREE

        def retire(req: Request, rst: RequestStats, status: str) -> None:
            req.done = True
            req.status = rst.status = status
            req.stats = rst
            stats.requests.append(rst)
            stats.total_tokens += len(req.out)
            done.append(req)

        while queue or any(s.state != _FREE for s in lanes):
            # -- admission: claim free slots for queued requests ---------------
            for s, lane in enumerate(lanes):
                if lane.state != _FREE or not queue:
                    continue
                n = len(queue[0].prompt)
                need = worst_pages(n, queue[0].max_new)
                if n + 1 > self.max_len or need > pool.capacity:
                    req = queue.popleft()
                    retire(req, RequestStats(
                        rid=req.rid,
                        queue_wait_s=time.perf_counter() - t_start), "failed")
                    continue
                outstanding = sum(l.reserve_remaining for l in lanes)
                if pool.capacity - pool.in_use - outstanding < need:
                    break            # wait for retirements to free pages
                req = queue.popleft()
                lane.reserve_remaining = need
                req.out = []
                req.stats = RequestStats(
                    rid=req.rid, queue_wait_s=time.perf_counter() - t_start)
                # unallocated logical pages read the never-written NULL page
                bt_full[s, :] = paged.NULL_PAGE
                lane.req, lane.state = req, _PREFILL
                lane.prefill_pos, lane.n_out = 0, 0

            # -- one batched prefill chunk over all admitting lanes ----------
            prefilling = [s for s, l in enumerate(lanes)
                          if l.state == _PREFILL]
            if prefilling:
                toks = np.zeros((slots, C), np.int32)
                start = np.zeros(slots, np.int32)
                clen = np.zeros(slots, np.int32)
                for s in prefilling:
                    lane = lanes[s]
                    prompt = lane.req.prompt
                    n = min(C, len(prompt) - lane.prefill_pos)
                    ensure_pages(lane, s, lane.prefill_pos,
                                 lane.prefill_pos + n)
                    toks[s, :n] = prompt[lane.prefill_pos:lane.prefill_pos + n]
                    start[s] = lane.prefill_pos
                    clen[s] = n
                chunk = (torch.from_numpy(toks).to(dev),
                         torch.from_numpy(start).to(dev),
                         torch.from_numpy(clen).to(dev))
                bts = tables()
                logits, cache = model.prefill_chunk(
                    params, cache, *chunk, max_len=self.max_len,
                    block_tables=bts, page_size=P, kv_quant=self.kv_quant)
                if shadow is not None:
                    _, shadow = model.prefill_chunk(
                        params, shadow, *chunk, max_len=self.max_len,
                        block_tables=bts, page_size=P)
                stats.prefill_iterations += 1
                first_toks = None
                for s in prefilling:
                    lane = lanes[s]
                    lane.prefill_pos += int(clen[s])
                    if lane.prefill_pos < len(lane.req.prompt):
                        continue     # more chunks to stream
                    if first_toks is None:
                        seeds = [None if greedy or l.state != _PREFILL
                                 else stream_seed(seed, l.req.rid, 0)
                                 for l in lanes]
                        first_toks = sample_per_slot(
                            logits, seeds, self.sampler).cpu().numpy()
                    req = lane.req
                    req.stats.prefill_s = (time.perf_counter() - t_start
                                           - req.stats.queue_wait_s)
                    tok = int(first_toks[s])
                    req.out.append(tok)
                    budget = min(req.max_new, self.max_len - len(req.prompt))
                    if tok == self.eos_id or len(req.out) >= budget:
                        retire(req, req.stats, "ok")
                        release(lane, s)
                        continue
                    lane.state = _LIVE
                    lane.tok, lane.pos, lane.n_out = tok, len(req.prompt), 1

            alloc_decode_pages()
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
            stats.pages_in_use_per_iteration.append(pool.in_use)
            t0 = time.perf_counter()
            horizon = max(l.pos + 1 for l in live)
            active = (_bucket_pages(paged.pages_for(horizon, P), n_full), 0)
            # per-lane page counts: each lane's page loop stops at its OWN
            # live pages (free lanes charge their single page)
            lf = np.array([min(paged.pages_for(l.pos + 1, P), active[0])
                           if l.live else 1 for l in lanes], np.int32)
            stats.decode_kv_bytes += int(lf.sum()) * self._page_bytes
            toks = torch.tensor([l.tok for l in lanes], dtype=torch.int32,
                                device=dev)
            pos = torch.tensor([l.pos if l.live else 0 for l in lanes],
                               dtype=torch.int32, device=dev)
            live_mask = torch.tensor([l.live for l in lanes], device=dev)
            step_kw = dict(page_size=P, max_len=self.max_len, live=live_mask,
                           active_pages=active,
                           lane_pages={"full": torch.from_numpy(lf).to(dev)})
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
            seeds = [stream_seed(seed, l.req.rid, l.n_out)
                     if l.live and not greedy else None for l in lanes]
            # one device-to-host copy per step; it also ends the timing
            host_tok = sample_per_slot(logits, seeds,
                                       self.sampler).cpu().numpy()
            dt = time.perf_counter() - t0
            stats.decode_step_s.append(dt)

            # -- emit + retire ------------------------------------------------
            for s, lane in enumerate(lanes):
                if not lane.live:
                    continue
                req = lane.req
                rst = req.stats
                rst.decode_s += dt
                rst.decode_tokens += 1
                tok = int(host_tok[s])
                req.out.append(tok)
                lane.tok, lane.pos, lane.n_out = tok, lane.pos + 1, \
                    lane.n_out + 1
                budget = min(req.max_new, self.max_len - len(req.prompt))
                if (tok == self.eos_id or lane.n_out >= budget
                        or lane.pos + 1 >= self.max_len):
                    retire(req, rst, "ok")
                    release(lane, s)

        stats.peak_pages = pool.peak_in_use
        stats.pages_leaked = pool.in_use
        if probe_gap is not None:
            stats.quant_logit_gap_per_lane = probe_gap.cpu().tolist()
        stats.wall_s = time.perf_counter() - t_start
        self.last_stats = stats
        return done
