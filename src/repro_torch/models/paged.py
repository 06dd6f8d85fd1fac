"""Paged KV-cache primitives: page pools, gathers and scatters.

Each positional cache leaf is a shared pool ``(num_pages, page_size,
*entry)``; a per-slot block table ``(batch, n_logical_pages)`` int32 maps
logical pages to physical ones.  Two physical pages are reserved:
``NULL_PAGE`` (0, read-only; its ``pos`` entries stay -1 so it reads as
unwritten) and ``GARBAGE_PAGE`` (1, the write sink for free lanes and
padded chunk tokens; never mapped into a live table, so never read).

Scatters write in place (``index_put_`` without ``accumulate``): a pool
is updated where it lies instead of being copied per step, which is what
keeps a full-width pool's memory flat.  Duplicate targets only ever hit
GARBAGE (last-writer-wins plans route superseded writes there), so the
unspecified order among duplicates is harmless.

Quantized pools store int8 values plus one f32 scale per row:
``kv_quant="q8_0"``, ``"q4_0"`` (two signed nibbles a byte along the row,
so the stored trailing dim is half the row width, :func:`q4_packed_dim`)
or ``"dq"``, the per-layer policy of :func:`resolve_layer_quant`: the
first and last ``max(1, n_layers // 8)`` layers, and every MLA latent,
stay q8_0 while the rest drop to q4_0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels.paged_attn import (KV_MODES, quantize_kv_page_pool,
                                  quantize_kv_page_pool_q4, unpack_q4_rows)

NULL_PAGE = 0
GARBAGE_PAGE = 1
RESERVED_PAGES = 2

# engine-level cache-quantization specs; "dq" resolves per layer to the
# concrete per-leaf storage modes
KV_QUANTS = ("q8_0", "q4_0", "dq")
KV_QUANT_MODES = KV_MODES


def check_kv_quant(kv_quant: str | None) -> str | None:
    """Validate a cache-quantization spec (None = model-dtype pools)."""
    if kv_quant and kv_quant not in KV_QUANTS:
        raise ValueError(f"unknown kv_quant {kv_quant!r}; "
                         f"supported: {KV_QUANTS}")
    return kv_quant or None


def q4_packed_dim(width: int, what: str = "row") -> int:
    """Stored (bytes) trailing dim of one q4_0 row of ``width`` values:
    two nibbles share a byte, so the width must be even."""
    if width % 2:
        raise ValueError(
            f"q4_0 requires an even {what} width (two nibbles per byte); "
            f"got {width}")
    return width // 2


class LayerQuant(NamedTuple):
    """One layer's cache-quantization modes: ``kv`` for the GQA K/V pools
    (on MLA layers, the rope-key pool) and ``latent`` for the MLA ``c_kv``
    pool (equal to ``kv`` on GQA layers, where it is unused)."""
    kv: str
    latent: str


def dq_sensitive_layers(n_layers: int) -> frozenset:
    """Layers "dq" keeps at q8_0: the first and last ``max(1, n_layers //
    8)``, so stacks of two layers or fewer are uniform q8_0."""
    n = max(1, n_layers // 8)
    return frozenset(range(n)) | frozenset(range(max(0, n_layers - n),
                                                 n_layers))


def resolve_layer_quant(kv_quant: str | None, cfg,
                        layer: int) -> LayerQuant | None:
    """The engine-level ``kv_quant`` spec for one layer: a uniform mode
    applies to every leaf; "dq" keeps the sensitive layers at q8_0, drops
    the rest to q4_0, and keeps MLA ``c_kv`` latents at q8_0 on every
    layer.  None for model-dtype pools."""
    kv_quant = check_kv_quant(kv_quant)
    if kv_quant is None:
        return None
    if kv_quant != "dq":
        return LayerQuant(kv_quant, kv_quant)
    kv = "q8_0" if layer in dq_sensitive_layers(cfg.n_layers) else "q4_0"
    return LayerQuant(kv, "q8_0" if cfg.mla else kv)


@functools.lru_cache(maxsize=None)
def layer_quants(kv_quant: str | None, cfg) -> tuple:
    """:func:`resolve_layer_quant` for every layer of ``cfg``, resolved
    once per (spec, config) rather than on every step."""
    return tuple(resolve_layer_quant(kv_quant, cfg, layer)
                 for layer in range(cfg.n_layers))


def codes_apart(cfg, kv_quant: str, ca: dict, cb: dict) -> dict:
    """The stored codes of two caches of one model compared layer by layer
    (q4_0 leaves unpacked, ``GARBAGE_PAGE``, the sink of padded writes,
    skipped).  ``ca``/``cb``: CPU tensors keyed as
    ``Model.init_paged_cache`` makes them.  Returns ``first_layer`` (the
    first layer whose codes differ, or None), ``first_modes`` (the modes
    of its leaves whose codes differ), ``max_step_first`` (its largest
    step apart), and over all layers ``apart`` (codes apart) and
    ``max_step_all``."""
    out = {"first_layer": None, "first_modes": [], "max_step_first": 0,
           "apart": 0, "max_step_all": 0}
    for layer, lq in enumerate(layer_quants(kv_quant, cfg)):
        steps = []
        for key in sorted(k for k in ca if k.endswith("_qs")
                          and k.startswith(f"dec/L{layer:03d}/")):
            mode = lq.latent if key.endswith("c_kv_qs") else lq.kv
            qa, qb = ca[key], cb[key]
            if mode == "q4_0":
                qa, qb = unpack_q4_rows(qa), unpack_q4_rows(qb)
            step = (qa.int() - qb.int()).abs()
            step[GARBAGE_PAGE] = 0
            steps.append((mode, step))
        n = sum(int((st > 0).sum()) for _, st in steps)
        out["apart"] += n
        top = max(int(st.max()) for _, st in steps)
        out["max_step_all"] = max(out["max_step_all"], top)
        if n and out["first_layer"] is None:
            out.update(first_layer=layer, max_step_first=top,
                       first_modes=sorted({m for m, st in steps
                                           if bool((st > 0).any())}))
    return out


def parity_limit(cfg, kv_quant: str | None, ca: dict, cb: dict, *,
                 exact: float, stepped: float) -> tuple[float, dict]:
    """The limit on ``max|d logits| / max|logit|`` between two f32 runs of
    one model over ``kv_quant`` pools that ended in caches ``ca`` and
    ``cb``, and the :func:`codes_apart` counts behind it.

    The runs differ in summation order.  Where that order moves a value
    across a rounding boundary, the two store codes one step apart; later
    layers take the inputs that step moved, so there codes may differ by
    more.  With no code apart the limit is ``exact``.  Otherwise the
    first layer whose codes differ may hold q8_0 codes one step apart (a
    step is 1/127 of the row's max|x|) and the limit is ``stepped``, a
    fixed q8_0-sized limit.  A q4_0 code apart there (a step of 1/7) is
    refused, not allowed for: its effect on the logits has no bound that
    would not pass anything, so it raises ``ValueError``, as does any
    code of that layer two or more steps apart."""
    if kv_quant is None:
        return exact, {}
    stats = codes_apart(cfg, kv_quant, ca, cb)
    if stats["first_layer"] is None:
        return exact, stats
    where = f"layer {stats['first_layer']}, the first whose codes differ"
    if stats["max_step_first"] > 1:
        raise ValueError(f"codes of {where}, more than one step apart")
    if "q4_0" in stats["first_modes"]:
        raise ValueError(f"q4_0 codes of {where}, one step apart")
    return stepped, stats


def pages_for(length: int, page_size: int) -> int:
    """Logical pages needed to cover ``length`` positions."""
    return -(-length // page_size)


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor,
                 length: int) -> torch.Tensor:
    """Dense ``(B, length, ...)`` view of a paged leaf."""
    b, n_pages = block_table.shape
    g = pool[block_table.long()]                   # (B, n_pages, P, ...)
    g = g.reshape(b, n_pages * pool.shape[1], *pool.shape[2:])
    return g[:, :length]


def _route(block_table, idx, ok, p):
    page = idx // p
    off = idx % p
    phys = torch.gather(block_table, 1, page.long())
    if ok is not None:
        phys = torch.where(ok, phys, torch.full_like(phys, GARBAGE_PAGE))
        off = torch.where(ok, off, torch.zeros_like(off))
    return phys.long(), off.long()


def scatter_token(pool: torch.Tensor, block_table: torch.Tensor,
                  idx: torch.Tensor, val: torch.Tensor,
                  ok: torch.Tensor | None = None) -> torch.Tensor:
    """Write one entry per batch row at logical index ``idx`` (B,), in
    place; rows with ``ok == False`` go to ``GARBAGE_PAGE``."""
    phys, off = _route(block_table, idx[:, None], None if ok is None
                       else ok[:, None], pool.shape[1])
    pool.index_put_((phys[:, 0], off[:, 0]), val.to(pool.dtype))
    return pool


def scatter_chunk(pool: torch.Tensor, block_table: torch.Tensor,
                  idx: torch.Tensor, val: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """Write a chunk of entries in place.  idx/ok: (B, C); val: (B, C, ...);
    entries with ``ok == False`` go to ``GARBAGE_PAGE``."""
    b, c = idx.shape
    phys, off = _route(block_table, idx, ok, pool.shape[1])
    flat = val.reshape(b * c, *val.shape[2:]).to(pool.dtype)
    pool.index_put_((phys.reshape(-1), off.reshape(-1)), flat)
    return pool


def write_dense(leaf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                ok: torch.Tensor | None = None) -> torch.Tensor:
    """The dense layout's :func:`scatter_chunk`: write ``val`` (B, C, ...)
    into a per-slot leaf (B, L, ...) at indices ``idx`` (B, C), in place.
    Entries with ``ok == False`` drop their writes (the reference's
    ``mode="drop"``) with no host sync to pick the writes out: such an
    entry writes what its index holds after the call, the value of the
    last entry with ``ok`` at that index in its row, else the leaf's own.
    So every entry at one index writes one value, and the order in which
    the card applies them does not matter.  Callers keep ``idx`` in
    range."""
    rows = torch.arange(leaf.shape[0], device=leaf.device)[:, None]
    rows, at = rows.expand_as(idx), idx.long()
    val = val.to(leaf.dtype)
    if ok is not None:
        if at.shape[1] > 1:
            # each entry takes the value of its index's last writer
            j = torch.arange(at.shape[1], device=at.device).expand_as(at)
            last = torch.full(leaf.shape[:2], -1, dtype=torch.long,
                              device=leaf.device)
            last.scatter_reduce_(1, at, torch.where(ok, j, -1),
                                 reduce="amax")
            src = torch.gather(last, 1, at)
            ok = src >= 0
            src = src.clamp(min=0).reshape(
                *src.shape, *([1] * (val.ndim - 2))).expand_as(val)
            val = torch.gather(val, 1, src)
        keep = ok.reshape(*ok.shape, *([1] * (val.ndim - ok.ndim)))
        val = torch.where(keep, val, leaf[rows, at])
    leaf.index_put_((rows, at), val)
    return leaf


def quantize_rows(val: torch.Tensor, mode: str):
    """Quantize float rows over the trailing axis in storage ``mode``:
    ``(qs, d)``, int8 values (nibble-packed for q4_0, trailing dim halved)
    and per-row f32 scales."""
    if mode == "q8_0":
        return quantize_kv_page_pool(val)
    if mode == "q4_0":
        return quantize_kv_page_pool_q4(val)
    raise ValueError(f"unknown kv-quant mode {mode!r}")


def dequant_rows(qs: torch.Tensor, d: torch.Tensor, mode: str
                 ) -> torch.Tensor:
    """Dequantize stored rows back to the f32 view every reader attends."""
    if mode == "q4_0":
        qs = unpack_q4_rows(qs)
    elif mode != "q8_0":
        raise ValueError(f"unknown kv-quant mode {mode!r}")
    return qs.to(torch.float32) * d.to(torch.float32)[..., None]


def roundtrip_quant(val: torch.Tensor, mode: str = "q8_0"):
    """Quantize rows once: ``(qs, d, dequantized)``."""
    qs, d = quantize_rows(val, mode)
    return qs, d, dequant_rows(qs, d, mode)


def gather_pages_quant(qs_pool, d_pool, block_table, length,
                       mode: str = "q8_0") -> torch.Tensor:
    """Dequantizing :func:`gather_pages` over a quantized leaf pair."""
    return dequant_rows(gather_pages(qs_pool, block_table, length),
                        gather_pages(d_pool, block_table, length), mode)


def scatter_token_quant(qs_pool, d_pool, block_table, idx, val, ok=None,
                        mode: str = "q8_0"):
    """Quantize-on-write :func:`scatter_token` for a quantized leaf pair."""
    qs, d = quantize_rows(val, mode)
    return (scatter_token(qs_pool, block_table, idx, qs, ok=ok),
            scatter_token(d_pool, block_table, idx, d, ok=ok))


def extract_pages(pool: torch.Tensor, page_ids) -> torch.Tensor:
    """Whole physical pages ``(n, P, ...)`` of one pool leaf, for swap-out.

    ``page_ids``: a host list of physical page ids.  Any leaf kind copies
    verbatim (model-dtype payloads, q8_0/q4_0 int8 codes and f32 scales,
    ``pos`` rows, MLA latent and rope leaves), so a swapped lane never
    re-quantizes.  The result stays on ``pool``'s device; the caller moves
    it to the host.  The page axis is 0 (the port has no stacked pools).
    """
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=pool.device)
    return pool.index_select(0, ids)


def inject_pages(pool: torch.Tensor, page_ids, rows: torch.Tensor
                 ) -> torch.Tensor:
    """Write saved page rows back at (possibly other) physical ids, in
    place: the inverse of :func:`extract_pages`.  ``page_ids`` must be
    freshly allocated pages (never NULL/GARBAGE, the caller's invariant).
    """
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=pool.device)
    pool.index_copy_(0, ids, rows.to(device=pool.device, dtype=pool.dtype))
    return pool


def chunk_write_plan(idx: torch.Tensor, valid: torch.Tensor, length: int):
    """Last-writer-wins resolution of in-chunk writes to one logical index.

    idx/valid: (B, C).  Returns ``ok`` (B, C): valid tokens that are the
    last writer of their logical index.
    """
    b, c = idx.shape
    j = torch.arange(c, dtype=torch.int32, device=idx.device)[None, :]
    marker = torch.where(valid, j, torch.full_like(j, -1)).expand(b, c)
    safe_idx = torch.where(valid, idx, torch.zeros_like(idx)).long()
    last = torch.full((b, length), -1, dtype=torch.int32, device=idx.device)
    last.scatter_reduce_(1, safe_idx, marker.to(torch.int32), reduce="amax")
    return valid & (torch.gather(last, 1, safe_idx) == j)
