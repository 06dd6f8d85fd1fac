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
unspecified order among duplicates is harmless.  Quantized pools
(``kv_quant="q8_0"``) store int8 values plus one f32 scale per row.
"""

from __future__ import annotations

import torch

from ..kernels.paged_attn import quantize_kv_page_pool

NULL_PAGE = 0
GARBAGE_PAGE = 1
RESERVED_PAGES = 2

KV_QUANTS = ("q8_0",)


def check_kv_quant(kv_quant: str | None) -> str | None:
    """Validate a cache-quantization spec (None = model-dtype pools)."""
    if kv_quant in ("q4_0", "dq"):
        raise NotImplementedError(
            f"kv_quant={kv_quant!r} is not ported yet (ROADMAP D1, kernel B5)")
    if kv_quant and kv_quant not in KV_QUANTS:
        raise ValueError(f"unknown kv_quant {kv_quant!r}; "
                         f"supported: {KV_QUANTS}")
    return kv_quant or None


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


def quantize_rows(val: torch.Tensor, mode: str):
    """Quantize float rows over the trailing axis: ``(qs, d)``."""
    if mode != "q8_0":
        check_kv_quant(mode)
        raise ValueError(f"unknown kv-quant mode {mode!r}")
    return quantize_kv_page_pool(val)


def dequant_rows(qs: torch.Tensor, d: torch.Tensor, mode: str
                 ) -> torch.Tensor:
    """Dequantize stored rows back to the f32 view every reader attends."""
    if mode != "q8_0":
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
