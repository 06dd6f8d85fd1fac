"""Full-horizon GQA attention (with QKV bias): the full-sequence forward,
a dense per-slot cache, and a paged KV cache.

The full-sequence forward (train, loss, one-shot prefill) and chunked
prefill over a dense cache or over model-dtype pools run the
online-softmax attention below in plain PyTorch, as the reference leaves
them to XLA; so does decode over a dense cache (:func:`attn_decode`) and
over the dense view of a paged one (``kernel="gather"``, the reference
path: :func:`_attend_cache`).  Decode over pages with ``kernel="fused"``
runs the fused paged kernels (B2 for model-dtype pools, B3 for q8_0
pools, its q4_0 loader B5 for q4_0 pools).  Chunked prefill over
quantized pools with ``kernel="fused"`` is write-then-attend: the chunk's
rows are quantized once, scattered into their pages, and every chunk
query attends the pools in place (B4, or B5 for q4_0); ``kernel="gather"``
attends their dequantized dense view instead.  ``lq`` is one layer's
``paged.LayerQuant`` (None for model-dtype pools); the K/V leaves take its
``kv`` mode.  Every cache is updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import paged_attn
from . import paged
from .common import apply_rope, linear, rms_norm

NEG_INF = -2.0e38


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def _chunk_attn(q, k, v, mask_fn, attn_cap: float, chunk: int = 1024):
    """Online-softmax attention over key chunks.

    q: (B, Tq, H, D); k/v: (B, Tk, Hkv, D); ``mask_fn(qi, ki)`` returns a
    (Tq, kc) or per-row (B, Tq, kc) validity mask for absolute query/key
    index arrays.  Returns (B, Tq, H, Dv) f32.
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hkv
    scale = d ** -0.5
    chunk = max(16, min(chunk, tk))
    nk = -(-tk // chunk)
    pad_k = nk * chunk - tk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    dev = q.device
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tq, dv), dtype=torch.float32, device=dev)
    qf = q.to(torch.float32)
    qi = torch.arange(tq, device=dev)
    for ki in range(nk):
        kq = torch.repeat_interleave(k[:, ki * chunk:(ki + 1) * chunk], rep,
                                     dim=2)
        vq = torch.repeat_interleave(v[:, ki * chunk:(ki + 1) * chunk], rep,
                                     dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kq.to(torch.float32)) * scale
        s = _softcap(s, attn_cap)
        kidx = ki * chunk + torch.arange(chunk, device=dev)
        valid = mask_fn(qi[:, None], kidx[None, :]) & (kidx < tk)[None, :]
        valid = valid[:, None] if valid.ndim == 3 else valid[None, None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vq.dtype).to(torch.float32),
            vq.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def chunk_key_positions(old_pos: torch.Tensor, positions: torch.Tensor,
                        valid_tok: torch.Tensor) -> torch.Tensor:
    """Key positions over [old cache view | chunk]."""
    chunk_pos = torch.where(valid_tok, positions,
                            torch.full_like(positions, -1))
    return torch.cat([old_pos, chunk_pos.to(torch.int32)], dim=1)


def chunk_mask_fn(key_pos: torch.Tensor, n_old: int, positions: torch.Tensor,
                  start: torch.Tensor, window: int):
    """Per-row validity for chunked prefill over [old cache | chunk] keys:
    written, causal, inside the window, and for cache-side entries below
    this request's write frontier (``pos < start``)."""
    total = key_pos.shape[1]
    from_old = torch.arange(total, device=key_pos.device) < n_old

    def mask_fn(qi, ki):
        kj = torch.clamp(ki[0], 0, total - 1)                      # (kc,)
        kp = key_pos[:, kj][:, None, :]                            # (B, 1, kc)
        qp = positions[:, :, None]                                 # (B, C, 1)
        ok = (kp >= 0) & (kp <= qp)
        ok &= torch.where(from_old[kj][None, None, :],
                          kp < start[:, None, None],
                          torch.ones_like(ok))
        if window:
            ok &= kp > qp - window
        return ok

    return mask_fn


def _qkv(p, cfg: ModelConfig, x, positions):
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["q_proj"], x, p.get("q_bias")).reshape(b, t, nh, hd)
    k = linear(p["k_proj"], x, p.get("k_bias")).reshape(b, t, nkv, hd)
    v = linear(p["v_proj"], x, p.get("v_bias")).reshape(b, t, nkv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def causal_mask(qi, ki):
    """The full-sequence mask: each query attends its own and earlier
    positions."""
    return ki <= qi


def _forward_kv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """Full-sequence causal attention: (output, rotated K, V)."""
    b, t, _ = x.shape
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    o = _chunk_attn(q, k, v, causal_mask, cfg.attn_softcap)
    o = o.reshape(b, t, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return linear(p["o_proj"], o), k, v


def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence causal attention (train / loss).  x: (B, T, D)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _forward_kv(p, cfg, x, positions)[0]


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    """Dense per-slot K/V/pos leaves ``(batch, max_len, ...)``; ``pos`` -1
    marks an entry never written."""
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=device)
    return {
        "k": torch.zeros((batch, max_len, nkv, hd), dtype=dtype, **kw),
        "v": torch.zeros((batch, max_len, nkv, hd), dtype=dtype, **kw),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, **kw),
    }


def attn_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, max_len: int
                 ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the dense decode cache over
    positions [0, T) (the last ``max_len`` of them when T is longer, each
    at ``pos % max_len``)."""
    b, t, _ = x.shape
    keep = torch.arange(t, device=x.device)
    out, k, v = _forward_kv(p, cfg, x, keep[None, :])
    cache = init_attn_cache(cfg, b, max_len, dtype=k.dtype, device=x.device)
    keep = keep[max(0, t - max_len):]
    slots = keep % max_len
    cache["k"][:, slots] = k[:, keep]
    cache["v"][:, slots] = v[:, keep]
    cache["pos"][:, slots] = keep.to(torch.int32)
    return out, cache


def _attend_cache(cfg: ModelConfig, q: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, cpos: torch.Tensor, pos: torch.Tensor
                  ) -> torch.Tensor:
    """One rotated query row against a dense cache view: the masked
    softmax read of :func:`attn_decode` and of the gather reference.  q:
    (B, 1, H, D); ck/cv: (B, L, Hkv, D); cpos: (B, L); returns (B, 1, H*D)
    in f32 (pre-``o_proj``)."""
    b = q.shape[0]
    rep = cfg.n_heads // cfg.n_kv_heads
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    kk = torch.repeat_interleave(ck.to(torch.float32), rep, dim=2)
    vv = torch.repeat_interleave(cv.to(torch.float32), rep, dim=2)
    s = torch.einsum("bhd,blhd->bhl",
                     q[:, 0].to(torch.float32) * cfg.head_dim ** -0.5, kk)
    s = _softcap(s, cfg.attn_softcap)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bhl,blhd->bhd", torch.softmax(s, dim=-1), vv)
    return o.reshape(b, 1, cfg.n_heads * cfg.head_dim)


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                pos: torch.Tensor, live: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode against a dense cache.  x: (B, 1, D); pos: (B,).
    Writes the new K/V/pos row at ``pos % L`` in place, except in rows
    with ``live == False``, then attends the cache."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, pos[:, None])
    slot = (pos % cache["k"].shape[1])[:, None]
    ok = None if live is None else live[:, None]
    paged.write_dense(cache["k"], slot, k, ok)
    paged.write_dense(cache["v"], slot, v, ok)
    paged.write_dense(cache["pos"], slot, pos[:, None].to(torch.int32), ok)
    o = _attend_cache(cfg, q, cache["k"], cache["v"], cache["pos"], pos)
    return linear(p["o_proj"], o.to(x.dtype)), cache


def init_paged_attn_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16,
                          lq: paged.LayerQuant | None = None,
                          device=None) -> dict:
    """Paged K/V/pos pools shared by every slot: model-dtype leaves, or int8
    values (q8_0, or q4_0 nibble-packed to ``head_dim / 2`` bytes a row)
    plus per-(token, head) f32 scales."""
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=device)
    pos = torch.full((num_pages, page_size), -1, dtype=torch.int32, **kw)
    mode = lq.kv if lq else None
    if mode:
        hd_s = paged.q4_packed_dim(hd, "head") if mode == "q4_0" else hd
        return {
            "k_qs": torch.zeros((num_pages, page_size, nkv, hd_s),
                                dtype=torch.int8, **kw),
            "k_d": torch.zeros((num_pages, page_size, nkv),
                               dtype=torch.float32, **kw),
            "v_qs": torch.zeros((num_pages, page_size, nkv, hd_s),
                                dtype=torch.int8, **kw),
            "v_d": torch.zeros((num_pages, page_size, nkv),
                               dtype=torch.float32, **kw),
            "pos": pos,
        }
    return {
        "k": torch.zeros((num_pages, page_size, nkv, hd), dtype=dtype, **kw),
        "v": torch.zeros((num_pages, page_size, nkv, hd), dtype=dtype, **kw),
        "pos": pos,
    }


def attn_decode_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict, pos: torch.Tensor,
                      block_table: torch.Tensor, *, max_len: int,
                      live: torch.Tensor | None = None,
                      active_pages: int | None = None,
                      lane_pages: torch.Tensor | None = None,
                      lq: paged.LayerQuant | None = None,
                      kernel: str = "fused"
                      ) -> tuple[torch.Tensor, dict]:
    """One-token decode against a paged cache.

    ``kernel="fused"``: scatter the new K/V/pos row into its page (in
    place; rows with ``live == False`` go to GARBAGE), then attend the
    pages in place through the block table.  ``active_pages`` bounds the
    page loop to the batch's live horizon, ``lane_pages`` (B,) each lane to
    its own.  ``kernel="gather"``, the reference path, ignores both: it
    runs :func:`attn_decode` on the gathered dense view of the whole table
    and scatters the new row back (model-dtype pools), or attends the
    dequantized dense view of the updated pools (quantized pools).
    """
    mode = lq.kv if lq else None
    b = x.shape[0]
    if kernel == "gather" and not mode:
        dense = {k: paged.gather_pages(cache[k], block_table, max_len)
                 for k in ("k", "v", "pos")}
        delta, dense = attn_decode(p, cfg, x, dense, pos, live=live)
        slot = (pos % max_len).long()
        rows = torch.arange(b, device=x.device)
        for key in ("k", "v", "pos"):
            paged.scatter_token(cache[key], block_table, slot.to(torch.int32),
                                dense[key][rows, slot], ok=live)
        return delta, cache
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, pos[:, None])
    slot = (pos % max_len).to(torch.int32)
    paged.scatter_token(cache["pos"], block_table, slot,
                        pos.to(torch.int32), ok=live)
    kw = dict(softcap=cfg.attn_softcap, scale=cfg.head_dim ** -0.5,
              active_pages=active_pages, lane_pages=lane_pages)
    if mode:
        paged.scatter_token_quant(cache["k_qs"], cache["k_d"], block_table,
                                  slot, k[:, 0], ok=live, mode=mode)
        paged.scatter_token_quant(cache["v_qs"], cache["v_d"], block_table,
                                  slot, v[:, 0], ok=live, mode=mode)
        if kernel == "gather":
            ck = paged.gather_pages_quant(cache["k_qs"], cache["k_d"],
                                          block_table, max_len, mode)
            cv = paged.gather_pages_quant(cache["v_qs"], cache["v_d"],
                                          block_table, max_len, mode)
            cpos = paged.gather_pages(cache["pos"], block_table, max_len)
            o = _attend_cache(cfg, q, ck, cv, cpos, pos).to(x.dtype)
            return linear(p["o_proj"], o), cache
        o = paged_attn.paged_attn_decode_quant(
            q[:, 0], cache["k_qs"], cache["k_d"], cache["v_qs"],
            cache["v_d"], cache["pos"], block_table, pos, mode=mode, **kw)
    else:
        paged.scatter_token(cache["k"], block_table, slot, k[:, 0], ok=live)
        paged.scatter_token(cache["v"], block_table, slot, v[:, 0], ok=live)
        o = paged_attn.paged_attn_decode(
            q[:, 0], cache["k"], cache["v"], cache["pos"], block_table, pos,
            **kw)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return linear(p["o_proj"], o), cache


def attn_prefill_chunk(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict, positions: torch.Tensor,
                       start: torch.Tensor, chunk_len: torch.Tensor, *,
                       max_len: int, block_table: torch.Tensor | None = None,
                       lq: paged.LayerQuant | None = None,
                       active_pages: int | None = None,
                       kernel: str = "fused") -> tuple[torch.Tensor, dict]:
    """One prefill chunk against the paged cache, or against the dense one
    when ``block_table`` is None.

    x: (B, C, D) right-padded per row; positions: (B, C) absolute; start:
    (B,) first position of the chunk; chunk_len: (B,) valid tokens (0 = an
    inactive row: no writes, output ignored).  Every path but the fused
    write-then-attend one attends [old cache view | chunk] and writes the
    chunk after.
    """
    mode = lq.kv if lq else None
    b, c, _ = x.shape
    length = max_len
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    valid_tok = (torch.arange(c, device=x.device)[None, :]
                 < chunk_len[:, None])                               # (B, C)
    idx = (positions % length).to(torch.int32)
    ok = paged.chunk_write_plan(idx, valid_tok, length)
    wpos = positions.to(torch.int32)

    if mode and kernel == "fused":
        # write-then-attend: quantize once, scatter, attend the pages in
        # place (stored pos == logical index lets the kernel mask stale
        # rows beyond the frontier)
        for leaf, val in (("k", k), ("v", v)):
            qs, d = paged.quantize_rows(val, mode)
            paged.scatter_chunk(cache[f"{leaf}_qs"], block_table, idx, qs, ok)
            paged.scatter_chunk(cache[f"{leaf}_d"], block_table, idx, d, ok)
        paged.scatter_chunk(cache["pos"], block_table, idx, wpos, ok)
        qpos = torch.where(valid_tok, positions,
                           torch.full_like(positions, -1)).to(torch.int32)
        o = paged_attn.paged_attn_prefill_quant(
            q, cache["k_qs"], cache["k_d"], cache["v_qs"], cache["v_d"],
            cache["pos"], block_table, qpos, mode=mode, window=0,
            softcap=cfg.attn_softcap, scale=cfg.head_dim ** -0.5,
            active_pages=active_pages)
        o = o.reshape(b, c, cfg.n_heads * cfg.head_dim).to(x.dtype)
        return linear(p["o_proj"], o), cache

    if mode:
        # the dequantizing gather reference: the chunk's rows quantized
        # once, attended through the same round trip they are stored with
        ck = paged.gather_pages_quant(cache["k_qs"], cache["k_d"],
                                      block_table, length, mode)
        cv = paged.gather_pages_quant(cache["v_qs"], cache["v_d"],
                                      block_table, length, mode)
        cpos = paged.gather_pages(cache["pos"], block_table, length)
        k_qs, k_d, k_att = paged.roundtrip_quant(k, mode)
        v_qs, v_d, v_att = paged.roundtrip_quant(v, mode)
    elif block_table is not None:
        ck = paged.gather_pages(cache["k"], block_table, length)
        cv = paged.gather_pages(cache["v"], block_table, length)
        cpos = paged.gather_pages(cache["pos"], block_table, length)
        k_att, v_att = k, v
    else:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        k_att, v_att = k, v
    # attend over [old cache view | chunk] so in-chunk writes can never
    # evict entries an earlier in-chunk query still needs
    key_pos = chunk_key_positions(cpos, positions, valid_tok)
    kk = torch.cat([ck, k_att.to(ck.dtype)], dim=1)
    vv = torch.cat([cv, v_att.to(cv.dtype)], dim=1)
    mask_fn = chunk_mask_fn(key_pos, length, positions, start, 0)
    o = _chunk_attn(q.to(ck.dtype), kk, vv, mask_fn, cfg.attn_softcap)
    o = o.reshape(b, c, cfg.n_heads * cfg.head_dim).to(x.dtype)
    out = linear(p["o_proj"], o)
    if mode:
        for leaf, qs, d in (("k", k_qs, k_d), ("v", v_qs, v_d)):
            paged.scatter_chunk(cache[f"{leaf}_qs"], block_table, idx, qs, ok)
            paged.scatter_chunk(cache[f"{leaf}_d"], block_table, idx, d, ok)
        paged.scatter_chunk(cache["pos"], block_table, idx, wpos, ok)
    elif block_table is not None:
        paged.scatter_chunk(cache["k"], block_table, idx, k, ok)
        paged.scatter_chunk(cache["v"], block_table, idx, v, ok)
        paged.scatter_chunk(cache["pos"], block_table, idx, wpos, ok)
    else:
        paged.write_dense(cache["k"], idx, k, ok)
        paged.write_dense(cache["v"], idx, v, ok)
        paged.write_dense(cache["pos"], idx, wpos, ok)
    return out, cache
