"""Full-horizon GQA attention (with QKV bias) over a paged KV cache.

Decode runs the fused paged kernels (B2 for model-dtype pools, B3 for
q8_0 pools, its q4_0 loader B5 for q4_0 pools).  Chunked prefill over
quantized pools is write-then-attend: the chunk's rows are quantized
once, scattered into their pages, and every chunk query attends the pools
in place (B4, or B5 for q4_0).  Chunked prefill over model-dtype pools
gathers the dense view and runs the online-softmax attention below in
plain PyTorch, as the reference leaves it to XLA.  ``lq`` is one layer's
``paged.LayerQuant`` (None for model-dtype pools); the K/V leaves take its
``kv`` mode.
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
                      lq: paged.LayerQuant | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """One-token decode against a paged cache (the fused kernels).

    Scatters the new K/V/pos row into its page (in place; rows with
    ``live == False`` go to GARBAGE), then attends the pages in place
    through the block table.  ``active_pages`` bounds the page loop to the
    batch's live horizon, ``lane_pages`` (B,) each lane to its own.
    """
    mode = lq.kv if lq else None
    b = x.shape[0]
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
                       max_len: int, block_table: torch.Tensor,
                       lq: paged.LayerQuant | None = None,
                       active_pages: int | None = None
                       ) -> tuple[torch.Tensor, dict]:
    """One prefill chunk against the paged cache.

    x: (B, C, D) right-padded per row; positions: (B, C) absolute; start:
    (B,) first position of the chunk; chunk_len: (B,) valid tokens (0 = an
    inactive row: no writes, output ignored).
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

    if mode:
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

    # attend over [old cache view | chunk] so in-chunk writes can never
    # evict entries an earlier in-chunk query still needs
    ck = paged.gather_pages(cache["k"], block_table, length)
    cv = paged.gather_pages(cache["v"], block_table, length)
    cpos = paged.gather_pages(cache["pos"], block_table, length)
    key_pos = chunk_key_positions(cpos, positions, valid_tok)
    kk = torch.cat([ck, k.to(ck.dtype)], dim=1)
    vv = torch.cat([cv, v.to(cv.dtype)], dim=1)
    mask_fn = chunk_mask_fn(key_pos, length, positions, start, 0)
    o = _chunk_attn(q.to(ck.dtype), kk, vv, mask_fn, cfg.attn_softcap)
    o = o.reshape(b, c, cfg.n_heads * cfg.head_dim).to(x.dtype)
    out = linear(p["o_proj"], o)
    paged.scatter_chunk(cache["k"], block_table, idx, k, ok)
    paged.scatter_chunk(cache["v"], block_table, idx, v, ok)
    paged.scatter_chunk(cache["pos"], block_table, idx, wpos, ok)
    return out, cache
