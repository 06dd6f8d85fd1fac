"""Multi-head Latent Attention (DeepSeek V2/V3): the full-sequence forward,
and decode and chunked prefill over a dense or paged latent cache.

The cache stores only the compressed latent ``c_kv`` (``kv_lora_rank``
wide) and the decoupled RoPE key (``qk_rope_head_dim`` wide) per token,
with no positions: a token is valid iff its logical index is ``<= pos``.
The dense layout holds ``(batch, max_len, ...)`` leaves, the paged one
page pools.  The full-sequence forward (train, loss, one-shot prefill)
materialises per-head K/V from the latents (``kv_b`` expanded) and runs
the online-softmax attention in plain PyTorch, as the reference leaves it
to XLA.  Decode runs the **absorbed** form: ``kv_b``'s key half is folded
into the query (``q_eff``), the latents are attended, and ``kv_b``'s value
half projects the attended latents out; over pages with
``kernel="fused"`` kernel B6 attends them in place, over a dense cache or
the dense view of a paged one (``kernel="gather"``, the reference path)
plain PyTorch does (:func:`_absorbed_attend`).  Chunked prefill over
quantized pools with ``kernel="fused"`` is write-then-attend in the same
absorbed form (kernel B7).  Quantized pools take one mode per leaf
(``paged.LayerQuant``: ``latent`` for ``c_kv``, ``kv`` for the rope key),
q8_0 or nibble-packed q4_0 (B6/B7's q4_0 loaders, B5); under "dq" the
latent stays q8_0 while the rope key of a non-sensitive layer is q4_0.
Every other prefill materialises per-head K/V from [cached latents |
chunk latents] and runs the online-softmax attention in plain PyTorch.
The ``kv_b`` absorption einsums and ``o_proj`` stay plain PyTorch / B1 as
well.  Every cache is updated in place.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.qtensor import QTensor
from ..kernels import paged_attn
from . import paged
from .attention import (NEG_INF, _chunk_attn, causal_mask,
                        chunk_key_positions, chunk_mask_fn)
from .common import apply_rope, linear, rms_norm


def _maybe_dequant(w, dtype):
    if isinstance(w, QTensor):
        return w.dequantize(dtype)
    return w.to(dtype)


def _project_q(p, cfg: ModelConfig, h, positions):
    b, t, _ = h.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rms_norm(linear(p["q_a"], h), p["q_a_norm"], cfg.norm_eps)
    q = linear(p["q_b"], cq).reshape(b, t, cfg.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p, cfg: ModelConfig, h, positions):
    kv = linear(p["kv_a"], h)                                 # (B,T,rank+dr)
    c_kv = rms_norm(kv[..., : cfg.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:]                       # (B,T,dr)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _forward_latents(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor):
    """Full-sequence causal MLA: (output, c_kv, k_rope)."""
    b, t, _ = x.shape
    nh = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q_nope, q_rope = _project_q(p, cfg, h, positions)
    c_kv, k_rope = _latents(p, cfg, h, positions)
    kvb = linear(p["kv_b"], c_kv).reshape(b, t, nh, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    # the decoupled rope key is shared by every head (MQA-style)
    q = torch.cat([q_nope, q_rope], dim=-1)                   # (B,T,H,dn+dr)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, nh, dr)],
                  dim=-1)
    o = _chunk_attn(q, k, v, causal_mask, 0.0)
    o = o.reshape(b, t, nh * dv).to(x.dtype)
    return linear(p["o_proj"], o), c_kv, k_rope


def mla_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence MLA (train / loss).  x: (B, T, D)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _forward_latents(p, cfg, x, positions)[0]


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    """Dense per-slot latent leaves ``(batch, max_len, ...)``."""
    kw = dict(dtype=dtype, device=device)
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), **kw),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), **kw),
    }


def mla_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, max_len: int
                ) -> tuple[torch.Tensor, dict]:
    """Full-sequence MLA forward that also fills the dense latent cache
    over positions [0, T), T <= max_len."""
    b, t, _ = x.shape
    out, c_kv, k_rope = _forward_latents(
        p, cfg, x, torch.arange(t, device=x.device)[None, :])
    cache = init_mla_cache(cfg, b, max_len, dtype=c_kv.dtype, device=x.device)
    cache["c_kv"][:, :t] = c_kv
    cache["k_rope"][:, :t] = k_rope
    return out, cache


def _latent_widths(cfg: ModelConfig, lq: paged.LayerQuant):
    """Stored trailing dims of the quantized ``c_kv`` / ``k_rope`` leaves
    (halved for a q4_0 leaf)."""
    rank_s = (paged.q4_packed_dim(cfg.kv_lora_rank, "latent rank")
              if lq.latent == "q4_0" else cfg.kv_lora_rank)
    dr_s = (paged.q4_packed_dim(cfg.qk_rope_head_dim, "rope dim")
            if lq.kv == "q4_0" else cfg.qk_rope_head_dim)
    return rank_s, dr_s


def init_paged_mla_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                         dtype=torch.bfloat16,
                         lq: paged.LayerQuant | None = None,
                         device=None) -> dict:
    """Paged latent pools shared by every slot: model-dtype leaves, or int8
    values (per leaf q8_0, or q4_0 nibble-packed to half the width) plus
    one f32 scale per (page, token) row (block = the latent / rope
    width).  NULL-page zeros are never attended: validity is
    positional."""
    rank, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kw = dict(device=device)
    if lq:
        rank_s, dr_s = _latent_widths(cfg, lq)
        return {
            "c_kv_qs": torch.zeros((num_pages, page_size, rank_s),
                                   dtype=torch.int8, **kw),
            "c_kv_d": torch.zeros((num_pages, page_size),
                                  dtype=torch.float32, **kw),
            "k_rope_qs": torch.zeros((num_pages, page_size, dr_s),
                                     dtype=torch.int8, **kw),
            "k_rope_d": torch.zeros((num_pages, page_size),
                                    dtype=torch.float32, **kw),
        }
    return {
        "c_kv": torch.zeros((num_pages, page_size, rank), dtype=dtype, **kw),
        "k_rope": torch.zeros((num_pages, page_size, dr), dtype=dtype, **kw),
    }


def _absorbed(p, cfg: ModelConfig, dt):
    """``kv_b`` split into its key half W_kb (rank, H, dn), folded into the
    query, and its value half W_vb (rank, H, dv), applied to the output."""
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    w_kvb = _maybe_dequant(p["kv_b"], dt).reshape(cfg.kv_lora_rank,
                                                  cfg.n_heads, dn + dv)
    return w_kvb[..., :dn], w_kvb[..., dn:]


def _project_out(p, cfg: ModelConfig, lat, w_vb, x):
    """Attended latents (..., H, rank) -> o_proj(latents @ W_vb)."""
    o = torch.einsum("...hr,rhd->...hd", lat.to(x.dtype).to(torch.float32),
                     w_vb.to(torch.float32))
    o = o.reshape(*x.shape[:2], cfg.n_heads * cfg.v_head_dim).to(x.dtype)
    return linear(p["o_proj"], o)


def _absorbed_attend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     q_nope: torch.Tensor, q_rope: torch.Tensor,
                     c_kv: torch.Tensor, k_rope: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Absorbed attention of one query row over dense latent views: the
    read of :func:`mla_decode` and of the gather reference.  q_nope/q_rope:
    (B, 1, H, *); c_kv: (B, L, rank); k_rope: (B, L, dr); returns the
    projected output (B, 1, D) in ``x.dtype``."""
    dt, f32 = x.dtype, torch.float32
    w_kb, w_vb = _absorbed(p, cfg, dt)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32),
                         w_kb.to(f32))                        # (B,H,rank)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    s = (torch.einsum("bhr,blr->bhl", q_eff.to(dt).to(f32), c_kv.to(f32))
         + torch.einsum("bhd,bld->bhl", q_rope[:, 0].to(f32),
                        k_rope.to(f32))) * scale
    valid = (torch.arange(c_kv.shape[1], device=x.device)[None, :]
             <= pos[:, None])
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    # attend in latent space, then project out with W_vb
    lat = torch.einsum("bhl,blr->bhr", w.to(dt).to(f32), c_kv.to(f32))
    return _project_out(p, cfg, lat[:, None], w_vb, x)


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor, live: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token decode against a dense latent cache.  x: (B, 1,
    D); pos: (B,).  Writes the new latent / rope row at ``pos`` in place,
    except in rows with ``live == False``, then attends the cache."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q_nope, q_rope = _project_q(p, cfg, h, pos[:, None])      # (B,1,H,*)
    c_new, kr_new = _latents(p, cfg, h, pos[:, None])         # (B,1,rank)
    at = (pos % cache["c_kv"].shape[1])[:, None]
    ok = None if live is None else live[:, None]
    paged.write_dense(cache["c_kv"], at, c_new, ok)
    paged.write_dense(cache["k_rope"], at, kr_new, ok)
    return _absorbed_attend(p, cfg, x, q_nope, q_rope, cache["c_kv"],
                            cache["k_rope"], pos), cache


def mla_decode_paged(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, block_table: torch.Tensor, *,
                     max_len: int, live: torch.Tensor | None = None,
                     active_pages: int | None = None,
                     lane_pages: torch.Tensor | None = None,
                     lq: paged.LayerQuant | None = None,
                     kernel: str = "fused"
                     ) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token decode against paged latents.

    ``kernel="fused"``: scatter the new latent / rope row into its page (in
    place, quantized first for quantized pools; rows with ``live ==
    False`` go to GARBAGE), then attend the pages in place through the
    block table (B6).  ``kernel="gather"``, the reference path: run
    :func:`mla_decode` on the gathered dense view and scatter the new row
    back (model-dtype pools), or attend the dequantized dense view of the
    updated pools (quantized pools).
    """
    if kernel == "gather" and not lq:
        dense = {k: paged.gather_pages(cache[k], block_table, max_len)
                 for k in ("c_kv", "k_rope")}
        delta, dense = mla_decode(p, cfg, x, dense, pos, live=live)
        rows = torch.arange(x.shape[0], device=x.device)
        at = pos.long()
        for key in ("c_kv", "k_rope"):
            paged.scatter_token(cache[key], block_table, pos.to(torch.int32),
                                dense[key][rows, at], ok=live)
        return delta, cache
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q_nope, q_rope = _project_q(p, cfg, h, pos[:, None])      # (B,1,H,*)
    c_new, kr_new = _latents(p, cfg, h, pos[:, None])         # (B,1,rank)
    idx = pos.to(torch.int32)
    if lq:
        paged.scatter_token_quant(cache["c_kv_qs"], cache["c_kv_d"],
                                  block_table, idx, c_new[:, 0], ok=live,
                                  mode=lq.latent)
        paged.scatter_token_quant(cache["k_rope_qs"], cache["k_rope_d"],
                                  block_table, idx, kr_new[:, 0], ok=live,
                                  mode=lq.kv)
        if kernel == "gather":
            # the dequantized views stay f32, as the fused kernel
            # dequantizes in f32
            ckv = paged.gather_pages_quant(cache["c_kv_qs"], cache["c_kv_d"],
                                           block_table, max_len, lq.latent)
            krope = paged.gather_pages_quant(
                cache["k_rope_qs"], cache["k_rope_d"], block_table, max_len,
                lq.kv)
            return _absorbed_attend(p, cfg, x, q_nope, q_rope, ckv, krope,
                                    pos), cache
    else:
        paged.scatter_token(cache["c_kv"], block_table, idx, c_new[:, 0],
                            ok=live)
        paged.scatter_token(cache["k_rope"], block_table, idx, kr_new[:, 0],
                            ok=live)
    dt = x.dtype
    w_kb, w_vb = _absorbed(p, cfg, dt)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(torch.float32),
                         w_kb.to(torch.float32))              # (B,H,rank)
    kw = dict(scale=(dn + dr) ** -0.5, active_pages=active_pages,
              lane_pages=lane_pages)
    if lq:
        lat = paged_attn.paged_mla_decode_quant(
            q_eff.to(dt), q_rope[:, 0], cache["c_kv_qs"], cache["c_kv_d"],
            cache["k_rope_qs"], cache["k_rope_d"], block_table, pos,
            latent_mode=lq.latent, rope_mode=lq.kv, **kw)
    else:
        lat = paged_attn.paged_mla_decode(
            q_eff.to(dt), q_rope[:, 0], cache["c_kv"], cache["k_rope"],
            block_table, pos, **kw)
    return _project_out(p, cfg, lat[:, None], w_vb, x), cache


def mla_prefill_chunk(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict, positions: torch.Tensor,
                      start: torch.Tensor, chunk_len: torch.Tensor, *,
                      max_len: int, block_table: torch.Tensor | None = None,
                      lq: paged.LayerQuant | None = None,
                      active_pages: int | None = None,
                      kernel: str = "fused"
                      ) -> tuple[torch.Tensor, dict]:
    """One prefill chunk against the paged latent cache, or against the
    dense one when ``block_table`` is None.

    x: (B, C, D) right-padded per row; positions: (B, C) absolute; start:
    (B,) first position of the chunk; chunk_len: (B,) valid tokens.
    Quantized pools with ``kernel="fused"``: quantize the chunk's latents
    once (each leaf in its own mode), scatter them, and attend the packed
    pools in place in absorbed form (B7).  Otherwise: materialise per-head
    K/V from [cached latents | chunk latents] (quantized pools: their
    dequantized view, the chunk's latents through the round trip they are
    stored with) and attend with per-row positional masks, then write the
    chunk's latents.
    """
    b, c, _ = x.shape
    nh = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q_nope, q_rope = _project_q(p, cfg, h, positions)
    c_new, kr_new = _latents(p, cfg, h, positions)
    valid_tok = (torch.arange(c, device=x.device)[None, :]
                 < chunk_len[:, None])                               # (B, C)
    idx = positions.to(torch.int32)

    if lq and kernel == "fused":
        for leaf, val, mode in (("c_kv", c_new, lq.latent),
                                ("k_rope", kr_new, lq.kv)):
            qs, d = paged.quantize_rows(val, mode)
            paged.scatter_chunk(cache[f"{leaf}_qs"], block_table, idx, qs,
                                valid_tok)
            paged.scatter_chunk(cache[f"{leaf}_d"], block_table, idx, d,
                                valid_tok)
        qpos = torch.where(valid_tok, positions,
                           torch.full_like(positions, -1)).to(torch.int32)
        dt = x.dtype
        w_kb, w_vb = _absorbed(p, cfg, dt)
        q_eff = torch.einsum("bchd,rhd->bchr", q_nope.to(torch.float32),
                             w_kb.to(torch.float32))          # (B,C,H,rank)
        lat = paged_attn.paged_mla_prefill_quant(
            q_eff.to(dt), q_rope, cache["c_kv_qs"], cache["c_kv_d"],
            cache["k_rope_qs"], cache["k_rope_d"], block_table, qpos,
            scale=(dn + dr) ** -0.5, latent_mode=lq.latent,
            rope_mode=lq.kv, active_pages=active_pages)
        return _project_out(p, cfg, lat, w_vb, x), cache

    if lq:
        ckv = paged.gather_pages_quant(cache["c_kv_qs"], cache["c_kv_d"],
                                       block_table, max_len, lq.latent)
        krope = paged.gather_pages_quant(cache["k_rope_qs"],
                                         cache["k_rope_d"], block_table,
                                         max_len, lq.kv)
        c_qs, c_d, c_att = paged.roundtrip_quant(c_new, lq.latent)
        kr_qs, kr_d, kr_att = paged.roundtrip_quant(kr_new, lq.kv)
    elif block_table is not None:
        ckv = paged.gather_pages(cache["c_kv"], block_table, max_len)
        krope = paged.gather_pages(cache["k_rope"], block_table, max_len)
        c_att, kr_att = c_new, kr_new
    else:
        ckv, krope = cache["c_kv"], cache["k_rope"]
        c_att, kr_att = c_new, kr_new
    ckv_all = torch.cat([ckv, c_att.to(ckv.dtype)], dim=1)
    kr_all = torch.cat([krope, kr_att.to(krope.dtype)], dim=1)
    # cache entries carry their logical index (latents store no positions)
    old_pos = torch.arange(max_len, dtype=torch.int32,
                           device=x.device)[None, :].expand(b, max_len)
    key_pos = chunk_key_positions(old_pos, positions, valid_tok)
    mask_fn = chunk_mask_fn(key_pos, max_len, positions, start, 0)
    kvb = linear(p["kv_b"], ckv_all).reshape(b, max_len + c, nh, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    k = torch.cat([k_nope, kr_all[:, :, None, :].expand(b, max_len + c, nh,
                                                        dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = _chunk_attn(q, k, v, mask_fn, 0.0)
    o = o.reshape(b, c, nh * dv).to(x.dtype)
    out = linear(p["o_proj"], o)
    # full horizon: no ring collisions, so every valid token writes
    if lq:
        for leaf, qs, d in (("c_kv", c_qs, c_d), ("k_rope", kr_qs, kr_d)):
            paged.scatter_chunk(cache[f"{leaf}_qs"], block_table, idx, qs,
                                valid_tok)
            paged.scatter_chunk(cache[f"{leaf}_d"], block_table, idx, d,
                                valid_tok)
    elif block_table is not None:
        paged.scatter_chunk(cache["c_kv"], block_table, idx, c_new, valid_tok)
        paged.scatter_chunk(cache["k_rope"], block_table, idx, kr_new,
                            valid_tok)
    else:
        # padded tokens past the horizon wrap to rows they leave as they are
        at = positions % max_len
        paged.write_dense(cache["c_kv"], at, c_new, valid_tok)
        paged.write_dense(cache["k_rope"], at, kr_new, valid_tok)
    return out, cache
