"""Multi-head Latent Attention (DeepSeek V2/V3) over a paged latent cache.

The cache stores only the compressed latent ``c_kv`` (``kv_lora_rank``
wide) and the decoupled RoPE key (``qk_rope_head_dim`` wide) per token, as
page pools with no positions: a token is valid iff its logical index is
``<= pos``.  Decode runs the **absorbed** form: ``kv_b``'s key half is
folded into the query (``q_eff``), kernel B6 attends the latent pages in
place, and ``kv_b``'s value half projects the attended latents out.
Chunked prefill over quantized pools is write-then-attend in the same
absorbed form (kernel B7).  Quantized pools take one mode per leaf
(``paged.LayerQuant``: ``latent`` for ``c_kv``, ``kv`` for the rope key),
q8_0 or nibble-packed q4_0 (B6/B7's q4_0 loaders, B5); under "dq" the
latent stays q8_0 while the rope key of a non-sensitive layer is q4_0.
Over model-dtype pools, prefill materialises per-head K/V from
[cached latents | chunk latents] and runs the online-softmax attention in
plain PyTorch, as the reference leaves it to XLA.  The ``kv_b`` absorption
einsums and ``o_proj`` stay plain PyTorch / B1 as well.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.qtensor import QTensor
from ..kernels import paged_attn
from . import paged
from .attention import _chunk_attn, chunk_key_positions, chunk_mask_fn
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


def mla_decode_paged(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, block_table: torch.Tensor, *,
                     max_len: int, live: torch.Tensor | None = None,
                     active_pages: int | None = None,
                     lane_pages: torch.Tensor | None = None,
                     lq: paged.LayerQuant | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token decode against paged latents (the fused kernel).

    Scatters the new latent / rope row into its page (in place, quantized
    first for quantized pools; rows with ``live == False`` go to GARBAGE),
    then attends the pages in place through the block table (B6).
    """
    del max_len
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
                      max_len: int, block_table: torch.Tensor,
                      lq: paged.LayerQuant | None = None,
                      active_pages: int | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """One prefill chunk against the paged latent cache.

    x: (B, C, D) right-padded per row; positions: (B, C) absolute; start:
    (B,) first position of the chunk; chunk_len: (B,) valid tokens.
    Quantized pools: quantize the chunk's latents once (each leaf in its
    own mode), scatter them, and attend the packed pools in place in
    absorbed form (B7).  Model-dtype pools:
    materialise per-head K/V from [cached latents | chunk latents] and
    attend with per-row positional masks, then write the chunk's latents.
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

    if lq:
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

    ckv = paged.gather_pages(cache["c_kv"], block_table, max_len)
    krope = paged.gather_pages(cache["k_rope"], block_table, max_len)
    ckv_all = torch.cat([ckv, c_new.to(ckv.dtype)], dim=1)
    kr_all = torch.cat([krope, kr_new.to(krope.dtype)], dim=1)
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
    paged.scatter_chunk(cache["c_kv"], block_table, idx, c_new, valid_tok)
    paged.scatter_chunk(cache["k_rope"], block_table, idx, kr_new, valid_tok)
    return out, cache
