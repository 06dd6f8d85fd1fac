"""Per-layer decode / chunked-prefill for the ported block kinds: full
attention (GQA or MLA) followed by a dense SwiGLU FFN or routed experts.

``lq`` is one layer's ``paged.LayerQuant`` (None for model-dtype pools),
which ``Model`` resolves once from the engine-level spec with
``paged.layer_quants``, so under "dq" the layers of one model keep
differently packed pools."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import attention, mla, moe
from .common import ffn_apply, rms_norm
from .paged import LayerQuant


def _ffn(cfg: ModelConfig, p: dict, layer: int, x: torch.Tensor
         ) -> torch.Tensor:
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.moe_layer(layer):
        y, _ = moe.moe_apply(p, cfg, h)
        return x + y
    return x + ffn_apply(p, h)


def decode_layer(cfg: ModelConfig, p: dict, layer: int, x: torch.Tensor,
                 cache: dict, pos: torch.Tensor, *,
                 block_table: torch.Tensor, max_len: int, live=None,
                 active_pages: int | None = None, lane_pages=None,
                 lq: LayerQuant | None = None):
    """One-token decode through one layer.  Returns (x, layer_cache)."""
    attend = mla.mla_decode_paged if cfg.mla else attention.attn_decode_paged
    delta, cache_new = attend(
        p, cfg, x, cache, pos, block_table, max_len=max_len, live=live,
        active_pages=active_pages, lane_pages=lane_pages, lq=lq)
    return _ffn(cfg, p, layer, x + delta), cache_new


def prefill_chunk_layer(cfg: ModelConfig, p: dict, layer: int,
                        x: torch.Tensor, cache: dict, positions: torch.Tensor,
                        start: torch.Tensor, chunk_len: torch.Tensor, *,
                        max_len: int, block_table: torch.Tensor,
                        lq: LayerQuant | None = None,
                        active_pages: int | None = None):
    """One prefill chunk through one layer.  Returns (x, layer_cache)."""
    attend = (mla.mla_prefill_chunk if cfg.mla
              else attention.attn_prefill_chunk)
    delta, cache_new = attend(
        p, cfg, x, cache, positions, start, chunk_len, max_len=max_len,
        block_table=block_table, lq=lq, active_pages=active_pages)
    return _ffn(cfg, p, layer, x + delta), cache_new


def init_layer_cache_paged(cfg: ModelConfig, layer: int, num_pages: int,
                           page_size: int, slots: int, dtype=torch.bfloat16,
                           lq: LayerQuant | None = None, device=None) -> dict:
    """Paged layer cache: the attention (or MLA latent) leaves as page
    pools, quantized in the layer's own modes."""
    del layer, slots  # modes come resolved in ``lq``; leaves are paged
    init = (mla.init_paged_mla_cache if cfg.mla
            else attention.init_paged_attn_cache)
    return init(cfg, num_pages, page_size, dtype, lq=lq, device=device)
