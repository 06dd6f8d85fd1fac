"""Per-layer decode / chunked-prefill for the ported block kind: full GQA
attention with a dense SwiGLU FFN."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import attention
from .common import ffn_apply, rms_norm


def _check_kind(cfg: ModelConfig, layer: int) -> None:
    if cfg.block_kind(layer) != "attn" or cfg.mla or cfg.moe_layer(layer):
        raise NotImplementedError(
            f"layer {layer} of {cfg.name}: only full-attention layers with a "
            "dense FFN are ported (ROADMAP D2, D6)")


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + ffn_apply(p, rms_norm(x, p["ffn_norm"], cfg.norm_eps))


def decode_layer(cfg: ModelConfig, p: dict, layer: int, x: torch.Tensor,
                 cache: dict, pos: torch.Tensor, *,
                 block_table: torch.Tensor, max_len: int, live=None,
                 active_pages: int | None = None, lane_pages=None,
                 kv_quant: str | None = None):
    """One-token decode through one layer.  Returns (x, layer_cache)."""
    _check_kind(cfg, layer)
    delta, cache_new = attention.attn_decode_paged(
        p, cfg, x, cache, pos, block_table, max_len=max_len, live=live,
        active_pages=active_pages, lane_pages=lane_pages, kv_quant=kv_quant)
    return _ffn(cfg, p, x + delta), cache_new


def prefill_chunk_layer(cfg: ModelConfig, p: dict, layer: int,
                        x: torch.Tensor, cache: dict, positions: torch.Tensor,
                        start: torch.Tensor, chunk_len: torch.Tensor, *,
                        max_len: int, block_table: torch.Tensor,
                        kv_quant: str | None = None,
                        active_pages: int | None = None):
    """One prefill chunk through one layer.  Returns (x, layer_cache)."""
    _check_kind(cfg, layer)
    delta, cache_new = attention.attn_prefill_chunk(
        p, cfg, x, cache, positions, start, chunk_len, max_len=max_len,
        block_table=block_table, kv_quant=kv_quant, active_pages=active_pages)
    return _ffn(cfg, p, x + delta), cache_new


def init_layer_cache_paged(cfg: ModelConfig, layer: int, num_pages: int,
                           page_size: int, slots: int, dtype=torch.bfloat16,
                           kv_quant: str | None = None, device=None) -> dict:
    """Paged layer cache: the attention leaves as page pools."""
    del slots  # recurrent passthrough state is not on the ported path
    _check_kind(cfg, layer)
    return attention.init_paged_attn_cache(cfg, num_pages, page_size, dtype,
                                           kv_quant=kv_quant, device=device)
