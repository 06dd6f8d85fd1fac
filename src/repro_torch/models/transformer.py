"""Per-layer forward, decode and prefill for the ported block kinds: full
attention (GQA or MLA) followed by a dense SwiGLU FFN or routed experts.

Decode and chunked prefill run against a paged cache (``block_table``
given) or the dense per-slot one (``block_table`` None).  ``lq`` is one
layer's ``paged.LayerQuant`` (None for model-dtype pools), which ``Model``
resolves once from the engine-level spec with ``paged.layer_quants``, so
under "dq" the layers of one model keep differently packed pools;
``kernel`` picks the fused paged kernels or the gather reference."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import attention, mla, moe
from .common import ffn_apply, rms_norm
from .paged import LayerQuant


def _ffn(cfg: ModelConfig, p: dict, layer: int, x: torch.Tensor):
    """The FFN half of a layer: (x, the MoE auxiliary loss or None)."""
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.moe_layer(layer):
        y, aux = moe.moe_apply(p, cfg, h)
        return x + y, aux
    return x + ffn_apply(p, h), None


def apply_layer(cfg: ModelConfig, p: dict, layer: int, x: torch.Tensor, *,
                positions=None):
    """Full-sequence layer (train / loss).  Returns (x, aux_loss or
    None)."""
    attend = mla.mla_forward if cfg.mla else attention.attn_forward
    return _ffn(cfg, p, layer, x + attend(p, cfg, x, positions))


def decode_layer(cfg: ModelConfig, p: dict, layer: int, x: torch.Tensor,
                 cache: dict, pos: torch.Tensor, *,
                 block_table: torch.Tensor | None = None, max_len: int = 0,
                 live=None, active_pages: int | None = None, lane_pages=None,
                 lq: LayerQuant | None = None, kernel: str = "fused"):
    """One-token decode through one layer.  Returns (x, layer_cache)."""
    if block_table is None:
        attend = mla.mla_decode if cfg.mla else attention.attn_decode
        delta, cache_new = attend(p, cfg, x, cache, pos, live=live)
    else:
        attend = (mla.mla_decode_paged if cfg.mla
                  else attention.attn_decode_paged)
        delta, cache_new = attend(
            p, cfg, x, cache, pos, block_table, max_len=max_len, live=live,
            active_pages=active_pages, lane_pages=lane_pages, lq=lq,
            kernel=kernel)
    return _ffn(cfg, p, layer, x + delta)[0], cache_new


def prefill_layer(cfg: ModelConfig, p: dict, layer: int, x: torch.Tensor,
                  max_len: int):
    """Full-sequence forward that also builds this layer's dense decode
    cache.  Returns (x, layer_cache)."""
    attend = mla.mla_prefill if cfg.mla else attention.attn_prefill
    delta, cache = attend(p, cfg, x, max_len)
    return _ffn(cfg, p, layer, x + delta)[0], cache


def prefill_chunk_layer(cfg: ModelConfig, p: dict, layer: int,
                        x: torch.Tensor, cache: dict, positions: torch.Tensor,
                        start: torch.Tensor, chunk_len: torch.Tensor, *,
                        max_len: int, block_table: torch.Tensor | None = None,
                        lq: LayerQuant | None = None,
                        active_pages: int | None = None,
                        kernel: str = "fused"):
    """One prefill chunk through one layer.  Returns (x, layer_cache)."""
    attend = (mla.mla_prefill_chunk if cfg.mla
              else attention.attn_prefill_chunk)
    delta, cache_new = attend(
        p, cfg, x, cache, positions, start, chunk_len, max_len=max_len,
        block_table=block_table, lq=lq, active_pages=active_pages,
        kernel=kernel)
    return _ffn(cfg, p, layer, x + delta)[0], cache_new


def init_layer_cache(cfg: ModelConfig, layer: int, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Dense layer cache: the attention (or MLA latent) leaves as
    ``(batch, max_len, ...)`` tensors in the model dtype."""
    del layer  # every ported layer is full attention
    init = mla.init_mla_cache if cfg.mla else attention.init_attn_cache
    return init(cfg, batch, max_len, dtype, device=device)


def init_layer_cache_paged(cfg: ModelConfig, layer: int, num_pages: int,
                           page_size: int, slots: int, dtype=torch.bfloat16,
                           lq: LayerQuant | None = None, device=None) -> dict:
    """Paged layer cache: the attention (or MLA latent) leaves as page
    pools, quantized in the layer's own modes."""
    del layer, slots  # modes come resolved in ``lq``; leaves are paged
    init = (mla.init_paged_mla_cache if cfg.mla
            else attention.init_paged_attn_cache)
    return init(cfg, num_pages, page_size, dtype, lq=lq, device=device)
