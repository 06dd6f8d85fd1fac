"""Model: the serving API (embed, paged decode, chunked prefill, logits).

Keeps the reference's signatures (``repro.models.model.Model``) for the
methods the serving path calls; the cache is a flat dict of tensors keyed
``dec/L000/<leaf>``, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from . import paged, transformer
from .common import embed, linear, rms_norm
from .spec import check_supported, layer_prefix, subview


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        check_supported(self.cfg)

    def _embed_tokens(self, params, tokens):
        return embed(params["token_embd"], tokens, self.dtype)

    def logits(self, params, hidden):
        cfg = self.cfg
        w = params["token_embd"] if cfg.tie_embeddings else params["output"]
        out = linear(w, hidden)
        if cfg.logit_softcap:
            out = cfg.logit_softcap * torch.tanh(out / cfg.logit_softcap)
        return out[..., : cfg.vocab_size]

    def init_paged_cache(self, num_pages: int, page_size: int, slots: int,
                         dtype=torch.bfloat16, kv_quant: str | None = None,
                         device=None):
        """Attention K/V (+pos), or MLA latents, as ``(num_pages,
        page_size, ...)`` pools shared by all slots via block tables.
        ``kv_quant`` stores int8 values + per-row f32 scales: "q8_0" in
        every leaf; "q4_0" nibble-packs every leaf (``k_qs``/``v_qs``,
        ``c_kv_qs``/``k_rope_qs``) to half its width; "dq" packs q4_0
        only the K/V (or MLA rope-key) leaves of the layers outside
        ``paged.dq_sensitive_layers`` and keeps the rest, and every MLA
        latent, q8_0."""
        flat = {}
        lqs = paged.layer_quants(kv_quant, self.cfg)
        for layer in range(self.cfg.n_layers):
            c = transformer.init_layer_cache_paged(
                self.cfg, layer, num_pages, page_size, slots, dtype,
                lq=lqs[layer], device=device)
            for k, v in c.items():
                flat[f"{layer_prefix('dec', layer)}/{k}"] = v
        return flat

    @staticmethod
    def _check_kernel(kernel):
        if kernel not in (None, "fused"):
            raise NotImplementedError(
                f"kernel={kernel!r}: only the fused paged kernels are "
                "ported (ROADMAP D5, the gather reference path)")

    def decode_step_paged(self, params, cache, tokens, pos, block_tables,
                          *, page_size: int, max_len: int, live=None,
                          kernel: str | None = None,
                          active_pages: tuple[int, int] | None = None,
                          lane_pages=None, kv_quant: str | None = None):
        """One decode step against a paged cache.

        tokens/pos: (B,) int32; block_tables: {"full": (B, n) int32};
        ``active_pages``: optional ``(n_full, n_ring)`` bound on the fused
        kernels' page loops; ``lane_pages``: optional ``{"full": (B,)}``
        per-lane refinement; ``kv_quant``: None, "q8_0", "q4_0" or "dq",
        as the cache was made.  Returns (logits (B, vocab), cache).
        """
        del page_size
        self._check_kernel(kernel)
        cfg = self.cfg
        ap = (active_pages[0] or None) if active_pages is not None else None
        lp = lane_pages["full"] if lane_pages is not None else None
        lqs = paged.layer_quants(kv_quant, cfg)
        x = self._embed_tokens(params, tokens[:, None])
        for layer in range(cfg.n_layers):
            lpx = layer_prefix("dec", layer)
            x, c_new = transformer.decode_layer(
                cfg, subview(params, lpx), layer, x, subview(cache, lpx), pos,
                block_table=block_tables["full"], max_len=max_len, live=live,
                active_pages=ap, lane_pages=lp, lq=lqs[layer])
            for k, v in c_new.items():
                cache[f"{lpx}/{k}"] = v
        x = rms_norm(x, params["output_norm"], cfg.norm_eps)
        return self.logits(params, x)[:, 0], cache

    def prefill_chunk(self, params, cache, tokens, start, chunk_len, *,
                      max_len: int, block_tables=None, page_size: int = 0,
                      kv_quant: str | None = None, kernel: str | None = None,
                      active_pages: tuple[int, int] | None = None):
        """One chunked-prefill step over the paged cache.

        tokens: (B, C) int32, right-padded per row; start: (B,) absolute
        position of each row's first token; chunk_len: (B,) valid tokens
        (0 = inactive row); ``kv_quant`` as in :meth:`decode_step_paged`.
        Returns (logits (B, vocab) at each row's last valid position,
        cache).
        """
        del page_size
        self._check_kernel(kernel)
        if block_tables is None:
            raise NotImplementedError(
                "the dense (page_size=0) cache layout is not ported "
                "(ROADMAP D5)")
        cfg = self.cfg
        ap = (active_pages[0] or None) if active_pages is not None else None
        c = tokens.shape[1]
        lqs = paged.layer_quants(kv_quant, cfg)
        x = self._embed_tokens(params, tokens)
        positions = start[:, None] + torch.arange(
            c, dtype=start.dtype, device=start.device)[None, :]
        for layer in range(cfg.n_layers):
            lpx = layer_prefix("dec", layer)
            x, c_new = transformer.prefill_chunk_layer(
                cfg, subview(params, lpx), layer, x, subview(cache, lpx),
                positions, start, chunk_len, max_len=max_len,
                block_table=block_tables["full"], lq=lqs[layer],
                active_pages=ap)
            for k, v in c_new.items():
                cache[f"{lpx}/{k}"] = v
        x = rms_norm(x, params["output_norm"], cfg.norm_eps)
        idx = torch.clamp(chunk_len - 1, 0, c - 1).long()
        last_h = torch.gather(
            x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
        return self.logits(params, last_h)[:, 0], cache
