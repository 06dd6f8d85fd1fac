"""Model: the public forward / loss / prefill / decode API (embed, layers,
logits), the port of ``repro.models.model.Model``.

Keeps the reference's signatures for the decoder-only text models the port
takes: the full-sequence ``forward`` and ``loss``, the one-shot
``prefill`` that builds a dense cache and ``decode_step`` against it, and
the serving path's ``decode_step_paged`` and ``prefill_chunk`` over paged
(or, for ``prefill_chunk``, dense) caches.  A cache is a flat dict of
tensors keyed ``dec/L000/<leaf>``, updated in place.
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

    KERNELS = ("fused", "gather")

    @classmethod
    def _check_kernel(cls, kernel) -> str:
        kernel = kernel or "fused"
        if kernel not in cls.KERNELS:
            raise ValueError(f"unknown paged decode kernel {kernel!r}")
        return kernel

    # -- full sequence --------------------------------------------------------
    def hidden_states(self, params, batch):
        """Full forward up to the final norm.  batch["tokens"]: (B, T).
        Returns (hidden (B, T, D), the summed MoE auxiliary loss)."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in range(cfg.n_layers):
            x, a = transformer.apply_layer(
                cfg, subview(params, layer_prefix("dec", layer)), layer, x,
                positions=positions)
            if a is not None:
                aux = aux + a
        return rms_norm(x, params["output_norm"], cfg.norm_eps), aux

    def forward(self, params, batch):
        """Returns (logits (B, T, vocab), aux)."""
        hidden, aux = self.hidden_states(params, batch)
        return self.logits(params, hidden), aux

    def loss(self, params, batch):
        """Next-token cross entropy (+ MoE aux).  batch["labels"]: (B, T),
        -1 where a position takes no loss.  Returns (total, {"nll",
        "aux"})."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"]
        lf = logits.to(torch.float32)
        logz = torch.logsumexp(lf, dim=-1)
        # a -1 label is masked out below; clamp it to a valid index first
        gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])
        mask = (labels >= 0).to(torch.float32)
        nll = (torch.sum((logz - gold[..., 0]) * mask)
               / torch.clamp(torch.sum(mask), min=1.0))
        return nll + self.cfg.router_aux_loss * aux, {"nll": nll, "aux": aux}

    # -- one-shot serving over a dense cache ----------------------------------
    def prefill(self, params, batch, max_len: int, *, lengths=None):
        """Forward that also builds the dense decode cache.  Returns
        (last_logits (B, 1, vocab), cache).  ``lengths`` ((B,) int,
        optional): true prompt lengths of a right-padded batch; each row's
        logits are then taken at ``lengths - 1``.  (The padded positions
        land in the cache too, but decode overwrites each position before
        it attends it and masks those past ``pos``.)"""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"])
        cache = {}
        for layer in range(cfg.n_layers):
            lpx = layer_prefix("dec", layer)
            x, c = transformer.prefill_layer(cfg, subview(params, lpx), layer,
                                             x, max_len)
            for k, v in c.items():
                cache[f"{lpx}/{k}"] = v
        x = rms_norm(x, params["output_norm"], cfg.norm_eps)
        if lengths is None:
            last_h = x[:, -1:]
        else:
            idx = torch.as_tensor(lengths, device=x.device).long() - 1
            last_h = torch.gather(
                x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
        return self.logits(params, last_h), cache

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """The dense cache: every layer's leaves ``(batch, max_len, ...)``
        (K/V/pos, or the MLA latents)."""
        flat = {}
        for layer in range(self.cfg.n_layers):
            c = transformer.init_layer_cache(self.cfg, layer, batch, max_len,
                                             dtype, device=device)
            for k, v in c.items():
                flat[f"{layer_prefix('dec', layer)}/{k}"] = v
        return flat

    def decode_step(self, params, cache, tokens, pos, *, live=None):
        """One decode step against the dense cache.  tokens/pos: (B,)
        int32; ``live`` (B,) bool: rows flagged False compute a throwaway
        step and leave the cache as it was.  Returns (logits (B, vocab),
        cache)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens[:, None])
        for layer in range(cfg.n_layers):
            lpx = layer_prefix("dec", layer)
            x, _ = transformer.decode_layer(
                cfg, subview(params, lpx), layer, x, subview(cache, lpx), pos,
                live=live)
        x = rms_norm(x, params["output_norm"], cfg.norm_eps)
        return self.logits(params, x)[:, 0], cache

    # -- paged serving --------------------------------------------------------
    def decode_step_paged(self, params, cache, tokens, pos, block_tables,
                          *, page_size: int, max_len: int, live=None,
                          kernel: str | None = None,
                          active_pages: tuple[int, int] | None = None,
                          lane_pages=None, kv_quant: str | None = None):
        """One decode step against a paged cache.

        tokens/pos: (B,) int32; block_tables: {"full": (B, n) int32};
        ``kernel``: "fused" (the default) attends the pages in place
        through the fused kernels, "gather" is the reference path over
        each layer's dense view of the whole table;
        ``active_pages``: optional ``(n_full, n_ring)`` bound on the fused
        kernels' page loops; ``lane_pages``: optional ``{"full": (B,)}``
        per-lane refinement (gather ignores both); ``kv_quant``: None,
        "q8_0", "q4_0" or "dq", as the cache was made.  Returns (logits
        (B, vocab), cache).
        """
        del page_size
        kernel = self._check_kernel(kernel)
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
                active_pages=ap, lane_pages=lp, lq=lqs[layer], kernel=kernel)
            for k, v in c_new.items():
                cache[f"{lpx}/{k}"] = v
        x = rms_norm(x, params["output_norm"], cfg.norm_eps)
        return self.logits(params, x)[:, 0], cache

    def prefill_chunk(self, params, cache, tokens, start, chunk_len, *,
                      max_len: int, block_tables=None, page_size: int = 0,
                      kv_quant: str | None = None, kernel: str | None = None,
                      active_pages: tuple[int, int] | None = None):
        """One chunked-prefill step over the paged cache, or over the dense
        one of :meth:`init_cache` when ``block_tables`` is None.

        tokens: (B, C) int32, right-padded per row; start: (B,) absolute
        position of each row's first token; chunk_len: (B,) valid tokens
        (0 = inactive row); ``kv_quant`` (paged only) and ``kernel`` as in
        :meth:`decode_step_paged` (``"gather"`` attends quantized pools'
        dequantized view instead of writing then attending them in place).
        Returns (logits (B, vocab) at each row's last valid position,
        cache).
        """
        del page_size
        kernel = self._check_kernel(kernel)
        if kv_quant and block_tables is None:
            raise ValueError("kv_quant requires a paged cache "
                             "(pass block_tables/page_size)")
        bt = None if block_tables is None else block_tables["full"]
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
                block_table=bt, lq=lqs[layer], active_pages=ap,
                kernel=kernel)
            for k, v in c_new.items():
                cache[f"{lpx}/{k}"] = v
        x = rms_norm(x, params["output_norm"], cfg.norm_eps)
        idx = torch.clamp(chunk_len - 1, 0, c - 1).long()
        last_h = torch.gather(
            x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
        return self.logits(params, last_h)[:, 0], cache
