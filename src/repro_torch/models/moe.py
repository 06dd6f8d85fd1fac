"""Mixture-of-Experts with capacity-based sorted dispatch (DeepSeek-style
routed experts plus shared experts), the port of ``repro.models.moe``.

Top-k routing -> stable sort of the (token, choice) assignments by expert
-> capacity-clipped scatter into per-expert buffers (E, capacity, D) ->
batched expert SwiGLU (kernel B1's expert form: one launch per weight for
all experts) -> gate-weighted combine.  The reference's behaviour is kept:
tokens past an expert's capacity are dropped in stable-sort order (at
decode the capacity is one slot per expert), and lanes that are not live
still route their throwaway token, so they can take a live token's slot.
An expert no token was routed to has an all-zero buffer, and SwiGLU keeps
its down projection's input zero, so its outputs are zero; the expert
kernels of every format read none of its weights (a decode step at 4 lanes
reads at most 32 of DeepSeek's 256 experts, 4 of llama4-scout's 16).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.qtensor import QTensor
from ..kernels import ops
from .common import linear, swiglu


def router_probs(router_w, x) -> torch.Tensor:
    """x: (T, D) -> router logits (T, E) in f32."""
    return torch.matmul(x.to(torch.float32), router_w.to(torch.float32))


def moe_dispatch(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                 n_experts: int, capacity: int):
    """Per-expert buffers.  x: (T, D); gates/idx: (T, K).  Returns
    (buf (E, capacity, D), combine metadata)."""
    t, d = x.shape
    k = idx.shape[1]
    dev = x.device
    flat_e = idx.reshape(-1)                                   # (T*K,)
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)                 # by expert
    e_s, g_s, tok_s = flat_e[order], flat_g[order], flat_tok[order]

    # rank within the expert's run: the index past the run's start, found
    # in the sorted keys (bincount would wait for the card to size its
    # output)
    run_start = torch.searchsorted(e_s, e_s)
    pos_in_e = torch.arange(t * k, device=dev) - run_start
    keep = pos_in_e < capacity
    slot = torch.where(keep, e_s * capacity + pos_in_e,
                       torch.full_like(e_s, n_experts * capacity))

    # dropped assignments all write zeros to the sink row past the buffers
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype,
                      device=dev)
    buf.index_put_((slot,), torch.where(keep[:, None], x[tok_s],
                                        torch.zeros_like(x[tok_s])))
    buf = buf[:-1].reshape(n_experts, capacity, d)
    return buf, (order, slot, g_s, keep)


def moe_combine(out_buf: torch.Tensor, meta, t: int) -> torch.Tensor:
    """out_buf: (E, C, D) -> (T, D) weighted by gates.

    The reference scatter-adds the assignments (``y.at[tok_s].add``);
    here each token's top-k contributions are gathered back into their
    routing order and summed over k — a fixed order, with no atomics, so
    the card gives the same result on every run.
    """
    order, slot, g_s, keep = meta
    e, c, d = out_buf.shape
    flat = torch.cat([out_buf.reshape(e * c, d),
                      torch.zeros((1, d), dtype=out_buf.dtype,
                                  device=out_buf.device)])
    vals = flat[torch.clamp(slot, max=e * c)] * (
        g_s * keep.to(g_s.dtype))[:, None].to(out_buf.dtype)
    unsorted = torch.empty_like(vals)
    unsorted[order] = vals                       # row t*K + k: choice k of t
    return unsorted.reshape(t, -1, d).sum(dim=1)


def expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU over per-expert buffers.  buf: (E, C, D)."""

    def bmm(w, u):
        if isinstance(w, QTensor):
            return ops.qmatmul(u, w)
        return torch.einsum("ecd,edf->ecf", u, w.to(u.dtype))

    g = bmm(p["gate_exps"], buf)
    up = bmm(p["up_exps"], buf)
    return bmm(p["down_exps"], swiglu(g, up))


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              capacity_factor: float | None = None,
              data_shards: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed-experts layer (plus shared experts).  x: (B, T, D) ->
    (y, aux_loss)."""
    if data_shards > 1:
        raise NotImplementedError(
            "shard-local MoE dispatch (data_shards > 1) is not ported yet "
            "(ROADMAP D8, mesh serving)")
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    n_tok = b * t
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor

    logits = router_probs(p["router"], xf)                     # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    # the reference's top-k (``jax.lax.top_k``) ranks NaN above every
    # number and breaks ties to the lower index; ``torch.topk`` does
    # neither.  A token whose router row went non-finite (a poisoned lane)
    # must claim the reference's experts, and so the same capacity slots,
    # or a bystander's drops differ: rank by a stable descending sort with
    # NaN read as +inf (softmax outputs are never inf themselves)
    key = torch.where(torch.isnan(probs),
                      torch.full_like(probs, float("inf")), probs)
    idx = torch.sort(key, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.top_k]       # (T, K)
    gates = torch.gather(probs, -1, idx)
    gates = gates /torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    capacity = max(1, int(cf * n_tok * cfg.top_k / cfg.n_experts))
    buf, meta = moe_dispatch(xf, gates.to(xf.dtype), idx, cfg.n_experts,
                             capacity)
    y = moe_combine(expert_ffn(p, buf), meta, n_tok).reshape(b, t, d)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                     # (E,)
    # one-hot of each token's first choice (F.one_hot checks its input's
    # range on the host, a wait for the card)
    experts = torch.arange(cfg.n_experts, device=x.device)
    ce = (idx[:, :1] == experts).to(torch.float32).mean(dim=0)
    aux = cfg.n_experts * torch.sum(me * ce)

    if cfg.n_shared_experts:
        y = y + linear(p["down_shexp"], swiglu(linear(p["gate_shexp"], x),
                                               linear(p["up_shexp"], x)))
    return y, aux
