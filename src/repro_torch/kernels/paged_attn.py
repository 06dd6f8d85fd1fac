"""Kernels B2/B3 and B4 (paged GQA attention over KV page pools) and B6/B7
(absorbed MLA over latent page pools).

Replace the Pallas TPU kernels ``repro/kernels/paged_attn.py::_attn_core``
(one-token flash-decode, f32 and q8_0 tile loaders),
``::_attn_prefill_core`` (write-then-attend chunked prefill, q8_0 loader),
``::_mla_core`` (absorbed-MLA decode, f32 and q8_0 loaders) and
``::_mla_prefill_core`` (its chunked-prefill form, q8_0 loader).  The CUDA
kernels are ``csrc/paged_attn.cu`` and ``csrc/paged_mla.cu`` (their headers
say what bounds them on an H100 and how the designs answer that).  Beside
each wrapper is its plain PyTorch version, the reference's bounded-gather
twin: gather only the first ``active_pages`` logical pages through the
block table and run one masked softmax over them.

Layouts are the reference's: GQA pools ``(num_pages, P, Hkv, D)``, q8_0
row scales ``(num_pages, P, Hkv)``, ``pos_pool (num_pages, P)`` int32 (-1
= unwritten); MLA pools ``(num_pages, P, R)`` and ``(num_pages, P, Dr)``
with q8_0 token scales ``(num_pages, P)`` and no positions (validity is
positional); block tables ``(B, n)`` int32.  Dispatch is by device only:
CPU tensors take the plain version, CUDA tensors launch the kernel or
raise.  Each public wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -2.0e38
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1}
_Q8 = 2
_ROWS_PER_BLOCK = 32      # prefill query rows (queries x rep) per block


def _n_active(block_table: torch.Tensor, active_pages: int | None) -> int:
    n_pages = block_table.shape[1]
    if active_pages is None:
        return n_pages
    return max(1, min(int(active_pages), n_pages))


def _lane_bound(lane_pages, b: int, nj: int, device) -> torch.Tensor:
    """Per-lane live-page counts clamped into ``[1, nj]`` (``None``: nj)."""
    if lane_pages is None:
        return torch.full((b,), nj, dtype=torch.int32, device=device)
    return torch.clamp(lane_pages.to(torch.int32), 1, nj)


def _check_mode(mode: str) -> str:
    if mode == "q4_0":
        raise NotImplementedError("q4_0 KV pages are not ported yet "
                                  "(ROADMAP D1, kernel B5)")
    if mode != "q8_0":
        raise ValueError(f"unknown kv-quant storage mode {mode!r}")
    return mode


# ---------------------------------------------------------------------------
# plain PyTorch versions (the bounded-gather twins)
# ---------------------------------------------------------------------------

def _dequant(qs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """q8_0 tile loader: int8 values x per-row f32 scale."""
    return qs.to(torch.float32) * d.to(torch.float32)[..., None]


def _gathered_kv(kv: tuple, btj: torch.Tensor, quant: bool):
    if quant:
        kq, kd, vq, vd = kv
        return _dequant(kq[btj], kd[btj]), _dequant(vq[btj], vd[btj])
    return tuple(x[btj].to(torch.float32) for x in kv)


def attn_decode_plain(q, kv, pos_pool, block_table, pos, lane_pages, *,
                      window: int, softcap: float, scale: float, nj: int,
                      quant: bool) -> torch.Tensor:
    """Bounded-gather twin of the decode kernel (``_attn_core`` xla)."""
    b, h, d = q.shape
    tp, hkv = kv[0].shape[1], kv[0].shape[2]
    dv = (kv[2] if quant else kv[1]).shape[-1]
    btj = block_table[:, :nj].long()
    ks, vs = _gathered_kv(kv, btj, quant)
    ps = pos_pool[btj]                                       # (B, nj, P)
    # out-of-lane pages read as unwritten, as the kernel never visits them
    in_lane = (torch.arange(nj, device=q.device)[None, :, None]
               < lane_pages[:, None, None])
    ps = torch.where(in_lane, ps, torch.full_like(ps, -1))
    ks = ks.reshape(b, nj * tp, hkv, d)
    vs = vs.reshape(b, nj * tp, hkv, dv)
    ps = ps.reshape(b, nj * tp)
    rep = h // hkv
    qg = (q.to(torch.float32) * scale).reshape(b, hkv, rep, d)
    s = torch.einsum("bkrd,blkd->bkrl", qg, ks)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (ps >= 0) & (ps <= pos[:, None])
    if window:
        valid &= ps > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrl,blkd->bkrd", w, vs)
    return o.reshape(b, h, dv)


def attn_prefill_plain(q, kv, pos_pool, block_table, qpos, *, window: int,
                       softcap: float, scale: float, nj: int) -> torch.Tensor:
    """Bounded-gather twin of the prefill kernel (``_attn_prefill_core``
    xla), including the zeroing of fully masked (padded) rows."""
    b, c, h, d = q.shape
    tp, hkv = kv[0].shape[1], kv[0].shape[2]
    rep = h // hkv
    dv = kv[2].shape[-1]
    btj = block_table[:, :nj].long()
    ks, vs = _gathered_kv(kv, btj, True)
    ks = ks.reshape(b, nj * tp, hkv, d)
    vs = vs.reshape(b, nj * tp, hkv, dv)
    ps = pos_pool[btj].reshape(b, nj * tp)
    kidx = torch.arange(nj * tp, device=q.device)
    valid = ((ps[:, None, :] >= 0)
             & (ps[:, None, :] <= qpos[:, :, None])
             & (kidx[None, None, :] <= qpos[:, :, None]))
    if window:
        valid &= ps[:, None, :] > qpos[:, :, None] - window
    qg = (q.to(torch.float32) * scale).reshape(b, c, hkv, rep, d)
    s = torch.einsum("bckrd,blkd->bckrl", qg, ks)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    vmask = valid[:, :, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    # NEG_INF is finite, so a fully masked row softmaxes to uniform: zero it
    w = torch.where(vmask, w, torch.zeros_like(w))
    o = torch.einsum("bckrl,blkd->bckrd", w, vs)
    return o.reshape(b, c, h, dv)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry():
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("paged_attn", "paged_attn",
                      [i, v, v, v, v, v, v, v, v, v, v,
                       i, i, i, i, i, i, i, i, i, i, i, i, f, f, v])


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _launch(kind: int, q, k, v, kd, vd, pos_pool, block_table, qpos,
            lane_pages, *, c: int, nj: int, ct: int, window: int,
            logical_mask: int, scale: float, softcap: float) -> torch.Tensor:
    dev = q.device
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tp, dv = k.shape[2], k.shape[1], v.shape[-1]
    tensors = [q, k, v, pos_pool, block_table, qpos] + [
        t for t in (kd, vd, lane_pages) if t is not None]
    _require(all(t.device == dev for t in tensors),
             "paged attention operands must share one CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "paged attention operands must be contiguous")
    _require(h % hkv == 0, f"H={h} is not a multiple of Hkv={hkv}")
    _require(d <= 256 and dv <= 256, "head_dim must be <= 256")
    _require(k.shape[:3] == v.shape[:3], "K and V pools differ in layout")
    _require(pos_pool.shape == k.shape[:2], "pos_pool is not (num_pages, P)")
    _require(q.dtype == torch.float32, "q must be float32")
    for t in (pos_pool, block_table, qpos) + (
            () if lane_pages is None else (lane_pages,)):
        _require(t.dtype == torch.int32, "indices must be int32")
    out = torch.empty((b, c, h, dv), dtype=torch.float32, device=dev)
    err = _entry()(kind, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   build.ptr(kd), build.ptr(vd), pos_pool.data_ptr(),
                   block_table.data_ptr(), qpos.data_ptr(),
                   build.ptr(lane_pages), out.data_ptr(),
                   b, c, h, hkv, d, dv, tp, block_table.shape[1], nj, ct,
                   int(window), int(logical_mask), float(scale),
                   float(softcap), build.stream_ptr(dev))
    build.check(err, "paged_attn")
    return out


def _decode(q, kv, pos_pool, block_table, pos, lane_pages, *, window,
            softcap, scale, active_pages, quant: bool, counter):
    nj = _n_active(block_table, active_pages)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        lp = _lane_bound(lane_pages, q.shape[0], nj, q.device)
        return attn_decode_plain(q, kv, pos_pool, block_table, pos, lp,
                                 window=window, softcap=softcap, scale=scale,
                                 nj=nj, quant=quant)
    if quant:
        k, kd, v, vd = kv
        _require(k.dtype == torch.int8 and v.dtype == torch.int8
                 and kd.dtype == torch.float32 and vd.dtype == torch.float32,
                 "q8_0 pools are int8 values with float32 row scales")
        kind = _Q8
    else:
        (k, v), kd, vd = kv, None, None
        _require(k.dtype in _KV_KIND and v.dtype == k.dtype,
                 "K/V pools must be float32 or bfloat16")
        kind = _KV_KIND[k.dtype]
    lp = None if lane_pages is None else lane_pages.to(torch.int32)
    out = _launch(kind, q.to(torch.float32).contiguous(), k, v, kd, vd,
                  pos_pool, block_table, pos.to(torch.int32).contiguous(), lp,
                  c=1, nj=nj, ct=1, window=window, logical_mask=0,
                  scale=scale, softcap=softcap)
    counter.launches += 1
    return out[:, 0]


def paged_attn_decode(q, k_pool, v_pool, pos_pool, block_table, pos, *,
                      window: int = 0, softcap: float = 0.0,
                      scale: float | None = None,
                      active_pages: int | None = None,
                      lane_pages: torch.Tensor | None = None) -> torch.Tensor:
    """Fused one-token paged GQA decode over f32/bf16 pools (B2).

    q: (B, H, D) (RoPE applied, unscaled); k_pool/v_pool: (num_pages, P,
    Hkv, D[v]); pos: (B,) current absolute positions.  A key at stored
    position ``t`` is attendable iff ``0 <= t <= pos`` (and ``t > pos -
    window`` when ``window > 0``), within the lane's first
    ``lane_pages[i]`` logical pages.  Returns (B, H, Dv) f32.
    """
    return _decode(q, (k_pool, v_pool), pos_pool, block_table, pos,
                   lane_pages, window=window, softcap=softcap, scale=scale,
                   active_pages=active_pages, quant=False,
                   counter=paged_attn_decode)


def paged_attn_decode_quant(q, k_qs, k_d, v_qs, v_d, pos_pool, block_table,
                            pos, *, mode: str = "q8_0", window: int = 0,
                            softcap: float = 0.0, scale: float | None = None,
                            active_pages: int | None = None,
                            lane_pages: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """:func:`paged_attn_decode` over q8_0 pools (B3): int8 values and one
    f32 scale per (page, token, head) row, dequantized inside the page
    loop."""
    _check_mode(mode)
    return _decode(q, (k_qs, k_d, v_qs, v_d), pos_pool, block_table, pos,
                   lane_pages, window=window, softcap=softcap, scale=scale,
                   active_pages=active_pages, quant=True,
                   counter=paged_attn_decode_quant)


def paged_attn_prefill_quant(q, k_qs, k_d, v_qs, v_d, pos_pool, block_table,
                             qpos, *, mode: str = "q8_0", window: int = 0,
                             softcap: float = 0.0, scale: float | None = None,
                             active_pages: int | None = None) -> torch.Tensor:
    """Write-then-attend chunked prefill over q8_0 pools (B4).

    q: (B, C, H, D); qpos: (B, C) int32 query positions, -1 for padded
    rows (their outputs are zeros).  A key row is attendable for query
    (b, c) iff written, causal (``pos <= qpos``), inside the window when
    one applies, and its logical index is ``<= qpos``.  Returns
    (B, C, H, Dv) f32.
    """
    _check_mode(mode)
    nj = _n_active(block_table, active_pages)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kv = (k_qs, k_d, v_qs, v_d)
    if q.device.type == "cpu":
        return attn_prefill_plain(q, kv, pos_pool, block_table, qpos,
                                  window=window, softcap=softcap, scale=scale,
                                  nj=nj)
    _require(k_qs.dtype == torch.int8 and v_qs.dtype == torch.int8,
             "q8_0 pools are int8 values with float32 row scales")
    rep = q.shape[2] // k_qs.shape[2]
    ct = max(1, min(q.shape[1], _ROWS_PER_BLOCK // max(rep, 1)))
    out = _launch(_Q8, q.to(torch.float32).contiguous(), k_qs, v_qs, k_d,
                  v_d, pos_pool, block_table, qpos.to(torch.int32).contiguous(),
                  None, c=q.shape[1], nj=nj, ct=ct, window=window,
                  logical_mask=1, scale=scale, softcap=softcap)
    paged_attn_prefill_quant.launches += 1
    return out


paged_attn_decode.launches = 0
paged_attn_decode_quant.launches = 0
paged_attn_prefill_quant.launches = 0


# ---------------------------------------------------------------------------
# MLA: absorbed latent attention over c_kv / k_rope page pools (B6, B7)
# ---------------------------------------------------------------------------

_MLA_MAX_R, _MLA_MAX_DR = 512, 64     # the widths csrc/paged_mla.cu holds


def _gathered_latents(kv: tuple, btj: torch.Tensor, quant: bool):
    b, nj = btj.shape
    cs, ks = _gathered_kv(kv, btj, quant)
    return (cs.reshape(b, nj * cs.shape[2], cs.shape[3]),
            ks.reshape(b, nj * ks.shape[2], ks.shape[3]))


def mla_decode_plain(q_eff, q_rope, kv, block_table, pos, *, scale: float,
                     nj: int, quant: bool) -> torch.Tensor:
    """Bounded-gather twin of the MLA decode kernel (``_xla_mla``): one
    masked softmax over the first ``nj`` pages, valid iff the key's
    logical index is ``<= pos``."""
    cs, ks = _gathered_latents(kv, block_table[:, :nj].long(), quant)
    s = (torch.einsum("bhr,blr->bhl", q_eff.to(torch.float32), cs)
         + torch.einsum("bhd,bld->bhl", q_rope.to(torch.float32),
                        ks)) * scale
    valid = (torch.arange(cs.shape[1], device=cs.device)[None, :]
             <= pos[:, None])
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,blr->bhr", w, cs)


def mla_prefill_plain(q_eff, q_rope, kv, block_table, qpos, *, scale: float,
                      nj: int) -> torch.Tensor:
    """Bounded-gather twin of the MLA prefill kernel (``_mla_prefill_core``
    xla), including the zeroing of fully masked (padded) rows."""
    cs, ks = _gathered_latents(kv, block_table[:, :nj].long(), True)
    kidx = torch.arange(cs.shape[1], device=cs.device)
    valid = kidx[None, None, :] <= qpos[:, :, None]              # (B, C, L)
    s = (torch.einsum("bchr,blr->bchl", q_eff.to(torch.float32), cs)
         + torch.einsum("bchd,bld->bchl", q_rope.to(torch.float32),
                        ks)) * scale
    vmask = valid[:, :, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    w = torch.where(vmask, w, torch.zeros_like(w))
    return torch.einsum("bchl,blr->bchr", w, cs)


@functools.lru_cache(maxsize=None)
def _mla_entry():
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("paged_mla", "paged_mla",
                      [i, v, v, v, v, v, v, v, v, v, v,
                       i, i, i, i, i, i, i, i, f, i, v])


def _mla_launch(kind: int, q_eff, q_rope, ckv, krope, cd, kd, block_table,
                qpos, lane_pages, *, nj: int, scale: float,
                rw: int) -> torch.Tensor:
    """q_eff (B, C, H, R) / q_rope (B, C, H, Dr) in any float type (read
    as f32); returns (B, C, H, R) f32."""
    dev = q_eff.device
    b, c, h, r = q_eff.shape
    dr = q_rope.shape[-1]
    q_eff = q_eff.to(torch.float32).contiguous()
    q_rope = q_rope.to(torch.float32).contiguous()
    tensors = [q_eff, q_rope, ckv, krope, block_table, qpos] + [
        t for t in (cd, kd, lane_pages) if t is not None]
    _require(all(t.device == dev for t in tensors),
             "paged MLA operands must share one CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "paged MLA operands must be contiguous")
    _require(r <= _MLA_MAX_R and dr <= _MLA_MAX_DR,
             f"MLA widths must be R <= {_MLA_MAX_R}, Dr <= {_MLA_MAX_DR}")
    _require(ckv.shape[-1] == r and krope.shape[-1] == dr
             and ckv.shape[:2] == krope.shape[:2],
             "latent pools do not match the queries")
    _require(q_rope.shape[:3] == (b, c, h), "q_rope does not match q_eff")
    for t in (block_table, qpos) + (
            () if lane_pages is None else (lane_pages,)):
        _require(t.dtype == torch.int32, "indices must be int32")
    out = torch.empty((b, c, h, r), dtype=torch.float32, device=dev)
    err = _mla_entry()(kind, q_eff.data_ptr(), q_rope.data_ptr(),
                       ckv.data_ptr(), krope.data_ptr(), build.ptr(cd),
                       build.ptr(kd), block_table.data_ptr(), qpos.data_ptr(),
                       build.ptr(lane_pages), out.data_ptr(), b, c, h, r, dr,
                       ckv.shape[1], block_table.shape[1], nj, float(scale),
                       rw, build.stream_ptr(dev))
    build.check(err, "paged_mla")
    return out


def _mla_decode(q_eff, q_rope, kv, block_table, pos, lane_pages, *, scale,
                active_pages, quant: bool, counter):
    nj = _n_active(block_table, active_pages)
    if q_eff.device.type == "cpu":
        # the positional kidx <= pos mask already bounds every lane
        return mla_decode_plain(q_eff, q_rope, kv, block_table, pos,
                                scale=scale, nj=nj, quant=quant)
    if quant:
        cq, cd, kq, kd = kv
        _require(cq.dtype == torch.int8 and kq.dtype == torch.int8
                 and cd.dtype == torch.float32 and kd.dtype == torch.float32,
                 "q8_0 latent pools are int8 values with float32 scales")
        kind = _Q8
    else:
        (cq, kq), cd, kd = kv, None, None
        _require(cq.dtype in _KV_KIND and kq.dtype == cq.dtype,
                 "latent pools must be float32 or bfloat16")
        kind = _KV_KIND[cq.dtype]
    lp = None if lane_pages is None else lane_pages.to(torch.int32)
    out = _mla_launch(kind, q_eff[:, None], q_rope[:, None], cq, kq, cd, kd,
                      block_table, pos.to(torch.int32)[:, None].contiguous(),
                      lp, nj=nj, scale=scale, rw=1)
    counter.launches += 1
    return out[:, 0]


def paged_mla_decode(q_eff, q_rope, ckv_pool, krope_pool, block_table, pos,
                     *, scale: float, active_pages: int | None = None,
                     lane_pages: torch.Tensor | None = None) -> torch.Tensor:
    """Fused one-token paged MLA decode, absorbed form (B6).

    q_eff: (B, H, R) query pre-multiplied by the absorbed ``kv_b`` key
    projection; q_rope: (B, H, Dr); ckv_pool: (num_pages, P, R);
    krope_pool: (num_pages, P, Dr), f32 or bf16.  Entry ``j * P + o`` is
    valid iff its logical index is ``<= pos``; ``lane_pages`` bounds each
    lane's page loop.  Returns the attended latents (B, H, R) f32.
    """
    return _mla_decode(q_eff, q_rope, (ckv_pool, krope_pool), block_table,
                       pos, lane_pages, scale=scale,
                       active_pages=active_pages, quant=False,
                       counter=paged_mla_decode)


def paged_mla_decode_quant(q_eff, q_rope, ckv_qs, ckv_d, kr_qs, kr_d,
                           block_table, pos, *, scale: float,
                           latent_mode: str = "q8_0",
                           rope_mode: str = "q8_0",
                           active_pages: int | None = None,
                           lane_pages: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """:func:`paged_mla_decode` over q8_0 latent/rope pools (B6): int8
    values and one f32 scale per (page, token) row, dequantized inside the
    page loop."""
    _check_mode(latent_mode)
    _check_mode(rope_mode)
    return _mla_decode(q_eff, q_rope, (ckv_qs, ckv_d, kr_qs, kr_d),
                       block_table, pos, lane_pages, scale=scale,
                       active_pages=active_pages, quant=True,
                       counter=paged_mla_decode_quant)


def paged_mla_prefill_quant(q_eff, q_rope, ckv_qs, ckv_d, kr_qs, kr_d,
                            block_table, qpos, *, scale: float,
                            latent_mode: str = "q8_0",
                            rope_mode: str = "q8_0",
                            active_pages: int | None = None) -> torch.Tensor:
    """Write-then-attend chunked-prefill absorbed MLA over q8_0 latent
    pools (B7).

    q_eff: (B, C, H, R); q_rope: (B, C, H, Dr); qpos: (B, C) int32 query
    positions, -1 for padded rows (their outputs are zeros).  A latent
    token is valid for row (b, c) iff its logical index is ``<= qpos``.
    Returns (B, C, H, R) f32.
    """
    _check_mode(latent_mode)
    _check_mode(rope_mode)
    nj = _n_active(block_table, active_pages)
    kv = (ckv_qs, ckv_d, kr_qs, kr_d)
    if q_eff.device.type == "cpu":
        return mla_prefill_plain(q_eff, q_rope, kv, block_table, qpos,
                                 scale=scale, nj=nj)
    _require(ckv_qs.dtype == torch.int8 and kr_qs.dtype == torch.int8,
             "q8_0 latent pools are int8 values with float32 scales")
    out = _mla_launch(_Q8, q_eff, q_rope, ckv_qs, kr_qs, ckv_d, kr_d,
                      block_table, qpos.to(torch.int32).contiguous(), None,
                      nj=nj, scale=scale, rw=4)
    paged_mla_prefill_quant.launches += 1
    return out


paged_mla_decode.launches = 0
paged_mla_decode_quant.launches = 0
paged_mla_prefill_quant.launches = 0


# ---------------------------------------------------------------------------
# quantized K/V page pools
# ---------------------------------------------------------------------------

def quantize_kv_page_pool(pool: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """q8_0-style per-row quantization over the trailing axis.

    pool: (..., D) float -> (qs int8 same shape, d (...) f32), ``x ~ qs *
    d`` with ``d = max|x| / 127``.  Bitwise equal to the reference:
    ``torch.round`` is half-to-even like ``jnp.round``, and ``x / safe``
    stays a division.
    """
    x = pool.to(torch.float32)
    d = torch.amax(torch.abs(x), dim=-1) / 127.0
    safe = torch.clamp(d, min=1e-30)
    qs = torch.clamp(torch.round(x / safe[..., None]), -127, 127).to(
        torch.int8)
    return qs, d
