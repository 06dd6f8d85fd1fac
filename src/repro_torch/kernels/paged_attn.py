"""Kernels B2/B3 and B4 (paged GQA attention over KV page pools), B6/B7
(absorbed MLA over latent page pools) and their q4_0 tile loaders (B5).

Replace the Pallas TPU kernels ``repro/kernels/paged_attn.py::_attn_core``
(one-token flash-decode, f32, q8_0 and q4_0 tile loaders),
``::_attn_prefill_core`` (write-then-attend chunked prefill, q8_0 and q4_0
loaders), ``::_mla_core`` (absorbed-MLA decode, f32, q8_0 and q4_0
loaders, one mode per leaf) and ``::_mla_prefill_core`` (its
chunked-prefill form, q8_0 and q4_0 loaders).  The CUDA
kernels are ``csrc/paged_attn.cu`` and ``csrc/paged_mla.cu`` (their headers
say what bounds them on an H100 and how the designs answer that).  Beside
each wrapper is its plain PyTorch version, the reference's bounded-gather
twin: gather only the first ``active_pages`` logical pages through the
block table and run one masked softmax over them.

Both decode kernels (GQA and MLA) split each lane's page walk over the
blocks of a thread-block cluster and merge their partial softmax states in
one launch (:func:`decode_splits` and :func:`mla_decode_splits` size the
split from host integers only, so a decode step stays free of host
syncs).  Both prefill kernels run on tensor cores: each 32-key tile is
converted once into exact bf16 codes, S and P . V are bf16
``mma.sync.m16n8k16`` products with the tokens' scales applied in f32 (the
GQA one's f32 queries: the dequantized values as three bf16 terms, the
plain version's function to f32 rounding), and the GQA one splits its key
walk over a cluster the same way where its blocks are few
(:func:`attn_prefill_tiles`).

Layouts are the reference's: GQA pools ``(num_pages, P, Hkv, D)``,
quantized row scales ``(num_pages, P, Hkv)``, ``pos_pool (num_pages, P)``
int32 (-1 = unwritten); MLA pools ``(num_pages, P, R)`` and ``(num_pages,
P, Dr)`` with token scales ``(num_pages, P)`` and no positions (validity
is positional); block tables ``(B, n)`` int32.  A q4_0 leaf packs two
signed nibbles a byte along its trailing axis (element 2i in the low
nibble of byte i), so it is half the logical width.  Dispatch is by device
only: CPU tensors take the plain version, CUDA tensors launch the kernel
or raise.  Each public wrapper's ``launches`` counts its kernel launches;
the quantized wrappers also count them per tile loader in ``loaders``
(keyed by the mode, or by the MLA ``(latent, rope)`` mode pair).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -2.0e38
# the kernels' loader ids: model-dtype pages, and the quantized modes
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1}
_QUANT_KIND = {"q8_0": 2, "q4_0": 3}
KV_MODES = tuple(_QUANT_KIND)
# the (latent, rope) mode pairs csrc/paged_mla.cu instantiates: uniform
# pools, and "dq"'s q8_0 latents beside q4_0 rope keys
MLA_MODE_PAIRS = (("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q8_0", "q4_0"))


class Launches:
    """A launch count of one tile loader of a quantized wrapper."""

    def __init__(self):
        self.launches = 0


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
    if mode not in _QUANT_KIND:
        raise ValueError(f"unknown kv-quant storage mode {mode!r}")
    return mode


def _width(stored: int, mode) -> int:
    """Logical row width of a leaf whose stored trailing dim is ``stored``
    (a q4_0 leaf holds two values a byte)."""
    return 2 * stored if mode == "q4_0" else stored


# ---------------------------------------------------------------------------
# plain PyTorch versions (the bounded-gather twins)
# ---------------------------------------------------------------------------

def _dequant(qs: torch.Tensor, d: torch.Tensor, mode: str) -> torch.Tensor:
    """Tile loader: int8 values x per-row f32 scale; a q4_0 leaf is first
    unpacked (:func:`unpack_q4_rows`), so its trailing axis doubles."""
    if mode == "q4_0":
        qs = unpack_q4_rows(qs)
    return qs.to(torch.float32) * d.to(torch.float32)[..., None]


def _gathered_kv(kv: tuple, btj: torch.Tensor, quant):
    """Both leaves of ``kv`` gathered through ``btj`` as f32.  ``quant`` is
    None (model-dtype leaves), one mode for both leaves, or a per-leaf
    ``(mode_a, mode_b)`` pair (MLA latent / rope under "dq")."""
    if quant:
        ma, mb = (quant, quant) if isinstance(quant, str) else quant
        aq, ad, bq, bd = kv
        return _dequant(aq[btj], ad[btj], ma), _dequant(bq[btj], bd[btj], mb)
    return tuple(x[btj].to(torch.float32) for x in kv)


def attn_decode_plain(q, kv, pos_pool, block_table, pos, lane_pages, *,
                      window: int, softcap: float, scale: float, nj: int,
                      quant: str | None) -> torch.Tensor:
    """Bounded-gather twin of the decode kernel (``_attn_core`` xla);
    ``quant`` is None (model-dtype pools) or the pools' mode."""
    b, h, d = q.shape
    tp, hkv = kv[0].shape[1], kv[0].shape[2]
    dv = _width((kv[2] if quant else kv[1]).shape[-1], quant)
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
                       softcap: float, scale: float, nj: int,
                       quant: str = "q8_0") -> torch.Tensor:
    """Bounded-gather twin of the prefill kernel (``_attn_prefill_core``
    xla), including the zeroing of fully masked (padded) rows."""
    b, c, h, d = q.shape
    tp, hkv = kv[0].shape[1], kv[0].shape[2]
    rep = h // hkv
    dv = _width(kv[2].shape[-1], quant)
    btj = block_table[:, :nj].long()
    ks, vs = _gathered_kv(kv, btj, quant)
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
def _prefill_entry():
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("paged_attn", "paged_attn_prefill",
                      [i, i, v, v, v, v, v, v, v, v, v,
                       i, i, i, i, i, i, i, i, i, i, i, f, f, v])


@functools.lru_cache(maxsize=None)
def _decode_entry():
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("paged_attn", "paged_attn_decode",
                      [i, v, v, v, v, v, v, v, v, v, v,
                       i, i, i, i, i, i, i, i, i, i, i, f, f, v])


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


# csrc/paged_attn.cu's decode kernel: blocks a cluster (MAX_SPLITS, the
# portable cluster size), query heads a block (RMAX) and tokens a page
_MAX_SPLITS = 8
_DECODE_ROWS = 8
_DECODE_MAX_P = 128



def decode_splits(nj: int, blocks: int, sms: int) -> tuple[int, int]:
    """How the decode kernel splits a walk over ``nj`` logical pages when
    ``blocks`` (lanes x kv heads x row tiles) clusters share ``sms`` SMs:
    ``(splits, pages_per_split)``, enough splits for about one block per
    SM, at most ``_MAX_SPLITS`` and ``nj``, and no split left without a
    page of the ``nj`` (a lane's own bound may still leave a split empty)."""
    want = max(1, -(-sms // max(blocks, 1)))
    s = max(1, min(want, _MAX_SPLITS, nj))
    pps = -(-nj // s)
    return -(-nj // pps), pps


def _check_gqa(q, k, v, kd, vd, pos_pool, block_table, qpos, lane_pages,
               dv: int) -> None:
    """The operand checks of both GQA kernels; ``qpos`` holds the query
    positions ((B,) at decode, (B, C) at prefill); q is f32 (prefill: or
    bf16)."""
    dev = q.device
    h, d, hkv = q.shape[-2], q.shape[-1], k.shape[2]
    indices = [t for t in (pos_pool, block_table, qpos, lane_pages)
               if t is not None]
    tensors = [q, k, v] + [t for t in (kd, vd) if t is not None] + indices
    _require(all(t.device == dev for t in tensors),
             "paged attention operands must share one CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "paged attention operands must be contiguous")
    _require(h % hkv == 0, f"H={h} is not a multiple of Hkv={hkv}")
    _require(d <= 256 and dv <= 256, "head_dim must be <= 256")
    _require(k.shape[:3] == v.shape[:3], "K and V pools differ in layout")
    _require(pos_pool.shape == k.shape[:2], "pos_pool is not (num_pages, P)")
    _require(q.dtype in _KV_KIND, "q must be float32 or bfloat16")
    _require(all(t.dtype == torch.int32 for t in indices),
             "indices must be int32")


def _launch_decode(kind: int, q, k, v, kd, vd, pos_pool, block_table, pos,
                   lane_pages, *, dv: int, nj: int, window: int,
                   scale: float, softcap: float) -> torch.Tensor:
    """``paged_attn_decode_kernel``: q (B, H, D) -> (B, H, Dv)."""
    _check_gqa(q, k, v, kd, vd, pos_pool, block_table, pos, lane_pages, dv)
    dev = q.device
    b, h, d = q.shape
    hkv, tp = k.shape[2], k.shape[1]
    _require(d % 8 == 0 and dv % 8 == 0,
             f"the decode kernel takes head widths that are multiples of 8, "
             f"got D={d}, Dv={dv}")
    _require(tp <= _DECODE_MAX_P,
             f"the decode kernel takes pages of at most {_DECODE_MAX_P} "
             f"tokens, got {tp}")
    _require(all(t.data_ptr() % 4 == 0 for t in (k, v)),
             "K/V pools must be 4-byte aligned")
    splits, pps = decode_splits(
        nj, b * hkv * -(-(h // hkv) // _DECODE_ROWS), build.sm_count(dev))
    out = torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    err = _decode_entry()(kind, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          build.ptr(kd), build.ptr(vd), pos_pool.data_ptr(),
                          block_table.data_ptr(), pos.data_ptr(),
                          build.ptr(lane_pages), out.data_ptr(),
                          b, h, hkv, d, dv, tp, block_table.shape[1], nj,
                          splits, pps, int(window), float(scale),
                          float(softcap), build.stream_ptr(dev))
    build.check(err, "paged_attn_decode")
    return out


# csrc/paged_attn.cu's prefill kernel: (query, rep head) rows a block
# holds, and the keys of a tile
_PREFILL_ROWS = 64
_PREFILL_KEYS = 32


def attn_prefill_tiles(b: int, c: int, h: int, hkv: int, *, nj: int,
                       page_size: int, sms: int) -> tuple[int, int]:
    """The GQA prefill kernel's grid from host integers: its row tiles per
    (lane, kv head) (64 of the ``c * h / hkv`` (query, rep head) rows
    each, a block each), and the blocks of a cluster that split each row
    tile's key tiles: enough for about two blocks per SM over the ``b *
    hkv * row_tiles`` clusters, at most 8 (the portable cluster size) and
    the 32-key tiles of ``nj`` pages.  The kernel walks a row tile's keys
    up to its rows' largest position (read on the card) and splits those
    tiles evenly, in rank order (``csrc/paged_attn.cu``).  On one H100
    80GB HBM3 at 700 W qwen2's 4 x 128-token chunk (96 clusters) ran
    0.060 ms at clusters of 3 blocks, 0.077 at 2 and 0.123 at 1
    (``PERF.md``)."""
    tiles = -(-c * (h // hkv) // _PREFILL_ROWS)
    want = -(-2 * sms // max(b * hkv * tiles, 1))
    keys = -(-nj * page_size // _PREFILL_KEYS)
    return tiles, max(1, min(want, _MAX_SPLITS, keys))


def _launch_prefill(kind: int, q, k, v, kd, vd, pos_pool, block_table,
                    qpos, *, dv: int, nj: int, window: int, scale: float,
                    softcap: float) -> torch.Tensor:
    """``paged_attn_prefill_kernel``: q (B, C, H, D), f32 or bf16 (read
    as it is) -> (B, C, H, Dv) f32."""
    _check_gqa(q, k, v, kd, vd, pos_pool, block_table, qpos, None, dv)
    dev = q.device
    b, c, h, d = q.shape
    hkv, tp = k.shape[2], k.shape[1]
    _require(d % 8 == 0 and dv % 8 == 0,
             f"the prefill kernel takes head widths that are multiples of "
             f"8, got D={d}, Dv={dv}")
    _, splits = attn_prefill_tiles(b, c, h, hkv, nj=nj, page_size=tp,
                                   sms=build.sm_count(dev))
    out = torch.empty((b, c, h, dv), dtype=torch.float32, device=dev)
    err = _prefill_entry()(kind, int(q.dtype == torch.bfloat16),
                           q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           build.ptr(kd), build.ptr(vd), pos_pool.data_ptr(),
                           block_table.data_ptr(), qpos.data_ptr(),
                           out.data_ptr(), b, c, h, hkv, d, dv, tp,
                           block_table.shape[1], nj, splits, int(window),
                           float(scale), float(softcap),
                           build.stream_ptr(dev))
    build.check(err, "paged_attn_prefill")
    return out


def _check_quant_pair(qs, d, width: int, mode: str, what: str) -> None:
    """A quantized leaf pair as the kernels take it: int8 values of
    ``width`` logical columns (``width / 2`` bytes for q4_0, which needs an
    even width) and one f32 scale per row."""
    _require(qs.dtype == torch.int8 and d.dtype == torch.float32,
             f"{mode} {what} pools are int8 values with float32 row scales")
    _require(mode != "q4_0" or width % 2 == 0,
             f"q4_0 {what} rows need an even width, got {width}")
    _require(_width(qs.shape[-1], mode) == width,
             f"{mode} {what} pool is {qs.shape[-1]} wide, not "
             f"{width // 2 if mode == 'q4_0' else width} for {width} values")
    _require(d.shape == qs.shape[:-1],
             f"{what} scales are not one per stored row")


def _quant_kv(q, kv, mode: str):
    """Validated quantized K/V leaves -> (kind, k, kd, v, vd, Dv)."""
    k, kd, v, vd = kv
    _check_quant_pair(k, kd, q.shape[-1], mode, "K")
    dv = _width(v.shape[-1], mode)
    _check_quant_pair(v, vd, dv, mode, "V")
    return _QUANT_KIND[mode], k, kd, v, vd, dv


def _count(counter, key) -> None:
    counter.launches += 1
    if key is not None:
        counter.loaders[key].launches += 1


def _decode(q, kv, pos_pool, block_table, pos, lane_pages, *, window,
            softcap, scale, active_pages, quant: str | None, counter):
    nj = _n_active(block_table, active_pages)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        lp = _lane_bound(lane_pages, q.shape[0], nj, q.device)
        return attn_decode_plain(q, kv, pos_pool, block_table, pos, lp,
                                 window=window, softcap=softcap, scale=scale,
                                 nj=nj, quant=quant)
    if quant:
        kind, k, kd, v, vd, dv = _quant_kv(q, kv, quant)
    else:
        (k, v), kd, vd = kv, None, None
        _require(k.dtype in _KV_KIND and v.dtype == k.dtype,
                 "K/V pools must be float32 or bfloat16")
        _require(k.shape[-1] == q.shape[-1], "K pool width differs from q")
        kind, dv = _KV_KIND[k.dtype], v.shape[-1]
    lp = None if lane_pages is None else lane_pages.to(torch.int32)
    out = _launch_decode(kind, q.to(torch.float32).contiguous(), k, v, kd, vd,
                         pos_pool, block_table,
                         pos.to(torch.int32).contiguous(), lp, dv=dv, nj=nj,
                         window=window, scale=scale, softcap=softcap)
    _count(counter, quant)
    return out


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
                   active_pages=active_pages, quant=None,
                   counter=paged_attn_decode)


def paged_attn_decode_quant(q, k_qs, k_d, v_qs, v_d, pos_pool, block_table,
                            pos, *, mode: str = "q8_0", window: int = 0,
                            softcap: float = 0.0, scale: float | None = None,
                            active_pages: int | None = None,
                            lane_pages: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """:func:`paged_attn_decode` over quantized pools: q8_0 (B3) or
    nibble-packed q4_0 (B5), int8 values (trailing axis halved for q4_0)
    and one f32 scale per (page, token, head) row, dequantized inside the
    page loop."""
    return _decode(q, (k_qs, k_d, v_qs, v_d), pos_pool, block_table, pos,
                   lane_pages, window=window, softcap=softcap, scale=scale,
                   active_pages=active_pages, quant=_check_mode(mode),
                   counter=paged_attn_decode_quant)


def paged_attn_prefill_quant(q, k_qs, k_d, v_qs, v_d, pos_pool, block_table,
                             qpos, *, mode: str = "q8_0", window: int = 0,
                             softcap: float = 0.0, scale: float | None = None,
                             active_pages: int | None = None) -> torch.Tensor:
    """Write-then-attend chunked prefill over q8_0 (B4) or q4_0 (B5)
    pools.

    q: (B, C, H, D), any float type (the kernel reads bf16 queries as
    they are, others as f32); qpos: (B, C) int32 query positions, -1 for
    padded rows (their outputs are zeros).  A key row is attendable for
    query (b, c) iff written, causal (``pos <= qpos``), inside the window
    when one applies, and its logical index is ``<= qpos``.  Returns
    (B, C, H, Dv) f32.
    """
    _check_mode(mode)
    nj = _n_active(block_table, active_pages)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kv = (k_qs, k_d, v_qs, v_d)
    if q.device.type == "cpu":
        return attn_prefill_plain(q, kv, pos_pool, block_table, qpos,
                                  window=window, softcap=softcap, scale=scale,
                                  nj=nj, quant=mode)
    kind, k, kd, v, vd, dv = _quant_kv(q, kv, mode)
    qt = q if q.dtype == torch.bfloat16 else q.to(torch.float32)
    out = _launch_prefill(kind, qt.contiguous(), k, v, kd, vd, pos_pool,
                          block_table, qpos.to(torch.int32).contiguous(),
                          dv=dv, nj=nj, window=window, scale=scale,
                          softcap=softcap)
    _count(paged_attn_prefill_quant, mode)
    return out


paged_attn_decode.launches = 0
paged_attn_decode_quant.launches = 0
paged_attn_prefill_quant.launches = 0
paged_attn_decode_quant.loaders = {m: Launches() for m in KV_MODES}
paged_attn_prefill_quant.loaders = {m: Launches() for m in KV_MODES}


# ---------------------------------------------------------------------------
# MLA: absorbed latent attention over c_kv / k_rope page pools (B6, B7)
# ---------------------------------------------------------------------------

_MLA_MAX_R, _MLA_MAX_DR = 512, 64     # the widths csrc/paged_mla.cu holds


def _gathered_latents(kv: tuple, btj: torch.Tensor, quant):
    b, nj = btj.shape
    cs, ks = _gathered_kv(kv, btj, quant)
    return (cs.reshape(b, nj * cs.shape[2], cs.shape[3]),
            ks.reshape(b, nj * ks.shape[2], ks.shape[3]))


def mla_decode_plain(q_eff, q_rope, kv, block_table, pos, *, scale: float,
                     nj: int, quant) -> torch.Tensor:
    """Bounded-gather twin of the MLA decode kernel (``_xla_mla``): one
    masked softmax over the first ``nj`` pages, valid iff the key's
    logical index is ``<= pos``.  ``quant``: None (model-dtype pools) or
    the ``(latent, rope)`` modes (one string for both)."""
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
                      nj: int, quant=("q8_0", "q8_0")) -> torch.Tensor:
    """Bounded-gather twin of the MLA prefill kernel (``_mla_prefill_core``
    xla), including the zeroing of fully masked (padded) rows."""
    cs, ks = _gathered_latents(kv, block_table[:, :nj].long(), quant)
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
def _mla_prefill_entry():
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("paged_mla", "paged_mla_prefill",
                      [i, i, i, v, v, v, v, v, v, v, v, v,
                       i, i, i, i, i, i, i, i, f, v])


@functools.lru_cache(maxsize=None)
def _mla_decode_entry():
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("paged_mla", "paged_mla_decode",
                      [i, i, i, v, v, v, v, v, v, v, v, v, v,
                       i, i, i, i, i, i, i, i, f, v])


# csrc/paged_mla.cu's decode kernel: query heads a block, and the blocks
# that are resident on one SM at once, in tenths: two an SM by its shared
# memory (bf16 and quantized pools), less a margin for the GPCs whose SMs
# no whole cluster fills (on an H100, 30 clusters of 8 are resident, not
# 33), so that every cluster of a launch runs in one wave
_MLA_HEADS = 16
_MLA_RESIDENT_TENTHS = 18


def mla_decode_splits(nj: int, b: int, h: int, sms: int) -> int:
    """Blocks a cluster of the MLA decode kernel, for ``b`` lanes of ``h``
    heads (a cluster per lane and 16-head tile) over ``nj`` logical pages
    on ``sms`` SMs, from host integers only: as many as keep every cluster
    resident at once, at most 8 (the portable cluster size) and ``nj``.
    The kernel splits each lane's valid tokens over them in 16-token
    tiles, evenly, in rank order (``csrc/paged_mla.cu``)."""
    clusters = b * -(-h // _MLA_HEADS)
    want = _MLA_RESIDENT_TENTHS * sms // (10 * clusters)
    return max(1, min(want, _MAX_SPLITS, nj))


# csrc/paged_mla.cu's prefill kernel: query rows (heads of one token) a
# block holds, by query type, and the keys of a tile
_MLA_PREFILL_ROWS = {torch.bfloat16: 64, torch.float32: 32}
_MLA_PREFILL_KEYS = 32


def mla_prefill_tiles(qpos: torch.Tensor, h: int, *, page_size: int,
                      nj: int, q_dtype) -> tuple[int, torch.Tensor]:
    """The prefill kernel's work from host integers: its head tiles per
    query token (a block each), and per token (B, C) the key tiles its
    blocks walk, ``ceil(min(qpos + 1, nj * P) / 32)`` (0 for a padded
    row).  bf16 queries take 64-head tiles, others 32."""
    rows = _MLA_PREFILL_ROWS[torch.bfloat16 if q_dtype == torch.bfloat16
                             else torch.float32]
    keys = torch.clamp(qpos.to(torch.int64) + 1, 0, nj * page_size)
    return -(-h // rows), -(-keys // _MLA_PREFILL_KEYS)


def _mla_operands(q_eff, q_rope, ckv, krope, cd, kd, block_table, qpos,
                  lane_pages):
    """The checks both MLA kernels share; q_eff / q_rope (any float type)
    come back contiguous, as f32 unless both are bf16 (the kernels read
    bf16 queries as they are)."""
    dev = q_eff.device
    r, dr = q_eff.shape[-1], q_rope.shape[-1]
    dt = (torch.bfloat16 if q_eff.dtype == torch.bfloat16
          and q_rope.dtype == torch.bfloat16 else torch.float32)
    q_eff = q_eff.to(dt).contiguous()
    q_rope = q_rope.to(dt).contiguous()
    tensors = [q_eff, q_rope, ckv, krope, block_table, qpos] + [
        t for t in (cd, kd, lane_pages) if t is not None]
    _require(all(t.device == dev for t in tensors),
             "paged MLA operands must share one CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "paged MLA operands must be contiguous")
    _require(r <= _MLA_MAX_R and dr <= _MLA_MAX_DR,
             f"MLA widths must be R <= {_MLA_MAX_R}, Dr <= {_MLA_MAX_DR}")
    _require(ckv.shape[:2] == krope.shape[:2],
             "latent and rope pools differ in layout")
    _require(q_rope.shape[:-1] == q_eff.shape[:-1],
             "q_rope does not match q_eff")
    for t in (block_table, qpos) + (
            () if lane_pages is None else (lane_pages,)):
        _require(t.dtype == torch.int32, "indices must be int32")
    return q_eff, q_rope


def _mla_prefill_launch(kinds: tuple, q_eff, q_rope, ckv, krope, cd, kd,
                        block_table, qpos, *, nj: int,
                        scale: float) -> torch.Tensor:
    """``paged_mla_prefill_kernel``: q_eff (B, C, H, R) / q_rope (B, C, H,
    Dr) in any float type (read as f32; bf16 ones as they are); ``kinds``:
    the latent and rope leaves' loader ids.  Returns (B, C, H, R) f32."""
    q_eff, q_rope = _mla_operands(q_eff, q_rope, ckv, krope, cd, kd,
                                  block_table, qpos, None)
    b, c, h, r = q_eff.shape
    out = torch.empty((b, c, h, r), dtype=torch.float32, device=q_eff.device)
    err = _mla_prefill_entry()(
        kinds[0], kinds[1], int(q_eff.dtype == torch.bfloat16),
        q_eff.data_ptr(), q_rope.data_ptr(),
        ckv.data_ptr(), krope.data_ptr(), build.ptr(cd), build.ptr(kd),
        block_table.data_ptr(), qpos.data_ptr(), out.data_ptr(), b, c, h, r,
        q_rope.shape[-1], ckv.shape[1], block_table.shape[1], nj,
        float(scale), build.stream_ptr(q_eff.device))
    build.check(err, "paged_mla_prefill")
    return out


def _mla_decode_launch(kinds: tuple, q_eff, q_rope, ckv, krope, cd, kd,
                       block_table, pos, lane_pages, *, nj: int,
                       scale: float) -> torch.Tensor:
    """``paged_mla_decode_kernel``: q_eff (B, H, R) / q_rope (B, H, Dr) in
    any float type (read as f32; bf16 ones as they are), pos (B,).
    Returns (B, H, R) f32."""
    q_eff, q_rope = _mla_operands(q_eff, q_rope, ckv, krope, cd, kd,
                                  block_table, pos, lane_pages)
    dev = q_eff.device
    b, h, r = q_eff.shape
    splits = mla_decode_splits(nj, b, h, build.sm_count(dev))
    out = torch.empty((b, h, r), dtype=torch.float32, device=dev)
    err = _mla_decode_entry()(
        kinds[0], kinds[1], int(q_eff.dtype == torch.bfloat16),
        q_eff.data_ptr(), q_rope.data_ptr(),
        ckv.data_ptr(), krope.data_ptr(), build.ptr(cd), build.ptr(kd),
        block_table.data_ptr(), pos.data_ptr(), build.ptr(lane_pages),
        out.data_ptr(), b, h, r, q_rope.shape[-1], ckv.shape[1],
        block_table.shape[1], nj, splits, float(scale),
        build.stream_ptr(dev))
    build.check(err, "paged_mla_decode")
    return out


def _mla_leaves(q_eff, q_rope, kv, quant):
    """Validated latent / rope leaves -> (kinds, ckv, cd, krope, kd)."""
    if quant is None:
        (ckv, krope), cd, kd = kv, None, None
        _require(ckv.dtype in _KV_KIND and krope.dtype == ckv.dtype,
                 "latent pools must be float32 or bfloat16")
        _require(ckv.shape[-1] == q_eff.shape[-1]
                 and krope.shape[-1] == q_rope.shape[-1],
                 "latent pools do not match the queries")
        kind = _KV_KIND[ckv.dtype]
        return (kind, kind), ckv, cd, krope, kd
    _require(quant in MLA_MODE_PAIRS,
             f"no MLA kernel holds (latent, rope) modes {quant}; supported: "
             f"{MLA_MODE_PAIRS}")
    ckv, cd, krope, kd = kv
    _check_quant_pair(ckv, cd, q_eff.shape[-1], quant[0], "latent")
    _check_quant_pair(krope, kd, q_rope.shape[-1], quant[1], "rope")
    return (_QUANT_KIND[quant[0]], _QUANT_KIND[quant[1]]), ckv, cd, krope, kd


def _mla_decode(q_eff, q_rope, kv, block_table, pos, lane_pages, *, scale,
                active_pages, quant, counter):
    nj = _n_active(block_table, active_pages)
    if q_eff.device.type == "cpu":
        # the positional kidx <= pos mask already bounds every lane
        return mla_decode_plain(q_eff, q_rope, kv, block_table, pos,
                                scale=scale, nj=nj, quant=quant)
    kinds, cq, cd, kq, kd = _mla_leaves(q_eff, q_rope, kv, quant)
    lp = None if lane_pages is None else lane_pages.to(torch.int32)
    out = _mla_decode_launch(kinds, q_eff, q_rope, cq, kq, cd, kd,
                             block_table, pos.to(torch.int32).contiguous(),
                             lp, nj=nj, scale=scale)
    _count(counter, quant)
    return out


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
                       active_pages=active_pages, quant=None,
                       counter=paged_mla_decode)


def paged_mla_decode_quant(q_eff, q_rope, ckv_qs, ckv_d, kr_qs, kr_d,
                           block_table, pos, *, scale: float,
                           latent_mode: str = "q8_0",
                           rope_mode: str = "q8_0",
                           active_pages: int | None = None,
                           lane_pages: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """:func:`paged_mla_decode` over quantized latent/rope pools (B6, and
    its q4_0 loaders B5): int8 values (a q4_0 leaf nibble-packed, its
    trailing axis halved) and one f32 scale per (page, token) row,
    dequantized inside the page loop.  ``latent_mode`` and ``rope_mode``
    may differ: "dq" keeps q8_0 latents beside q4_0 rope keys."""
    quant = (_check_mode(latent_mode), _check_mode(rope_mode))
    return _mla_decode(q_eff, q_rope, (ckv_qs, ckv_d, kr_qs, kr_d),
                       block_table, pos, lane_pages, scale=scale,
                       active_pages=active_pages, quant=quant,
                       counter=paged_mla_decode_quant)


def paged_mla_prefill_quant(q_eff, q_rope, ckv_qs, ckv_d, kr_qs, kr_d,
                            block_table, qpos, *, scale: float,
                            latent_mode: str = "q8_0",
                            rope_mode: str = "q8_0",
                            active_pages: int | None = None) -> torch.Tensor:
    """Write-then-attend chunked-prefill absorbed MLA over quantized latent
    pools (B7, and its q4_0 loaders B5); the modes as in
    :func:`paged_mla_decode_quant`.

    q_eff: (B, C, H, R); q_rope: (B, C, H, Dr); qpos: (B, C) int32 query
    positions, -1 for padded rows (their outputs are zeros).  A latent
    token is valid for row (b, c) iff its logical index is ``<= qpos``.
    Returns (B, C, H, R) f32.
    """
    quant = (_check_mode(latent_mode), _check_mode(rope_mode))
    nj = _n_active(block_table, active_pages)
    kv = (ckv_qs, ckv_d, kr_qs, kr_d)
    if q_eff.device.type == "cpu":
        return mla_prefill_plain(q_eff, q_rope, kv, block_table, qpos,
                                 scale=scale, nj=nj, quant=quant)
    kinds, cq, cd, kq, kd = _mla_leaves(q_eff, q_rope, kv, quant)
    out = _mla_prefill_launch(kinds, q_eff, q_rope, cq, kq, cd, kd,
                              block_table, qpos.to(torch.int32).contiguous(),
                              nj=nj, scale=scale)
    _count(paged_mla_prefill_quant, quant)
    return out


paged_mla_decode.launches = 0
paged_mla_decode_quant.launches = 0
paged_mla_prefill_quant.launches = 0
paged_mla_decode_quant.loaders = {m: Launches() for m in MLA_MODE_PAIRS}
paged_mla_prefill_quant.loaders = {m: Launches() for m in MLA_MODE_PAIRS}


# ---------------------------------------------------------------------------
# quantized K/V page pools: q8_0, and nibble-packed q4_0
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


def pack_q4_rows(qs: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 rows two a byte along the trailing axis.

    qs: (..., D) int8, every value in [-8, 7]; D must be even.  Byte ``i``
    holds element ``2i`` in its low nibble and ``2i + 1`` in its high
    nibble (GGUF's q4_0 order).  int8 ``<<`` wraps, as ``jnp``'s does.
    """
    width = qs.shape[-1]
    if width % 2:
        raise ValueError(f"q4_0 packing needs an even trailing dim; "
                         f"got {width}")
    lo = torch.bitwise_and(qs[..., 0::2], 0x0F)
    hi = torch.bitwise_left_shift(qs[..., 1::2], 4)
    return torch.bitwise_or(lo, hi).to(torch.int8)


def unpack_q4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Invert :func:`pack_q4_rows`: (..., D/2) int8 -> (..., D) int8.
    ``(b << 4) >> 4`` sign-extends the low nibble, ``b >> 4`` the high one
    (arithmetic shifts on int8)."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])


def quantize_kv_page_pool_q4(pool: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """q4_0-style per-row quantization: symmetric int4 in [-7, 7], ``d =
    max|x| / 7``, nibble-packed (:func:`pack_q4_rows`), so the stored
    trailing axis is ``D // 2``.  Bitwise equal to the reference."""
    x = pool.to(torch.float32)
    d = torch.amax(torch.abs(x), dim=-1) / 7.0
    safe = torch.clamp(d, min=1e-30)
    qs = torch.clamp(torch.round(x / safe[..., None]), -7, 7).to(torch.int8)
    return pack_q4_rows(qs), d
