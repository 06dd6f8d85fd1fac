// Absorbed multi-head latent attention (DeepSeek MLA) over paged latent
// pools, for Hopper: one-token decode and write-then-attend chunked prefill.
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attn.py::_mla_core
// (body :566-589; entries paged_mla_decode :438 and paged_mla_decode_quant
// :468) with its f32, q8_0 and q4_0 tile loaders, and ::_mla_prefill_core
// (body :1011-1036; entry paged_mla_prefill_quant :950) with the q8_0 and
// q4_0 loaders.  As there, the latent and rope leaves each have their own
// mode: the "dq" cache policy keeps q8_0 latents beside q4_0 rope keys, so
// each kernel takes one loader per leaf and one launch reads both.
// Every query row r = (c, h) scores s = (q_eff . c_kv + q_rope . k_rope) *
// scale against the lane's latent tokens, a token valid iff its logical
// index is <= the row's position, and returns the attended latents p . c_kv
// (B, C, H, R) in f32; the caller projects them out with W_vb.
//
// What bounds it on an H100: decode reads each live latent token once per
// lane (R + Dr values: 1,152 B in bf16; with the two f32 scales 584 B in
// q8_0, 296 B in q4_0, 552 B for dq's q8_0 latent and q4_0 rope) and does
// ~2 (2R + Dr) flops per head per token, 128 heads: ~240 flops per byte in
// bf16, so its bound is the f32 FMAs (4 lanes of 100-400 tokens: 0.0044 ms
// at the 67 TFLOP/s CUDA-core peak), and the latent pages of a step are a
// few MB that sit in L2.  Prefill (C = 128 queries x 128 heads per lane,
// ~28 GFLOP per layer per chunk at ~200 keys per query) is bound by its
// operations: >= 0.4 ms as f32 FMAs, ~0.03 ms at the bf16 tensor-core
// peak.
//
// Decode design (paged_mla_decode_kernel).  The TPU grid (lane, logical
// page) runs in order and carries (m, l, acc) in VMEM across page steps.
// Here a thread-block cluster per (lane, tile of HT = 16 query heads) holds
// ``splits`` blocks (flash-decoding).  The lane's valid tokens (its first
// lane_pages logical pages, cut at the query position: tokens past it are
// masked, so the cut is an exact no-op) are split evenly, in tiles of TT =
// 16 tokens, over the blocks, each walking its own run of tiles (a run may
// start or end inside a page); the split is read on the card, so the host
// sizes only the cluster.  Inside a block, tile by tile:
//  - the block's 16 query rows are read once (f32, or bf16 as the model
//    passes them) into an f32 tile;
//  - the tile's latent and rope rows come into one shared-memory stage as
//    stored (16-byte cp.async copies where the rows and pools allow, 4-byte
//    ones, or plain byte copies for rows of an odd size such as a q4_0 rope
//    row of 7 bytes), with their f32 token scales; the next tile's copies
//    are in flight while this tile is used;
//  - the stage is converted once into an f32 tile of [c_kv | k_rope] rows
//    (bf16 by a shift, q8_0 int8 x the token's f32 scale, q4_0 the
//    sign-extended nibble x the scale: one f32 multiply, as the plain
//    version, so every element is bitwise its value), rows padded so that
//    the 16-byte loads below are free of bank conflicts;
//  - scores S = Q . [c_kv | k_rope]^T as a register-tiled f32 product: a
//    thread holds 4 heads x 4 tokens of one K slice (8 loads of 16 bytes
//    feed 64 FMAs), the 16 slices are summed in a fixed order (one shuffle,
//    then shared memory); no per-token warp reduction;
//  - the online softmax runs per head row, 16 lanes a head;
//  - acc += P . c_kv: a thread keeps 8 heads x 4 latent columns of the
//    HT x R accumulator in registers (two broadcast loads of P and one of
//    c_kv feed 32 FMAs).
// After cluster.sync() every block merges a slice of the outputs from all
// the blocks' partial (m, l, acc), read through distributed shared memory
// and summed in rank order (bitwise repeatable, one launch, no global
// scratch), and a second cluster.sync() keeps each block's shared memory
// alive until all have read it.  A block whose run holds no valid token
// keeps the empty partial (m = NEG_INF, l = 0, acc = 0).
//
// Prefill design (paged_mla_prefill_kernel), on tensor cores.  The former
// CUDA-core kernel (4 warps x 4 query rows a warp, every lane 1/32 of a
// row, four five-step warp sums a token, all f32 FMAs) ran 8-9x over its
// f32 bound; the bf16 tensor cores' peak is 15x the f32 CUDA cores'.  The
// codes are exact bf16 values (int8, sign-extended int4) and the serve's
// queries are bf16 already, so the products are the CUDA-core kernel's;
// only the order of the sums changes.  A block owns one query token of a
// lane and a tile of its heads (64 with bf16 queries, 32 with f32), which
// share the token's mask, so its page loop stops at the token's position.
// Per tile of 32 keys (tokens of any page size, mapped one by one through
// the block table):
//  - the stored rows (int8 codes, or q4_0 nibbles, and their f32 token
//    scales) come into one of two stages by cp.async while the previous
//    tile is used (byte copies for rows of an odd size, such as a q4_0 rope
//    row of 7 bytes), and are converted once into a bf16 key tile [c_kv |
//    0 | k_rope | 0], rows 16 bytes longer than a multiple of 32 so that
//    ldmatrix reads it without bank conflicts;
//  - S = Q . [c_kv | k_rope]^T by mma.sync.m16n8k16 (bf16, f32
//    accumulation): the warps of a row group (16 query rows) split the 32
//    keys, the latent and rope parts apart, four k16 steps accumulating
//    in the tensor core before f32 registers; then each key's column is
//    multiplied by its token scale, and by ``scale``, and the row group's
//    warps exchange their scores through shared memory (a named barrier).
//    f32 queries are held as three bf16 terms (hi + mid + lo);
//  - the online softmax runs in registers, four lanes a row;
//  - acc += P . c_kv by mma: each key's latent scale is folded into its
//    column of P, which is split into three bf16 terms, and the c_kv
//    columns are read from the key tile by ldmatrix.trans.  The f32
//    accumulator (rows x R) is split over the warps along R: 8 warps hold
//    4 row groups x 2 column halves (f32 queries: 2 x 4).
// Fixed order, no atomics: bitwise repeatable.  It is bound by the tensor
// cores' operations (the chip_smoke case: ~55 GFLOP of mma with P's three
// terms, ~0.06 ms at the bf16 peak) before its bytes.
//
// The reference's numerics are kept by both: NEG_INF = -2e38 is a finite
// sentinel, so masked probabilities are set to 0 explicitly, and l is
// clamped at 1e-30 before the divide (a row with no valid key, such as a
// padded prefill row, gives zeros).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "paged_tiles.cuh"

namespace {

constexpr int RMAX = 512;            // latent width the kernels take
constexpr int DMAX = 64;             // rope width the kernels take

// ---------------------------------------------------------------------------
// Decode: paged_mla_decode_kernel (see the header)
// ---------------------------------------------------------------------------

constexpr int DNT = 256;             // threads per decode block
constexpr int DNW = DNT / 32;        // warps
constexpr int HT = 16;               // query heads a block holds
constexpr int TT = 16;               // tokens a tile
constexpr int MAX_SPLITS = 8;        // blocks a cluster (the portable size)

__host__ __device__ constexpr int align4(int x) { return (x + 3) & ~3; }

// Shared memory of a decode block (byte offsets, from the shapes).  The f32
// rows [c_kv | 0 | k_rope | 0] are ``kw`` floats (the rope part at ``ra``,
// kw a multiple of 64: 16 K slices of whole 16-byte pairs), ``ks`` = kw + 8
// apart, so that the 16-byte loads of 4 rows x 2 neighbouring slices fall in
// 8 distinct bank groups.
struct DecodeSmem {
  int ra, da, kw, ks;      // floats
  int lrb, krb, lrs, krs;  // bytes of a stored latent / rope row; in the stage
  int st_k, st_cd, st_kd;  // within the stage
  int q, tile, part, p, stats, wts, bt, total;
};

__host__ __device__ inline DecodeSmem decode_smem(int lk, int kk, int R,
                                                  int Dr, int bt_cap) {
  DecodeSmem L{};
  L.ra = align4(R);
  L.da = align4(Dr);
  L.kw = (L.ra + L.da + 63) / 64 * 64;
  L.ks = L.kw + 8;
  L.lrb = kind_bytes(lk, R);
  L.krb = kind_bytes(kk, Dr);
  L.lrs = align16(L.lrb);
  L.krs = align16(L.krb);
  L.st_k = TT * L.lrs;
  L.st_cd = L.st_k + TT * L.krs;
  L.st_kd = L.st_cd + TT * 4;
  int off = align16(L.st_kd + TT * 4);
  L.q = off;     off += HT * L.ks * 4;        // the query tile
  L.tile = off;  off += TT * L.ks * 4;        // the f32 tile; then HT x R acc
  L.part = off;  off += DNW * HT * TT * 4;    // score partials
  L.p = off;     off += TT * HT * 4;          // probabilities [token][head]
  L.stats = off; off += 3 * HT * 4;           // corr, m, l
  L.wts = off;   off += (MAX_SPLITS + 1) * HT * 4;
  L.bt = off;    off += align16(bt_cap * 4);
  L.total = off;
  return L;
}

struct DecodeArgs {
  const void* q_eff;       // (B, H, R) f32 or bf16
  const void* q_rope;      // (B, H, Dr), the same type
  const uint8_t* ckv;      // (NP, P, R) as stored (q4_0: R/2 bytes)
  const uint8_t* krope;    // (NP, P, Dr)          (q4_0: Dr/2)
  const float* cd;         // (NP, P) quantized token scales (else null)
  const float* kd;
  const int* block_table;  // (B, nbt)
  const int* pos;          // (B,) query positions
  const int* lane_pages;   // (B,) page bound per lane, or null
  float* out;              // (B, H, R)
  int B, H, R, Dr, P, nbt, nj;
  int bt_cap;              // block-table entries a block holds (bt_capacity)
  int lv, kv;              // copy widths of the latent / rope rows: 16, 4, 1
  int qsize;               // bytes of a query element: 4 (f32) or 2 (bf16)
  float scale;
};

// Block-table entries a block can need: the pages of its share of the
// 16-token tiles of nj pages of P tokens split over ``splits`` blocks.
inline int bt_capacity(int nj, int P, int splits) {
  const long long tiles = ((long long)nj * P + TT - 1) / TT;
  const long long tokens = (tiles + splits - 1) / splits * TT;
  return (int)((tokens + P - 1) / P + 1);
}

// Elements e .. e + 3 (e a multiple of 4) of a stored row of ``width``
// elements, zeros past it; ``row`` is 16-byte aligned.
template <int KIND>
__device__ __forceinline__ float4 elems4(const uint8_t* row, int e, int width,
                                         float sc) {
  float v[4];
  if (e + 4 <= width) {
    if constexpr (KIND == 0) {
      return *reinterpret_cast<const float4*>(row + 4 * e);
    } else if constexpr (KIND == 1) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + 2 * e);
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xFFFF0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xFFFF0000u));
    } else if constexpr (KIND == 2) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(row + e);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (float)(int8_t)(u >> (8 * i)) * sc;
    } else {
      const uint32_t u = *reinterpret_cast<const uint16_t*>(row + e / 2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (float)((int)(((u >> (4 * i)) & 15u) ^ 8u) - 8) * sc;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = e + i < width ? elem<KIND>(row, e + i, sc) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// LK: the latent leaf's kind, KK: the rope leaf's.  Two blocks an SM where
// shared memory allows (the bf16 and quantized pools' ~94-103 KB).
template <int LK, int KK>
__global__ void __launch_bounds__(DNT, 2)
    paged_mla_decode_kernel(DecodeArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t dsmem[];
  const int R = a.R, Dr = a.Dr, P = a.P;
  const DecodeSmem L = decode_smem(LK, KK, R, Dr, a.bt_cap);
  const int KS = L.ks;
  uint8_t* stage = dsmem;
  float* q_s = reinterpret_cast<float*>(dsmem + L.q);
  float* c_s = reinterpret_cast<float*>(dsmem + L.tile);
  float* part_s = reinterpret_cast<float*>(dsmem + L.part);
  float* p_s = reinterpret_cast<float*>(dsmem + L.p);
  float* corr_s = reinterpret_cast<float*>(dsmem + L.stats);
  float* m_s = corr_s + HT;
  float* l_s = m_s + HT;
  int* bt_s = reinterpret_cast<int*>(dsmem + L.bt);

  const int split = blockIdx.x, splits = gridDim.x;
  const int h0 = blockIdx.y * HT, nh = min(HT, a.H - h0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;

  // the query tile: row h = [q_eff | 0 | q_rope | 0] as f32, zero past H,
  // a thread's loads all issued before its stores; columns past the rope
  // part are zero in it and in the f32 tile (the conversion writes the
  // rest of a tile row, zeros up to ra and ra + da)
  {
    constexpr int QCH = (HT * (RMAX + DMAX) / 4 + DNT - 1) / DNT;
    const int ncl = L.ra / 4, nch = ncl + L.da / 4;   // 4-element chunks
    float4 qv[QCH];
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int idx = tid + u * DNT, h = idx / nch, c = idx - h * nch;
      qv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h < nh) {
        const size_t qrow = (size_t)b * a.H + h0 + h;
        qv[u] = c < ncl
                    ? q_elems4(static_cast<const uint8_t*>(a.q_eff) +
                                   qrow * R * a.qsize,
                               4 * c, R, a.qsize == 2)
                    : q_elems4(static_cast<const uint8_t*>(a.q_rope) +
                                   qrow * Dr * a.qsize,
                               4 * (c - ncl), Dr, a.qsize == 2);
      }
    }
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int idx = tid + u * DNT, h = idx / nch, c = idx - h * nch;
      if (h < HT)
        *reinterpret_cast<float4*>(
            q_s + h * KS + (c < ncl ? 4 * c : L.ra + 4 * (c - ncl))) = qv[u];
    }
    for (int h = 0; h < HT; ++h) {
      for (int e = L.ra + L.da + tid; e < L.kw; e += DNT) {
        q_s[h * KS + e] = 0.f;
        c_s[h * KS + e] = 0.f;      // TT == HT rows
      }
    }
  }

  // the lane's valid tokens: its first min(lane_pages, nj) logical pages,
  // cut after the query position (kidx <= pos: past it every token is
  // masked, so the cut is exact); their 16-token tiles are split evenly
  // over the cluster's blocks, and this block takes tokens [u0, u0 + ntok)
  // and the block-table entries of their pages
  const int jmax = a.lane_pages != nullptr
                       ? min(max(a.lane_pages[b], 1), a.nj)
                       : a.nj;
  const int nvalid = max(0, min(jmax * P, a.pos[b] + 1));
  const int ntt = (nvalid + TT - 1) / TT;
  const int u0 = ntt * split / splits * TT;
  const int ntok = max(0, min(ntt * (split + 1) / splits * TT, nvalid) - u0);
  const int ntiles = (ntok + TT - 1) / TT;
  const int pg0 = u0 / P;
  const int npg = ntok > 0 ? (u0 + ntok - 1) / P - pg0 + 1 : 0;
  for (int i = tid; i < npg; i += DNT)
    bt_s[i] = a.block_table[(size_t)b * a.nbt + pg0 + i];
  __syncthreads();

  // start the copies of tile i into the stage
  auto issue = [&](int i) {
    const int nt = min(TT, ntok - i * TT);
    const int t = lane & (TT - 1);
    int grow = 0;
    if (t < nt) {
      const int u = u0 + i * TT + t, pg = u / P;
      grow = bt_s[pg - pg0] * P + (u - pg * P);
    }
    copy_leaf<DNW>(stage, a.ckv, L.lrb, L.lrs, L.lrb, a.lv, nt, grow, w,
                   lane);
    copy_leaf<DNW>(stage + L.st_k, a.krope, L.krb, L.krs, L.krb, a.kv, nt,
                   grow, w, lane);
    if (LK >= 2 && w == 0 && lane < nt)
      cp_async<4>(smem_u32(stage + L.st_cd + 4 * lane), a.cd + grow);
    if (KK >= 2 && w == 1 && lane < nt)
      cp_async<4>(smem_u32(stage + L.st_kd + 4 * lane), a.kd + grow);
  };
  if (ntiles > 0) issue(0);
  cp_async_commit();

  // softmax: warp w's half ``half`` owns head 2w + half, its 16 lanes one
  // token each, and keeps (m, l) alike in all of them
  const int half = lane >> 4, hs = 2 * w + half, ts = lane & 15;
  float m = NEG_INF, l = 0.f;
  // scores: lane (half, hq, tq) holds heads hq + 4j and tokens tq + 4i of K
  // slice 2w + half (16-byte pairs, the two halves' interleaved)
  const int hq = (lane >> 2) & 3, tq = lane & 3;
  const int kslice = L.kw / DNW;            // floats a warp's slice, mult. of 8
  const float* qb = q_s + w * kslice + 4 * half;
  const float* cb = c_s + w * kslice + 4 * half;
  // p . c_kv: heads hb .. hb + 7, latent columns 4 r4 .. 4 r4 + 3
  const int hb = 8 * (w & 1), r4 = (w >> 1) * 32 + lane;
  float acc[8][4];
#pragma unroll
  for (int h = 0; h < 8; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[h][c] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int nt = min(TT, ntok - i * TT);
    cp_async_wait<0>();
    __syncthreads();      // tile i's rows landed; tile i - 1 is consumed

    // the stage as f32 rows, warp w converting rows w, w + DNW
    {
      const float* cd_s = reinterpret_cast<const float*>(stage + L.st_cd);
      const float* kd_s = reinterpret_cast<const float*>(stage + L.st_kd);
      const int ncl = L.ra / 4, nc = ncl + L.da / 4;
      for (int t = w; t < nt; t += DNW) {
        const uint8_t* lrow = stage + t * L.lrs;
        const uint8_t* krow = stage + L.st_k + t * L.krs;
        const float sl = LK >= 2 ? cd_s[t] : 1.f, sk = KK >= 2 ? kd_s[t] : 1.f;
        float* dst = c_s + t * KS;
        for (int c = lane; c < nc; c += 32) {
          const float4 v = c < ncl ? elems4<LK>(lrow, 4 * c, R, sl)
                                   : elems4<KK>(krow, 4 * (c - ncl), Dr, sk);
          *reinterpret_cast<float4*>(dst + 4 * c) = v;
        }
      }
    }
    __syncthreads();      // the f32 tile is whole; the stage is free
    if (i + 1 < ntiles) issue(i + 1);
    cp_async_commit();

    // scores over this thread's K slice
    {
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) s[j][t] = 0.f;
      for (int k = 0; k < kslice; k += 8) {
        float4 cv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          cv[t] = *reinterpret_cast<const float4*>(cb + (tq + 4 * t) * KS + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qb + (hq + 4 * j) * KS + k);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float v = s[j][t];
            v = fmaf(qv.x, cv[t].x, v);
            v = fmaf(qv.y, cv[t].y, v);
            v = fmaf(qv.z, cv[t].z, v);
            v = fmaf(qv.w, cv[t].w, v);
            s[j][t] = v;
          }
        }
      }
      // the two halves' slices summed: half 0 keeps heads hq, hq + 4, half
      // 1 hq + 8, hq + 12; then one partial a warp
      float* pw = part_s + w * HT * TT;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float send = half ? s[jj][t] : s[jj + 2][t];
          const float keep = half ? s[jj + 2][t] : s[jj][t];
          pw[(hq + 4 * (jj + 2 * half)) * TT + tq + 4 * t] =
              keep + __shfl_xor_sync(FULL, send, 16);
        }
      }
    }
    __syncthreads();      // every warp's partial scores

    // online softmax of head hs over the tile's tokens
    {
      float sv = 0.f;
#pragma unroll
      for (int ww = 0; ww < DNW; ++ww) sv += part_s[(ww * HT + hs) * TT + ts];
      const bool ok = ts < nt;
      sv = ok ? sv * a.scale : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m, mx);
      const float p = ok ? expf(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float corr = expf(m - m_new);
      l = l * corr + sum;
      m = m_new;
      p_s[ts * HT + hs] = p;
      if (ts == 0) corr_s[hs] = corr;
    }
    __syncthreads();      // the tile's probabilities

    // acc = acc * corr + p . c_kv
    {
      const float4 ca = *reinterpret_cast<const float4*>(corr_s + hb);
      const float4 cb4 = *reinterpret_cast<const float4*>(corr_s + hb + 4);
      const float cr[8] = {ca.x, ca.y, ca.z, ca.w, cb4.x, cb4.y, cb4.z, cb4.w};
#pragma unroll
      for (int h = 0; h < 8; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[h][c] *= cr[h];
      if (4 * r4 < R) {
        const float* cc = c_s + 4 * r4;
#pragma unroll 2
        for (int t = 0; t < nt; ++t) {
          const float4 cv = *reinterpret_cast<const float4*>(cc + t * KS);
          const float4 pa = *reinterpret_cast<const float4*>(p_s + t * HT + hb);
          const float4 pb =
              *reinterpret_cast<const float4*>(p_s + t * HT + hb + 4);
          const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int h = 0; h < 8; ++h) {
            acc[h][0] = fmaf(pr[h], cv.x, acc[h][0]);
            acc[h][1] = fmaf(pr[h], cv.y, acc[h][1]);
            acc[h][2] = fmaf(pr[h], cv.z, acc[h][2]);
            acc[h][3] = fmaf(pr[h], cv.w, acc[h][3]);
          }
        }
      }
    }
  }

  // this block's partial: (m, l) per head and acc as HT x R in place of the
  // f32 tile
  cp_async_wait<0>();
  __syncthreads();
  float* red = c_s;
  if (4 * r4 < R) {
#pragma unroll
    for (int h = 0; h < 8; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * r4 + c < R) red[(hb + h) * R + 4 * r4 + c] = acc[h][c];
  }
  if (ts == 0) {
    m_s[hs] = m;
    l_s[hs] = l;
  }

  // every block of the cluster merges a slice of the outputs from all the
  // blocks' partials, in rank order
  cluster.sync();
  float* wts = reinterpret_cast<float*>(dsmem + L.wts);   // splits x HT
  float* lsum = wts + MAX_SPLITS * HT;
  if (tid < HT) {
    float ms[MAX_SPLITS], ls[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < splits) {
        ms[sp] = cluster.map_shared_rank(m_s, sp)[tid];
        ls[sp] = cluster.map_shared_rank(l_s, sp)[tid];
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) mx = fmaxf(mx, ms[sp]);
    float lt = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < splits) {
        const float e = expf(ms[sp] - mx);
        wts[sp * HT + tid] = e;
        lt += ls[sp] * e;
      }
    }
    lsum[tid] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  const int n_out = nh * R, rank = (int)cluster.block_rank();
  const int lo = n_out * rank / splits, hi = n_out * (rank + 1) / splits;
  for (int idx = lo + tid; idx < hi; idx += DNT) {
    const int h = idx / R;
    float part[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) part[sp] = cluster.map_shared_rank(red, sp)[idx];
    float v = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) v += part[sp] * wts[sp * HT + h];
    a.out[((size_t)b * a.H + h0 + h) * R + idx - h * R] = v / lsum[h];
  }
  cluster.sync();   // each block's shared memory stays until all have read it
}

template <int LK, int KK>
int launch_decode(const DecodeArgs& a, int splits, cudaStream_t stream) {
  auto kernel = paged_mla_decode_kernel<LK, KK>;
  const DecodeSmem L = decode_smem(LK, KK, a.R, a.Dr, a.bt_cap);
  static int configured = 48 * 1024;   // the largest size allowed so far
  if (L.total > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = L.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.H + HT - 1) / HT, a.B);
  cfg.blockDim = dim3(DNT);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Prefill on tensor cores: paged_mla_prefill_kernel (see the header)
// ---------------------------------------------------------------------------

constexpr int PNT = 256;             // threads a prefill block (8 warps)
constexpr int PKT = 32;              // tokens a key tile

// A block's query rows (heads of one token), their row groups of 16 (one
// warp's mma rows), the warps that split the latent columns of a row
// group's accumulator, and the bf16 terms the queries are held as (bf16
// queries: one, as passed; f32: three, hi + mid + lo).
template <bool QF32>
struct PrefillTile {
  static constexpr int ROWS = QF32 ? 32 : 64;
  static constexpr int RG = ROWS / 16;
  static constexpr int RS = 8 / RG;
  static constexpr int NQ = QF32 ? 3 : 1;
  static constexpr int MAXP = RMAX / 16 / RS;   // 16-column pairs a warp
};

// Shared memory of a prefill block (byte offsets).  Query and key rows are
// bf16 [c_kv | 0 | k_rope | 0] of kw = rp + dp elements (rp, dp: R and Dr
// rounded up to 16), ``pitch`` = 2 kw + 16 bytes apart, so that the eight
// 16-byte rows of an ldmatrix fall in distinct banks.
struct PrefillSmem {
  int rp, dp, kw, pitch;
  int lrb, krb, lrs, krs;      // bytes of a stored latent / rope row; in the stage
  int st_k, st_cd, st_kd, st_bytes;
  int q, k, stage, dsc, dsk, sx, total;
};

// scores a row group's warps exchange: 16 rows x PKT keys, rows SXP floats
// apart (the 8-byte accesses of a warp's 8 rows x 4 lanes hit 32 banks)
constexpr int SXP = PKT + 4;

__host__ __device__ inline PrefillSmem prefill_smem(int lk, int kk, int R,
                                                    int Dr, int nq, int rows) {
  PrefillSmem L{};
  L.rp = align16(R);
  L.dp = align16(Dr);
  L.kw = L.rp + L.dp;
  L.pitch = 2 * L.kw + 16;
  L.lrb = kind_bytes(lk, R);
  L.krb = kind_bytes(kk, Dr);
  L.lrs = align16(L.lrb);
  L.krs = align16(L.krb);
  L.st_k = PKT * L.lrs;
  L.st_cd = L.st_k + PKT * L.krs;
  L.st_kd = L.st_cd + PKT * 4;
  L.st_bytes = align16(L.st_kd + PKT * 4);
  int off = 0;
  L.q = off;      off += nq * rows * L.pitch;      // query planes
  L.k = off;      off += PKT * L.pitch;            // the key tile, bf16 codes
  L.stage = off;  off += 2 * L.st_bytes;           // two stages, as stored
  L.dsc = off;    off += PKT * 4;                  // the tile's token scales
  L.dsk = off;    off += PKT * 4;
  L.sx = off;     off += rows * SXP * 4;           // the tile's scores
  L.total = off;
  return L;
}

struct PrefillArgs {
  const void* q_eff;       // (B, C, H, R) f32 or bf16
  const void* q_rope;      // (B, C, H, Dr), the same type
  const uint8_t* ckv;      // (NP, P, R) int8 (q4_0: R/2 bytes)
  const uint8_t* krope;    // (NP, P, Dr)     (q4_0: Dr/2)
  const float* cd;         // (NP, P) token scales
  const float* kd;
  const int* block_table;  // (B, nbt)
  const int* qpos;         // (B, C) query positions, -1 = padded row
  float* out;              // (B, C, H, R)
  int B, C, H, R, Dr, P, nbt, nj;
  int lv, kv;              // copy widths of the latent / rope rows: 16, 4, 1
  int qcopy;               // 1: bf16 query rows copied as they are (16 B)
  float scale;
};

// A barrier of the ``n`` threads of a block that use barrier ``id`` (1..15).
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// LK: the latent leaf's kind, KK: the rope leaf's (2 q8_0, 3 q4_0);
// QF32: f32 queries (else bf16).
template <int LK, int KK, bool QF32>
__global__ void __launch_bounds__(PNT, 1)
    paged_mla_prefill_kernel(PrefillArgs a) {
  using Tile = PrefillTile<QF32>;
  constexpr int ROWS = Tile::ROWS, RS = Tile::RS, NQ = Tile::NQ;
  constexpr int MAXP = Tile::MAXP;
  extern __shared__ __align__(16) uint8_t psmem[];
  const int R = a.R, Dr = a.Dr, P = a.P;
  const PrefillSmem L = prefill_smem(LK, KK, R, Dr, NQ, ROWS);
  uint8_t* q_s = psmem + L.q;
  uint8_t* k_s = psmem + L.k;
  float* dsc = reinterpret_cast<float*>(psmem + L.dsc);
  float* dsk = reinterpret_cast<float*>(psmem + L.dsk);

  const int c = blockIdx.x, h0 = blockIdx.y * ROWS, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = w / RS, rh = w % RS;
  const int nh = min(ROWS, a.H - h0);
  const size_t row0 = ((size_t)b * a.C + c) * a.H + h0;   // (b, c, h0)
  const int qp = a.qpos[(size_t)b * a.C + c];
  if (qp < 0) {
    // a padded row: no valid key, zeros (the plain version's result)
    for (int i = tid; i < nh * R; i += PNT) a.out[row0 * R + i] = 0.f;
    return;
  }
  // keys with logical index <= qp among the first nj pages
  const int nvalid = min(qp + 1, a.nj * P);
  const int ntiles = (nvalid + PKT - 1) / PKT;

  // lane t's token row in the pool for row t of key tile i (a global load,
  // made a tile ahead of its use)
  auto token_row = [&](int i) {
    const int u = i * PKT + lane;
    if (i >= ntiles || u >= nvalid) return 0;
    const int pg = u / P;
    return a.block_table[(size_t)b * a.nbt + pg] * P + (u - pg * P);
  };
  // start the copies of key tile i into stage i % 2, as stored
  auto issue = [&](int i, int grow) {
    uint8_t* st = psmem + L.stage + (i & 1) * L.st_bytes;
    const int nt = min(PKT, nvalid - i * PKT);
    copy_leaf<PNT / 32>(st, a.ckv, L.lrb, L.lrs, L.lrb, a.lv, nt, grow, w,
                        lane);
    copy_leaf<PNT / 32>(st + L.st_k, a.krope, L.krb, L.krs, L.krb, a.kv, nt,
                        grow, w, lane);
    if (w == 0 && lane < nt)
      cp_async<4>(smem_u32(st + L.st_cd + 4 * lane), a.cd + grow);
    if (w == 1 && lane < nt)
      cp_async<4>(smem_u32(st + L.st_kd + 4 * lane), a.kd + grow);
  };
  issue(0, token_row(0));
  // the query tile: rows h0 .. h0 + ROWS - 1 of token (b, c) as bf16
  // [q_eff | 0 | q_rope | 0] (f32 queries: three planes), zero past H.
  // bf16 rows of whole 16-byte pieces (R, Dr multiples of 16) are copied
  // as they are, in the first tile's group
  if (!QF32 && a.qcopy) {
    const int pl = R / 8, np = pl + Dr / 8;            // 16-byte pieces
    for (int idx = tid; idx < ROWS * np; idx += PNT) {
      const int r = idx / np, pc = idx - r * np;
      const uint8_t* src =
          pc < pl ? static_cast<const uint8_t*>(a.q_eff) +
                        ((row0 + r) * R + 8 * pc) * 2
                  : static_cast<const uint8_t*>(a.q_rope) +
                        ((row0 + r) * Dr + 8 * (pc - pl)) * 2;
      cp_async_zfill(smem_u32(q_s + r * L.pitch) +
                         (pc < pl ? 16 * pc : 2 * L.rp + 16 * (pc - pl)),
                     r < nh ? src : a.q_eff, r < nh ? 16 : 0);
    }
  }
  cp_async_commit();
  int grow_next = token_row(1);

  // other queries: a thread's loads of a batch are all issued before its
  // stores
  if (QF32 || !a.qcopy) {
    const int ncl = L.rp / 4, nch = ncl + L.dp / 4;   // 4-element chunks
    const int qsize = QF32 ? 4 : 2;
    const int plane = ROWS * L.pitch;
    constexpr int QB = 6;                              // loads a batch
    for (int i0 = tid; i0 < ROWS * nch; i0 += QB * PNT) {
      float4 v[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int idx = i0 + u * PNT, r = idx / nch, ch = idx - r * nch;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < ROWS * nch && r < nh)
          v[u] = ch < ncl
                     ? q_elems4(static_cast<const uint8_t*>(a.q_eff) +
                                    (row0 + r) * R * qsize,
                                4 * ch, R, !QF32)
                     : q_elems4(static_cast<const uint8_t*>(a.q_rope) +
                                    (row0 + r) * Dr * qsize,
                                4 * (ch - ncl), Dr, !QF32);
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int idx = i0 + u * PNT, r = idx / nch, ch = idx - r * nch;
        const int e = ch < ncl ? 4 * ch : L.rp + 4 * (ch - ncl);
        if (idx < ROWS * nch)
          store_bf16x4<NQ>(q_s + r * L.pitch + 2 * e, v[u], plane);
      }
    }
  }

  // softmax state of rows g and g + 8 of this warp's row group (l: this
  // lane's share, summed over the row's four lanes at the end)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // acc: the row group's latent columns of 16-column pairs [p0, p1), pair
  // p0 + cp in acc[2 cp], acc[2 cp + 1] (8 columns each)
  const int npair = L.rp / 16;
  const int p0 = npair * rh / RS, p1 = npair * (rh + 1) / RS;
  float acc[2 * MAXP][4];
#pragma unroll
  for (int j = 0; j < 2 * MAXP; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  const int nkc = L.rp / 16, nkr = L.dp / 16;   // k16 steps of c_kv, k_rope
  // ldmatrix row addresses: lane i gives row i % 8 of matrix i / 8
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t qa = smem_u32(q_s) +
                      (16 * rg + (mi & 1) * 8 + mr) * L.pitch + (mi >> 1) * 16;
  const uint32_t ka = smem_u32(k_s) + ((mi >> 1) * 8 + mr) * L.pitch +
                      (mi & 1) * 16;
  const uint32_t va = smem_u32(k_s) + ((mi & 1) * 8 + mr) * L.pitch +
                      (mi >> 1) * 16;

  for (int i = 0; i < ntiles; ++i) {
    const int nt = min(PKT, nvalid - i * PKT);
    cp_async_wait<0>();
    __syncthreads();   // tile i's rows landed; the key tile is consumed
    if (i + 1 < ntiles) issue(i + 1, grow_next);
    cp_async_commit();
    grow_next = token_row(i + 2);

    // the stage as bf16 codes (exact: int8 and int4 values), the token
    // scales beside them; rows past nt zero.  Warp w converts rows w, w +
    // 8, .., its lanes along the row.
    {
      const uint8_t* st = psmem + L.stage + (i & 1) * L.st_bytes;
      const float* cd_s = reinterpret_cast<const float*>(st + L.st_cd);
      const float* kd_s = reinterpret_cast<const float*>(st + L.st_kd);
      const int ncl = L.rp / 4, nch = ncl + L.dp / 4;
      for (int r = w; r < PKT; r += PNT / 32) {
        for (int ch = lane; ch < nch; ch += 32) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < nt)
            v = ch < ncl ? codes4<LK>(st + r * L.lrs, 4 * ch, R)
                         : codes4<KK>(st + L.st_k + r * L.krs,
                                      4 * (ch - ncl), Dr);
          const int e = ch < ncl ? 4 * ch : L.rp + 4 * (ch - ncl);
          store_bf16x4<1>(k_s + r * L.pitch + 2 * e, v, 0);
        }
      }
      if (tid < PKT) {
        dsc[tid] = tid < nt ? cd_s[tid] : 0.f;
        dsk[tid] = tid < nt ? kd_s[tid] : 0.f;
      }
    }
    __syncthreads();   // the key tile is whole

    // S = Q . [c_kv | k_rope]^T, the two parts apart (each has its own
    // token scale): the RS warps of a row group split the tile's 32 keys
    // (KTW 8-key column tiles each) and exchange their scores through
    // shared memory
    constexpr int KTW = 4 / RS;
    const int kt0 = rh * KTW;
    float sc[KTW][4], sr[KTW][4];
#pragma unroll
    for (int j = 0; j < KTW; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) sc[j][v] = sr[j][v] = 0.f;
    auto scores = [&](int k0, int k1, float (&s)[KTW][4]) {
      // four k16 steps (64 columns) accumulate in the tensor core, then in
      // f32 registers
      for (int kg = k0; kg < k1; kg += 4) {
        float d[KTW][4];
#pragma unroll
        for (int j = 0; j < KTW; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) d[j][v] = 0.f;
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const int ks = kg + kq;
          if (ks < k1) {
            uint32_t qf[NQ][4], kf[4];
#pragma unroll
            for (int u = 0; u < NQ; ++u)
              ldmatrix_x4<false>(qf[u], qa + u * ROWS * L.pitch + ks * 32);
            // the 16 keys of column tiles kt0 & ~1 and its neighbour
            ldmatrix_x4<false>(kf, ka + (kt0 >> 1) * 16 * L.pitch + ks * 32);
#pragma unroll
            for (int j = 0; j < KTW; ++j) {
              const int jt = (kt0 + j) & 1;
#pragma unroll
              for (int u = 0; u < NQ; ++u)
                mma_bf16(d[j], qf[u], kf[2 * jt], kf[2 * jt + 1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < KTW; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[j][v] += d[j][v];
      }
    };
    scores(0, nkc, sc);
    scores(nkc, nkc + nkr, sr);
    float* sxg = reinterpret_cast<float*>(psmem + L.sx) + rg * 16 * SXP;
#pragma unroll
    for (int j = 0; j < KTW; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = 8 * (kt0 + j) + 2 * t;
        float2 sv;
        sv.x = key < nt ? (dsc[key] * sc[j][2 * h] + dsk[key] * sr[j][2 * h]) *
                              a.scale
                        : NEG_INF;
        sv.y = key + 1 < nt ? (dsc[key + 1] * sc[j][2 * h + 1] +
                               dsk[key + 1] * sr[j][2 * h + 1]) *
                                  a.scale
                            : NEG_INF;
        *reinterpret_cast<float2*>(sxg + (g + 8 * h) * SXP + key) = sv;
      }
    }
    named_sync(1 + rg, RS * 32);   // the row group's scores

    // online softmax: lane (g, t) holds keys 8j + 2t, + 1 of rows g (v < 2)
    // and g + 8 (v >= 2)
    float p[4][4], mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 sv = *reinterpret_cast<const float2*>(
            sxg + (g + 8 * h) * SXP + 8 * j + 2 * t);
        p[j][2 * h] = sv.x;
        p[j][2 * h + 1] = sv.y;
        mx[h] = fmaxf(mx[h], fmaxf(sv.x, sv.y));
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int key = 8 * j + 2 * t + (v & 1);
        const float pv = key < nt ? expf(p[j][v] - m[v >> 1]) : 0.f;
        l[v >> 1] += pv;
        p[j][v] = pv * dsc[key];    // the latent token's scale, folded in
      }
    }
    // (a row group whose maxima all stayed keeps its accumulator as is)
    if (__any_sync(FULL, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < 2 * MAXP; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
    }

    // acc += P . c_kv: P (16 rows x 32 keys) as three bf16 terms, the A
    // fragments of the two k16 steps straight from S's layout; both steps
    // accumulate in the tensor core, then in f32 registers
    uint32_t pf[2][3][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split3(p[2 * kk][0], p[2 * kk][1], pf[kk][0][0], pf[kk][1][0],
             pf[kk][2][0]);
      split3(p[2 * kk][2], p[2 * kk][3], pf[kk][0][1], pf[kk][1][1],
             pf[kk][2][1]);
      split3(p[2 * kk + 1][0], p[2 * kk + 1][1], pf[kk][0][2], pf[kk][1][2],
             pf[kk][2][2]);
      split3(p[2 * kk + 1][2], p[2 * kk + 1][3], pf[kk][0][3], pf[kk][1][3],
             pf[kk][2][3]);
    }
#pragma unroll
    for (int cp = 0; cp < MAXP; ++cp) {
      if (p0 + cp < p1) {
        uint32_t vf[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          ldmatrix_x4<true>(vf[kk], va + kk * 16 * L.pitch + (p0 + cp) * 32);
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int u = 0; u < 3; ++u)
              mma_bf16(d, pf[kk][u], vf[kk][2 * jt], vf[kk][2 * jt + 1]);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[2 * cp + jt][v] += d[v];
        }
      }
    }
  }

  // out = acc / l, l summed over the row's four lanes and clamped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int cp = 0; cp < MAXP; ++cp) {
    if (p0 + cp < p1) {
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = 16 * rg + g + 8 * (v >> 1);
          const int col = 16 * (p0 + cp) + 8 * jt + 2 * t + (v & 1);
          if (r < nh && col < R)
            a.out[(row0 + r) * R + col] = acc[2 * cp + jt][v] * l[v >> 1];
        }
      }
    }
  }
}

template <int LK, int KK, bool QF32>
int launch_prefill(const PrefillArgs& a, cudaStream_t stream) {
  auto kernel = paged_mla_prefill_kernel<LK, KK, QF32>;
  using Tile = PrefillTile<QF32>;
  const PrefillSmem L = prefill_smem(LK, KK, a.R, a.Dr, Tile::NQ, Tile::ROWS);
  static int configured = 48 * 1024;   // the largest size allowed so far
  if (L.total > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    configured = L.total;
  }
  const dim3 grid(a.C, (a.H + Tile::ROWS - 1) / Tile::ROWS, a.B);
  kernel<<<grid, PNT, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LK, int KK>
int launch_prefill_q(const PrefillArgs& a, bool q_bf16, cudaStream_t st) {
  return q_bf16 ? launch_prefill<LK, KK, false>(a, st)
                : launch_prefill<LK, KK, true>(a, st);
}

}  // namespace

// latent_kind / rope_kind: 0 = float32 pools, 1 = bfloat16 pools, 2 = q8_0
// (int8 + f32 token scales), 3 = q4_0 (two int4 a byte + f32 token scales;
// R or Dr even).  The pairs built: (0, 0), (1, 1), (2, 2), (3, 3) and
// (2, 3), the "dq" policy's q8_0 latents and q4_0 rope keys; prefill takes
// the quantized ones.  R <= 512 and Dr <= 64 (logical widths).

// Chunked prefill (paged_mla_prefill_kernel): q_eff / q_rope float32
// (q_bf16 = 0) or bfloat16 (q_bf16 = 1); qpos (B, C) query positions, -1
// for padded rows.  Returns cudaGetLastError() after the launch.
extern "C" int paged_mla_prefill(int latent_kind, int rope_kind, int q_bf16,
                                 const void* q_eff, const void* q_rope,
                                 const void* ckv, const void* krope,
                                 const float* cd, const float* kd,
                                 const int* block_table, const int* qpos,
                                 float* out, int B, int C, int H, int R,
                                 int Dr, int P, int nbt, int nj, float scale,
                                 void* stream) {
  if (R < 1 || R > RMAX || Dr < 1 || Dr > DMAX || P < 1 || nj < 1 ||
      (q_bf16 != 0 && q_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  if ((latent_kind == 3 && (R & 1)) || (rope_kind == 3 && (Dr & 1)))
    return (int)cudaErrorInvalidValue;
  const int lrb = kind_bytes(latent_kind, R), krb = kind_bytes(rope_kind, Dr);
  PrefillArgs a{q_eff, q_rope, static_cast<const uint8_t*>(ckv),
                static_cast<const uint8_t*>(krope), cd, kd, block_table,
                qpos, out, B, C, H, R, Dr, P, nbt, nj,
                copy_width(lrb, ckv), copy_width(krb, krope),
                q_bf16 && R % 16 == 0 && Dr % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q_eff) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q_rope) % 16 == 0,
                scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (latent_kind * 4 + rope_kind) {
    case 10: return launch_prefill_q<2, 2>(a, q_bf16, st);
    case 15: return launch_prefill_q<3, 3>(a, q_bf16, st);
    case 11: return launch_prefill_q<2, 3>(a, q_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One-token decode (paged_mla_decode_kernel): q_eff / q_rope float32
// (q_bf16 = 0) or bfloat16 (q_bf16 = 1); pos (B,) the query positions;
// lane_pages (B,) or null.  A lane's valid tokens (its first
// min(lane_pages, nj) logical pages, cut after its position) are split in
// 16-token tiles over ``splits`` blocks (1 <= splits <= 8), a cluster per
// (lane, tile of 16 heads).  Returns the launch's error code.
extern "C" int paged_mla_decode(int latent_kind, int rope_kind, int q_bf16,
                                const void* q_eff, const void* q_rope,
                                const void* ckv, const void* krope,
                                const float* cd, const float* kd,
                                const int* block_table, const int* pos,
                                const int* lane_pages, float* out, int B,
                                int H, int R, int Dr, int P, int nbt, int nj,
                                int splits, float scale, void* stream) {
  if (R < 1 || R > RMAX || Dr < 1 || Dr > DMAX || P < 1 || nj < 1 ||
      splits < 1 || splits > MAX_SPLITS || (q_bf16 != 0 && q_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  if ((latent_kind == 3 && (R & 1)) || (rope_kind == 3 && (Dr & 1)))
    return (int)cudaErrorInvalidValue;
  const int lrb = kind_bytes(latent_kind, R), krb = kind_bytes(rope_kind, Dr);
  const int bt_cap = bt_capacity(nj, P, splits);
  const DecodeSmem L = decode_smem(latent_kind, rope_kind, R, Dr, bt_cap);
  if (L.total > 227 * 1024) return (int)cudaErrorInvalidValue;
  DecodeArgs a{q_eff, q_rope, static_cast<const uint8_t*>(ckv),
               static_cast<const uint8_t*>(krope), cd, kd, block_table, pos,
               lane_pages, out, B, H, R, Dr, P, nbt, nj, bt_cap,
               copy_width(lrb, ckv), copy_width(krb, krope),
               q_bf16 ? 2 : 4, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (latent_kind * 4 + rope_kind) {
    case 0: return launch_decode<0, 0>(a, splits, st);
    case 5: return launch_decode<1, 1>(a, splits, st);
    case 10: return launch_decode<2, 2>(a, splits, st);
    case 15: return launch_decode<3, 3>(a, splits, st);
    case 11: return launch_decode<2, 3>(a, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
