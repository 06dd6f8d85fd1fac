// Paged GQA attention over KV page pools, for Hopper: one-token decode and
// write-then-attend chunked prefill.
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attn.py::_attn_core
// (body :321-362; entries paged_attn_decode :183, paged_attn_decode_quant
// :728, paged_attn_decode_q8 :761) with its f32, q8_0 and q4_0 tile loaders
// (q4_0: _dequant :217 -> unpack_q4_rows :692), and ::_attn_prefill_core
// (body :880-940; entry paged_attn_prefill_quant :784) with the q8_0 and
// q4_0 loaders.
//
// What bounds decode on an H100: the page bytes it streams (each live K/V
// row once per kv head, ~1 MB for 4 lanes of 100-400 tokens: 0.3 us at
// 3.35 TB/s) and ~2 * rep flops per K/V element — far below either peak,
// so a launch is bound by latency: the dependent loads (lane bound and
// block table, then the pages) and the length of the longest serial walk.
// So is prefill: a 4 x 128-token chunk of qwen2-1.5b (12 / 2 heads, D =
// 128) over lanes of 100-400 tokens is ~0.1 M causal (query, key) pairs a
// head, ~0.06 GFLOP (~0.0006 ms at the bf16 peak) and ~7 MB with q and the
// output (~0.002 ms at 3.35 TB/s); what costs is each block's walk over up
// to 13 key tiles one after the other.
//
// Decode design (paged_attn_decode_kernel).  The TPU grid (slot,
// logical_page) runs in order and carries the online softmax (m, l, acc) in
// VMEM across page steps.  Here the page walk is split (flash-decoding): a
// thread-block cluster per (lane, kv head, row tile of up to RMAX query
// heads) holds ``splits`` blocks, each walking its own run of
// ``pages_per_split`` logical pages.  After cluster.sync() every block of
// the cluster merges a slice of the outputs from all the blocks' partial
// (m, l, acc), read through distributed shared memory and summed in rank
// order (deterministic, one launch, no global scratch; spreading the merge
// keeps each thread's remote loads few and issued together).  A block
// whose run lies wholly past its lane's lane_pages keeps the empty partial
// (m = NEG_INF, l = 0, acc = 0).  Inside a block:
//  - the run goes in tiles of whole pages (at least TILE_TOKENS tokens, or
//    one page) through a ring of NSTAGE shared-memory stages filled by
//    cp.async: K and V rows as stored (16-byte copies, neighbouring threads
//    on neighbouring bytes, each thread's (row, chunk) stepped without a
//    divide), their row scales and the tokens' positions; tile i + 2 is in
//    flight while tile i is used;
//  - scoring: 8 lanes share a token, each holding 8-element chunks of its K
//    row (dequantized in registers: bf16 by a shift, q8_0 int8 x the row's
//    f32 scale, q4_0 the sign-extended nibble x the scale — one f32
//    multiply, as the plain version, so every element is bitwise its value)
//    against the block's scaled query rows in shared memory (laid out so
//    that the 8 lanes' 16-byte loads are conflict-free); the 8 rows'
//    partial sums are reduced across the 8 lanes in 7 shuffles, lane i
//    ending with row i's score;
//  - the online softmax runs one warp per row (a warp's rows side by
//    side), with warp shuffles;
//  - p @ V: a thread owns 4 output columns of every row and a strided share
//    of the tile's tokens (so acc stays in registers), and the shares are
//    summed in a fixed order once, at the end of the run.
//
// Prefill design (paged_attn_prefill_kernel), on tensor cores.  The former
// CUDA-core kernel (a block per lane, kv head and 32 // rep queries, so
// ~26 blocks re-read and re-converted the same pages; f32 K/V sub-tiles of
// 16 tokens, one FMA chain per (row, token), one thread per row for the
// softmax) ran slower than its plain PyTorch version.  The codes are exact
// bf16 values (int8, sign-extended int4) and the serve's queries are bf16,
// so the tensor cores compute the products FMAs would; only the order of
// the sums changes.  A block owns 64 query rows of one (lane, kv head), the
// (query, rep head) pairs laid out (c, r) as the reference's (Hkv, C, rep)
// rows, so one key tile serves every rep head of its kv head; its 4 warps
// hold 16 rows each, and its walk stops after the last key tile any of its
// rows can see (the rows' largest position).  Per tile of 32 keys (tokens
// of any page size, mapped one by one through the block table, a tile
// ahead of their use):
//  - the stored K and V rows (int8 codes, or q4_0 nibbles), their f32 row
//    scales and the tokens' positions come into one of two stages by
//    cp.async while the previous tile is used, and are converted once into
//    bf16 key and value tiles (rows past the tile's keys zero), rows 16
//    bytes longer than a multiple of 32 so that ldmatrix reads them without
//    bank conflicts;
//  - each warp computes S = Q . K^T for its 16 rows and the 32 keys by
//    mma.sync.m16n8k16 (bf16, f32 accumulation; four k16 steps accumulate
//    in the tensor core, then in f32 registers), bf16 queries as passed;
//    then each key's column times its row scale and ``scale``, the
//    softcap, and the mask;
//  - the online softmax runs in registers, four lanes a row;
//  - acc += P . V by mma: each key's value scale is folded into its column
//    of P, which is split into three bf16 terms, and V's columns are read
//    from the value tile by ldmatrix.trans; a warp's 16 x Dv accumulator
//    stays in registers.
// f32 queries (the parity runs, the f32 tests) take the plain version's
// function to f32 rounding instead: q * scale and the keys and values
// dequantized as it rounds them, each as three bf16 terms (hi + mid + lo),
// six mmas a k16 step smallest first (see the kernel).
// Where the blocks (lanes x kv heads x row tiles) are fewer than twice the
// SMs, a cluster of ``splits`` blocks (attn_prefill_tiles, host integers)
// splits each row tile's run of key tiles evenly (on one H100 80GB HBM3
// at 700 W a 4 x 128-token qwen2 chunk ran 0.123 ms at one block a row
// tile, 0.060 at clusters of 3); after cluster.sync() every block merges
// a slice of the outputs from all the blocks' partial (m, l, acc), read
// through distributed shared memory and summed in rank order.  Fixed
// order, no atomics: bitwise repeatable.
//
// Both keep the reference's numerics: NEG_INF = -2e38 is a finite
// sentinel, so the probabilities of masked keys are set to exactly 0; a key
// is valid iff written (pos >= 0), causal (pos <= the query's position),
// inside the window when one applies (prefill: and its logical index <=
// the query's position); the softcap applies to the scores before the
// mask; l is clamped at 1e-30 before the divide (a row with no valid key,
// such as a padded prefill row, gives zeros).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "paged_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// Decode: paged_attn_decode_kernel (see the header)
// ---------------------------------------------------------------------------

constexpr int DNT = 256;             // threads per decode block
constexpr int NW = DNT / 32;         // warps
constexpr int RMAX = 8;              // query rows (heads of one kv head) a block holds
constexpr int RPW = (RMAX + NW - 1) / NW;  // softmax rows a warp
constexpr int GL = 8;                // lanes that score one token
constexpr int TOK_PASS = DNT / GL;   // tokens scored at once
constexpr int CMAX = 4;              // 8-element K chunks a lane holds: D <= 256
constexpr int TILE_TOKENS = 32;      // a tile: the fewest whole pages holding this many
constexpr int NSTAGE = 3;            // tiles in the ring
constexpr int MAX_SPLITS = 8;        // blocks a cluster (the portable size)

// Dynamic shared memory of a decode block: byte offsets, from the shapes.
struct DecodeSmem {
  int krb, vrb;     // bytes of a stored K row, V row
  int qw;           // floats of a query row (D rounded up to 64)
  int st_v, st_kd, st_vd, st_pos, stage;  // within a stage
  int ring, q, bt, tok, s, p, stats, wts, total;
};

__host__ __device__ inline DecodeSmem decode_smem(int kind, int D, int Dv,
                                                  int tt, int pps) {
  DecodeSmem L{};
  L.krb = kind_bytes(kind, D);
  L.vrb = kind_bytes(kind, Dv);
  L.qw = (D + 63) / 64 * 64;
  const bool quant = kind >= 2;
  L.st_v = align16(tt * L.krb);
  L.st_kd = L.st_v + align16(tt * L.vrb);
  L.st_vd = L.st_kd + (quant ? align16(tt * 4) : 0);
  L.st_pos = L.st_vd + (quant ? align16(tt * 4) : 0);
  L.stage = L.st_pos + align16(tt * 4);
  // after the walk the ring holds the token groups' p @ V shares
  const int groups = DNT / (Dv / 4);
  const int ring = NSTAGE * L.stage, red = groups * RMAX * Dv * 4;
  int off = 0;
  L.ring = off;  off += align16(ring > red ? ring : red);
  L.q = off;     off += align16(RMAX * L.qw * 4);
  L.bt = off;    off += align16(pps * 4);
  L.tok = off;   off += align16(tt * 4);
  L.s = off;     off += align16(RMAX * tt * 4);
  L.p = off;     off += align16(tt * RMAX * 4);
  L.stats = off; off += 3 * RMAX * 4;            // m, l, corr
  L.wts = off;   off += align16((MAX_SPLITS + 1) * RMAX * 4);
  L.total = off;
  return L;
}

struct DecodeArgs {
  const float* q;          // (B, H, D) f32
  const uint8_t* k;        // (NP, P, Hkv, D) as stored (q4_0: D/2 bytes)
  const uint8_t* v;        // (NP, P, Hkv, Dv)
  const float* kd;         // (NP, P, Hkv) quantized row scales (else null)
  const float* vd;
  const int* pos_pool;     // (NP, P)
  const int* block_table;  // (B, nbt)
  const int* pos;          // (B,) query positions
  const int* lane_pages;   // (B,) page bound per lane, or null
  float* out;              // (B, H, Dv)
  int B, H, Hkv, D, Dv, P, nbt, nj, pps, npt, window;
  float scale, softcap;
};

// N (4 or 8) consecutive elements of a stored row, from shared memory at
// ``p`` (the first one's byte), as f32: quantized kinds times the row's
// scale, one f32 multiply each, as the plain version's.
template <int KIND, int N>
__device__ __forceinline__ void row_elems(const uint8_t* p, float sc,
                                          float (&o)[N]) {
  if constexpr (KIND == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = f.x;
      o[4 * i + 1] = f.y;
      o[4 * i + 2] = f.z;
      o[4 * i + 3] = f.w;
    }
  } else if constexpr (KIND == 1) {
    uint32_t u[N / 2];
    if constexpr (N == 8) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      u[0] = r.x, u[1] = r.y, u[2] = r.z, u[3] = r.w;
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      u[0] = r.x, u[1] = r.y;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  } else if constexpr (KIND == 2) {
    uint32_t u[N / 4];
    if constexpr (N == 8) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      u[0] = r.x, u[1] = r.y;
    } else {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      o[i] = (float)(int8_t)((u[i >> 2] >> (8 * (i & 3))) & 0xFFu) * sc;
  } else {
    // element 2i in the low nibble of byte i, 2i + 1 in the high one
    const uint32_t u = N == 8 ? *reinterpret_cast<const uint32_t*>(p)
                              : *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i)
      o[i] = (float)((int)(((u >> (4 * i)) & 15u) ^ 8u) - 8) * sc;
  }
}

// Lane gi of 8 holds partial sums of 8 rows; returns the sum over the 8
// lanes of row gi (three exchange steps, each halving the rows a lane
// keeps: 4 + 2 + 1 shuffles).
__device__ __forceinline__ float reduce_rows8(const float (&v)[RMAX], int gi) {
  const bool h4 = gi & 4, h2 = gi & 2, h1 = gi & 1;
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = h4 ? v[k] : v[k + 4];
    a[k] = (h4 ? v[k + 4] : v[k]) + __shfl_xor_sync(FULL, send, 4);
  }
  float c[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = h2 ? a[k] : a[k + 2];
    c[k] = (h2 ? a[k + 2] : a[k]) + __shfl_xor_sync(FULL, send, 2);
  }
  const float send = h1 ? c[0] : c[1];
  return (h1 ? c[1] : c[0]) + __shfl_xor_sync(FULL, send, 1);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// A thread's copies of the stored rows of one tile, V bytes each: copy u
// of the tile is row u / upr, chunk u % upr; the thread's first (row,
// chunk) is set once, then stepped by DNT copies without a divide.
struct RowCopies {
  int upr, t0, c0, dt, dc;
  __device__ __forceinline__ RowCopies(int row_bytes, int v, int tid) {
    upr = row_bytes / v;
    t0 = tid / upr;
    c0 = tid - t0 * upr;
    dt = DNT / upr;
    dc = DNT - dt * upr;
  }
};

template <int V>
__device__ __forceinline__ void copy_rows(const RowCopies& rc, uint8_t* dst,
                                          const uint8_t* pool, int rb, int nt,
                                          const int* bt, const int* tok,
                                          int P, int Hkv, int hkv) {
  int t = rc.t0, c = rc.c0;
  while (t < nt) {
    const int tk = tok[t];
    const size_t row = ((size_t)bt[tk >> 16] * P + (tk & 0xFFFF)) * Hkv + hkv;
    cp_async<V>(smem_u32(dst + t * rb + c * V), pool + row * rb + c * V);
    t += rc.dt;
    c += rc.dc;
    if (c >= rc.upr) {
      c -= rc.upr;
      ++t;
    }
  }
}

// (one block an SM is all the bound promises, so ptxas may give a thread
// up to 255 registers; held to 128, the q8_0 kernel spilled)
template <int KIND, int V>
__global__ void __launch_bounds__(DNT, 1)
    paged_attn_decode_kernel(DecodeArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t dsmem[];
  constexpr bool QUANT = KIND >= 2;
  const int D = a.D, Dv = a.Dv, P = a.P;
  const int tt = P * a.npt;
  const DecodeSmem L = decode_smem(KIND, D, Dv, tt, a.pps);
  uint8_t* ring = dsmem + L.ring;
  float* q_s = reinterpret_cast<float*>(dsmem + L.q);
  int* bt_s = reinterpret_cast<int*>(dsmem + L.bt);
  int* tok_s = reinterpret_cast<int*>(dsmem + L.tok);
  float* s_s = reinterpret_cast<float*>(dsmem + L.s);
  float* p_s = reinterpret_cast<float*>(dsmem + L.p);
  float* m_s = reinterpret_cast<float*>(dsmem + L.stats);
  float* l_s = m_s + RMAX;
  float* corr_s = l_s + RMAX;

  const int split = blockIdx.x, splits = gridDim.x;
  const int rep = a.H / a.Hkv, row_tiles = (rep + RMAX - 1) / RMAX;
  const int hkv = blockIdx.y / row_tiles;
  const int h0 = hkv * rep + (blockIdx.y % row_tiles) * RMAX;  // first head
  const int R = min(RMAX, hkv * rep + rep - h0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, gi = lane & 7;

  // the split's run of logical pages [js, je): its block-table slice and
  // the lane's bound load together
  const int js = split * a.pps;
  const int nbt_s = min(a.pps, a.nj - js);
  for (int i = tid; i < nbt_s; i += DNT)
    bt_s[i] = a.block_table[(size_t)b * a.nbt + js + i];
  const int jmax = a.lane_pages != nullptr
                       ? min(max(a.lane_pages[b], 1), a.nj)
                       : a.nj;
  const int qp = a.pos[b];
  const int je = min(js + a.pps, jmax);
  const int ntiles = je > js ? (je - js + a.npt - 1) / a.npt : 0;
  // scaled query rows, element e at (e & ~63) + 32 * ((e >> 2) & 1) + 4 *
  // ((e >> 3) & 7) + (e & 3): the 8 lanes of a token read 16 consecutive
  // bytes each
  for (int r = 0; r < R; ++r)
    for (int e = tid; e < D; e += DNT)
      q_s[r * L.qw + (e & ~63) + 32 * ((e >> 2) & 1) + 4 * ((e >> 3) & 7) +
          (e & 3)] = a.q[((size_t)b * a.H + h0 + r) * D + e] * a.scale;
  for (int t = tid; t < tt; t += DNT) tok_s[t] = ((t / P) << 16) | (t % P);
  if (tid < RMAX) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }
  __syncthreads();

  const RowCopies kc(L.krb, V, tid), vc(L.vrb, V, tid);
  // start the copies of tile i into ring slot ``slot``
  auto issue = [&](int i, int slot) {
    const int jt = js + i * a.npt;
    const int nt = min(a.npt, je - jt) * P;
    const int* bt = bt_s + (jt - js);
    uint8_t* st = ring + slot * L.stage;
    copy_rows<V>(kc, st, a.k, L.krb, nt, bt, tok_s, P, a.Hkv, hkv);
    copy_rows<V>(vc, st + L.st_v, a.v, L.vrb, nt, bt, tok_s, P, a.Hkv, hkv);
    for (int t = tid; t < nt; t += DNT) {
      const int tk = tok_s[t];
      const size_t pr = (size_t)bt[tk >> 16] * P + (tk & 0xFFFF);
      if constexpr (QUANT) {
        cp_async<4>(smem_u32(st + L.st_kd + 4 * t), a.kd + pr * a.Hkv + hkv);
        cp_async<4>(smem_u32(st + L.st_vd + 4 * t), a.vd + pr * a.Hkv + hkv);
      }
      cp_async<4>(smem_u32(st + L.st_pos + 4 * t), a.pos_pool + pr);
    }
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < ntiles) issue(i, i);
    cp_async_commit();
  }

  // p @ V: thread (quad, group) owns columns 4 quad .. 4 quad + 3 of every
  // row and the tile's tokens group, group + groups, ...
  const int nq = Dv / 4, groups = DNT / nq;
  const int quad = tid % nq, group = tid / nq;
  float acc[RMAX][4];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int slot = i % NSTAGE;
    const uint8_t* st = ring + slot * L.stage;
    const float* kd_s = reinterpret_cast<const float*>(st + L.st_kd);
    const float* vd_s = reinterpret_cast<const float*>(st + L.st_vd);
    const int* tp_s = reinterpret_cast<const int*>(st + L.st_pos);
    const int nt = min(a.npt, je - (js + i * a.npt)) * P;
    cp_async_wait<NSTAGE - 2>();   // this thread's copies of tile i
    __syncthreads();               // everyone's; tile i - 1 is consumed
    if (i + NSTAGE - 1 < ntiles) issue(i + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
    cp_async_commit();

    // scores: the 8 lanes of token t hold chunks gi, gi + 8, .. of its row
    for (int t0 = 0; t0 < nt; t0 += TOK_PASS) {
      const int t = t0 + (tid >> 3);
      float part[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) part[r] = 0.f;
      if (t < nt) {
        const uint8_t* kr = st + t * L.krb;
        const float sc = QUANT ? kd_s[t] : 1.f;
#pragma unroll
        for (int i8 = 0; i8 < CMAX; ++i8) {
          const int c = gi + GL * i8;
          if (c * 8 < D) {
            float kf[8];
            row_elems<KIND, 8>(kr + kind_bytes(KIND, 8 * c), sc, kf);
            const float* qc = q_s + 64 * i8 + 4 * gi;
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              if (r < R) {
                const float4 x0 = *reinterpret_cast<const float4*>(qc + r * L.qw);
                const float4 x1 =
                    *reinterpret_cast<const float4*>(qc + r * L.qw + 32);
                float s = part[r];
                s = fmaf(x0.x, kf[0], s);
                s = fmaf(x0.y, kf[1], s);
                s = fmaf(x0.z, kf[2], s);
                s = fmaf(x0.w, kf[3], s);
                s = fmaf(x1.x, kf[4], s);
                s = fmaf(x1.y, kf[5], s);
                s = fmaf(x1.z, kf[6], s);
                s = fmaf(x1.w, kf[7], s);
                part[r] = s;
              }
            }
          }
        }
      }
      float dot = reduce_rows8(part, gi);
      if (t < nt && gi < R) {
        if (a.softcap != 0.f) dot = a.softcap * tanhf(dot / a.softcap);
        s_s[gi * tt + t] = dot;
      }
    }
    __syncthreads();

    // online softmax, a warp per row (its RPW rows side by side); masked
    // keys' probabilities are 0
    {
      float mx[RPW], sum[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) mx[k] = NEG_INF, sum[k] = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const int tp = tp_s[t];
        if (tp >= 0 && tp <= qp && (a.window == 0 || tp > qp - a.window)) {
#pragma unroll
          for (int k = 0; k < RPW; ++k)
            if (w + NW * k < R) mx[k] = fmaxf(mx[k], s_s[(w + NW * k) * tt + t]);
        }
      }
      float m_prev[RPW], m_new[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        mx[k] = warp_max(mx[k]);
        m_prev[k] = w + NW * k < R ? m_s[w + NW * k] : NEG_INF;
        m_new[k] = fmaxf(m_prev[k], mx[k]);
      }
      for (int t = lane; t < nt; t += 32) {
        const int tp = tp_s[t];
        const bool ok = tp >= 0 && tp <= qp && (a.window == 0 || tp > qp - a.window);
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          const int r = w + NW * k;
          if (r < R) {
            const float p = ok ? expf(s_s[r * tt + t] - m_new[k]) : 0.f;
            p_s[t * RMAX + r] = p;
            sum[k] += p;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = w + NW * k;
        sum[k] = warp_sum(sum[k]);
        if (lane == 0 && r < R) {
          const float cr = expf(m_prev[k] - m_new[k]);
          l_s[r] = l_s[r] * cr + sum[k];
          m_s[r] = m_new[k];
          corr_s[r] = cr;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V over this thread's tokens
    if (group < groups) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const float cr = corr_s[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= cr;
      }
      const uint8_t* vq = st + L.st_v + kind_bytes(KIND, 4 * quad);
#pragma unroll 2
      for (int t = group; t < nt; t += groups) {
        float vf[4];
        row_elems<KIND, 4>(vq + t * L.vrb, QUANT ? vd_s[t] : 1.f, vf);
        const float4 pa = *reinterpret_cast<const float4*>(p_s + t * RMAX);
        const float4 pb = *reinterpret_cast<const float4*>(p_s + t * RMAX + 4);
        const float pr[RMAX] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pr[r], vf[c], acc[r][c]);
          }
        }
      }
    }
  }

  // the groups' shares of acc, summed in group order, in place in the ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (group < groups) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[(group * RMAX + r) * Dv + 4 * quad + c] = acc[r][c];
      }
    }
  }
  __syncthreads();
  for (int r = 0; r < R; ++r)
    for (int d = tid; d < Dv; d += DNT) {
      float v = red[r * Dv + d];
      for (int g = 1; g < groups; ++g) v += red[(g * RMAX + r) * Dv + d];
      red[r * Dv + d] = v;
    }

  // every block of the cluster merges a slice of the outputs from all the
  // blocks' partials, in rank order
  cluster.sync();
  float* wts = reinterpret_cast<float*>(dsmem + L.wts);   // splits x RMAX
  float* lsum = wts + MAX_SPLITS * RMAX;
  if (tid < R) {
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
    float l = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < splits) {
        const float e = expf(ms[sp] - mx);
        wts[sp * RMAX + tid] = e;
        l += ls[sp] * e;
      }
    }
    lsum[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int n_out = R * Dv, rank = (int)cluster.block_rank();
  const int lo = n_out * rank / splits, hi = n_out * (rank + 1) / splits;
  for (int idx = lo + tid; idx < hi; idx += DNT) {
    const int r = idx / Dv;
    float part[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) part[sp] = cluster.map_shared_rank(red, sp)[idx];
    float v = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) v += part[sp] * wts[sp * RMAX + r];
    a.out[((size_t)b * a.H + h0 + r) * Dv + idx - r * Dv] = v / lsum[r];
  }
  cluster.sync();   // each block's shared memory stays until all have read it
}

template <int KIND, int V>
int launch_decode(const DecodeArgs& a, int splits, cudaStream_t stream) {
  auto kernel = paged_attn_decode_kernel<KIND, V>;
  const DecodeSmem L = decode_smem(KIND, a.D, a.Dv, a.P * a.npt, a.pps);
  static int configured = 48 * 1024;   // the largest size allowed so far
  if (L.total > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    configured = L.total;
  }
  const int rep = a.H / a.Hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.Hkv * ((rep + RMAX - 1) / RMAX), a.B);
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

template <int KIND>
int launch_decode_kind(const DecodeArgs& a, int splits, int v16,
                       cudaStream_t stream) {
  return v16 ? launch_decode<KIND, 16>(a, splits, stream)
             : launch_decode<KIND, 4>(a, splits, stream);
}

// ---------------------------------------------------------------------------
// Prefill on tensor cores: paged_attn_prefill_kernel (see the header)
// ---------------------------------------------------------------------------

constexpr int PNT = 128;             // threads a prefill block (4 warps)
constexpr int PROWS = 64;            // query rows a block, 16 a warp
constexpr int PKT = 32;              // keys a tile
static_assert(PROWS == 16 * (PNT / 32) && PROWS == 64,
              "a warp's 16 rows; the rows' positions are two warps' loads");

// Shared memory of a prefill block (byte offsets).  Query and key rows are
// bf16 of dp elements (D rounded up to 16), value rows of vp (Dv), each
// ``pitch`` = 2 width + 16 bytes apart, so that the eight 16-byte rows of
// an ldmatrix fall in distinct banks; ``nq`` planes of the key and value
// tiles (bf16 queries: one, the codes; f32: three, the terms hi, mid, lo
// of the dequantized keys and values).  f32 queries are kept as f32 rows
// (4 width + 32 bytes apart), so that a q8_0 block fits twice an SM.
// After the walk, a split block's partial (acc, m, l) and its merge
// weights overlay the front.
struct PrefillSmem {
  int dp, vp, qpitch, vpitch, qfpitch;
  int krb, vrb, krs, vrs;      // bytes of a stored K / V row; in the stage
  int st_v, st_kd, st_vd, st_pos, st_bytes;
  int q, k, v, stage, kd, vd, tpos, rpos, qmax;
  int red, rm, rl, wts, lsum, total;
};

__host__ __device__ inline PrefillSmem prefill_smem(int kind, int D, int Dv,
                                                    int nq) {
  PrefillSmem L{};
  L.dp = align16(D);
  L.vp = align16(Dv);
  L.qpitch = 2 * L.dp + 16;
  L.qfpitch = 4 * L.dp + 32;
  L.vpitch = 2 * L.vp + 16;
  L.krb = kind_bytes(kind, D);
  L.vrb = kind_bytes(kind, Dv);
  L.krs = align16(L.krb);
  L.vrs = align16(L.vrb);
  L.st_v = PKT * L.krs;
  L.st_kd = L.st_v + PKT * L.vrs;
  L.st_vd = L.st_kd + PKT * 4;
  L.st_pos = L.st_vd + PKT * 4;
  L.st_bytes = align16(L.st_pos + PKT * 4);
  int off = 0;
  // the query tile: bf16 rows, or (f32 queries) f32 rows of q * scale,
  // split into their three terms as the mma fragments are read
  L.q = off;      off += PROWS * (nq == 1 ? L.qpitch : L.qfpitch);
  L.k = off;      off += nq * PKT * L.qpitch;     // the key tile's planes
  L.v = off;      off += nq * PKT * L.vpitch;     // the value tile's
  L.stage = off;  off += 2 * L.st_bytes;          // two stages, as stored
  L.kd = off;     off += PKT * 4;                 // the tile's row scales
  L.vd = off;     off += PKT * 4;
  L.tpos = off;   off += PKT * 4;                 // its keys' positions
  L.rpos = off;   off += PROWS * 4;               // the rows' query positions
  L.qmax = off;   off += 16;
  int merge = 0;
  L.red = merge;  merge += PROWS * Dv * 4;        // acc, rows Dv floats apart
  L.rm = merge;   merge += PROWS * 4;
  L.rl = merge;   merge += PROWS * 4;
  L.wts = merge;  merge += MAX_SPLITS * PROWS * 4;
  L.lsum = merge; merge += PROWS * 4;
  L.total = off > merge ? off : merge;
  return L;
}

struct PrefillArgs {
  const void* q;           // (B, C, H, D) f32 or bf16
  const uint8_t* k;        // (NP, P, Hkv, D) int8 (q4_0: D/2 bytes)
  const uint8_t* v;        // (NP, P, Hkv, Dv)     (q4_0: Dv/2)
  const float* kd;         // (NP, P, Hkv) row scales
  const float* vd;
  const int* pos_pool;     // (NP, P)
  const int* block_table;  // (B, nbt)
  const int* qpos;         // (B, C) query positions, -1 = padded row
  float* out;              // (B, C, H, Dv)
  int B, C, H, Hkv, D, Dv, P, nbt, nj, window;
  int kw, vw;              // copy widths of the K / V rows: 16, 4, 1
  int qcopy;               // 1: bf16 query rows copied as they are (16 B)
  float scale, softcap;
};

// KIND: the pools' kind (2 q8_0, 3 q4_0); QF32: f32 queries (else bf16);
// NV: the n8 tiles of Dv a warp's accumulator holds (16: Dv <= 128, 32:
// Dv <= 256).  bf16 queries (the serve's): the tiles hold the exact codes,
// each key's row scale is applied in f32 to its column of S and folded
// into its column of P.  f32 queries (the parity runs and the f32 tests):
// the plain version's function to f32 rounding instead, as the f32 path of
// qmatmul_prefill_kernel computes it: q * scale and the keys and values
// dequantized as the plain version rounds them (code * row scale), each
// as three bf16 terms, six mmas a k16 step smallest first into a sum
// zeroed for the step (the three term products below f32 precision
// dropped).  Factoring the scales out of the sums moved a q4_0 KV code of
// a later layer a step from the CPU's in the parity run.
template <int KIND, bool QF32, int NV>
__global__ void __launch_bounds__(PNT)
    paged_attn_prefill_kernel(PrefillArgs a) {
  constexpr int NQ = QF32 ? 3 : 1;
  extern __shared__ __align__(16) uint8_t psmem[];
  const int D = a.D, Dv = a.Dv, P = a.P;
  const PrefillSmem L = prefill_smem(KIND, D, Dv, NQ);
  uint8_t* q_s = psmem + L.q;
  uint8_t* k_s = psmem + L.k;
  uint8_t* v_s = psmem + L.v;
  float* kd_s = reinterpret_cast<float*>(psmem + L.kd);
  float* vd_s = reinterpret_cast<float*>(psmem + L.vd);
  int* tpos_s = reinterpret_cast<int*>(psmem + L.tpos);
  int* rpos_s = reinterpret_cast<int*>(psmem + L.rpos);
  int* qmax_s = reinterpret_cast<int*>(psmem + L.qmax);

  const int split = blockIdx.x, splits = gridDim.x;
  const int rep = a.H / a.Hkv, nrows = a.C * rep;
  const int row_tiles = (nrows + PROWS - 1) / PROWS;
  const int hkv = blockIdx.y / row_tiles;
  const int R0 = (blockIdx.y - hkv * row_tiles) * PROWS;   // first row
  const int b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // row i is (query c, rep head r) = ((R0 + i) / rep, (R0 + i) % rep): its
  // position (-1 past the chunk's rows), and the rows' largest
  if (tid < PROWS) {
    const int row = R0 + tid;
    int qp = row < nrows ? a.qpos[(size_t)b * a.C + row / rep] : -1;
    rpos_s[tid] = qp;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) qp = max(qp, __shfl_xor_sync(FULL, qp, o));
    if (lane == 0) qmax_s[w] = qp;
  }
  __syncthreads();
  // the keys any row can see: logical index <= the largest position, in
  // the first nj pages; this block's run of their tiles [i0, i1)
  const int qmax = max(qmax_s[0], qmax_s[1]);
  const int nvalid = qmax < 0 ? 0 : min(qmax + 1, a.nj * P);
  const int ntiles = (nvalid + PKT - 1) / PKT;
  const int i0 = ntiles * split / splits, i1 = ntiles * (split + 1) / splits;

  const uint8_t* kpool = a.k + (size_t)hkv * L.krb;
  const uint8_t* vpool = a.v + (size_t)hkv * L.vrb;
  const size_t kstride = (size_t)a.Hkv * L.krb, vstride = (size_t)a.Hkv * L.vrb;
  // lane t's token row for key t of tile i (a global load, made a tile
  // ahead of its use)
  auto token_row = [&](int i) {
    const int u = i * PKT + lane;
    if (i >= i1 || u >= nvalid) return 0;
    const int pg = u / P;
    return a.block_table[(size_t)b * a.nbt + pg] * P + (u - pg * P);
  };
  // start the copies of tile i into stage (i - i0) % 2, as stored
  auto issue = [&](int i, int grow) {
    uint8_t* st = psmem + L.stage + ((i - i0) & 1) * L.st_bytes;
    const int nt = min(PKT, nvalid - i * PKT);
    copy_leaf<PNT / 32>(st, kpool, L.krb, L.krs, kstride, a.kw, nt, grow, w,
                        lane);
    copy_leaf<PNT / 32>(st + L.st_v, vpool, L.vrb, L.vrs, vstride, a.vw, nt,
                        grow, w, lane);
    if (lane < nt) {
      const size_t hrow = (size_t)grow * a.Hkv + hkv;
      if (w == 0) cp_async<4>(smem_u32(st + L.st_kd + 4 * lane), a.kd + hrow);
      if (w == 1) cp_async<4>(smem_u32(st + L.st_vd + 4 * lane), a.vd + hrow);
      if (w == 2)
        cp_async<4>(smem_u32(st + L.st_pos + 4 * lane), a.pos_pool + grow);
    }
  };
  if (i0 < i1) issue(i0, token_row(i0));

  // the query tile: row i's head hkv * rep + r as bf16, zero past D and
  // past the chunk's rows (f32 queries: q * scale as f32).
  // bf16 rows of whole 16-byte pieces are copied as they are, in the
  // first tile's group.
  constexpr int QSIZE = QF32 ? 4 : 2;
  auto q_row = [&](int i) -> const uint8_t* {
    const int row = R0 + i;
    if (row >= nrows) return nullptr;
    const int h = hkv * rep + row % rep;
    return static_cast<const uint8_t*>(a.q) +
           (((size_t)b * a.C + row / rep) * a.H + h) * D * QSIZE;
  };
  if (!QF32 && a.qcopy) {
    const int np = L.dp / 8;                           // 16-byte pieces
    for (int idx = tid; idx < PROWS * np; idx += PNT) {
      const int r = idx / np, pc = idx - r * np;
      const uint8_t* src = q_row(r);
      const bool in = src != nullptr && 8 * pc < D;
      cp_async_zfill(smem_u32(q_s + r * L.qpitch + 16 * pc),
                     in ? src + 16 * pc : a.q, in ? 16 : 0);
    }
  }
  cp_async_commit();
  int grow_next = token_row(i0 + 1);
  if (QF32 || !a.qcopy) {
    // a thread's loads of a batch are all issued before its stores
    const int nch = L.dp / 4;                          // 4-element chunks
    constexpr int QB = 4;
    for (int j0 = tid; j0 < PROWS * nch; j0 += QB * PNT) {
      float4 v[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int idx = j0 + u * PNT, r = idx / nch, ch = idx - r * nch;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        const uint8_t* src = idx < PROWS * nch ? q_row(r) : nullptr;
        if (src != nullptr) v[u] = q_elems4(src, 4 * ch, D, !QF32);
        if constexpr (QF32)
          v[u] = make_float4(__fmul_rn(v[u].x, a.scale),
                             __fmul_rn(v[u].y, a.scale),
                             __fmul_rn(v[u].z, a.scale),
                             __fmul_rn(v[u].w, a.scale));
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int idx = j0 + u * PNT, r = idx / nch, ch = idx - r * nch;
        if (idx < PROWS * nch) {
          if constexpr (QF32)
            *reinterpret_cast<float4*>(q_s + r * L.qfpitch + 16 * ch) = v[u];
          else
            store_bf16x4<1>(q_s + r * L.qpitch + 8 * ch, v[u], 0);
        }
      }
    }
  }

  // this lane's rows g and g + 8 of the warp's 16: their positions and
  // softmax state (l: this lane's share, summed over the row's four lanes
  // at the end); acc: the rows' Dv columns, n8 tile j in acc[j]
  const int qp0 = rpos_s[16 * w + g], qp1 = rpos_s[16 * w + g + 8];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  const int nkd = L.dp / 16, nvp = L.vp / 16;   // k16 steps of D; Dv pairs
  // ldmatrix row addresses: lane i gives row i % 8 of matrix i / 8
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t qa = smem_u32(q_s) +
                      (16 * w + (mi & 1) * 8 + mr) * L.qpitch + (mi >> 1) * 16;
  const uint32_t ka = smem_u32(k_s) + ((mi >> 1) * 8 + mr) * L.qpitch +
                      (mi & 1) * 16;
  const uint32_t va = smem_u32(v_s) + ((mi & 1) * 8 + mr) * L.vpitch +
                      (mi >> 1) * 16;

  for (int i = i0; i < i1; ++i) {
    const int nt = min(PKT, nvalid - i * PKT);
    cp_async_wait<0>();
    __syncthreads();   // tile i's rows landed; the tiles are consumed
    if (i + 1 < i1) issue(i + 1, grow_next);
    cp_async_commit();
    grow_next = token_row(i + 2);

    // the stage as bf16 codes (exact: int8 and int4 values; f32 queries:
    // code * row scale as three terms), rows past nt zero; its row scales
    // and positions beside them (past nt: 0 and -1).  Warp w converts rows
    // w, w + 4, .., its lanes along the K and V rows.
    {
      const uint8_t* st = psmem + L.stage + ((i - i0) & 1) * L.st_bytes;
      const float* st_kd = reinterpret_cast<const float*>(st + L.st_kd);
      const float* st_vd = reinterpret_cast<const float*>(st + L.st_vd);
      const int nck = L.dp / 4, ncv = L.vp / 4;
      for (int r = w; r < PKT; r += PNT / 32) {
        for (int ch = lane; ch < nck + ncv; ch += 32) {
          const bool isk = ch < nck;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < nt) {
            v = isk ? codes4<KIND>(st + r * L.krs, 4 * ch, D)
                    : codes4<KIND>(st + L.st_v + r * L.vrs, 4 * (ch - nck),
                                   Dv);
            if constexpr (QF32) {
              const float sc = isk ? st_kd[r] : st_vd[r];
              v = make_float4(__fmul_rn(v.x, sc), __fmul_rn(v.y, sc),
                              __fmul_rn(v.z, sc), __fmul_rn(v.w, sc));
            }
          }
          if (isk)
            store_bf16x4<NQ>(k_s + r * L.qpitch + 8 * ch, v,
                             PKT * L.qpitch);
          else
            store_bf16x4<NQ>(v_s + r * L.vpitch + 8 * (ch - nck), v,
                             PKT * L.vpitch);
        }
      }
      if (tid < PKT) {
        const bool in = tid < nt;
        kd_s[tid] = in ? st_kd[tid] : 0.f;
        vd_s[tid] = in ? st_vd[tid] : 0.f;
        tpos_s[tid] = in ? reinterpret_cast<const int*>(st + L.st_pos)[tid] : -1;
      }
    }
    __syncthreads();   // the tiles are whole

    // S = Q . K^T for the warp's 16 rows and the tile's 32 keys.  bf16
    // queries: four k16 steps (64 elements of D) accumulate in the tensor
    // core, then in f32 registers; f32: each k16 step's six term products,
    // smallest first, then in f32.  s[j]: keys 8 j + 2t, + 1 of rows g
    // (s[j][0..1]) and g + 8 (s[j][2..3]).
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) s[j][v] = 0.f;
    constexpr int KG = QF32 ? 1 : 4;   // k16 steps a tensor-core sum
    for (int kg = 0; kg < nkd; kg += KG) {
      float d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) d[j][v] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KG; ++kq) {
        const int ks = kg + kq;
        if (ks < nkd) {
          // qf[u]: the queries' term u (bf16: the queries); kf[u][h]: key
          // plane u, keys 16 h ..
          uint32_t qf[NQ][4], kf[NQ][2][4];
          if constexpr (QF32) {
            // a[j]: rows g (j even) or g + 8, elements 2t (j < 2) or 2t + 8
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 v = *reinterpret_cast<const float2*>(
                  q_s + (16 * w + g + 8 * (j & 1)) * L.qfpitch +
                  (16 * ks + 2 * t + 8 * (j >> 1)) * 4);
              split3(v.x, v.y, qf[0][j], qf[1][j], qf[2][j]);
            }
          } else {
            ldmatrix_x4<false>(qf[0], qa + ks * 32);
          }
#pragma unroll
          for (int u = 0; u < NQ; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              ldmatrix_x4<false>(kf[u][h], ka + (u * PKT + 16 * h) *
                                                    L.qpitch + ks * 32);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t(&k)[NQ][2][4] = kf;
            const int h = j >> 1, c = 2 * (j & 1);
            if constexpr (QF32) {
              mma_bf16(d[j], qf[2], k[0][h][c], k[0][h][c + 1]);
              mma_bf16(d[j], qf[1], k[1][h][c], k[1][h][c + 1]);
              mma_bf16(d[j], qf[0], k[2][h][c], k[2][h][c + 1]);
              mma_bf16(d[j], qf[1], k[0][h][c], k[0][h][c + 1]);
              mma_bf16(d[j], qf[0], k[1][h][c], k[1][h][c + 1]);
              mma_bf16(d[j], qf[0], k[0][h][c], k[0][h][c + 1]);
            } else {
              mma_bf16(d[j], qf[0], k[0][h][c], k[0][h][c + 1]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) s[j][v] += d[j][v];
    }

    // (bf16 queries: each key's column times its row scale and ``scale``)
    // the softcap, then the mask: a key is valid for a row iff written (pos
    // >= 0), causal (pos <= qpos), inside the window, and its logical index
    // <= qpos
    float mx[2] = {NEG_INF, NEG_INF};
    unsigned valid = 0;   // bit 4 j + v
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int key = 8 * j + 2 * t + (v & 1);
        const int qp = v < 2 ? qp0 : qp1, tp = tpos_s[key];
        float x = QF32 ? s[j][v] : s[j][v] * kd_s[key] * a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        s[j][v] = x;
        if (tp >= 0 && tp <= qp && i * PKT + key <= qp &&
            (a.window == 0 || tp > qp - a.window)) {
          valid |= 1u << (4 * j + v);
          mx[v >> 1] = fmaxf(mx[v >> 1], x);
        }
      }
    }
    // online softmax in registers, four lanes a row; masked keys'
    // probabilities are 0
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
        const float pv =
            (valid >> (4 * j + v)) & 1u ? expf(s[j][v] - m[v >> 1]) : 0.f;
        l[v >> 1] += pv;
        // (bf16 queries: the value row's scale, folded in)
        s[j][v] = QF32 ? pv : pv * vd_s[key];
      }
    }
    // (a warp whose rows' maxima all stayed keeps its accumulator as is)
    if (__any_sync(FULL, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
    }

    // acc += P . V: P (16 rows x 32 keys) as three bf16 terms, the A
    // fragments of the two k16 steps straight from S's layout; V's columns
    // by ldmatrix.trans.  bf16 queries: both steps and the three terms
    // accumulate in the tensor core, then in f32 registers; f32: each
    // step's six term products (P's by the values'), smallest first, then
    // in f32.
    uint32_t pf[2][3][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split3(s[2 * kk][0], s[2 * kk][1], pf[kk][0][0], pf[kk][1][0],
             pf[kk][2][0]);
      split3(s[2 * kk][2], s[2 * kk][3], pf[kk][0][1], pf[kk][1][1],
             pf[kk][2][1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], pf[kk][0][2], pf[kk][1][2],
             pf[kk][2][2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], pf[kk][0][3], pf[kk][1][3],
             pf[kk][2][3]);
    }
#pragma unroll
    for (int cp = 0; cp < NV / 2; ++cp) {
      if (cp < nvp) {
        uint32_t vf[NQ][2][4];   // value plane u, keys 16 kk ..
#pragma unroll
        for (int u = 0; u < NQ; ++u)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            ldmatrix_x4<true>(vf[u][kk], va + (u * PKT + kk * 16) *
                                                  L.vpitch + cp * 32);
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const int c = 2 * jt;
          if constexpr (QF32) {
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const uint32_t(&p)[3][4] = pf[kk];
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(d, p[2], vf[0][kk][c], vf[0][kk][c + 1]);
              mma_bf16(d, p[1], vf[1][kk][c], vf[1][kk][c + 1]);
              mma_bf16(d, p[0], vf[2][kk][c], vf[2][kk][c + 1]);
              mma_bf16(d, p[1], vf[0][kk][c], vf[0][kk][c + 1]);
              mma_bf16(d, p[0], vf[1][kk][c], vf[1][kk][c + 1]);
              mma_bf16(d, p[0], vf[0][kk][c], vf[0][kk][c + 1]);
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[2 * cp + jt][v] += d[v];
            }
          } else {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
              for (int u = 0; u < 3; ++u)
                mma_bf16(d, pf[kk][u], vf[0][kk][c], vf[0][kk][c + 1]);
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[2 * cp + jt][v] += d[v];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // l summed over the row's four lanes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
  }
  // (b, query, head) of block row r, as an offset into out
  auto out_row = [&](int r) {
    const int row = R0 + r;
    return (((size_t)b * a.C + row / rep) * a.H + hkv * rep + row % rep) *
           (size_t)Dv;
  };
  if (splits == 1) {
    // out = acc / l, l clamped (a row with no valid key gives zeros)
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int cp = 0; cp < NV / 2; ++cp) {
      if (cp < nvp) {
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const int col = 16 * cp + 8 * jt + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h;
            if (col < Dv && R0 + r < nrows)
              *reinterpret_cast<float2*>(a.out + out_row(r) + col) =
                  make_float2(acc[2 * cp + jt][2 * h] / l[h],
                              acc[2 * cp + jt][2 * h + 1] / l[h]);
          }
        }
      }
    }
    return;
  }

  // the cluster's blocks split the key tiles: each leaves its partial (acc,
  // m, l) in shared memory, and every block merges a slice of the outputs
  // from all the blocks' partials, in rank order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();   // every warp is done with the tiles
  float* red = reinterpret_cast<float*>(psmem + L.red);
  float* rm = reinterpret_cast<float*>(psmem + L.rm);
  float* rl = reinterpret_cast<float*>(psmem + L.rl);
#pragma unroll
  for (int cp = 0; cp < NV / 2; ++cp) {
    if (cp < nvp) {
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int col = 16 * cp + 8 * jt + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (col < Dv)
            *reinterpret_cast<float2*>(red + (16 * w + g + 8 * h) * Dv +
                                       col) =
                make_float2(acc[2 * cp + jt][2 * h],
                            acc[2 * cp + jt][2 * h + 1]);
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rm[16 * w + g + 8 * h] = m[h];
      rl[16 * w + g + 8 * h] = l[h];
    }
  }
  cluster.sync();
  float* wts = reinterpret_cast<float*>(psmem + L.wts);   // splits x PROWS
  float* lsum = reinterpret_cast<float*>(psmem + L.lsum);
  if (tid < PROWS) {
    float ms[MAX_SPLITS], ls[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < splits) {
        ms[sp] = cluster.map_shared_rank(rm, sp)[tid];
        ls[sp] = cluster.map_shared_rank(rl, sp)[tid];
      }
    }
    float mxs = NEG_INF;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) mxs = fmaxf(mxs, ms[sp]);
    float lt = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < splits) {
        const float e = expf(ms[sp] - mxs);
        wts[sp * PROWS + tid] = e;
        lt += ls[sp] * e;
      }
    }
    lsum[tid] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  const int n_out = PROWS * Dv, rank = (int)cluster.block_rank();
  const int lo = n_out * rank / splits, hi = n_out * (rank + 1) / splits;
  for (int idx = lo + tid; idx < hi; idx += PNT) {
    const int r = idx / Dv;
    float part[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) part[sp] = cluster.map_shared_rank(red, sp)[idx];
    float o = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < splits) o += part[sp] * wts[sp * PROWS + r];
    if (R0 + r < nrows) a.out[out_row(r) + idx - r * Dv] = o / lsum[r];
  }
  cluster.sync();   // each block's shared memory stays until all have read it
}

template <int KIND, bool QF32, int NV>
int launch_prefill(const PrefillArgs& a, int splits, cudaStream_t stream) {
  auto kernel = paged_attn_prefill_kernel<KIND, QF32, NV>;
  const PrefillSmem L = prefill_smem(KIND, a.D, a.Dv, QF32 ? 3 : 1);
  static int configured = 48 * 1024;   // the largest size allowed so far
  if (L.total > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    configured = L.total;
  }
  const int row_tiles = (a.C * (a.H / a.Hkv) + PROWS - 1) / PROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.Hkv * row_tiles, a.B);
  cfg.blockDim = dim3(PNT);
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

template <int KIND>
int launch_prefill_kind(const PrefillArgs& a, bool q_bf16, int splits,
                        cudaStream_t st) {
  if (a.Dv <= 128)
    return q_bf16 ? launch_prefill<KIND, false, 16>(a, splits, st)
                  : launch_prefill<KIND, true, 16>(a, splits, st);
  return q_bf16 ? launch_prefill<KIND, false, 32>(a, splits, st)
                : launch_prefill<KIND, true, 32>(a, splits, st);
}

}  // namespace

// Chunked prefill (paged_attn_prefill_kernel): kv_kind 2 = q8_0 (int8 + f32
// row scales), 3 = q4_0 (two int4 a byte + f32 row scales; D and Dv are
// the logical widths); q float32 (q_bf16 = 0) or bfloat16 (q_bf16 = 1),
// (B, C, H, D); qpos (B, C) the query positions, -1 for padded rows.  A key
// is masked past the query's position by its logical index too.  D and Dv
// are multiples of 8, at most 256.  A block holds 64 (query, rep head) rows
// of one kv head; ``splits`` (1..8) blocks a cluster split its key tiles.
// Returns the launch's error code.
extern "C" int paged_attn_prefill(int kv_kind, int q_bf16, const void* q,
                                  const void* k, const void* v,
                                  const float* kd, const float* vd,
                                  const int* pos_pool, const int* block_table,
                                  const int* qpos, float* out, int B, int C,
                                  int H, int Hkv, int D, int Dv, int P,
                                  int nbt, int nj, int splits, int window,
                                  float scale, float softcap, void* stream) {
  if ((kv_kind != 2 && kv_kind != 3) || (q_bf16 != 0 && q_bf16 != 1) ||
      D < 8 || Dv < 8 || D % 8 || Dv % 8 || D > 256 || Dv > 256 || P < 1 ||
      nj < 1 || Hkv < 1 || H % Hkv || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (prefill_smem(kv_kind, D, Dv, q_bf16 ? 1 : 3).total > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int krb = kind_bytes(kv_kind, D), vrb = kind_bytes(kv_kind, Dv);
  PrefillArgs a{q, static_cast<const uint8_t*>(k),
                static_cast<const uint8_t*>(v), kd, vd, pos_pool,
                block_table, qpos, out, B, C, H, Hkv, D, Dv, P, nbt, nj,
                window, copy_width(krb, k), copy_width(vrb, v),
                q_bf16 && reinterpret_cast<uintptr_t>(q) % 16 == 0, scale,
                softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_kind == 2 ? launch_prefill_kind<2>(a, q_bf16, splits, st)
                      : launch_prefill_kind<3>(a, q_bf16, splits, st);
}

// One-token decode (paged_attn_decode_kernel): kv_kind 0 = float32 pages,
// 1 = bfloat16 pages, 2 = q8_0, 3 = q4_0 (as above); pos (B,)
// the query positions; lane_pages (B,) or null.  The walk over the first
// nj logical pages is split into ``splits`` runs of ``pps`` pages (1 <=
// splits <= 8, (splits - 1) * pps < nj <= splits * pps), one block each, a
// cluster per (lane, kv head, row tile of 8 heads).  D and Dv are multiples
// of 8, at most 256; P <= 128.  K/V rows are copied 16 bytes at a time when
// every row and both pools' addresses are 16-byte aligned, else 4.  Returns
// the launch's error code.
extern "C" int paged_attn_decode(int kv_kind, const float* q, const void* k,
                                 const void* v, const float* kd,
                                 const float* vd, const int* pos_pool,
                                 const int* block_table, const int* pos,
                                 const int* lane_pages, float* out, int B,
                                 int H, int Hkv, int D, int Dv, int P, int nbt,
                                 int nj, int splits, int pps, int window,
                                 float scale, float softcap, void* stream) {
  if (kv_kind < 0 || kv_kind > 3 || D % 8 || Dv % 8 || D > 256 || Dv > 256 ||
      P < 1 || P > 128 || H % Hkv || splits < 1 || splits > MAX_SPLITS ||
      pps < 1 || (splits - 1) * pps >= nj || splits * pps < nj)
    return (int)cudaErrorInvalidValue;
  const int npt = P >= TILE_TOKENS ? 1 : (TILE_TOKENS + P - 1) / P;
  DecodeArgs a{q, static_cast<const uint8_t*>(k),
               static_cast<const uint8_t*>(v), kd, vd, pos_pool, block_table,
               pos, lane_pages, out, B, H, Hkv, D, Dv, P, nbt, nj, pps, npt,
               window, scale, softcap};
  const int krb = kind_bytes(kv_kind, D), vrb = kind_bytes(kv_kind, Dv);
  const int v16 = (krb % 16 == 0 && vrb % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & 15) == 0);
  if (decode_smem(kv_kind, D, Dv, P * npt, pps).total > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0: return launch_decode_kind<0>(a, splits, v16, st);
    case 1: return launch_decode_kind<1>(a, splits, v16, st);
    case 2: return launch_decode_kind<2>(a, splits, v16, st);
    default: return launch_decode_kind<3>(a, splits, v16, st);
  }
}
