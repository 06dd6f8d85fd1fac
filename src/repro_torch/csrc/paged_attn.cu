// Paged GQA attention over KV page pools, for Hopper: one-token decode and
// write-then-attend chunked prefill.
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attn.py::_attn_core
// (body :321-362; entries paged_attn_decode :183, paged_attn_decode_quant
// :728, paged_attn_decode_q8 :761) with its f32, q8_0 and q4_0 tile loaders
// (q4_0: _dequant :217 -> unpack_q4_rows :692), and ::_attn_prefill_core
// (body :880-919; entry paged_attn_prefill_quant :784) with the q8_0 and
// q4_0 loaders.
//
// What bounds decode on an H100: the page bytes it streams (each live K/V
// row once per kv head, ~1 MB for 4 lanes of 100-400 tokens: 0.3 us at
// 3.35 TB/s) and ~2 * rep flops per K/V element — far below either peak,
// so a launch is bound by latency: the dependent loads (lane bound and
// block table, then the pages) and the length of the longest serial walk.
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
// The reference's numerics are kept: NEG_INF = -2e38 is a finite sentinel,
// so the probabilities of masked keys are set to exactly 0, a window and a
// softcap apply as there, and l is clamped at 1e-30 before the divide (a
// row with no valid key gives zeros).
//
// Prefill design (paged_attn_kernel).  One block owns (lane, kv head, query
// tile) and the page walk is a loop inside the block, with (m, l, acc) in
// shared memory.  The block reads its own block-table entry per page, loads
// one page sub-tile (TP tokens) of K and V into shared memory as f32 (q8_0
// pages as int8 x the row's f32 scale, q4_0 pages as the row's
// sign-extended nibble x its f32 scale: one f32 multiply, as the plain
// version's), scores the block's query rows against it, folds the
// tile into the online softmax and accumulates p @ V.  It stops after the
// last page any of the tile's queries can see (pages past it are fully
// masked, and a fully masked tile is an exact no-op).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads per prefill block
constexpr int TP = 16;            // tokens per page sub-tile
constexpr float NEG_INF = -2.0e38f;

// The prefill kernel's arguments.  Its body is the one-block-a-lane design
// that decode also ran before paged_attn_decode_kernel; the entry point
// passes lane_pages = null and logical_mask = 1.
struct Args {
  const float* q;          // (B, C, H, D) f32
  const void* k;           // (NP, P, Hkv, D) int8 (q4_0: D/2)
  const void* v;           // (NP, P, Hkv, Dv)                  (q4_0: Dv/2)
  const float* kd;         // (NP, P, Hkv) quantized row scales (else null)
  const float* vd;
  const int* pos_pool;     // (NP, P)
  const int* block_table;  // (B, nbt)
  const int* qpos;         // (B, C) query positions, -1 = padded row
  const int* lane_pages;   // (B,) page bound per lane, or null
  float* out;              // (B, C, H, Dv)
  int B, C, H, Hkv, D, Dv, P, nbt, nj, ct, window, logical_mask;  // D, Dv:
  float scale, softcap;                                  // logical widths
};

// Tile loaders: element d of the K or V row ``row`` (= (page * P + token) *
// Hkv + kv head) as f32; ``width`` is the row's logical width.
struct Q8Loader {
  __device__ __forceinline__ static float load(const void* pool,
                                               const float* scales, size_t row,
                                               int width, int d) {
    return (float)static_cast<const int8_t*>(pool)[row * width + d] *
           scales[row];
  }
};

// q4_0: a row of ``width`` values is width / 2 bytes, element d in the low
// (d even) or high (d odd) nibble of byte d / 2, two's complement: the
// (n ^ 8) - 8 sign extension gives what the plain version's (b << 4) >> 4
// and b >> 4 give.
struct Q4Loader {
  __device__ __forceinline__ static float load(const void* pool,
                                               const float* scales, size_t row,
                                               int width, int d) {
    const unsigned b = static_cast<const uint8_t*>(
        pool)[row * (size_t)(width >> 1) + (d >> 1)];
    const unsigned n = (d & 1) ? (b >> 4) : (b & 15u);
    return (float)((int)(n ^ 8u) - 8) * scales[row];
  }
};

template <typename L>
__global__ void __launch_bounds__(NT) paged_attn_kernel(Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hkv = blockIdx.y, c0 = blockIdx.z * a.ct;
  const int rep = a.H / a.Hkv;
  const int ct = min(a.ct, a.C - c0);
  const int R = ct * rep;                 // query rows: r = ci * rep + ri
  const int D = a.D, Dv = a.Dv, DP = a.D + 1;
  const int tid = threadIdx.x;

  float* qs = smem;                       // R x (D+1), scaled queries
  float* ks = qs + R * DP;                // TP x (D+1)
  float* vs = ks + TP * DP;               // TP x Dv
  float* ps = vs + TP * Dv;               // R x TP scores, then probs
  float* m = ps + R * TP;                 // R
  float* l = m + R;                       // R
  float* corr = l + R;                    // R
  float* acc = corr + R;                  // R x Dv
  int* tpos = reinterpret_cast<int*>(acc + R * Dv);   // TP
  int* rowpos = tpos + TP;                // ct
  uint8_t* valid = reinterpret_cast<uint8_t*>(rowpos + a.ct);  // R x TP
  __shared__ int max_qpos;

  for (int idx = tid; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int h = hkv * rep + r % rep, c = c0 + r / rep;
    qs[r * DP + d] = a.q[(((size_t)b * a.C + c) * a.H + h) * D + d] * a.scale;
  }
  for (int idx = tid; idx < R * Dv; idx += NT) acc[idx] = 0.f;
  for (int r = tid; r < R; r += NT) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  if (tid == 0) {
    int mx = -1;
    for (int ci = 0; ci < ct; ++ci) {
      rowpos[ci] = a.qpos[(size_t)b * a.C + c0 + ci];
      mx = max(mx, rowpos[ci]);
    }
    max_qpos = mx;
  }
  __syncthreads();

  int jmax = a.nj;
  if (a.lane_pages != nullptr) jmax = min(max(a.lane_pages[b], 1), a.nj);
  if (a.logical_mask) jmax = max_qpos < 0 ? 0 : min(jmax, max_qpos / a.P + 1);

  for (int j = 0; j < jmax; ++j) {
    const int page = a.block_table[(size_t)b * a.nbt + j];
    for (int t0 = 0; t0 < a.P; t0 += TP) {
      const int nt = min(TP, a.P - t0);
      const size_t row0 = ((size_t)page * a.P + t0) * a.Hkv + hkv;
      for (int idx = tid; idx < nt * D; idx += NT) {
        const int t = idx / D, d = idx % D;
        ks[t * DP + d] = L::load(a.k, a.kd, row0 + (size_t)t * a.Hkv, D, d);
      }
      for (int idx = tid; idx < nt * Dv; idx += NT) {
        const int t = idx / Dv, d = idx % Dv;
        vs[t * Dv + d] = L::load(a.v, a.vd, row0 + (size_t)t * a.Hkv, Dv, d);
      }
      if (tid < nt) tpos[tid] = a.pos_pool[(size_t)page * a.P + t0 + tid];
      __syncthreads();

      // scores of every (row, token) pair of the sub-tile
      for (int idx = tid; idx < R * TP; idx += NT) {
        const int r = idx / TP, t = idx % TP;
        float s = NEG_INF;
        bool ok = false;
        if (t < nt) {
          const float* qr = qs + r * DP;
          const float* kr = ks + t * DP;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          if (a.softcap != 0.f) dot = a.softcap * tanhf(dot / a.softcap);
          const int tp = tpos[t], qp = rowpos[r / rep];
          ok = tp >= 0 && tp <= qp;
          if (a.window) ok = ok && tp > qp - a.window;
          if (a.logical_mask) ok = ok && (j * a.P + t0 + t) <= qp;
          s = ok ? dot : NEG_INF;
        }
        ps[idx] = s;
        valid[idx] = ok;
      }
      __syncthreads();

      // online softmax, one thread per row
      for (int r = tid; r < R; r += NT) {
        const float m_prev = m[r];
        float mx = NEG_INF;
        for (int t = 0; t < TP; ++t) mx = fmaxf(mx, ps[r * TP + t]);
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = 0; t < TP; ++t) {
          const float p = valid[r * TP + t] ? expf(ps[r * TP + t] - m_new) : 0.f;
          ps[r * TP + t] = p;
          sum += p;
        }
        const float cr = expf(m_prev - m_new);
        l[r] = l[r] * cr + sum;
        m[r] = m_new;
        corr[r] = cr;
      }
      __syncthreads();

      // acc = acc * corr + p @ V, one thread per output dim
      for (int d = tid; d < Dv; d += NT) {
        for (int r = 0; r < R; ++r) {
          float pv = 0.f;
          for (int t = 0; t < nt; ++t) pv = fmaf(ps[r * TP + t], vs[t * Dv + d], pv);
          acc[r * Dv + d] = acc[r * Dv + d] * corr[r] + pv;
        }
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < R * Dv; idx += NT) {
    const int r = idx / Dv, d = idx % Dv;
    const int h = hkv * rep + r % rep, c = c0 + r / rep;
    a.out[(((size_t)b * a.C + c) * a.H + h) * Dv + d] =
        acc[idx] / fmaxf(l[r], 1e-30f);
  }
}

size_t smem_bytes(const Args& a) {
  const int R = a.ct * (a.H / a.Hkv);
  const size_t floats = (size_t)R * (a.D + 1) + (size_t)TP * (a.D + 1) +
                        (size_t)TP * a.Dv + (size_t)R * TP + 3 * (size_t)R +
                        (size_t)R * a.Dv;
  const size_t ints = TP + a.ct;
  return floats * sizeof(float) + ints * sizeof(int) + (size_t)R * TP;
}

template <typename L>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.B, a.Hkv, (a.C + a.ct - 1) / a.ct);
  paged_attn_kernel<L><<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

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
constexpr unsigned FULL = 0xffffffffu;

// kv kinds: 0 f32, 1 bf16, 2 q8_0 (int8 + f32 row scale), 3 q4_0 (two
// nibbles a byte + f32 row scale).  Bytes of ``n`` stored elements.
__host__ __device__ constexpr int kind_bytes(int kind, int n) {
  return kind == 0 ? 4 * n : kind == 1 ? 2 * n : kind == 2 ? n : n / 2;
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

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

}  // namespace

// Chunked prefill (paged_attn_kernel): kv_kind 2 = q8_0 (int8 + f32 row
// scales), 3 = q4_0 (two int4 a byte + f32 row scales; D and Dv are the
// logical widths, even).  A key is masked past the query's position by its
// logical index too.  ct = queries per block.  Returns cudaGetLastError()
// after the launch.
extern "C" int paged_attn_prefill(int kv_kind, const float* q, const void* k,
                                  const void* v, const float* kd,
                                  const float* vd, const int* pos_pool,
                                  const int* block_table, const int* qpos,
                                  float* out, int B, int C, int H, int Hkv,
                                  int D, int Dv, int P, int nbt, int nj,
                                  int ct, int window, float scale,
                                  float softcap, void* stream) {
  Args a{q, k, v, kd, vd, pos_pool, block_table, qpos, nullptr, out,
         B, C, H, Hkv, D, Dv, P, nbt, nj, ct, window, 1, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 2: return launch<Q8Loader>(a, st);
    case 3:
      if ((D | Dv) & 1) return (int)cudaErrorInvalidValue;
      return launch<Q4Loader>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
