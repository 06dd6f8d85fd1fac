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
// What bounds it on an H100: the page bytes it streams (each live K/V row
// once per kv head) — decode is memory-bound, ~2*rep flops per K/V element.
// At the serving shapes (4 lanes x 2 kv heads) this first version is bound
// instead by latency: one block per (lane, kv head) walks its pages in
// order, so only B*Hkv blocks run; splitting the page loop over blocks
// (flash-decoding) is later work.
//
// Design.  The TPU grid (slot, logical_page) runs in order and carries the
// online softmax (m, l, acc) in VMEM across page steps; here one block owns
// (lane, kv head, query tile) and the page walk is a loop inside the block,
// with (m, l, acc) in shared memory.  The block reads its own block-table
// entry per page, loads one page sub-tile (TP tokens) of K and V into
// shared memory as f32 (f32/bf16 pages as stored, q8_0 pages as int8 x the
// row's f32 scale, q4_0 pages as the row's sign-extended nibble x its f32
// scale: one f32 multiply, as the plain version's, so every dequantised
// element is bitwise the plain version's), scores the block's query rows against it, folds the
// tile into the online softmax and accumulates p @ V.  Decode loops
// j < min(active pages, lane_pages[i]), so no page is revisited and the
// j < lane_pages[i] mask follows from the loop bound; prefill stops after
// the last page any of the tile's queries can see (pages past it are fully
// masked, and a fully masked tile is an exact no-op).  The reference's
// numerics are kept: NEG_INF = -2e38 is a finite sentinel, so the
// probabilities of masked keys are set to 0 explicitly, and l is clamped at
// 1e-30 before the divide (a row with no valid key gives zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads per block
constexpr int TP = 16;            // tokens per page sub-tile
constexpr float NEG_INF = -2.0e38f;

struct Args {
  const float* q;          // (B, C, H, D) f32 (decode: C = 1)
  const void* k;           // (NP, P, Hkv, D) f32 | bf16 | int8 (q4_0: D/2)
  const void* v;           // (NP, P, Hkv, Dv)                  (q4_0: Dv/2)
  const float* kd;         // (NP, P, Hkv) quantized row scales (else null)
  const float* vd;
  const int* pos_pool;     // (NP, P)
  const int* block_table;  // (B, nbt)
  const int* qpos;         // (B, C) query positions, -1 = padded row
  const int* lane_pages;   // (B,) decode page bound per lane, or null
  float* out;              // (B, C, H, Dv)
  int B, C, H, Hkv, D, Dv, P, nbt, nj, ct, window, logical_mask;  // D, Dv:
  float scale, softcap;                                  // logical widths
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Tile loaders: element d of the K or V row ``row`` (= (page * P + token) *
// Hkv + kv head) as f32; ``width`` is the row's logical width.
template <typename T>
struct PlainLoader {
  __device__ __forceinline__ static float load(const void* pool,
                                               const float*, size_t row,
                                               int width, int d) {
    return to_f32<T>(static_cast<const T*>(pool)[row * width + d]);
  }
};

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

}  // namespace

// kv_kind: 0 = float32 pages, 1 = bfloat16 pages, 2 = q8_0 (int8 + f32 row
// scales), 3 = q4_0 (two int4 a byte + f32 row scales; D and Dv are the
// logical widths, even).  Decode passes C = 1, qpos = pos and lane_pages; prefill passes
// logical_mask = 1 (a key's logical index must not exceed the query's
// position) and lane_pages = null.  ct = queries per block.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attn(int kv_kind, const float* q, const void* k,
                          const void* v, const float* kd, const float* vd,
                          const int* pos_pool, const int* block_table,
                          const int* qpos, const int* lane_pages, float* out,
                          int B, int C, int H, int Hkv, int D, int Dv, int P,
                          int nbt, int nj, int ct, int window,
                          int logical_mask, float scale, float softcap,
                          void* stream) {
  Args a{q, k, v, kd, vd, pos_pool, block_table, qpos, lane_pages, out,
         B, C, H, Hkv, D, Dv, P, nbt, nj, ct, window, logical_mask,
         scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0: return launch<PlainLoader<float>>(a, st);
    case 1: return launch<PlainLoader<__nv_bfloat16>>(a, st);
    case 2: return launch<Q8Loader>(a, st);
    case 3:
      if ((D | Dv) & 1) return (int)cudaErrorInvalidValue;
      return launch<Q4Loader>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
