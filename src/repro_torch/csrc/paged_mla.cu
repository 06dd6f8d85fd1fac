// Absorbed multi-head latent attention (DeepSeek MLA) over paged latent
// pools, for Hopper: one-token decode and write-then-attend chunked prefill.
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attn.py::_mla_core
// (body :566-589; entries paged_mla_decode :438 and paged_mla_decode_quant
// :468) with its f32, q8_0 and q4_0 tile loaders, and ::_mla_prefill_core
// (body :1011-1036; entry paged_mla_prefill_quant :950) with the q8_0 and
// q4_0 loaders.  As there, the latent and rope leaves each have their own
// mode: the "dq" cache policy keeps q8_0 latents beside q4_0 rope keys, so
// the kernel takes one loader per leaf and one launch reads both.
// Every query row r = (c, h) scores s = (q_eff . c_kv + q_rope . k_rope) *
// scale against the lane's latent tokens, a token valid iff its logical
// index is <= the row's position, and returns the attended latents p . c_kv
// (B, C, H, R) in f32; the caller projects them out with W_vb.
//
// What bounds it on an H100: decode reads each live latent token once per
// lane (R + Dr values: 1,152 B in bf16; with the two f32 scales 584 B in
// q8_0, 296 B in q4_0, 552 B for dq's q8_0 latent and q4_0 rope) and does
// ~4 (R + Dr) flops per head per token, 128 heads: ~1.1 flop per byte in
// bf16, so it is memory-bound, but the latent pages of a step are a few MB
// and sit in L2.
// Prefill (C = 128 queries x 128 heads per lane) is bound by its f32 FMAs
// (~28 GFLOP per layer per chunk at ~200 keys per query: >= 0.4 ms at the
// 67 TFLOP/s CUDA-core peak).
//
// Design.  Every head of a lane reads the same latent page, so a block owns
// one lane and a tile of NW x RW query rows (one warp per RW rows), stages
// each page sub-tile (TP tokens x (R + Dr) latents, bf16 / f32 as stored, or
// the q8_0 int8 or q4_0 sign-extended nibble x the token's f32 scale, one
// f32 multiply as in the plain version) in shared memory as f32 once, and every
// warp scores its rows against it: a lane holds 1/32 of each row's query
// and of its accumulator (R / 32 values) in registers, partial dot products
// are summed across the warp with shuffles, lane t keeps token t's score,
// and the online softmax (m, l) runs warp-wide.  RW = 1 at decode (128
// heads / 4 warps: 32 blocks per lane, 128 blocks for 4 lanes on 132 SMs);
// RW = 4 at prefill, where each shared-memory read feeds four rows.  The
// page loop stops at min(active pages, lane_pages[b], the last page any of
// the block's rows can see); fully masked pages are exact no-ops, so that
// bound changes nothing.  The reference's numerics are kept: NEG_INF =
// -2e38 is a finite sentinel, so masked probabilities are set to 0
// explicitly, and l is clamped at 1e-30 before the divide (a row with no
// valid key, such as a padded prefill row, gives zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;                // warps per block
constexpr int NT = 32 * NW;          // threads per block
constexpr int TP = 16;               // tokens per page sub-tile
constexpr int RMAX = 512;            // latent width the registers hold
constexpr int DMAX = 64;             // rope width the registers hold
constexpr int RK = RMAX / 32;        // latent values per lane
constexpr int DK = DMAX / 32;        // rope values per lane
constexpr float NEG_INF = -2.0e38f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* q_eff;      // (B, C, H, R) f32
  const float* q_rope;     // (B, C, H, Dr) f32
  const void* ckv;         // (NP, P, R) f32 | bf16 | int8 (q4_0: R/2)
  const void* krope;       // (NP, P, Dr)                  (q4_0: Dr/2)
  const float* cd;         // (NP, P) quantized token scales (else null)
  const float* kd;
  const int* block_table;  // (B, nbt)
  const int* qpos;         // (B, C) query positions, -1 = padded row
  const int* lane_pages;   // (B,) page bound per lane, or null
  float* out;              // (B, C, H, R)
  int B, C, H, R, Dr, P, nbt, nj;
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Tile loaders: element d of token row ``row`` (= page * P + token) as f32.
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

// q4_0: a token row of ``width`` values is width / 2 bytes, element d in the
// low (d even) or high (d odd) nibble of byte d / 2, two's complement: the
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// LC loads the latent leaf, LK the rope leaf.
template <typename LC, typename LK, int RW>
__global__ void __launch_bounds__(NT) paged_mla_kernel(Args a) {
  extern __shared__ float smem[];
  float* cs = smem;                      // TP x R latents
  float* ks = cs + TP * a.R;             // TP x Dr rope keys
  __shared__ int max_qpos;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, Dr = a.Dr;
  const int rows = a.C * a.H;
  const int row0 = (blockIdx.y * NW + warp) * RW;

  float q[RW][RK], qr[RW][DK], acc[RW][RK], m[RW], l[RW];
  int qp[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = row0 + i;
    const bool live = row < rows;
    qp[i] = live ? a.qpos[(size_t)b * a.C + row / a.H] : -1;
    const float* qe = a.q_eff + ((size_t)b * rows + row) * R;
    const float* qo = a.q_rope + ((size_t)b * rows + row) * Dr;
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const int r = lane + 32 * k;
      q[i][k] = (live && r < R) ? qe[r] : 0.f;
      acc[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = lane + 32 * k;
      qr[i][k] = (live && d < Dr) ? qo[d] : 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  if (tid == 0) max_qpos = -1;
  __syncthreads();
  if (lane == 0) {
    int mx = -1;
#pragma unroll
    for (int i = 0; i < RW; ++i) mx = max(mx, qp[i]);
    atomicMax(&max_qpos, mx);
  }
  __syncthreads();

  int jmax = a.nj;
  if (a.lane_pages != nullptr) jmax = min(max(a.lane_pages[b], 1), a.nj);
  jmax = max_qpos < 0 ? 0 : min(jmax, max_qpos / a.P + 1);

  for (int j = 0; j < jmax; ++j) {
    const int page = a.block_table[(size_t)b * a.nbt + j];
    for (int t0 = 0; t0 < a.P; t0 += TP) {
      const int nt = min(TP, a.P - t0);
      const size_t tok0 = (size_t)page * a.P + t0;
      __syncthreads();                   // every warp is done with the tile
      for (int idx = tid; idx < nt * R; idx += NT) {
        const int t = idx / R, r = idx % R;
        cs[t * R + r] = LC::load(a.ckv, a.cd, tok0 + t, R, r);
      }
      for (int idx = tid; idx < nt * Dr; idx += NT) {
        const int t = idx / Dr, d = idx % Dr;
        ks[t * Dr + d] = LK::load(a.krope, a.kd, tok0 + t, Dr, d);
      }
      __syncthreads();

      // scores: lane t keeps token t's score of every row
      float s[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) s[i] = NEG_INF;
      for (int t = 0; t < nt; ++t) {
        float part[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) part[i] = 0.f;
#pragma unroll
        for (int k = 0; k < RK; ++k) {
          const int r = lane + 32 * k;
          if (r < R) {
            const float cv = cs[t * R + r];
#pragma unroll
            for (int i = 0; i < RW; ++i) part[i] = fmaf(q[i][k], cv, part[i]);
          }
        }
#pragma unroll
        for (int k = 0; k < DK; ++k) {
          const int d = lane + 32 * k;
          if (d < Dr) {
            const float kv = ks[t * Dr + d];
#pragma unroll
            for (int i = 0; i < RW; ++i) part[i] = fmaf(qr[i][k], kv, part[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float dot = warp_sum(part[i]);
          if (lane == t) s[i] = dot * a.scale;
        }
      }

      // online softmax over the sub-tile, warp-wide per row
      const int kidx = j * a.P + t0 + lane;      // lane's token
      float p[RW], corr[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const bool ok = lane < nt && kidx <= qp[i];
        const float sv = ok ? s[i] : NEG_INF;
        const float m_new = fmaxf(m[i], warp_max(sv));
        p[i] = ok ? expf(sv - m_new) : 0.f;
        corr[i] = expf(m[i] - m_new);
        l[i] = l[i] * corr[i] + warp_sum(p[i]);
        m[i] = m_new;
#pragma unroll
        for (int k = 0; k < RK; ++k) acc[i][k] *= corr[i];
      }
      // acc += p . c_kv
      for (int t = 0; t < nt; ++t) {
        float pt[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) pt[i] = __shfl_sync(FULL, p[i], t);
#pragma unroll
        for (int k = 0; k < RK; ++k) {
          const int r = lane + 32 * k;
          if (r < R) {
            const float cv = cs[t * R + r];
#pragma unroll
            for (int i = 0; i < RW; ++i)
              acc[i][k] = fmaf(pt[i], cv, acc[i][k]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = row0 + i;
    if (row >= rows) break;
    float* o = a.out + ((size_t)b * rows + row) * R;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const int r = lane + 32 * k;
      if (r < R) o[r] = acc[i][k] * inv_l;
    }
  }
}

template <typename LC, typename LK, int RW>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = (size_t)TP * (a.R + a.Dr) * sizeof(float);
  const int per_block = NW * RW;
  const dim3 grid(a.B, (a.C * a.H + per_block - 1) / per_block);
  paged_mla_kernel<LC, LK, RW><<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename LC, typename LK>
int launch_rw(const Args& a, int rw, cudaStream_t stream) {
  if (rw == 1) return launch<LC, LK, 1>(a, stream);
  if (rw == 4) return launch<LC, LK, 4>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// latent_kind / rope_kind: 0 = float32 pools, 1 = bfloat16 pools, 2 = q8_0
// (int8 + f32 token scales), 3 = q4_0 (two int4 a byte + f32 token scales;
// R or Dr even).  The pairs built: (0, 0), (1, 1), (2, 2), (3, 3) and
// (2, 3), the "dq" policy's q8_0 latents and q4_0 rope keys.  Decode passes
// C = 1, qpos = pos and lane_pages; prefill passes the chunk's C and
// lane_pages = null.  rw = query rows per warp (1 or 4).  R <= 512 and
// Dr <= 64 (logical widths).  Returns cudaGetLastError() after the launch.
extern "C" int paged_mla(int latent_kind, int rope_kind, const float* q_eff,
                         const float* q_rope, const void* ckv,
                         const void* krope, const float* cd, const float* kd,
                         const int* block_table, const int* qpos,
                         const int* lane_pages, float* out, int B, int C,
                         int H, int R, int Dr, int P, int nbt, int nj,
                         float scale, int rw, void* stream) {
  if (R > RMAX || Dr > DMAX) return (int)cudaErrorInvalidValue;
  if ((latent_kind == 3 && (R & 1)) || (rope_kind == 3 && (Dr & 1)))
    return (int)cudaErrorInvalidValue;
  Args a{q_eff, q_rope, ckv, krope, cd, kd, block_table, qpos, lane_pages,
         out, B, C, H, R, Dr, P, nbt, nj, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (latent_kind * 4 + rope_kind) {
    case 0: return launch_rw<PlainLoader<float>, PlainLoader<float>>(a, rw, st);
    case 5:
      return launch_rw<PlainLoader<__nv_bfloat16>,
                       PlainLoader<__nv_bfloat16>>(a, rw, st);
    case 10: return launch_rw<Q8Loader, Q8Loader>(a, rw, st);
    case 15: return launch_rw<Q4Loader, Q4Loader>(a, rw, st);
    case 11: return launch_rw<Q8Loader, Q4Loader>(a, rw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
