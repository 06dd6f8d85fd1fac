// Fused K-quant dequant-matmul for Hopper: y = x @ dequant(W), for one
// weight (K, N) or a stack of expert weights (E, K, N) against x (E, M, K).
//
// Replaces the Pallas TPU kernel repro/kernels/common.py::build_qmatmul
// (kernel body :119-131) instantiated for q4_k (kernels/q4_k.py:30), q6_k
// (kernels/q6_k.py:27) and q3_k (kernels/q3_k.py:27, tile decode :19-24):
// every weight format DQ3_K_M and Q4_K_M give qwen2-1.5b and DeepSeek-V3.
// The reference sends expert weights to XLA (repro/kernels/ops.py:39-50,
// dequantize then einsum); here they run through the same kernel, with the
// expert index folded into gridDim.z, one launch for all experts.
//
// What bounds it on an H100: at decode (M = 1..8 rows) it streams the packed
// weights once and does ~2*M flops per weight, so it is memory-bound (one
// qwen2-1.5b decode step streams ~0.99 GB of packed q4_k/q6_k fields:
// ~0.30 ms at 3.35 TB/s; one DeepSeek-V3 MoE layer's experts are ~5.7 GB,
// ~1.7 ms).  At prefill (M = slots x chunk, or the experts' capacity) it is
// bound by the f32 FMAs of its CUDA-core inner loop.
//
// Design.  Fields are structure-of-arrays (S, X, N) with N last, so a
// thread owns 4 neighbouring output columns and reads 4 neighbouring bytes
// of each field row with one 32-bit load: a warp reads 128 contiguous bytes.
// A block (32 x 4 threads) owns 128 columns and one tile of MT rows; its
// four warps split each 256-row superblock (warp w decodes the bytes that
// hold sub-blocks w and w+4 for q4_k; for q6_k the bytes of elements
// 32w..32w+31 and 128+32w..), so the packed tile is decoded in registers,
// never written back, and each warp prefetches its 32 byte-rows before it
// decodes.  The activation tile x[MT, 256] of the superblock sits in shared
// memory as f32 and every lane of a warp reads the same element (a
// broadcast).  Accumulation is f32; the four warps' partial sums are added
// in a fixed order.  Where the column tiles alone give too few blocks to
// fill the card, the superblocks are split over gridDim.y and a second
// kernel adds the per-split partials in a fixed order (deterministic
// split-K, no atomics).  K that is not a multiple of 256 reads x as zero
// past K.  The dequantized weights are the same f32 values as the plain
// version's (q4_k: q * (sc*d) - (m*dmin); q6_k: (q-32) * (sc*d); q3_k:
// (q-4) * (sc*d)).  Expert weights are never split over K: E column-tile
// rows already give thousands of blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QK = 256;       // superblock rows
constexpr int TX = 32;        // threads along N (4 columns each)
constexpr int TY = 4;         // warps along the superblock
constexpr int COLS = 4 * TX;  // output columns per block
constexpr int NTHREADS = TX * TY;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void load4_half(const __half* p, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __half2 a = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&raw.y);
  out[0] = __low2float(a);
  out[1] = __high2float(a);
  out[2] = __low2float(b);
  out[3] = __high2float(b);
}

__device__ __forceinline__ uint32_t load4_u8(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t word, int c) {
  return (word >> (8 * c)) & 0xFFu;
}

template <int MT>
__device__ __forceinline__ void fma_rows(float (&acc)[MT][4], const float* xs,
                                         int k, const float (&w)[4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float xv = xs[m * QK + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
  }
}

// q4_k: qs (S,128,N) u8, scales (S,8,N) u8, mins (S,8,N) u8, d/dmin (S,N) f16
template <int MT>
__device__ __forceinline__ void q4k_superblock(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ scales,
    const uint8_t* __restrict__ mins, const __half* __restrict__ d,
    const __half* __restrict__ dmin, int s, int N, int n0, int w,
    const float* xs, float (&acc)[MT][4]) {
  float dd[4], dm[4];
  load4_half(d + (size_t)s * N + n0, dd);
  load4_half(dmin + (size_t)s * N + n0, dm);
  const uint32_t sl = load4_u8(scales + ((size_t)s * 8 + w) * N + n0);
  const uint32_t sh = load4_u8(scales + ((size_t)s * 8 + w + 4) * N + n0);
  const uint32_t ml = load4_u8(mins + ((size_t)s * 8 + w) * N + n0);
  const uint32_t mh = load4_u8(mins + ((size_t)s * 8 + w + 4) * N + n0);
  float es_lo[4], em_lo[4], es_hi[4], em_hi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    es_lo[c] = (float)byte_of(sl, c) * dd[c];
    es_hi[c] = (float)byte_of(sh, c) * dd[c];
    em_lo[c] = (float)byte_of(ml, c) * dm[c];
    em_hi[c] = (float)byte_of(mh, c) * dm[c];
  }
  const uint8_t* row = qs + ((size_t)s * 128 + 32 * w) * N + n0;
  uint32_t b[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) b[j] = load4_u8(row + (size_t)j * N);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float wl[4], wh[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t byte = byte_of(b[j], c);
      wl[c] = (float)(byte & 15u) * es_lo[c] - em_lo[c];
      wh[c] = (float)(byte >> 4) * es_hi[c] - em_hi[c];
    }
    fma_rows<MT>(acc, xs, 32 * w + j, wl);
    fma_rows<MT>(acc, xs, 128 + 32 * w + j, wh);
  }
}

// q6_k: ql (S,128,N) u8, qh (S,64,N) u8, scales (S,16,N) i8, d (S,N) f16
template <int MT>
__device__ __forceinline__ void q6k_superblock(
    const uint8_t* __restrict__ ql, const uint8_t* __restrict__ qh,
    const int8_t* __restrict__ scales, const __half* __restrict__ d, int s,
    int N, int n0, int w, const float* xs, float (&acc)[MT][4]) {
  float dd[4];
  load4_half(d + (size_t)s * N + n0, dd);
  // sub-blocks of 16: elements 32w+j use 2w + j/16, elements 128+32w+j use
  // 8 + 2w + j/16
  const int sub[4] = {2 * w, 2 * w + 1, 8 + 2 * w, 9 + 2 * w};
  float eff[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sc = load4_u8(reinterpret_cast<const uint8_t*>(scales) +
                                 ((size_t)s * 16 + sub[i]) * N + n0);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      eff[i][c] = (float)(int8_t)byte_of(sc, c) * dd[c];
  }
  // element i's high 2 bits: qh byte i % 64, bit-pair i / 64
  const int sh_lo = 2 * (w >> 1);
  const int sh_hi = 2 * (2 + (w >> 1));
  const uint8_t* lrow = ql + ((size_t)s * 128 + 32 * w) * N + n0;
  const uint8_t* hrow = qh + ((size_t)s * 64 + 32 * (w & 1)) * N + n0;
  uint32_t bl[32], bh[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    bl[j] = load4_u8(lrow + (size_t)j * N);
    bh[j] = load4_u8(hrow + (size_t)j * N);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int half = j >> 4;
    float wl[4], wh[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t lq = byte_of(bl[j], c);
      const uint32_t hq = byte_of(bh[j], c);
      const int q_lo = (int)((lq & 15u) | (((hq >> sh_lo) & 3u) << 4)) - 32;
      const int q_hi = (int)((lq >> 4) | (((hq >> sh_hi) & 3u) << 4)) - 32;
      wl[c] = (float)q_lo * eff[half][c];
      wh[c] = (float)q_hi * eff[2 + half][c];
    }
    fma_rows<MT>(acc, xs, 32 * w + j, wl);
    fma_rows<MT>(acc, xs, 128 + 32 * w + j, wh);
  }
}

// q3_k: qs (S,64,N) u8 (byte k holds elements k+64p in bit-pair p), hmask
// (S,32,N) u8 (byte k holds the high bit of element k+32b in bit b), scales
// (S,16,N) i8, d (S,N) f16.  Warp w decodes elements 64w..64w+63: bit-pair w
// of every qs byte and bits 2w, 2w+1 of every hmask byte; sub-blocks
// 4w..4w+3.
template <int MT>
__device__ __forceinline__ void q3k_superblock(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ hmask,
    const int8_t* __restrict__ scales, const __half* __restrict__ d, int s,
    int N, int n0, int w, const float* xs, float (&acc)[MT][4]) {
  float dd[4];
  load4_half(d + (size_t)s * N + n0, dd);
  float eff[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sc = load4_u8(reinterpret_cast<const uint8_t*>(scales) +
                                 ((size_t)s * 16 + 4 * w + i) * N + n0);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      eff[i][c] = (float)(int8_t)byte_of(sc, c) * dd[c];
  }
  const uint8_t* hrow = hmask + (size_t)s * 32 * N + n0;
  uint32_t bh[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) bh[j] = load4_u8(hrow + (size_t)j * N);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // element 64w + 32hh + j: qs byte 32hh + j, hmask byte j bit 2w + hh,
    // sub-block 4w + 2hh + j/16
    const uint8_t* qrow = qs + ((size_t)s * 64 + 32 * hh) * N + n0;
    uint32_t bq[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) bq[j] = load4_u8(qrow + (size_t)j * N);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      // the four columns' 3-bit codes at once, one per byte (2w + 1 <= 7
      // and 2w + hh <= 7: no bit crosses into the next byte's field)
      const uint32_t q4 = ((bq[j] >> (2 * w)) & 0x03030303u) |
                          (((bh[j] >> (2 * w + hh)) & 0x01010101u) << 2);
      const int sub = 2 * hh + (j >> 4);
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = ((float)byte_of(q4, c) - 4.f) * eff[sub][c];
      fma_rows<MT>(acc, xs, 64 * w + 32 * hh + j, wv);
    }
  }
}

// byte rows per superblock of the fields f0, f1, f2 (f3, f4 hold one per
// superblock): q4_k qs/scales/mins, q6_k ql/qh/scales, q3_k qs/hmask/scales
template <int FMT>
struct Rows;
template <>
struct Rows<0> { static constexpr int f0 = 128, f1 = 8, f2 = 8; };
template <>
struct Rows<1> { static constexpr int f0 = 128, f1 = 64, f2 = 16; };
template <>
struct Rows<2> { static constexpr int f0 = 64, f1 = 32, f2 = 16; };

template <typename T, int MT, int FMT, bool EXPERTS>
__global__ void __launch_bounds__(NTHREADS)
    qmatmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ f0,
                   const uint8_t* __restrict__ f1,
                   const uint8_t* __restrict__ f2,
                   const __half* __restrict__ f3,
                   const __half* __restrict__ f4, float* __restrict__ partial,
                   T* __restrict__ out, int M, int K, int N, int S,
                   int splits, int row_tiles) {
  constexpr int XS = MT * QK;
  constexpr int RED = (TY - 1) * MT * COLS;
  __shared__ float smem[XS > RED ? XS : RED];

  const int tx = threadIdx.x, w = threadIdx.y, tid = w * TX + tx;
  const int n0 = blockIdx.x * COLS + tx * 4;
  const int split = blockIdx.y;
  const int m0 = (EXPERTS ? blockIdx.z % row_tiles : blockIdx.z) * MT;
  if (EXPERTS) {
    // expert e's slices of x, out and every field
    const size_t e = blockIdx.z / row_tiles, sn = (size_t)S * N;
    x += e * M * K;
    out += e * M * N;
    f0 += e * sn * Rows<FMT>::f0;
    f1 += e * sn * Rows<FMT>::f1;
    f2 += e * sn * Rows<FMT>::f2;
    f3 += e * sn;
    if (FMT == 0) f4 += e * sn;
  }
  const int s_begin = (int)((long long)S * split / splits);
  const int s_end = (int)((long long)S * (split + 1) / splits);
  const bool col_ok = n0 < N;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int s = s_begin; s < s_end; ++s) {
    __syncthreads();
    for (int idx = tid; idx < XS; idx += NTHREADS) {
      const int m = idx / QK, k = s * QK + idx % QK;
      smem[idx] = (m0 + m < M && k < K) ? to_f32<T>(x[(size_t)(m0 + m) * K + k])
                                        : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      if (FMT == 0)
        q4k_superblock<MT>(f0, f1, f2, f3, f4, s, N, n0, w, smem, acc);
      else if (FMT == 1)
        q6k_superblock<MT>(f0, f1, reinterpret_cast<const int8_t*>(f2), f3, s,
                           N, n0, w, smem, acc);
      else
        q3k_superblock<MT>(f0, f1, reinterpret_cast<const int8_t*>(f2), f3, s,
                           N, n0, w, smem, acc);
    }
  }

  // fixed-order reduction of the four warps' partial sums
  __syncthreads();
  if (w > 0 && col_ok) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        smem[((w - 1) * MT + m) * COLS + tx * 4 + c] = acc[m][c];
  }
  __syncthreads();
  if (w == 0 && col_ok) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int gm = m0 + m;
      if (gm >= M) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[m][c];
#pragma unroll
        for (int r = 0; r < TY - 1; ++r) v += smem[(r * MT + m) * COLS + tx * 4 + c];
        if (splits == 1)
          out[(size_t)gm * N + n0 + c] = from_f32<T>(v);
        else
          partial[((size_t)split * M + gm) * N + n0 + c] = v;
      }
    }
  }
}

template <typename T>
__global__ void splitk_reduce(const float* __restrict__ partial,
                              T* __restrict__ out, long long mn, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int sp = 0; sp < splits; ++sp) v += partial[sp * mn + i];
  out[i] = from_f32<T>(v);
}

template <typename T, int MT, int FMT>
void launch(const void* x, const void* f0, const void* f1, const void* f2,
            const void* f3, const void* f4, void* partial, void* out, int E,
            int M, int K, int N, int splits, cudaStream_t stream) {
  const int S = (K + QK - 1) / QK;
  const int row_tiles = (M + MT - 1) / MT;
  const dim3 block(TX, TY);
  const dim3 grid((N + COLS - 1) / COLS, splits, row_tiles * E);
  auto kernel = E > 1 ? qmatmul_kernel<T, MT, FMT, true>
                      : qmatmul_kernel<T, MT, FMT, false>;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(f0),
      static_cast<const uint8_t*>(f1), static_cast<const uint8_t*>(f2),
      static_cast<const __half*>(f3), static_cast<const __half*>(f4),
      static_cast<float*>(partial), static_cast<T*>(out), M, K, N, S, splits,
      row_tiles);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    splitk_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<T*>(out), mn, splits);
  }
}

template <typename T, int FMT>
void launch_rows(const void* x, const void* f0, const void* f1, const void* f2,
                 const void* f3, const void* f4, void* partial, void* out,
                 int E, int M, int K, int N, int splits, cudaStream_t stream) {
  if (M <= 4)
    launch<T, 4, FMT>(x, f0, f1, f2, f3, f4, partial, out, E, M, K, N, splits,
                      stream);
  else
    launch<T, 16, FMT>(x, f0, f1, f2, f3, f4, partial, out, E, M, K, N,
                       splits, stream);
}

template <typename T>
int launch_fmt(int fmt, const void* x, const void* f0, const void* f1,
               const void* f2, const void* f3, const void* f4, void* partial,
               void* out, int E, int M, int K, int N, int splits,
               cudaStream_t st) {
  switch (fmt) {
    case 0: launch_rows<T, 0>(x, f0, f1, f2, f3, f4, partial, out, E, M, K, N,
                              splits, st); break;
    case 1: launch_rows<T, 1>(x, f0, f1, f2, f3, f4, partial, out, E, M, K, N,
                              splits, st); break;
    case 2: launch_rows<T, 2>(x, f0, f1, f2, f3, f4, partial, out, E, M, K, N,
                              splits, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = q4_k (f0..f4 = qs, scales, mins, d, dmin), 1 = q6_k (f0..f3 =
// ql, qh, scales, d), 2 = q3_k (f0..f3 = qs, hmask, scales, d).  dtype of x
// and out: 0 = float32, 1 = bfloat16.  E experts: x (E, M, K), fields with
// a leading E, out (E, M, N); E = 1 for one weight.  N must be a multiple
// of 4; ``partial`` holds splits x M x N floats when splits > 1 (E = 1
// only).  Returns cudaGetLastError() after the launches.
extern "C" int qmatmul(int fmt, int dtype, const void* x, const void* f0,
                       const void* f1, const void* f2, const void* f3,
                       const void* f4, void* partial, void* out, int E, int M,
                       int K, int N, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || (E > 1 && splits != 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fmt<float>(fmt, x, f0, f1, f2, f3, f4, partial, out, E, M,
                             K, N, splits, st);
  if (dtype == 1)
    return launch_fmt<__nv_bfloat16>(fmt, x, f0, f1, f2, f3, f4, partial, out,
                                     E, M, K, N, splits, st);
  return (int)cudaErrorInvalidValue;
}
