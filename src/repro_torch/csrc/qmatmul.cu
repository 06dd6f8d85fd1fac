// Fused K-quant dequant-matmul for Hopper: y = x @ dequant(W), for one
// weight (K, N) or a stack of expert weights (E, K, N) against x (E, M, K).
//
// Replaces the Pallas TPU kernel repro/kernels/common.py::build_qmatmul
// (kernel body :119-131) instantiated for q4_k (kernels/q4_k.py:30), q6_k
// (kernels/q6_k.py:27), q3_k (kernels/q3_k.py:27, tile decode :19-24), q5_k
// (kernels/q5_k.py:25), q2_k (kernels/q2_k.py:26) and q8_0
// (kernels/q8_0.py:23): every weight format of the paper's policies
// (DQ3_K_M, Q4_K_M, Q3_K_M, Q2_K_L, UD_Q2_K_XL, Q8_0).  The reference sends
// expert weights to XLA (repro/kernels/ops.py:39-50, dequantize then
// einsum); here they run through the same kernel, with the expert index
// folded into gridDim.z, one launch for all experts.
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
// four warps split each 256-row tile of K (one superblock; eight q8_0
// blocks), each decoder's header says how, so the packed tile is decoded in
// registers, never written back, and each warp prefetches its byte-rows
// before it decodes.  The activation tile x[MT, 256] sits in shared memory
// as f32 and every lane of a warp reads the same element (a broadcast).
// Accumulation is f32; the four warps' partial sums are added in a fixed
// order.  Where the column tiles alone give too few blocks to fill the
// card, the tiles are split over gridDim.y and a second kernel adds the
// per-split partials in a fixed order (deterministic split-K, no atomics).
// K that is not a multiple of 256 reads x as zero past K, and q8_0 blocks
// past the last one are not read at all.  The dequantized weights are the
// same f32 values as the plain version's (q6_k: (q-32) * (sc*d); q3_k:
// (q-4) * (sc*d); q5_k and q2_k: q * (sc*d) - (m*dmin), product rounded
// before the subtraction as the plain version does; q8_0: q * d); q4_k's
// q * (sc*d) - (m*dmin) may be contracted into one FMA by the compiler.
// Expert weights are never split over K: E column-tile rows already give
// thousands of blocks.
//
// Built once per format: -DQMATMUL_FMT=<id> instantiates that format's
// kernels only (kernels/build.py builds the six libraries in parallel).

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

// q5_k: qs (S,128,N) u8, qh (S,32,N) u8 (byte k holds the high bit of
// element k+32b in bit b), scales (S,8,N) u8, mins (S,8,N) u8, d/dmin (S,N)
// f16.  Warp w takes sub-blocks w and w+4, as q4_k: qs byte rows
// 32w..32w+31 (element 32w+j in the low nibble, 128+32w+j in the high one)
// and bits w and w+4 of all 32 qh byte rows.
template <int MT>
__device__ __forceinline__ void q5k_superblock(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ qh,
    const uint8_t* __restrict__ scales, const uint8_t* __restrict__ mins,
    const __half* __restrict__ d, const __half* __restrict__ dmin, int s,
    int N, int n0, int w, const float* xs, float (&acc)[MT][4]) {
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
  const uint8_t* hrow = qh + (size_t)s * 32 * N + n0;
  uint32_t b[32], h[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    b[j] = load4_u8(row + (size_t)j * N);
    h[j] = load4_u8(hrow + (size_t)j * N);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    // the four columns' 5-bit codes at once, one per byte (w + 4 <= 7: no
    // bit crosses into the next byte's field)
    const uint32_t lo = (b[j] & 0x0F0F0F0Fu) | (((h[j] >> w) & 0x01010101u) << 4);
    const uint32_t hi = ((b[j] >> 4) & 0x0F0F0F0Fu) |
                        (((h[j] >> (w + 4)) & 0x01010101u) << 4);
    float wl[4], wh[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wl[c] = __fsub_rn(__fmul_rn((float)byte_of(lo, c), es_lo[c]), em_lo[c]);
      wh[c] = __fsub_rn(__fmul_rn((float)byte_of(hi, c), es_hi[c]), em_hi[c]);
    }
    fma_rows<MT>(acc, xs, 32 * w + j, wl);
    fma_rows<MT>(acc, xs, 128 + 32 * w + j, wh);
  }
}

// q2_k: qs (S,64,N) u8 (byte k holds elements k+64p in bit-pair p), sm
// (S,16,N) u8 (sub-block i of 16 elements: scale code in the low nibble,
// min code in the high one), d/dmin (S,N) f16.  Warp w takes qs byte rows
// 16w..16w+15 whole: their bit-pairs p are elements 64p+16w+j, sub-blocks
// w+4p.  Chosen over q3_k's split (warp w takes bit-pair w of all 64 rows)
// because every byte of the superblock is then loaded by one warp only: 16
// words and 4 scale words a warp instead of 64 and 4.  The bit-pairs are
// decoded one after the other, each with only its own sub-block's scale
// and min live: with all four live the 16-row tile spills to local memory
// (its prefill shapes ran 1.3-1.4x slower; at M = 1..4 the two orders are
// within 4 %).
template <int MT>
__device__ __forceinline__ void q2k_superblock(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ sm,
    const __half* __restrict__ d, const __half* __restrict__ dmin, int s,
    int N, int n0, int w, const float* xs, float (&acc)[MT][4]) {
  float dd[4], dm[4];
  load4_half(d + (size_t)s * N + n0, dd);
  load4_half(dmin + (size_t)s * N + n0, dm);
  uint32_t v[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    v[p] = load4_u8(sm + ((size_t)s * 16 + w + 4 * p) * N + n0);
  const uint8_t* row = qs + ((size_t)s * 64 + 16 * w) * N + n0;
  uint32_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = load4_u8(row + (size_t)j * N);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float es[4], em[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      es[c] = (float)(byte_of(v[p], c) & 15u) * dd[c];
      em[c] = (float)(byte_of(v[p], c) >> 4) * dm[c];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t q4 = (b[j] >> (2 * p)) & 0x03030303u;
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = __fsub_rn(__fmul_rn((float)byte_of(q4, c), es[c]), em[c]);
      fma_rows<MT>(acc, xs, 64 * p + 16 * w + j, wv);
    }
  }
}

// q8_0: qs (S,32,N) i8, d (S,N) f16, S = ceil(K/32) blocks of 32 rows.  The
// 256-row tile s holds blocks 8s..8s+7; warp w takes blocks 8s+w and
// 8s+w+4 (tile rows 32w.. and 128+32w..) and loads both before it decodes.
// When S is not a multiple of 8 the last tile's missing blocks have no
// fields: the warps they fall to skip them (x is zero there anyway).
template <int MT>
__device__ __forceinline__ void q8_0_tile(
    const int8_t* __restrict__ qs, const __half* __restrict__ d, int nblk,
    int s, int N, int n0, int w, const float* xs, float (&acc)[MT][4]) {
  float dd[2][4];
  uint32_t q[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int blk = 8 * s + w + 4 * h;
    if (blk < nblk) {
      load4_half(d + (size_t)blk * N + n0, dd[h]);
      const uint8_t* row =
          reinterpret_cast<const uint8_t*>(qs) + (size_t)blk * 32 * N + n0;
#pragma unroll
      for (int j = 0; j < 32; ++j) q[h][j] = load4_u8(row + (size_t)j * N);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (8 * s + w + 4 * h >= nblk) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = (float)(int8_t)byte_of(q[h][j], c) * dd[h][c];
      fma_rows<MT>(acc, xs, 128 * h + 32 * w + j, wv);
    }
  }
}

// Formats: 0 q4_k, 1 q6_k, 2 q3_k, 3 q5_k, 4 q2_k, 5 q8_0.  Their fields
// in the order the C entry point takes them, and each field's bytes per
// output column per block of the format (256 rows; q8_0: 32), which place
// expert e's slab of the field.
constexpr int NFMT = 6;
constexpr int MAXF = 6;
constexpr int Q8_0 = 5;
constexpr int kNumFields[NFMT] = {5, 4, 4, 6, 4, 2};
__constant__ int kFieldBytes[NFMT][MAXF] = {
    {128, 8, 8, 2, 2, 0},     // q4_k: qs, scales, mins, d, dmin
    {128, 64, 16, 2, 0, 0},   // q6_k: ql, qh, scales, d
    {64, 32, 16, 2, 0, 0},    // q3_k: qs, hmask, scales, d
    {128, 32, 8, 8, 2, 2},    // q5_k: qs, qh, scales, mins, d, dmin
    {64, 16, 2, 2, 0, 0},     // q2_k: qs, sm, d, dmin
    {32, 2, 0, 0, 0, 0}};     // q8_0: qs, d

struct Fields {
  const uint8_t* p[MAXF];
};

__device__ __forceinline__ const __half* as_half(const uint8_t* p) {
  return reinterpret_cast<const __half*>(p);
}
__device__ __forceinline__ const int8_t* as_i8(const uint8_t* p) {
  return reinterpret_cast<const int8_t*>(p);
}

template <typename T, int MT, int FMT, bool EXPERTS>
__global__ void __launch_bounds__(NTHREADS)
    qmatmul_kernel(const T* __restrict__ x, Fields f,
                   float* __restrict__ partial, T* __restrict__ out, int M,
                   int K, int N, int splits, int row_tiles) {
  constexpr int XS = MT * QK;
  constexpr int RED = (TY - 1) * MT * COLS;
  __shared__ float smem[XS > RED ? XS : RED];

  const int tx = threadIdx.x, w = threadIdx.y, tid = w * TX + tx;
  const int n0 = blockIdx.x * COLS + tx * 4;
  const int split = blockIdx.y;
  const int m0 = (EXPERTS ? blockIdx.z % row_tiles : blockIdx.z) * MT;
  // 256-row tiles of K, and the format's blocks along K (the fields' S)
  const int tiles = (K + QK - 1) / QK;
  const int nblk = FMT == Q8_0 ? (K + 31) / 32 : tiles;
  if (EXPERTS) {
    // expert e's slices of x, out and every field
    const size_t e = blockIdx.z / row_tiles, sn = (size_t)nblk * N;
    x += e * M * K;
    out += e * M * N;
#pragma unroll
    for (int i = 0; i < MAXF; ++i) f.p[i] += e * sn * kFieldBytes[FMT][i];
  }
  const int s_begin = (int)((long long)tiles * split / splits);
  const int s_end = (int)((long long)tiles * (split + 1) / splits);
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
      if constexpr (FMT == 0)
        q4k_superblock<MT>(f.p[0], f.p[1], f.p[2], as_half(f.p[3]),
                           as_half(f.p[4]), s, N, n0, w, smem, acc);
      else if constexpr (FMT == 1)
        q6k_superblock<MT>(f.p[0], f.p[1], as_i8(f.p[2]), as_half(f.p[3]), s,
                           N, n0, w, smem, acc);
      else if constexpr (FMT == 2)
        q3k_superblock<MT>(f.p[0], f.p[1], as_i8(f.p[2]), as_half(f.p[3]), s,
                           N, n0, w, smem, acc);
      else if constexpr (FMT == 3)
        q5k_superblock<MT>(f.p[0], f.p[1], f.p[2], f.p[3], as_half(f.p[4]),
                           as_half(f.p[5]), s, N, n0, w, smem, acc);
      else if constexpr (FMT == 4)
        q2k_superblock<MT>(f.p[0], f.p[1], as_half(f.p[2]), as_half(f.p[3]),
                           s, N, n0, w, smem, acc);
      else
        q8_0_tile<MT>(as_i8(f.p[0]), as_half(f.p[1]), nblk, s, N, n0, w, smem,
                      acc);
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
void launch(const void* x, const Fields& f, void* partial, void* out, int E,
            int M, int K, int N, int splits, cudaStream_t stream) {
  const int row_tiles = (M + MT - 1) / MT;
  const dim3 block(TX, TY);
  const dim3 grid((N + COLS - 1) / COLS, splits, row_tiles * E);
  auto kernel = E > 1 ? qmatmul_kernel<T, MT, FMT, true>
                      : qmatmul_kernel<T, MT, FMT, false>;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), f, static_cast<float*>(partial),
      static_cast<T*>(out), M, K, N, splits, row_tiles);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    splitk_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<T*>(out), mn, splits);
  }
}

template <typename T, int FMT>
void launch_rows(const void* x, const Fields& f, void* partial, void* out,
                 int E, int M, int K, int N, int splits, cudaStream_t stream) {
  if (M <= 4)
    launch<T, 4, FMT>(x, f, partial, out, E, M, K, N, splits, stream);
  else
    launch<T, 16, FMT>(x, f, partial, out, E, M, K, N, splits, stream);
}

#ifndef QMATMUL_FMT
#error "build with -DQMATMUL_FMT=<format id>"
#endif

template <typename T>
int launch_fmt(const void* x, const Fields& f, void* partial, void* out,
               int E, int M, int K, int N, int splits, cudaStream_t st) {
  launch_rows<T, QMATMUL_FMT>(x, f, partial, out, E, M, K, N, splits, st);
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = q4_k, 1 = q6_k, 2 = q3_k, 3 = q5_k, 4 = q2_k, 5 = q8_0, and
// must be the QMATMUL_FMT this library was built for; ``fields`` holds the
// format's ``nfields`` field pointers in the order of kFieldBytes.  dtype of x and out: 0 = float32, 1 = bfloat16.  E experts:
// x (E, M, K), fields with a leading E, out (E, M, N); E = 1 for one
// weight.  N must be a multiple of 4; ``partial`` holds splits x M x N
// floats when splits > 1 (E = 1 only; splits count 256-row tiles).
// Returns cudaGetLastError() after the launches.
extern "C" int qmatmul(int fmt, int dtype, const void* x,
                       const void* const* fields, int nfields, void* partial,
                       void* out, int E, int M, int K, int N, int splits,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt != QMATMUL_FMT || nfields != kNumFields[fmt] || E < 1 ||
      (E > 1 && splits != 1))
    return (int)cudaErrorInvalidValue;
  Fields f{};
  for (int i = 0; i < nfields; ++i)
    f.p[i] = static_cast<const uint8_t*>(fields[i]);
  if (dtype == 0)
    return launch_fmt<float>(x, f, partial, out, E, M, K, N, splits, st);
  if (dtype == 1)
    return launch_fmt<__nv_bfloat16>(x, f, partial, out, E, M, K, N, splits,
                                     st);
  return (int)cudaErrorInvalidValue;
}
