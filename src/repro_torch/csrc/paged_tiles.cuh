// Helpers shared by the paged attention kernels of csrc/paged_attn.cu (GQA)
// and csrc/paged_mla.cu (MLA): the pools' stored row kinds, the copies of
// stored rows into shared memory, and the conversion of stored rows and
// queries into the bf16 tiles of the tensor-core prefill kernels.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;   // the reference's finite sentinel
constexpr unsigned FULL = 0xffffffffu;

// pool kinds: 0 f32, 1 bf16, 2 q8_0 (int8 + f32 row scale), 3 q4_0 (two
// nibbles a byte + f32 row scale).  Bytes of a stored row of n elements.
__host__ __device__ constexpr int kind_bytes(int kind, int n) {
  return kind == 0 ? 4 * n : kind == 1 ? 2 * n : kind == 2 ? n : n / 2;
}
__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// 16 or 4 where every row and the pool's address allow copies that wide,
// else 1 (plain byte copies)
inline int copy_width(int row_bytes, const void* pool) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(pool);
  if (row_bytes % 16 == 0 && p % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && p % 4 == 0) return 4;
  return 1;
}

// Element e of a stored row as f32 (quantized kinds times the row's scale,
// one f32 multiply, as the plain version's).
template <int KIND>
__device__ __forceinline__ float elem(const uint8_t* row, int e, float sc) {
  if constexpr (KIND == 0) {
    return reinterpret_cast<const float*>(row)[e];
  } else if constexpr (KIND == 1) {
    return __uint_as_float(
        (uint32_t)reinterpret_cast<const uint16_t*>(row)[e] << 16);
  } else if constexpr (KIND == 2) {
    return (float)reinterpret_cast<const int8_t*>(row)[e] * sc;
  } else {
    const uint32_t b = row[e >> 1];
    const uint32_t n = (e & 1) ? b >> 4 : b & 15u;
    return (float)((int)(n ^ 8u) - 8) * sc;
  }
}

// Elements e .. e + 3 (e a multiple of 4) of a query row (f32, or bf16
// where ``bf16``) as f32, zeros past ``width``: one 16- or 8-byte load
// where the row allows it.
__device__ __forceinline__ float4 q_elems4(const void* row, int e, int width,
                                           bool bf16) {
  float v[4];
  if (bf16) {
    const uint16_t* p = static_cast<const uint16_t*>(row) + e;
    if (e + 4 <= width && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xFFFF0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xFFFF0000u));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = e + i < width ? __uint_as_float((uint32_t)p[i] << 16) : 0.f;
  } else {
    const float* p = static_cast<const float*>(row) + e;
    if (e + 4 <= width && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
      return *reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = e + i < width ? p[i] : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Codes e .. e + 3 (e a multiple of 4) of a stored quantized row of
// ``width`` elements as f32 (exact), zeros past it: an int8 code as 2^23 +
// 128 + q by one byte permute and one FADD, a q4_0 nibble as 2^23 + (n ^
// 8) by a shift and a mask, no int-to-float instruction.
template <int KIND>
__device__ __forceinline__ float4 codes4(const uint8_t* row, int e,
                                         int width) {
  constexpr float kMagic = 8388608.f;   // 2^23
  float v[4];
  if (e + 4 <= width) {
    if constexpr (KIND == 2) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(row + e) ^
                         0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) -
               (kMagic + 128.f);
    } else {
      const uint32_t u = *reinterpret_cast<const uint16_t*>(row + e / 2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __uint_as_float(0x4B000000u | (((u >> (4 * i)) & 15u) ^ 8u)) -
               (kMagic + 8.f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = e + i < width ? elem<KIND>(row, e + i, 1.f) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Warp w of NW copies the stored rows w, w + NW, .. (< nt) of one pool into
// shared memory at ``dst`` (rows ``rs`` bytes apart), ``rb`` bytes a row and
// ``v`` bytes a copy (16, 4, or 1: plain byte copies), its lanes along the
// row; lane t holds ``grow``, row t's token row (page * P + token), whose
// stored row starts ``grow * stride`` bytes into ``pool``.
template <int NW>
__device__ __forceinline__ void copy_leaf(uint8_t* dst, const uint8_t* pool,
                                          int rb, int rs, size_t stride,
                                          int v, int nt, int grow, int w,
                                          int lane) {
  for (int t = w; t < nt; t += NW) {
    const uint8_t* src = pool + (size_t)__shfl_sync(FULL, grow, t) * stride;
    uint8_t* d = dst + t * rs;
    if (v == 16) {
      for (int c = 16 * lane; c < rb; c += 16 * 32)
        cp_async<16>(smem_u32(d + c), src + c);
    } else if (v == 4) {
      for (int c = 4 * lane; c < rb; c += 4 * 32)
        cp_async<4>(smem_u32(d + c), src + c);
    } else {
      for (int c = lane; c < rb; c += 32) d[c] = src[c];
    }
  }
}

// Four elements as bf16 at ``dst`` (8 bytes): one plane, or (f32 values)
// the three planes ``plane`` bytes apart.
template <int NQ>
__device__ __forceinline__ void store_bf16x4(uint8_t* dst, float4 v,
                                             int plane) {
  if constexpr (NQ == 1) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2(v.x, v.y),
                                                bf16x2(v.z, v.w));
  } else {
    uint32_t h[2], m[2], o[2];
    split3(v.x, v.y, h[0], m[0], o[0]);
    split3(v.z, v.w, h[1], m[1], o[1]);
    *reinterpret_cast<uint2*>(dst) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(dst + plane) = make_uint2(m[0], m[1]);
    *reinterpret_cast<uint2*>(dst + 2 * plane) = make_uint2(o[0], o[1]);
  }
}

}  // namespace
