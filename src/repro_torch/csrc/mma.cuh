// Helpers shared by the tensor-core kernels of csrc/qmatmul.cu and
// csrc/paged_mla.cu: cp.async copies from global to shared memory, the
// bf16 mma.sync.m16n8k16 and ldmatrix fragments (their layouts from the PTX
// ISA), and the split of f32 operands into bf16 terms.
//
// Each helper is one inline-asm statement over its own argument names
// (dst, src, n; d, a, b0, b1; r, addr): a CPU emulation of the sources can
// then map each statement by its text.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16 or 4) from global to shared memory
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

// 16 bytes from global to shared memory, of which the first ``n`` are read
// (0 or 16) and the rest zero-filled
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src,
                                               int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// D (f32) += A (bf16, 16 x 16) x B (bf16, 16 x 8), the PTX ISA's m16n8k16
// fragments: lane (g, t) = (lane / 4, lane % 4) holds a = {A[g][2t..],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g],
// B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}; a
// register's lower half is the lower index.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8; r[j] of lane (g, t) is row g, elements 2t, 2t
// + 1 of matrix j (``trans``: rows 2t, 2t + 1 of column g).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// (lo, hi) as a bf16 pair, rounded to nearest
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The pair (x, y) (f32) as three bf16 pairs hi + mid + lo, each the rounded
// remainder of the ones before: their sum is the pair to ~2^-24 relative,
// and each term times an integer code of up to 8 bits is exact in the
// tensor core.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float rx = x - __low2float(h), ry = y - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = bf16x2(rx - __low2float(m), ry - __high2float(m));
}

}  // namespace
