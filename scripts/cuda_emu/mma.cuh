// src/repro_torch/csrc/mma.cuh for the CPU emulation (emu_core.h): the same
// helpers, each inline-asm statement as CPU code.  mma.sync sums its 16
// products in double and rounds once; ldmatrix faults on a row address
// that is unaligned or outside the block's shared memory.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>
namespace {
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  const size_t off = (const uint8_t*)p - tl_block->smem;
  if (off > tl_block->smem_bytes) emu_fault("smem_u32 of a pointer outside shared memory");
  return (uint32_t)off;
}
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  emu_check_smem(dst, BYTES);
  if (dst % BYTES || (uintptr_t)src % BYTES) emu_fault("cp.async misaligned");
  tl_cur.push_back({tl_block->smem + dst, src, BYTES, BYTES});
}
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, int n) {
  emu_check_smem(dst, 16);
  if (dst % 16 || (n && (uintptr_t)src % 16)) emu_fault("cp.async zfill misaligned");
  tl_cur.push_back({tl_block->smem + dst, src, n, 16});
}
__device__ __forceinline__ void cp_async_commit() {
  tl_groups.push_back(tl_cur);
  tl_cur.clear();
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  while ((int)tl_groups.size() > PENDING) {
    for (auto& p : tl_groups.front()) {
      std::memcpy(p.dst, p.src, p.n);
      if (p.size > p.n) std::memset(p.dst + p.n, 0, p.size - p.n);
    }
    tl_groups.erase(tl_groups.begin());
  }
}
inline float emu_a_elem(const uint32_t (&ma)[32][4], int row, int k) {
  const int lane = 4 * (row % 8) + (k % 8) / 2, reg = row / 8 + 2 * (k / 8);
  return emu_bf2f((ma[lane][reg] >> (16 * (k % 2))) & 0xFFFF);
}
inline float emu_b_elem(const uint32_t (&mb)[32][2], int k, int n) {
  const int lane = 4 * n + (k % 8) / 2, reg = k / 8;
  return emu_bf2f((mb[lane][reg] >> (16 * (k % 2))) & 0xFFFF);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  WarpCtx& W = emu_warp();
  const int lane = emu_lane(), g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) W.ma[lane][i] = a[i];
  W.mb[lane][0] = b0;
  W.mb[lane][1] = b1;
  W.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double s = 0;
    for (int k = 0; k < 16; ++k) s += (double)emu_a_elem(W.ma, row, k) * emu_b_elem(W.mb, k, col);
    d[i] = (float)(d[i] + s);
  }
  W.bar.arrive_and_wait();
}
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  WarpCtx& W = emu_warp();
  const int lane = emu_lane(), g = lane >> 2, t = lane & 3;
  if (addr % 16) emu_fault("ldmatrix row not 16-byte aligned");
  emu_check_smem(addr, 16);
  W.addr[lane] = addr;
  W.bar.arrive_and_wait();
  const uint8_t* s = tl_block->smem;
  for (int j = 0; j < 4; ++j) {
    if (!TRANS) {
      r[j] = *(const uint32_t*)(s + W.addr[8 * j + g] + 4 * t);
    } else {
      const uint32_t lo = *(const uint16_t*)(s + W.addr[8 * j + 2 * t] + 2 * g);
      const uint32_t hi = *(const uint16_t*)(s + W.addr[8 * j + 2 * t + 1] + 2 * g);
      r[j] = lo | (hi << 16);
    }
  }
  W.bar.arrive_and_wait();
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
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
