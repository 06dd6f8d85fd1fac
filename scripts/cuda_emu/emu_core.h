// CPU emulation of the CUDA features that the kernels of
// src/repro_torch/csrc use, for rehearsing their indexing with g++ before a
// card is at hand (scripts/cuda_emu/emulate.py).  Each cluster of a launch
// (a block, where no cluster is asked for) runs as one std::thread per CUDA
// thread; __syncthreads and cluster.sync() are barriers over the block's or
// the cluster's threads, and a warp's shuffles, mma.sync and ldmatrix are
// exchanges through per-warp slots between two warp barriers.  Shared
// memory starts filled with 0xFF, and cp.async copies land only at
// cp.async.wait_group, so a missing wait reads the fill.  It says nothing
// about speed, nor about what nvcc accepts.
#pragma once
#include <barrier>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>
#include <mutex>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3e { unsigned x, y, z; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

inline thread_local uint3e threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributePreferredSharedMemoryCarveout = 9,
       cudaFuncAttributeNonPortableClusterSizeAllowed = 10,
       cudaSharedmemCarveoutMaxShared = 100 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline std::atomic<long> emu_faults{0};
inline void emu_fault(const char* what) {
  std::fprintf(stderr, "EMU FAULT: %s\n", what);
  emu_faults++;
  std::abort();
}

// ---- per-warp, per-block, per-cluster state ----
struct WarpCtx {
  std::barrier<> bar{32};
  uint64_t slot[32];
  uint32_t ma[32][4], mb[32][2];
  uint32_t addr[32];
};
struct BlockCtx {
  std::barrier<>* bar;
  uint8_t* smem;
  size_t smem_bytes;
  std::vector<WarpCtx*> warps;
  std::vector<std::vector<uint8_t>> statics;
  std::mutex mu;
  std::vector<int> flags;
  int nthreads;
  std::barrier<>* named[16] = {};
};
struct ClusterCtx {
  std::barrier<>* bar;
  std::vector<BlockCtx*> blocks;
};
inline thread_local BlockCtx* tl_block;
inline thread_local ClusterCtx* tl_cluster;
inline thread_local int tl_rank, tl_tid, tl_static_calls;
struct Pending { uint8_t* dst; const void* src; int n, size; };
inline thread_local std::vector<std::vector<Pending>> tl_groups;
inline thread_local std::vector<Pending> tl_cur;
inline std::atomic<long> emu_unwaited{0};

inline WarpCtx& emu_warp() { return *tl_block->warps[tl_tid >> 5]; }
inline int emu_lane() { return tl_tid & 31; }
inline uint8_t* emu_smem() { return tl_block->smem; }
inline uint8_t* emu_static_smem(size_t bytes) {
  std::lock_guard<std::mutex> g(tl_block->mu);
  int i = tl_static_calls++;
  if ((int)tl_block->statics.size() <= i) {
    tl_block->statics.emplace_back(bytes + 64, 0xFF);
  }
  return tl_block->statics[i].data();
}

inline void __syncthreads() { tl_block->bar->arrive_and_wait(); }
// bar.sync id, n: a barrier of the n threads of the block that use id
inline void emu_bar_sync(int id, int n) {
  if (id < 1 || id > 15) emu_fault("named barrier id");
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(tl_block->mu);
    if (!tl_block->named[id]) tl_block->named[id] = new std::barrier<>(n);
    b = tl_block->named[id];
  }
  b->arrive_and_wait();
}
inline int __syncthreads_or(int p) {
  tl_block->flags[tl_tid] = p != 0;
  tl_block->bar->arrive_and_wait();
  int r = 0;
  for (int i = 0; i < tl_block->nthreads; ++i) r |= tl_block->flags[i];
  tl_block->bar->arrive_and_wait();
  return r;
}
template <class T>
inline T emu_xchg(T v, int src) {
  static_assert(sizeof(T) <= 8, "");
  WarpCtx& W = emu_warp();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  W.slot[emu_lane()] = bits;
  W.bar.arrive_and_wait();
  uint64_t o = W.slot[src & 31];
  W.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &o, sizeof(T));
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return emu_xchg(v, src); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return emu_xchg(v, emu_lane() ^ m); }
inline int __any_sync(unsigned, int p) {
  WarpCtx& W = emu_warp();
  W.slot[emu_lane()] = p != 0;
  W.bar.arrive_and_wait();
  int r = 0;
  for (int i = 0; i < 32; ++i) r |= (int)W.slot[i];
  W.bar.arrive_and_wait();
  return r;
}

// ---- scalar intrinsics ----
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint8_t b[8];
  for (int i = 0; i < 4; ++i) { b[i] = (x >> (8 * i)) & 0xFF; b[4 + i] = (y >> (8 * i)) & 0xFF; }
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)b[(s >> (4 * i)) & 7] << (8 * i);
  return r;
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
template <class A, class B> inline auto min(A a, B b) { return a < b ? a : b; }
template <class A, class B> inline auto max(A a, B b) { return a > b ? a : b; }
inline unsigned __cvta_generic_to_shared(const void* p) {
  return (unsigned)((const uint8_t*)p - tl_block->smem);
}

// ---- bf16 / f16 ----
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct __half { uint16_t x; };
struct __half2 { __half x, y; };
inline uint16_t emu_f2bf(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7F800000u) == 0x7F800000u && (u & 0x7FFFFFu)) return (uint16_t)((u >> 16) | 0x40);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
inline float emu_bf2f(uint16_t b) { return __uint_as_float((uint32_t)b << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) { return {emu_f2bf(f)}; }
inline float __bfloat162float(__nv_bfloat16 b) { return emu_bf2f(b.x); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {{emu_f2bf(a)}, {emu_f2bf(b)}}; }
inline float __low2float(__nv_bfloat162 h) { return emu_bf2f(h.x.x); }
inline float __high2float(__nv_bfloat162 h) { return emu_bf2f(h.y.x); }
inline float emu_h2f(uint16_t h) {
  uint32_t s = (h >> 15) & 1, e = (h >> 10) & 31, m = h & 1023;
  float v;
  if (e == 0) v = std::ldexp((float)m, -24);
  else if (e == 31) v = m ? NAN : INFINITY;
  else v = std::ldexp((float)(m | 1024), (int)e - 25);
  return s ? -v : v;
}
inline float __half2float(__half h) { return emu_h2f(h.x); }
inline float __low2float(__half2 h) { return emu_h2f(h.x.x); }
inline float __high2float(__half2 h) { return emu_h2f(h.y.x); }
// fma.rn.bf16x2 d, a, b, c
inline uint32_t emu_fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r = 0;
  for (int h = 0; h < 2; ++h) {
    double x = (double)emu_bf2f((a >> (16 * h)) & 0xFFFF) * emu_bf2f((b >> (16 * h)) & 0xFFFF) +
               emu_bf2f((c >> (16 * h)) & 0xFFFF);
    float f = (float)x;
    if ((double)f != x) emu_fault("inexact fma.rn.bf16x2 (emulation rounds twice)");
    r |= (uint32_t)emu_f2bf(f) << (16 * h);
  }
  return r;
}

// ---- cooperative groups: clusters ----
namespace cooperative_groups {
struct cluster_group {
  void sync() { tl_cluster->bar->arrive_and_wait(); }
  unsigned block_rank() { return (unsigned)tl_rank; }
  template <class T> T* map_shared_rank(T* p, int rank) {
    size_t off = (uint8_t*)p - tl_block->smem;
    if (off >= tl_block->smem_bytes) emu_fault("map_shared_rank outside shared memory");
    if (rank < 0 || rank >= (int)tl_cluster->blocks.size()) emu_fault("map_shared_rank rank");
    return (T*)(tl_cluster->blocks[rank]->smem + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// ---- launches ----
inline void emu_check_smem(uint32_t addr, int n) {
  if ((size_t)addr + n > tl_block->smem_bytes) emu_fault("shared address out of range");
}
template <class K, class... Args>
void emu_run(K kernel, dim3 grid, dim3 block, size_t smem, dim3 cl, Args... args) {
  if (grid.x % cl.x || grid.y % cl.y || grid.z % cl.z) emu_fault("grid not a multiple of the cluster");
  const int nt = block.x * block.y * block.z, nb = cl.x * cl.y * cl.z;
  if (nt % 32) emu_fault("block not whole warps");
  for (unsigned cz = 0; cz < grid.z / cl.z; ++cz)
  for (unsigned cy = 0; cy < grid.y / cl.y; ++cy)
  for (unsigned cx = 0; cx < grid.x / cl.x; ++cx) {
    ClusterCtx C;
    C.bar = new std::barrier<>(nt * nb);
    std::vector<std::vector<uint8_t>> bufs(nb);
    for (int i = 0; i < nb; ++i) {
      auto* B = new BlockCtx;
      B->bar = new std::barrier<>(nt);
      bufs[i].assign(smem + 16, 0xFF);
      B->smem = (uint8_t*)(((uintptr_t)bufs[i].data() + 15) & ~(uintptr_t)15);
      B->smem_bytes = smem;
      B->nthreads = nt;
      B->flags.assign(nt, 0);
      for (int w = 0; w < nt / 32; ++w) B->warps.push_back(new WarpCtx);
      C.blocks.push_back(B);
    }
    std::vector<std::thread> th;
    for (int r = 0; r < nb; ++r) {
      const unsigned rx = r % cl.x, ry = (r / cl.x) % cl.y, rz = r / (cl.x * cl.y);
      const uint3e bi{cx * cl.x + rx, cy * cl.y + ry, cz * cl.z + rz};
      for (int t = 0; t < nt; ++t) {
        th.emplace_back([=, &C]() {
          tl_block = C.blocks[r];
          tl_cluster = &C;
          tl_rank = r;
          tl_tid = t;
          tl_static_calls = 0;
          tl_groups.clear();
          tl_cur.clear();
          threadIdx = {(unsigned)(t % block.x), (unsigned)((t / block.x) % block.y), (unsigned)(t / (block.x * block.y))};
          blockIdx = bi;
          blockDim = block;
          gridDim = grid;
          kernel(args...);
          for (auto& g : tl_groups) if (!g.empty()) emu_unwaited++;
          if (!tl_cur.empty()) emu_unwaited++;
        });
      }
    }
    for (auto& x : th) x.join();
    for (auto* B : C.blocks) {
      for (auto* w : B->warps) delete w;
      for (auto* nb : B->named) delete nb;
      delete B->bar;
      delete B;
    }
    delete C.bar;
  }
}
template <class K, class... Args>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, K kernel, Args... args) {
  dim3 cl(1, 1, 1);
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cl = dim3(cfg->attrs[i].val.clusterDim.x, cfg->attrs[i].val.clusterDim.y, cfg->attrs[i].val.clusterDim.z);
  emu_run(kernel, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cl, args...);
  return 0;
}
template <class K, class... Args>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, Args... args) {
  emu_run(kernel, grid, block, smem, dim3(1, 1, 1), args...);
}
