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
// einsum); here they run in one launch for all experts, through
// qmatmul_experts_kernel (below).
//
// What bounds it on an H100: at decode (M = 1..8 rows) it streams the packed
// weights once and does ~2*M flops per weight, so it is memory-bound (one
// qwen2-1.5b decode step streams ~0.99 GB of packed q4_k/q6_k fields:
// ~0.30 ms at 3.35 TB/s; one DeepSeek-V3 MoE layer's experts are ~5.7 GB,
// ~1.7 ms).  At prefill (M = slots x chunk, or the experts' capacity) it is
// bound by operations: the tensor cores' products and their f32 scaling
// (one weight), the f32 FMAs of the CUDA-core inner loops (experts).
//
// Design.  Fields are structure-of-arrays (S, X, N) with N last, so a
// thread owns 4 neighbouring output columns and reads 4 neighbouring bytes
// of each field row with one 32-bit load: a warp reads 128 contiguous bytes.
// Every call is one launch of one of three kernels (launch_fmt): a stack of
// expert weights takes qmatmul_experts_kernel; one weight at M <= 4 rows
// (K <= 65536) its format's decode form, qmatmul_q4k_decode_kernel (q4_k)
// or qmatmul_mma_decode_kernel (every other format); one weight at any
// other M or K the prefill form, qmatmul_prefill_kernel.  Each replaced a
// first draft (one CUDA-core kernel for every form, which restaged x per
// superblock behind two barriers with no weight bytes in flight, turned
// each code into a float by an int-to-float conversion, and split K with a
// second kernel and an f32 buffer); the paragraphs below say what held the
// draft back in each form and what the redesign does about it.  No kernel
// takes atomics: every sum is added in a fixed order, and K that is not a
// multiple of 256 reads x as zero past K.
//
// The expert form (qmatmul_experts_kernel<T, ROWS, FMT, V>), on the first
// draft the largest device-time family of a DeepSeek-V3 decode step under
// every policy.  At decode C = 1 (4 lanes x top-8 over 256 experts), and
// the draft there was bound by instructions, not bytes: a 4-row tile (4
// FMAs a weight for 1 live row), one int-to-float conversion a weight (a
// quarter-rate pipe), x staged again per superblock behind two barriers,
// and every expert's weights read, used or not.  The redesign:
//  - the row tile follows C: one row at C = 1 (ROWS = 1), else 20 rows
//    (the capacity of a 4 x 128-token prefill chunk);
//  - codes become floats in one byte permute each, no int-to-float: q3_k
//    as 2^23 + (code << shift) and one exact FADD, q6_k as 2^23 + q and
//    one exact FADD (q - 32), q8_0 as 2^23 + (q + 128) (one XOR a word of
//    four codes) and one exact FADD; at C = 1
//    q2_k as 0.5 + code/16, q4_k as 0.5 + q/32 (the nibble in bits 3-6
//    of its byte) and q5_k as 0.5 + q/64 (its nibble and qh bit in bits
//    2-6), with no FADD at all.  At C = 1 each sub-block's scale
//    is factored out of its sum (q3_k: y += d * sum_sub sc * sum x (q -
//    4) and q6_k: y += d * sum_sub sc * sum x (q - 32); q2_k (16
//    elements), q4_k and q5_k (32): y += d * sum_sub sc * sum x q - dmin *
//    sum_sub m * sum x, the sums of x per sub-block taken once per block;
//    q8_0: y += sum_blk d * sum x q), so a weight costs one FMA, one
//    permute and (q3_k, q6_k, q8_0) one FADD, plus ~0.7 (q3_k), ~0.6
//    (q6_k), ~0.45 (q2_k), 0.5 (q4_k), ~1.25 (q5_k) or 0.25 (q8_0) integer
//    ops of code assembly.
//    These sums are f32 in another order than the plain version's, not
//    its dequantized weights (held to the same tolerances).  At C > 1
//    each weight is dequantized once to the plain version's f32 value,
//    then one FMA per row;
//  - x is staged as f32 once for the whole K at C = 1 (28 KB at K = 7168,
//    one barrier), per stage at C > 1, ordered so that one 16-byte shared
//    load gives a byte row's four bit-pairs (q3_k, q2_k), the four
//    elements of two ql rows and a qh row (q6_k), two byte rows' nibbles
//    (q4_k, q5_k) or four rows (q8_0);
//  - the weight fields come into shared memory through a ring of stages
//    (2 at C = 1, 3 at C > 1; a stage is a superblock, or 4 q8_0 blocks
//    of 32 rows) filled by cp.async, 16 bytes a copy (V = 4 when N is not
//    a multiple of 16), whose addresses a thread sets once per block; one
//    barrier per stage at C = 1;
//  - a block whose rows of x are all zero (an expert no token was routed
//    to) reads no weight byte and writes +0, the plain version's result.
// So at C = 1 it is bound by the weight bytes and by the issue of ~2.7-4.3
// instructions a weight, which take about the same time on an H100; at C
// = 20 by the f32 FMAs.  The warps' partial sums are added in a fixed
// order, with no atomics.
//
// q4_k's 2-D form at M <= 4 (qmatmul_q4k_decode_kernel<T, V>), on the
// first draft the largest B1 family of a qwen2 decode step (1536 -> 1536 /
// 8960 at 12 % of the bytes bound).  There x was
// restaged per superblock behind two barriers with no weight bytes in
// flight, each weight took an int-to-float conversion, each thread had one
// 4-byte load a field row in flight, and the split over K cost a second
// launch and a per-call f32 buffer.  The redesign takes the expert form's
// pieces: the weight tiles through a ring of cp.async stages (StageCopies),
// x (up to DROWS = 4 rows, zero past M) staged once as f32 in q4_k's order
// with its 32-element sub-block sums, a nibble moved to bits 3-6 becoming
// 0.5 + q/32 in one byte permute, and each sub-block's scale and min
// factored out of its sums (q4k_stage_rows4), so a weight costs one
// permute, 0.5 integer ops and one FMA a row: ~6 instructions, about the
// time of its 0.5625 bytes.  Where the column tiles alone are few, the
// superblocks are split over a cluster of up to 8 blocks (about 4 blocks an
// SM in all) and the blocks' column sums are added in rank order through
// distributed shared memory: one launch, deterministic.  A zero row of x
// gives +0, as the plain version does.
//
// The 2-D forms at M <= 4 of q6_k, q3_k, q5_k, q2_k and q8_0 on tensor
// cores (qmatmul_mma_decode_kernel<T, FMT, V>), for q6_k on the first draft
// the largest B1 family left (qwen2's
// down, attn_k, attn_v; DeepSeek's output, attn_kv_a_mqa and dense downs):
// the same restaging, conversions and second launch held it back, and a
// copy of q4_k's CUDA-core design would stop at the same issue wall (q6_k's
// codes cost more integer ops).  A code q - 32 is exact in bf16 and so is
// bf16 x, so one bf16 mma.sync.m16n8k16 with f32 accumulation computes a
// 16-element sub-block's products for 16 columns exactly as FMAs would;
// only the summation order changes.  The codes become bf16 pairs without
// an int-to-float instruction (byte permutes place a code under the
// exponent byte of 128, one bf16x2 FMA subtracts 160), each sub-block's
// product is scaled in f32 by its int8 scale (made a float by a byte
// permute) and each superblock's by its d; f32 x is three bf16 terms (hi +
// mid + lo), three mmas.  A block of 8 warps owns 128 columns; the weight
// tiles come through a 3-stage ring of cp.async copies (StageCopies, rows
// padded by 16 bytes so that a warp's 4-byte loads of eight columns in four
// rows hit 32 banks) with x's rows of the superblock in the same stage (no
// K limit from shared memory); the superblocks are split over a cluster of
// up to 16 blocks (decode_ksplit_q6k: the most whose clusters are all
// resident at once) whose sums are added in rank order through distributed
// shared memory.  One launch; a zero row of x gives +0.  Within a block it is
// bound by the latency of each stage's ~430 instructions a warp (~3.4 a
// weight), not by the issue rate, so at decode's few blocks a stage's
// products take longer than its bytes (scripts/decode_ablation.py).
// q3_k takes the same kernel (FMT 2): its codes come in q6_k's element
// order (qs row r holds elements r + 64p in bit-pair p, hmask row r % 32
// their high bits), so the stage loop, the fragments and the cluster merge
// are shared; a code is assembled by q3k_codes (the expert form's: bit-pair
// p at bit q3_shift(p) of its byte, ~0.45 integer ops a code) and made
// (q - 4) 2^q3_shift(p) in bf16 by code_pair's FMA, the 2^-q3_shift(p)
// folded into the scale's conversion (an exact FMA in place of the FADD).
// A q3_k stage is 16.0 KB of fields against q6_k's 29.5, so the stage's
// fixed cost (a barrier, x's rows, d) weighs twice as much a byte; its K
// split (decode_ksplit_q3k) was fitted to it by a scan of its own.  On an
// H100 at 18432 -> 7168 (ks 4) the weight stream alone, with its waits and
// barriers, takes 0.026 of the kernel's 0.042 ms against a bytes bound of
// 0.018; the code conversion 17 % of it and the mmas 11 %; three or four
// blocks an SM (80 or 64 registers, with spills) ran 3-10 % and 5-31 %
// slower at the eight DeepSeek shapes (scripts/decode_ablation.py).
// q2_k (FMT 4) takes q3_k's element order without hmask: qs row r holds
// elements r + 64p in bit-pair p; the two rows of a fragment are
// interleaved first and each bit-pair then masked in place (bit q3_shift(p),
// ~0.4 integer ops a code), q 2^q3_shift(p) in bf16 by code_pair, the scale
// (sm's low nibble) times 2^-q3_shift(p) exactly.  Its min term, dmin m sum
// x a sub-block: each lane's sub-block sums of x's rows come from the x
// fragments by shuffles, and four FMAs a tile add m (sm's high nibble) times
// them into a second accumulator, scaled once a superblock by -dmin (one
// more mma a sub-block, A the column's m, ran 1-2 % slower).  q8_0 (FMT 5)
// has no sub-blocks: a stage is MD_Q8_BLOCKS = 4 blocks of 32 rows, warp
// group j0 takes block j0 (two mmas into one D, scaled once by the block's
// fp16 d), an int8 code is its low 7 bits through code_pair with a bias of
// -128, or -256 where its sign bit is set (the prefill form's conversion),
// and a block past the field's last (K % 128 != 0) is neither copied nor
// read: its stale d could be an Inf, and 0 x Inf is NaN.  q5_k (FMT 3)
// takes q6_k's element order: qs rows r and r + 64 give the low nibbles of
// elements r + 64p as q6_k's ql rows do, and bit r / 32 + 2p of qh row r %
// 32 their high bits, as q3_k's hmask (q5k_codes: q6k_codes's integer ops
// and one shift a qh word); a code is at most 31, exact under code_pair's exponent with a bias
// of -128; the 16-element piece r + 64p is half of the 32-element sub-block
// j0 / 2 + 2p, whose u8 scale scales D (2^23 + sc, no mask).  Its min
// term, dmin m sum x a 32-element sub-block, stays off the mma warps'
// fragments (q2_k's way, sums of x from the B fragments and 16 FMAs a
// piece and lane, ran 2-10 % slower; one more mma a piece spilled):
// in each stage warp w takes row w % 4 of x and four sub-blocks, lane l
// four columns (q5k_min_stage: x's sub-block sums by shuffles, one 4-byte
// load a mins row, ~70 instructions a thread), and the block's sums less
// these at the end.  A q5_k stage is 25.3 KB of padded fields
// (qs 128, qh 32, scales 8 and mins 8 rows, d and dmin): three stages and
// x's rows, 82 KB (f32 x 88 KB), leave two blocks an SM.  All of them keep the
// block's shape, the x fragments and the cluster merge, so q6_k's, q3_k's,
// q2_k's and q8_0's instances compute their former bits.
//
// The 2-D form at M > 4 of every format on tensor cores
// (qmatmul_prefill_kernel<T, FMT, V, ROWS>): every prefill chunk of the
// engine is 4 x 128 = 512 rows, where the first draft ran at ~25 TFLOP/s
// (2.5 % of the bf16 peak): its 16-row tile decoded each weight again for
// every 16 rows, with an int-to-float conversion and 16 f32 FMAs a weight,
// and x was restaged a superblock at a time behind two barriers with no
// weight bytes in flight.  Here a block of 8 warps owns a ROWS x 128 tile
// of the output (128 rows: 4 x 2 warps of 32 x 64; 64 rows, where the
// 128-row tiles would be at most 8: 2 x 4 warps of 32 x 32) in f32
// registers and walks K in stages of half a superblock (bf16 x; a quarter
// for f32 x), each stage a whole number of the fields' byte rows and
// sub-blocks (see the section below).  Per stage:
//  - the fields' rows and x's rows of the stage's elements (bf16 or f32, as
//    the model passes it) come in through a ring of 3 slots by cp.async,
//    16-byte copies (4-byte ones for the fields when N % 16 != 0; x
//    zero-filled past M and K, or loaded and stored by the threads when its
//    rows are not 16-byte aligned);
//  - the codes become a bf16 tile in shared memory, once per block (once
//    per 128 rows of x, 4 times a call at M = 512, against 32), by byte
//    permutes under the exponent of 128 and one bf16x2 FMA of -128 (q4_k,
//    q2_k, whose code is a bit-pair of qs, and q5_k, whose code is a nibble
//    of qs and a bit of qh above it), -160 (q6_k) or -132 (q3_k, whose
//    code is first assembled from a bit-pair of qs and a bit of hmask) a
//    pair: exact, no int-to-float.
//    q8_0's int8 code takes 8 bits, one more than fits under the exponent:
//    its low 7 bits go there, and the FMA's bias pair is -128 or -256 by
//    the code's sign bit, that bit placed under the exponent byte of -128
//    by one more byte permute a pair (2 instructions a code; 2^23 + (q +
//    128) as an f32, one FADD and a conversion to bf16 would take 2.75);
//    each sub-block's sc * d (q4_k, q5_k and q2_k also -m * dmin; q8_0
//    each block's d) is
//    made once per column in f32, laid out so that a lane reads its
//    columns' scales in 16-byte loads;
//  - the products are bf16 mma.sync.m16n8k16 with f32 accumulation, x the
//    A operand (ldmatrix), the code tile B (ldmatrix.trans; rows padded 16
//    bytes, so that eight rows of a fragment hit 32 banks); the codes and
//    bf16 x are exact, so they compute the products FMAs would, in another
//    order.  The scales
//    are applied in f32 outside the product, design (a): each sub-block's
//    products go to accumulators zeroed for it and are added into the
//    output accumulators times sc * d (4 FMAs a thread an mma for the
//    16-element sub-blocks of q6_k, q3_k and q2_k, 2 for the 32 of q4_k
//    and q5_k and q8_0's blocks), and the min term -m * dmin * sum x of
//    q4_k, q5_k and q2_k with them, the sub-block's sums of x's rows made
//    by one more mma against a B of ones (one a k16 step: q2_k's
//    16-element sub-blocks take one, q4_k's and q5_k's two).  Design (b), the integer product code x
//    scale as two exact bf16 terms, would double the mmas and the
//    conversion and was not built;
//  - a stage is multiplied while the next is converted (two tile buffers)
//    and the one after is copied: one barrier a stage.
// f32 x (the card-vs-CPU parity runs and the f32 tests) computes the plain
// version's function to f32 rounding instead: each weight dequantized as
// qmatmul_plain does it (each product and difference rounded to f32) and
// split, like x (split3), into three bf16 terms, six mmas a product (the
// three term products below f32 precision dropped), each k16 step's sum
// added in f32; one tile buffer (three terms' tiles), two barriers a
// stage.  The factored scales of the bf16 path moved an f32 run far enough
// from the CPU's that a q4_0 KV code of the parity phase came out a step
// apart (run M2, PR 20); with the plain version's weights the card and the
// CPU differ in summation order only, as cuBLAS's f32 product does.
// Shared memory (one block an SM, at most 227 KB): the ring's slots hold x
// (128 rows x 256 bytes, padded: 34.0 KB, f32 36.0 KB; half that at 64
// rows) and the stage's fields (q4_k 9.5 KB, q6_k 13.25 KB, q3_k 9.25 KB
// with all 32 hmask rows, q5_k 13.5 KB with all 32 qh rows, q2_k 5.5 KB,
// q8_0 17.0 KB; f32 5.0 / 6.75 / 6.75 / 9.0 / 3.0 / 8.5 KB), the two
// buffers the code tile (34.0 KB) and the
// scales (2.5-5 KB) (f32:
// one buffer of three 17.0 KB tiles): at most 226.0 KB (q8_0, bf16, 128
// rows; launch_prefill_rows checks each instance at compile time), so q8_0
// keeps the others' stage of half a superblock.  A fourth slot would not
// fit, so one stage is in flight while one is converted and one
// multiplied; a ring of 5-7 quarter-superblock stages
// (more bytes in flight) measured 7-12 % slower.  Where the tiles are
// fewer than the SMs, the half superblocks split over a cluster of up to 8
// blocks (prefill_ksplit, host integers) whose sums are added in rank
// order through distributed shared memory: one launch, no partial buffer.
// Rows past M are read as zero and not written; a zero row of x gives +0;
// the order of every sum is fixed.  On an H100 it runs at ~130-150
// TFLOP/s at the large shapes, bound by each block's instruction stream at
// two warps a scheduler (the scale FMAs alone cost a third of the time,
// the mmas a fifth; scripts/decode_ablation.py), and at the smallest by
// the launch, the first stage's copies and the cluster merge.  The q3_k
// instances are bound as q6_k's are (the same 4 scale FMAs an mma; the
// code assembly is once per block); q8_0's as q4_k's less its min term (2
// scale FMAs an mma, no mma against ones), with 17 KB of fields a stage
// to copy against q4_k's 9.5; q2_k's as q3_k's plus q4_k's min term at
// twice its rate (an mma against ones and 4 more FMAs a sub-block); q5_k's
// as q4_k's, with 13.5 KB of fields a stage and its code assembled from
// two fields (a qh word shifted and masked into each nibble's bit 4).
//
// Built once per format: -DQMATMUL_FMT=<id> instantiates that format's
// kernels only (kernels/build.py builds the six libraries in parallel).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

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

__device__ __forceinline__ uint32_t byte_of(uint32_t word, int c) {
  return (word >> (8 * c)) & 0xFFu;
}

// Formats: 0 q4_k, 1 q6_k, 2 q3_k, 3 q5_k, 4 q2_k, 5 q8_0.  Their fields,
// in the order the C entry point takes them, each as its byte rows per 256
// rows of K (a row holds one element per output column) and the bytes of
// one element; {0, 0} past a format's last field.  The field count and a
// stage's rows derive from it.
constexpr int MAXF = 6;
constexpr int Q8_0 = 5;
struct FieldLayout {
  int rows, esz;
};
// field g of a list, {0, 0} past its end (a chain of selects: no array
// for device code to keep in memory)
__host__ __device__ constexpr FieldLayout pick(
    int g, FieldLayout f0, FieldLayout f1, FieldLayout f2 = {},
    FieldLayout f3 = {}, FieldLayout f4 = {}, FieldLayout f5 = {}) {
  return g == 0   ? f0
         : g == 1 ? f1
         : g == 2 ? f2
         : g == 3 ? f3
         : g == 4 ? f4
         : g == 5 ? f5
                  : FieldLayout{};
}
__host__ __device__ constexpr FieldLayout field_layout(int fmt, int g) {
  // q4_k: qs, scales, mins, d, dmin
  return fmt == 0 ? pick(g, {128, 1}, {8, 1}, {8, 1}, {1, 2}, {1, 2})
         // q6_k: ql, qh, scales, d
         : fmt == 1 ? pick(g, {128, 1}, {64, 1}, {16, 1}, {1, 2})
         // q3_k: qs, hmask, scales, d
         : fmt == 2 ? pick(g, {64, 1}, {32, 1}, {16, 1}, {1, 2})
         // q5_k: qs, qh, scales, mins, d, dmin
         : fmt == 3 ? pick(g, {128, 1}, {32, 1}, {8, 1}, {8, 1}, {1, 2},
                           {1, 2})
         // q2_k: qs, sm, d, dmin
         : fmt == 4 ? pick(g, {64, 1}, {16, 1}, {1, 2}, {1, 2})
         // q8_0: qs, d (8 blocks of 32 rows)
                    : pick(g, {256, 1}, {8, 2});
}
__host__ __device__ constexpr int num_fields(int fmt) {
  int n = 0;
  while (n < MAXF && field_layout(fmt, n).rows > 0) ++n;
  return n;
}

struct Fields {
  const uint8_t* p[MAXF];
};

__device__ __forceinline__ const __half* as_half(const uint8_t* p) {
  return reinterpret_cast<const __half*>(p);
}

// ---------------------------------------------------------------------------
// The expert form for every format but q5_k: qmatmul_experts_kernel (see
// the header).  A block owns 128 columns of one expert and one row tile (1
// row, or XROWS rows when C > 1), and walks K one stage at a time: a
// superblock (256 rows), or for q8_0 Q8_STAGE_BLOCKS blocks of 32 rows.
// Thread tid owns columns 4 * (tid % 32) .. + 3; how the four warps split a
// stage, and the order in which x is kept in shared memory (as f32, so that
// one 16-byte load gives the elements a warp needs next), is each format's
// own (xperm, and the stage functions below).
// ---------------------------------------------------------------------------

// stages in the ring: at C = 1 two (one in flight while one is
// consumed; four blocks of q2_k then fit an SM, three of q3_k, q4_k and
// q8_0, and of q6_k at K = 2048, so 40-80 KB of weights are in flight per
// SM), at C > 1 three
template <int ROWS>
__host__ __device__ constexpr int xstages() {
  return ROWS == 1 ? 2 : 3;
}
constexpr int XROWS = 20;              // row tile when C > 1 (20 at prefill)
constexpr int XWHOLE_MAX = 64 * 1024;  // bytes of x a C = 1 block keeps
// q8_0 blocks a stage: 4 (128 rows, 17 KB with their d) rather than a
// superblock's 8, so that at C = 1 three blocks share an SM (two 34 KB
// stages and 28 KB of x would let only two): more warps to hide the
// shared-memory and FMA latencies, and as many bytes in flight.
constexpr int Q8_STAGE_BLOCKS = 4;

// rows of K a format block (q8_0 32, else a superblock), format blocks a
// stage, and rows of K a stage
__host__ __device__ constexpr int block_k(int fmt) {
  return fmt == Q8_0 ? 32 : QK;
}
__host__ __device__ constexpr int stage_blocks(int fmt) {
  return fmt == Q8_0 ? Q8_STAGE_BLOCKS : 1;
}
__host__ __device__ constexpr int stage_k(int fmt) {
  return block_k(fmt) * stage_blocks(fmt);
}
// field g's byte rows per stage of ``sk`` rows of K (0: stage_k), and
// their element bytes (field_layout)
__host__ __device__ constexpr int xf_rows(int fmt, int g, int sk = 0) {
  return field_layout(fmt, g).rows * (sk ? sk : stage_k(fmt)) / QK;
}
__host__ __device__ constexpr int xf_esz(int fmt, int g) {
  return field_layout(fmt, g).esz;
}
// where field g of a stage (128 columns, ``sk`` rows of K; 0: stage_k)
// starts (a loop rather than recursion, which nvcc did not fold at every
// call site), when each of a field's rows is ``pad`` bytes longer in shared
// memory than its 128 columns (pad = 0 everywhere but the tensor-core
// decode form)
__host__ __device__ constexpr int xf_off(int fmt, int g, int pad = 0,
                                         int sk = 0) {
  int off = 0;
  for (int i = 0; i < g; ++i)
    off += xf_rows(fmt, i, sk) * (COLS * xf_esz(fmt, i) + pad);
  return off;
}
__host__ __device__ constexpr int stage_bytes(int fmt) {
  return xf_off(fmt, num_fields(fmt));
}
// sums of x a C = 1 block keeps per stage: one per sub-block whose min is
// factored out (q2_k 16 of 16 elements, q4_k and q5_k 8 of 32)
__host__ __device__ constexpr int xsums(int fmt) {
  return fmt == 4 ? 16 : fmt == 0 || fmt == 3 ? 8 : 0;
}

// A thread's share of the copies of one stage (SK rows of K) of the
// block's 128 columns, V bytes a copy (16 when N is a multiple of 16, else
// 4): in field g its chunks are ``step`` rows apart, at the same column in
// every row, so their addresses are set once per block and advanced by a
// stage after each one.  A chunk past N is not copied, nor a format block
// past the field's last where a stage holds more than one: a field holds
// ceil(K / block_k) blocks, not a whole number of stages.
template <int FMT, int V, int PAD = 0, int SK = stage_k(FMT),
          int STAGE = xf_off(FMT, num_fields(FMT), PAD, SK)>
struct StageCopies {
  static constexpr int NF = num_fields(FMT);
  static constexpr int SB = SK / block_k(FMT);   // format blocks a stage
  const uint8_t* src[NF];
  uint32_t dst[NF];
  int row[NF];
  bool on[NF];

  // blk0: the expert's first format block along K (e * blocks an expert)
  __device__ __forceinline__ StageCopies(const Fields& f, size_t blk0, int N,
                                         int n0, const uint8_t* ring,
                                         int tid) {
#pragma unroll
    for (int g = 0; g < NF; ++g) {
      const int R = xf_rows(FMT, g, SK), ES = xf_esz(FMT, g);
      const int RB = R / SB;          // byte rows a format block
      const int cpr = COLS * ES / V;  // chunks a row: divides NTHREADS
      const int r0 = tid / cpr, b = (tid % cpr) * V;
      row[g] = r0;
      on[g] = r0 < R && n0 + b / ES < N;
      src[g] = f.p[g] + ((blk0 * RB + r0) * N + n0) * ES + b;
      dst[g] = smem_u32(ring) + xf_off(FMT, g, PAD, SK) +
               r0 * (COLS * ES + PAD) + b;
    }
  }
  // start the copies of the next stage, whose first ``nvalid`` format
  // blocks exist, into ring slot ``slot``
  __device__ __forceinline__ void issue(int slot, int N, int nvalid) {
#pragma unroll
    for (int g = 0; g < NF; ++g) {
      const int R = xf_rows(FMT, g, SK), ES = xf_esz(FMT, g);
      const int RB = R / SB;
      const int step = NTHREADS / (COLS * ES / V);
      if (on[g]) {
#pragma unroll
        for (int i = 0; i < (R + step - 1) / step; ++i)
          if (SB == 1 || row[g] + i * step < nvalid * RB)
            cp_async<V>(
                dst[g] + slot * STAGE + i * step * (COLS * ES + PAD),
                src[g] + (size_t)i * step * N * ES);
      }
      src[g] += (size_t)R * N * ES;
    }
  }
};

// Byte c of ``codes`` as the float 2^23 + byte (exact), in one byte
// permute: the magic-number conversion, no int-to-float instruction.
__device__ __forceinline__ float code_f32(uint32_t codes, int c) {
  return __int_as_float(__byte_perm(codes, 0x4B000000u, 0x7440u | c));
}
constexpr float kMagic = 8388608.f;  // 2^23
// Byte c of ``codes`` (bit 7 clear) under the exponent byte 0x3F: the
// float 0.5 + byte / 256, also one byte permute.  A q2_k code in bits 4-5
// gives 0.5 + code / 16, a q4_k nibble in bits 3-6 0.5 + q / 32.
__device__ __forceinline__ float code_half(uint32_t codes, int c) {
  return __int_as_float(__byte_perm(codes, 0x3F000000u, 0x7044u | (c << 8)));
}

// q3_k: the four columns' codes of bit-pair p, one per byte, from one qs
// word and one hmask word: bit-pair p stays at bits 2p.. of its byte (bits
// 4.. for p = 3, whose 3-bit code would cross the byte), so the byte is
// code << q3_shift(p).
__device__ __forceinline__ constexpr int q3_shift(int p) {
  return p == 3 ? 4 : 2 * p;
}
__device__ __forceinline__ void q3k_codes(uint32_t q, uint32_t hm, int h,
                                          uint32_t (&t)[4]) {
  // hmask bit 2p + h goes to bit 2p + 2 of its byte (p < 3), bit 6 + h to
  // bit 6 (p = 3)
  const uint32_t hs = hm << (2 - h), hr = hm >> h;
  t[0] = (q & 0x03030303u) | (hs & 0x04040404u);
  t[1] = (q & 0x0C0C0C0Cu) | (hs & 0x10101010u);
  t[2] = (q & 0x30303030u) | (hs & 0x40404040u);
  t[3] = ((q >> 2) & 0x30303030u) | (hr & 0x40404040u);
}

// The sub-block's scale (q3_k eff = sc * d; q2_k es = sc * d) and min
// (q2_k em = m * dmin) for four columns, each product rounded as the plain
// version rounds it.  ``sub`` is the sub-block's row of scales or sm.
struct SubScale {
  float mul[4];
  float min[4];
};
template <int FMT>
__device__ __forceinline__ SubScale sub_scale(const uint8_t* stage, int sub,
                                              int l) {
  SubScale r;
  float dd[4];
  if constexpr (FMT == 2) {
    load4_half(as_half(stage + xf_off(2, 3)) + 4 * l, dd);
    const uint32_t sc = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(2, 2) + sub * COLS + 4 * l);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r.mul[c] = __fmul_rn((float)(int8_t)byte_of(sc, c), dd[c]);
      r.min[c] = 0.f;
    }
  } else {
    float dm[4];
    load4_half(as_half(stage + xf_off(4, 2)) + 4 * l, dd);
    load4_half(as_half(stage + xf_off(4, 3)) + 4 * l, dm);
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(4, 1) + sub * COLS + 4 * l);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r.mul[c] = __fmul_rn(dd[c], (float)(byte_of(v, c) & 15u));
      r.min[c] = __fmul_rn(dm[c], (float)(byte_of(v, c) >> 4));
    }
  }
  return r;
}

// C = 1: sums per sub-block of x times the code, one byte permute and one
// or two float ops a weight; then per sub-block and column the scale codes
// times those sums, and per column the superblock's d (and dmin) times
// that.  q3_k: y += d * sum_sub sc * sum x (q - 4), x stored divided by
// 2^q3_shift(p).  q2_k: y += 16 d * sum_sub sc * (sum x (1/2 + q/16) -
// sum x / 2) - dmin * sum_sub m * sum x: the code as 0.5 + q/16 needs no
// subtraction per weight, and the sums of x per sub-block (``xsum``) are
// taken once per block.
template <int FMT>
__device__ __forceinline__ void experts_superblock_c1(const uint8_t* stage,
                                                      const float* xsb,
                                                      const float* xsum_s,
                                                      int w, int l,
                                                      float (&acc)[4]) {
  const int h = w >> 1;
  const uint8_t* qrow = stage + 16 * w * COLS + 4 * l;
  const uint8_t* hrow = stage + xf_off(FMT, 1) + 16 * (w & 1) * COLS + 4 * l;
  const float* xr = xsb + 64 * w;
  float part[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[p][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < 16; ++j) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(qrow + j * COLS);
    const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * j);
    const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t t[4];
    if constexpr (FMT == 2) {
      const uint32_t hm = *reinterpret_cast<const uint32_t*>(hrow + j * COLS);
      q3k_codes(q, hm, h, t);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[p][c] =
              fmaf(xp[p],
                   code_f32(t[p], c) - (kMagic + (float)(4 << q3_shift(p))),
                   part[p][c]);
    } else {
      // bit-pair p's codes to bits 4-5 of their byte
      t[0] = (q << 4) & 0x30303030u;
      t[1] = (q << 2) & 0x30303030u;
      t[2] = q & 0x30303030u;
      t[3] = (q >> 2) & 0x30303030u;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[p][c] = fmaf(xp[p], code_half(t[p], c), part[p][c]);
    }
  }
  float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int sub = w + 4 * p;
    if constexpr (FMT == 2) {
      const uint32_t sc = *reinterpret_cast<const uint32_t*>(
          stage + xf_off(2, 2) + sub * COLS + 4 * l);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        a1[c] = fmaf((float)(int8_t)byte_of(sc, c), part[p][c], a1[c]);
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          stage + xf_off(4, 1) + sub * COLS + 4 * l);
      const float xsub = xsum_s[sub];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a1[c] = fmaf((float)(byte_of(v, c) & 15u),
                     part[p][c] - 0.5f * xsub, a1[c]);
        a2[c] = fmaf((float)(byte_of(v, c) >> 4), xsub, a2[c]);
      }
    }
  }
  float dd[4];
  load4_half(as_half(stage + xf_off(FMT, FMT == 2 ? 3 : 2)) + 4 * l, dd);
  if constexpr (FMT == 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = fmaf(dd[c], a1[c], acc[c]);
  } else {
    float dm[4];
    load4_half(as_half(stage + xf_off(4, 3)) + 4 * l, dm);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] = fmaf(16.f * dd[c], a1[c], acc[c]);
      acc[c] = fmaf(-dm[c], a2[c], acc[c]);
    }
  }
}

// C > 1: the XROWS rows of x at one element (``xk``, 16-byte aligned)
// times four columns' weights
__device__ __forceinline__ void fma_xrows(const float* xk, const float (&wv)[4],
                                          float (&acc)[XROWS][4]) {
#pragma unroll
  for (int r4 = 0; r4 < XROWS / 4; ++r4) {
    const float4 xv = *reinterpret_cast<const float4*>(xk + 4 * r4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[4 * r4 + 0][c] = fmaf(xv.x, wv[c], acc[4 * r4 + 0][c]);
      acc[4 * r4 + 1][c] = fmaf(xv.y, wv[c], acc[4 * r4 + 1][c]);
      acc[4 * r4 + 2][c] = fmaf(xv.z, wv[c], acc[4 * r4 + 2][c]);
      acc[4 * r4 + 3][c] = fmaf(xv.w, wv[c], acc[4 * r4 + 3][c]);
    }
  }
}

// C > 1: each weight dequantized once (the plain version's f32 value:
// (code - 4) * eff, or code * es - em with the product rounded first), then
// one FMA per row.  x is the superblock's (256, XROWS) tile.
template <int FMT>
__device__ __forceinline__ void experts_superblock_rows(
    const uint8_t* stage, const float* xt, int w, int l,
    float (&acc)[XROWS][4]) {
  const int h = w >> 1;
  const uint8_t* qrow = stage + 16 * w * COLS + 4 * l;
  const uint8_t* hrow = stage + xf_off(FMT, 1) + 16 * (w & 1) * COLS + 4 * l;
  SubScale ss[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) ss[p] = sub_scale<FMT>(stage, w + 4 * p, l);
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(qrow + j * COLS);
    uint32_t t[4];
    if constexpr (FMT == 2) {
      q3k_codes(q, *reinterpret_cast<const uint32_t*>(hrow + j * COLS), h, t);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) t[p] = q & (0x03030303u << (2 * p));
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      // code << shift, then times the scale over 2^shift: exact scalings
      const int shift = FMT == 2 ? q3_shift(p) : 2 * p;
      const float inv = 1.f / (float)(1 << shift);
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (FMT == 2)
          wv[c] = __fmul_rn(code_f32(t[p], c) - (kMagic + (4 << shift)),
                            ss[p].mul[c] * inv);
        else
          wv[c] = __fsub_rn(__fmul_rn(code_f32(t[p], c) - kMagic,
                                      ss[p].mul[c] * inv),
                            ss[p].min[c]);
      }
      fma_xrows(xt + (64 * w + 4 * j + p) * XROWS, wv, acc);
    }
  }
}

// x[k0, k0 + V) of one row as f32, zeros past K: one 16-byte load when the
// rows are 16-byte aligned, so that a thread has V elements in flight
template <typename T>
__device__ __forceinline__ void load_x(const T* row, int k0, int K, bool vec,
                                       float (&v)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  if (vec && k0 + V <= K) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + k0);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32<T>(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = k0 + i < K ? to_f32<T>(row[k0 + i]) : 0.f;
  }
}

// where element k of a stage sits in shared memory: q3_k, q2_k, q6_k (16w
// + j, p) for k = 16w + j + 64p (a byte row's four bit-pairs; q6_k: ql
// rows 16w + j and 64 + 16w + j and qh row 16w + j); q4_k and q5_k (j, h)
// for k = j + 128h (a byte row's two nibbles); q8_0 in order
template <int FMT>
__device__ __forceinline__ int xperm(int k) {
  if constexpr (FMT == 0 || FMT == 3)
    return ((k & 127) << 1) + (k >> 7);
  else if constexpr (FMT == Q8_0)
    return k;
  else
    return ((k & 63) << 2) + (k >> 6);
}

// q4_k, C = 1.  Warp w takes qs byte rows 32w .. 32w + 31: their low
// nibbles are elements 32w + j (sub-block w), their high ones 128 + 32w +
// j (sub-block 4 + w), and one 16-byte load of x gives two byte rows' four
// elements.  A nibble moved to bits 3-6 of its byte becomes 0.5 + q/32 in
// one byte permute (two integer ops a word place the four low or high
// nibbles), so a weight costs one permute and one FMA, plus 0.5 integer
// ops.  Per sub-block and column: sum x q = 32 (part - xsum / 2), and y +=
// 32 d sum_sub sc (part - xsum / 2) - dmin sum_sub m xsum, with the sums
// of x per sub-block (``xsum_s``) taken once per block.
__device__ __forceinline__ void q4k_stage_c1(const uint8_t* stage,
                                             const float* xsb,
                                             const float* xsum_s, int w,
                                             int l, float (&acc)[4]) {
  const uint8_t* qrow = stage + 32 * w * COLS + 4 * l;
  const float* xr = xsb + 64 * w;
  float plo[4] = {0.f, 0.f, 0.f, 0.f}, phi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int j = 0; j < 32; j += 2) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + 2 * j);
    const uint32_t q0 = *reinterpret_cast<const uint32_t*>(qrow + j * COLS);
    const uint32_t q1 =
        *reinterpret_cast<const uint32_t*>(qrow + (j + 1) * COLS);
    const uint32_t lo0 = (q0 << 3) & 0x78787878u, hi0 = (q0 >> 1) & 0x78787878u;
    const uint32_t lo1 = (q1 << 3) & 0x78787878u, hi1 = (q1 >> 1) & 0x78787878u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      plo[c] = fmaf(xv.x, code_half(lo0, c), plo[c]);
      phi[c] = fmaf(xv.y, code_half(hi0, c), phi[c]);
      plo[c] = fmaf(xv.z, code_half(lo1, c), plo[c]);
      phi[c] = fmaf(xv.w, code_half(hi1, c), phi[c]);
    }
  }
  const uint8_t* sc = stage + xf_off(0, 1) + 4 * l;
  const uint8_t* mn = stage + xf_off(0, 2) + 4 * l;
  const uint32_t sl = *reinterpret_cast<const uint32_t*>(sc + w * COLS);
  const uint32_t sh = *reinterpret_cast<const uint32_t*>(sc + (4 + w) * COLS);
  const uint32_t ml = *reinterpret_cast<const uint32_t*>(mn + w * COLS);
  const uint32_t mh = *reinterpret_cast<const uint32_t*>(mn + (4 + w) * COLS);
  const float xl = xsum_s[w], xh = xsum_s[4 + w];
  float dd[4], dm[4];
  load4_half(as_half(stage + xf_off(0, 3)) + 4 * l, dd);
  load4_half(as_half(stage + xf_off(0, 4)) + 4 * l, dm);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float a1 = fmaf((float)byte_of(sl, c), plo[c] - 0.5f * xl,
                          (float)byte_of(sh, c) * (phi[c] - 0.5f * xh));
    const float a2 =
        fmaf((float)byte_of(ml, c), xl, (float)byte_of(mh, c) * xh);
    acc[c] = fmaf(32.f * dd[c], a1, acc[c]);
    acc[c] = fmaf(-dm[c], a2, acc[c]);
  }
}

// q4_k, C > 1: the same split; each weight dequantized once to the plain
// version's q * (sc * d) - m * dmin: q * (sc * d) is exact (4 x 17
// significant bits), so one FMA rounds as the plain version's product and
// subtraction do.  The high nibble is taken as 16 q, times the scale over
// 16.  Then one FMA per row; x is the stage's (256, XROWS) tile.  Two byte
// rows an iteration: on an H100 SXM at C = 20, 5.0-5.2 ms a launch, against
// 5.4-5.6 with one row an iteration and 5.6 with the two nibbles'
// sub-blocks in turn.
__device__ __forceinline__ void q4k_stage_rows(const uint8_t* stage,
                                               const float* xt, int w, int l,
                                               float (&acc)[XROWS][4]) {
  const uint8_t* qrow = stage + 32 * w * COLS + 4 * l;
  float dd[4], dm[4], es[2][4], nem[2][4];
  load4_half(as_half(stage + xf_off(0, 3)) + 4 * l, dd);
  load4_half(as_half(stage + xf_off(0, 4)) + 4 * l, dm);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t sc = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(0, 1) + (w + 4 * h) * COLS + 4 * l);
    const uint32_t mn = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(0, 2) + (w + 4 * h) * COLS + 4 * l);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      es[h][c] =
          __fmul_rn(dd[c], (float)byte_of(sc, c)) * (h ? 1.f / 16.f : 1.f);
      nem[h][c] = -__fmul_rn(dm[c], (float)byte_of(mn, c));
    }
  }
#pragma unroll 2
  for (int j = 0; j < 32; ++j) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(qrow + j * COLS);
    const uint32_t t[2] = {q & 0x0F0F0F0Fu, q & 0xF0F0F0F0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = fmaf(code_f32(t[h], c) - kMagic, es[h][c], nem[h][c]);
      fma_xrows(xt + (2 * (32 * w + j) + h) * XROWS, wv, acc);
    }
  }
}

// q5_k, C = 1: q4_k's split, with the high bits.  Warp w takes qs byte rows
// 32w .. 32w + 31 (elements 32w + j of sub-block w in the low nibbles, 128
// + 32w + j of sub-block 4 + w in the high ones) and bits w and 4 + w of qh
// rows 0 .. 31 (row j holds their high bits).  A 5-bit code placed in bits
// 2-6 of its byte becomes 0.5 + q/64 in one byte permute (five integer ops
// a word place four codes, from a qs word and a qh word shifted by w once),
// so a weight costs one permute, ~1.25 integer ops and one FMA.  Per
// sub-block and column: sum x q = 64 (part - xsum / 2), and y += 64 d
// sum_sub sc (part - xsum / 2) - dmin sum_sub m xsum, with the sums of x
// per sub-block (``xsum_s``) taken once per block.
__device__ __forceinline__ void q5k_stage_c1(const uint8_t* stage,
                                             const float* xsb,
                                             const float* xsum_s, int w,
                                             int l, float (&acc)[4]) {
  const uint8_t* qrow = stage + 32 * w * COLS + 4 * l;
  const uint8_t* hrow = stage + xf_off(3, 1) + 4 * l;
  const float* xr = xsb + 64 * w;
  float plo[4] = {0.f, 0.f, 0.f, 0.f}, phi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int j = 0; j < 32; j += 2) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + 2 * j);
    const uint32_t q0 = *reinterpret_cast<const uint32_t*>(qrow + j * COLS);
    const uint32_t q1 =
        *reinterpret_cast<const uint32_t*>(qrow + (j + 1) * COLS);
    // bits w and 4 + w of the qh rows to bits 0 and 4
    const uint32_t h0 =
        *reinterpret_cast<const uint32_t*>(hrow + j * COLS) >> w;
    const uint32_t h1 =
        *reinterpret_cast<const uint32_t*>(hrow + (j + 1) * COLS) >> w;
    const uint32_t lo0 = ((q0 << 2) & 0x3C3C3C3Cu) | ((h0 << 6) & 0x40404040u);
    const uint32_t hi0 = ((q0 >> 2) & 0x3C3C3C3Cu) | ((h0 << 2) & 0x40404040u);
    const uint32_t lo1 = ((q1 << 2) & 0x3C3C3C3Cu) | ((h1 << 6) & 0x40404040u);
    const uint32_t hi1 = ((q1 >> 2) & 0x3C3C3C3Cu) | ((h1 << 2) & 0x40404040u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      plo[c] = fmaf(xv.x, code_half(lo0, c), plo[c]);
      phi[c] = fmaf(xv.y, code_half(hi0, c), phi[c]);
      plo[c] = fmaf(xv.z, code_half(lo1, c), plo[c]);
      phi[c] = fmaf(xv.w, code_half(hi1, c), phi[c]);
    }
  }
  const uint8_t* sc = stage + xf_off(3, 2) + 4 * l;
  const uint8_t* mn = stage + xf_off(3, 3) + 4 * l;
  const uint32_t sl = *reinterpret_cast<const uint32_t*>(sc + w * COLS);
  const uint32_t sh = *reinterpret_cast<const uint32_t*>(sc + (4 + w) * COLS);
  const uint32_t ml = *reinterpret_cast<const uint32_t*>(mn + w * COLS);
  const uint32_t mh = *reinterpret_cast<const uint32_t*>(mn + (4 + w) * COLS);
  const float xl = xsum_s[w], xh = xsum_s[4 + w];
  float dd[4], dm[4];
  load4_half(as_half(stage + xf_off(3, 4)) + 4 * l, dd);
  load4_half(as_half(stage + xf_off(3, 5)) + 4 * l, dm);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float a1 = fmaf((float)byte_of(sl, c), plo[c] - 0.5f * xl,
                          (float)byte_of(sh, c) * (phi[c] - 0.5f * xh));
    const float a2 =
        fmaf((float)byte_of(ml, c), xl, (float)byte_of(mh, c) * xh);
    acc[c] = fmaf(64.f * dd[c], a1, acc[c]);
    acc[c] = fmaf(-dm[c], a2, acc[c]);
  }
}

// q5_k, C > 1: q4k_stage_rows with the high bits: each weight dequantized
// once to the plain version's q * (sc * d) - m * dmin (q * (sc * d) is
// exact, 5 x 17 significant bits, so one FMA rounds as the plain version's
// product and subtraction do), then one FMA per row; x is the stage's
// (256, XROWS) tile.
__device__ __forceinline__ void q5k_stage_rows(const uint8_t* stage,
                                               const float* xt, int w, int l,
                                               float (&acc)[XROWS][4]) {
  const uint8_t* qrow = stage + 32 * w * COLS + 4 * l;
  const uint8_t* hrow = stage + xf_off(3, 1) + 4 * l;
  float dd[4], dm[4], es[2][4], nem[2][4];
  load4_half(as_half(stage + xf_off(3, 4)) + 4 * l, dd);
  load4_half(as_half(stage + xf_off(3, 5)) + 4 * l, dm);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t sc = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(3, 2) + (w + 4 * h) * COLS + 4 * l);
    const uint32_t mn = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(3, 3) + (w + 4 * h) * COLS + 4 * l);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      es[h][c] = __fmul_rn(dd[c], (float)byte_of(sc, c));
      nem[h][c] = -__fmul_rn(dm[c], (float)byte_of(mn, c));
    }
  }
#pragma unroll 2
  for (int j = 0; j < 32; ++j) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(qrow + j * COLS);
    const uint32_t hb =
        *reinterpret_cast<const uint32_t*>(hrow + j * COLS) >> w;
    const uint32_t t[2] = {(q & 0x0F0F0F0Fu) | ((hb << 4) & 0x10101010u),
                           ((q >> 4) & 0x0F0F0F0Fu) | (hb & 0x10101010u)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = fmaf(code_f32(t[h], c) - kMagic, es[h][c], nem[h][c]);
      fma_xrows(xt + (2 * (32 * w + j) + h) * XROWS, wv, acc);
    }
  }
}

// q6_k: the four columns' 6-bit codes of elements r, r + 64, r + 128 and r
// + 192 (t[p] for element r + 64p, one code a byte), from ql rows r (``lo``)
// and r + 64 (``hi``) and qh row r: ql row r's low and high nibbles are
// elements r and r + 128, row r + 64's are r + 64 and r + 192, and qh row
// r's bit-pair p holds element r + 64p's two high bits.
__device__ __forceinline__ void q6k_codes(uint32_t lo, uint32_t hi,
                                          uint32_t qh, uint32_t (&t)[4]) {
  t[0] = (lo & 0x0F0F0F0Fu) | ((qh << 4) & 0x30303030u);
  t[1] = (hi & 0x0F0F0F0Fu) | ((qh << 2) & 0x30303030u);
  t[2] = ((lo >> 4) & 0x0F0F0F0Fu) | (qh & 0x30303030u);
  t[3] = ((hi >> 4) & 0x0F0F0F0Fu) | ((qh >> 2) & 0x30303030u);
}

// q5_k: the four columns' 5-bit codes of elements r, r + 64, r + 128 and r
// + 192 (t[p] for element r + 64p, one code a byte), from qs rows r (``lo``)
// and r + 64 (``hi``) and qh row r % 32 shifted right by r / 32 (``qh``):
// qs rows as q6_k's ql rows, and element r + 64p's high bit is bit r / 32 +
// 2p of qh row r % 32, bit 2p of ``qh``.
__device__ __forceinline__ void q5k_codes(uint32_t lo, uint32_t hi,
                                          uint32_t qh, uint32_t (&t)[4]) {
  t[0] = (lo & 0x0F0F0F0Fu) | ((qh << 4) & 0x10101010u);
  t[1] = (hi & 0x0F0F0F0Fu) | ((qh << 2) & 0x10101010u);
  t[2] = ((lo >> 4) & 0x0F0F0F0Fu) | (qh & 0x10101010u);
  t[3] = ((hi >> 4) & 0x0F0F0F0Fu) | ((qh >> 2) & 0x10101010u);
}

// q6_k, C = 1.  Warp w takes qh rows 16w .. 16w + 15 and the ql rows r and
// r + 64 beside each: elements 16w + j + 64p of sub-blocks w + 4p, whose
// four x values one 16-byte load gives.  A code becomes 2^23 + q in one
// byte permute and q - 32 in one exact FADD; each 16-element sub-block's
// int8 scale and the superblock's d are factored out of its sum: y += d *
// sum_sub sc * sum x (q - 32).
__device__ __forceinline__ void q6k_stage_c1(const uint8_t* stage,
                                             const float* xsb, int w, int l,
                                             float (&acc)[4]) {
  const uint8_t* lrow = stage + 16 * w * COLS + 4 * l;
  const uint8_t* hrow = stage + xf_off(1, 1) + 16 * w * COLS + 4 * l;
  const float* xr = xsb + 64 * w;
  float part[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[p][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < 16; ++j) {
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(lrow + j * COLS);
    const uint32_t hi =
        *reinterpret_cast<const uint32_t*>(lrow + (64 + j) * COLS);
    const uint32_t qh = *reinterpret_cast<const uint32_t*>(hrow + j * COLS);
    const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * j);
    const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t t[4];
    q6k_codes(lo, hi, qh, t);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[p][c] =
            fmaf(xp[p], code_f32(t[p], c) - (kMagic + 32.f), part[p][c]);
  }
  float a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t sc = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(1, 2) + (w + 4 * p) * COLS + 4 * l);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      a1[c] = fmaf((float)(int8_t)byte_of(sc, c), part[p][c], a1[c]);
  }
  float dd[4];
  load4_half(as_half(stage + xf_off(1, 3)) + 4 * l, dd);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = fmaf(dd[c], a1[c], acc[c]);
}

// q6_k, C > 1: the same split; each weight dequantized once to the plain
// version's (q - 32) * (sc * d), then one FMA per row.  x is the stage's
// (256, XROWS) tile.
__device__ __forceinline__ void q6k_stage_rows(const uint8_t* stage,
                                               const float* xt, int w, int l,
                                               float (&acc)[XROWS][4]) {
  const uint8_t* lrow = stage + 16 * w * COLS + 4 * l;
  const uint8_t* hrow = stage + xf_off(1, 1) + 16 * w * COLS + 4 * l;
  float dd[4], eff[4][4];
  load4_half(as_half(stage + xf_off(1, 3)) + 4 * l, dd);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t sc = *reinterpret_cast<const uint32_t*>(
        stage + xf_off(1, 2) + (w + 4 * p) * COLS + 4 * l);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      eff[p][c] = __fmul_rn((float)(int8_t)byte_of(sc, c), dd[c]);
  }
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    uint32_t t[4];
    q6k_codes(*reinterpret_cast<const uint32_t*>(lrow + j * COLS),
              *reinterpret_cast<const uint32_t*>(lrow + (64 + j) * COLS),
              *reinterpret_cast<const uint32_t*>(hrow + j * COLS), t);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = __fmul_rn(code_f32(t[p], c) - (kMagic + 32.f), eff[p][c]);
      fma_xrows(xt + (64 * w + 4 * j + p) * XROWS, wv, acc);
    }
  }
}

// q8_0: warp w takes the stage's blocks w, w + 4, .. (32 rows each) that
// exist (``nvalid`` of them).  A code becomes a float in one XOR (0x80 per
// byte, four codes a word: q + 128), one byte permute (2^23 + q + 128)
// and one exact FADD of -(2^23 + 128).  C = 1: d is factored out of each
// block's sum, acc += d * sum x q, so a weight costs ~3.3 instructions.
__device__ __forceinline__ void q80_stage_c1(const uint8_t* stage,
                                             const float* xsb, int nvalid,
                                             int w, int l, float (&acc)[4]) {
  for (int b = w; b < Q8_STAGE_BLOCKS; b += TY) {
    if (b >= nvalid) break;
    const uint8_t* qrow = stage + 32 * b * COLS + 4 * l;
    const float* xr = xsb + 32 * b;
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int j = 0; j < 32; j += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + j);
      const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t u =
            *reinterpret_cast<const uint32_t*>(qrow + (j + i) * COLS) ^
            0x80808080u;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[i & 1][c] = fmaf(xp[i], code_f32(u, c) - (kMagic + 128.f),
                                part[i & 1][c]);
      }
    }
    float dd[4];
    load4_half(as_half(stage + xf_off(Q8_0, 1)) + b * COLS + 4 * l, dd);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[c] = fmaf(dd[c], part[0][c] + part[1][c], acc[c]);
  }
}

// q8_0, C > 1: each weight dequantized once to the plain version's q * d,
// then one FMA per row, four rows an iteration (on an H100 SXM at C = 20,
// 5.0-5.1 ms a launch, against 5.2-5.3 with one).  x is the stage's (128,
// XROWS) tile.
__device__ __forceinline__ void q80_stage_rows(const uint8_t* stage,
                                               const float* xt, int nvalid,
                                               int w, int l,
                                               float (&acc)[XROWS][4]) {
  for (int b = w; b < Q8_STAGE_BLOCKS; b += TY) {
    if (b >= nvalid) break;
    const uint8_t* qrow = stage + 32 * b * COLS + 4 * l;
    float dd[4];
    load4_half(as_half(stage + xf_off(Q8_0, 1)) + b * COLS + 4 * l, dd);
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const uint32_t u =
          *reinterpret_cast<const uint32_t*>(qrow + j * COLS) ^ 0x80808080u;
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = __fmul_rn(code_f32(u, c) - (kMagic + 128.f), dd[c]);
      fma_xrows(xt + (32 * b + j) * XROWS, wv, acc);
    }
  }
}

// Dynamic shared memory: the ring of weight tiles, then x (ROWS = 1: all S
// stages, and for q2_k and q4_k their sub-block sums; else one stage's
// (stage_k, XROWS) tile).  The ring holds the warps' partial sums at the
// end.
template <int ROWS, int FMT>
__host__ __device__ constexpr size_t experts_smem(int S) {
  return (size_t)xstages<ROWS>() * stage_bytes(FMT) +
         (ROWS == 1 ? (size_t)S * (stage_k(FMT) + xsums(FMT)) * 4
                    : (size_t)stage_k(FMT) * XROWS * 4);
}

template <typename T, int ROWS, int FMT, int V>
__global__ void __launch_bounds__(NTHREADS)
    qmatmul_experts_kernel(const T* __restrict__ x, Fields f,
                           T* __restrict__ out, int M, int K, int N,
                           int row_tiles) {
  constexpr int STAGE = stage_bytes(FMT);
  constexpr int NST = xstages<ROWS>();
  constexpr int SK = stage_k(FMT);       // rows of K a stage
  constexpr int SB = stage_blocks(FMT);  // format blocks a stage
  static_assert((TY - 1) * ROWS * COLS * 4 <= NST * STAGE,
                "the warps' partial sums must fit in the ring");
  extern __shared__ __align__(16) uint8_t smem_x[];
  uint8_t* ring = smem_x;
  float* xs = reinterpret_cast<float*>(smem_x + NST * STAGE);

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int n0 = blockIdx.x * COLS;
  const int e = blockIdx.y / row_tiles;
  const int m0 = (blockIdx.y % row_tiles) * ROWS;
  const int rows = min(ROWS, M - m0);
  const int S = (K + SK - 1) / SK;                    // stages
  const int nblk = (K + SK / SB - 1) / (SK / SB);     // format blocks
  const T* xe = x + ((size_t)e * M + m0) * K;
  T* oe = out + ((size_t)e * M + m0) * N;

  // Stage x (C = 1: all of it, once) and find whether any row of the tile
  // is non-zero: an expert no token was routed to reads no weight byte and
  // writes +0, as the plain version does.
  constexpr int XV = 16 / sizeof(T);   // elements of x a load
  constexpr int KV = SK / XV;          // loads a stage row
  const bool vec =
      K % XV == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  bool live = false;
  if constexpr (ROWS == 1) {
    bool nz = false;
#pragma unroll 4
    for (int g = tid; g < S * KV; g += NTHREADS) {
      float v[XV];
      load_x<T>(xe, g * XV, K, vec, v);
      const int base = (g / KV) * SK, kb = (g % KV) * XV;
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        nz |= v[i] != 0.f;
        // q3_k: bit-pair p's elements divided by 2^q3_shift(p) (exact)
        const int p = (kb + i) >> 6;
        xs[base + xperm<FMT>(kb + i)] =
            FMT == 2 ? v[i] * (1.f / (float)(1 << q3_shift(p))) : v[i];
      }
    }
    live = __syncthreads_or(nz);
  } else {
    // the first non-zero settles it: a live tile reads one stage's rows
    for (int k0 = 0; k0 < K && !live; k0 += SK) {
      bool nz = false;
      for (int g = tid; g < rows * KV; g += NTHREADS) {
        float v[XV];
        load_x<T>(xe + (size_t)(g / KV) * K, k0 + (g % KV) * XV, K, vec, v);
#pragma unroll
        for (int i = 0; i < XV; ++i) nz |= v[i] != 0.f;
      }
      live = __syncthreads_or(nz);
    }
  }
  if (!live) {
    for (int i = tid; i < rows * COLS; i += NTHREADS) {
      const int n = n0 + i % COLS;
      if (n < N) oe[(size_t)(i / COLS) * N + n] = from_f32<T>(0.f);
    }
    return;
  }
  float* xsum = xs + S * SK;
  if constexpr (ROWS == 1 && xsums(FMT) > 0) {
    // the sum of x over each sub-block (elements sub * NS .. + NS - 1)
    constexpr int NSUB = xsums(FMT), NS = QK / NSUB;
    for (int i = tid; i < S * NSUB; i += NTHREADS) {
      const float* src = xs + (i / NSUB) * QK;
      const int k0 = (i % NSUB) * NS;
      float v = 0.f;
      for (int j = 0; j < NS; ++j) v += src[xperm<FMT>(k0 + j)];
      xsum[i] = v;
    }
  }

  StageCopies<FMT, V> copies(f, (size_t)e * nblk, N, n0, ring, tid);
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < S) copies.issue(st, N, min(SB, nblk - st * SB));
    cp_async_commit();
  }
  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  // ring slots of stages s and s + NST - 1
  int slot = 0, fill = NST - 1;
  for (int s = 0; s < S; ++s) {
    const uint8_t* stage = ring + slot * STAGE;
    if constexpr (ROWS == 1) {
      cp_async_wait<NST - 2>();  // this thread's copies of stage s
      __syncthreads();  // everyone's; and stage s - 1 is consumed
    } else {
      __syncthreads();  // stage s - 1 and its x tile are consumed
    }
    if (s + NST - 1 < S)
      copies.issue(fill, N, min(SB, nblk - (s + NST - 1) * SB));
    cp_async_commit();
    const int nvalid = min(SB, nblk - s * SB);  // q8_0 blocks of stage s
    if constexpr (ROWS == 1) {
      if constexpr (FMT == 0)
        q4k_stage_c1(stage, xs + s * SK, xsum + 8 * s, w, l, acc[0]);
      else if constexpr (FMT == 3)
        q5k_stage_c1(stage, xs + s * SK, xsum + 8 * s, w, l, acc[0]);
      else if constexpr (FMT == 1)
        q6k_stage_c1(stage, xs + s * SK, w, l, acc[0]);
      else if constexpr (FMT == Q8_0)
        q80_stage_c1(stage, xs + s * SK, nvalid, w, l, acc[0]);
      else
        experts_superblock_c1<FMT>(stage, xs + s * QK, xsum + 16 * s, w, l,
                                   acc[0]);
    } else {
#pragma unroll 2
      for (int g = tid; g < ROWS * KV; g += NTHREADS) {
        const int r = g / KV, kb = (g % KV) * XV;
        float v[XV];
        if (r < rows) {
          load_x<T>(xe + (size_t)r * K, s * SK + kb, K, vec, v);
        } else {
#pragma unroll
          for (int i = 0; i < XV; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < XV; ++i)
          xs[xperm<FMT>(kb + i) * ROWS + r] = v[i];
      }
      cp_async_wait<NST - 1>();
      __syncthreads();
      if constexpr (FMT == 0)
        q4k_stage_rows(stage, xs, w, l, acc);
      else if constexpr (FMT == 3)
        q5k_stage_rows(stage, xs, w, l, acc);
      else if constexpr (FMT == 1)
        q6k_stage_rows(stage, xs, w, l, acc);
      else if constexpr (FMT == Q8_0)
        q80_stage_rows(stage, xs, nvalid, w, l, acc);
      else
        experts_superblock_rows<FMT>(stage, xs, w, l, acc);
    }
    slot = slot == NST - 1 ? 0 : slot + 1;
    fill = fill == NST - 1 ? 0 : fill + 1;
  }

  // fixed-order sum of the four warps' partial sums
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (w > 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((w - 1) * ROWS + r) * COLS + 4 * l + c] = acc[r][c];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + 4 * l + c;
          float v = acc[r][c];
#pragma unroll
          for (int ww = 0; ww < TY - 1; ++ww)
            v += red[(ww * ROWS + r) * COLS + 4 * l + c];
          if (n < N) oe[(size_t)r * N + n] = from_f32<T>(v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// q4_k's 2-D form at M <= 4: qmatmul_q4k_decode_kernel (see the header).  A
// cluster of ``ks`` blocks owns 128 columns; block ``rank`` walks its share
// of the superblocks with x's up to DROWS rows staged once as f32 (rows past
// M are zero) and the weight tiles through a ring of cp.async stages, then
// the blocks' column sums are added in rank order through distributed
// shared memory.
// ---------------------------------------------------------------------------

constexpr int DROWS = 4;                  // rows of x a decode block carries
constexpr int DSTAGES = 2;                // stages in its ring
constexpr int DECODE_MAX_K = 65536;       // K the decode form takes
constexpr int MAX_KSPLIT = 8;             // blocks a cluster (the portable size)

// q4_k, up to DROWS rows: q4k_stage_c1's split and code conversion, each
// code feeding one FMA per row (x row r at ``xsb + r * xstride``, its
// sub-block sums at ``xsum_s + r * sstride``).
__device__ __forceinline__ void q4k_stage_rows4(const uint8_t* stage,
                                                const float* xsb, int xstride,
                                                const float* xsum_s,
                                                int sstride, int w, int l,
                                                float (&acc)[DROWS][4]) {
  const uint8_t* qrow = stage + 32 * w * COLS + 4 * l;
  const float* xr = xsb + 64 * w;
  float plo[DROWS][4], phi[DROWS][4];
#pragma unroll
  for (int r = 0; r < DROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) plo[r][c] = phi[r][c] = 0.f;
#pragma unroll 2
  for (int j = 0; j < 32; j += 2) {
    const uint32_t q0 = *reinterpret_cast<const uint32_t*>(qrow + j * COLS);
    const uint32_t q1 =
        *reinterpret_cast<const uint32_t*>(qrow + (j + 1) * COLS);
    const uint32_t lo0 = (q0 << 3) & 0x78787878u, hi0 = (q0 >> 1) & 0x78787878u;
    const uint32_t lo1 = (q1 << 3) & 0x78787878u, hi1 = (q1 >> 1) & 0x78787878u;
    float cl0[4], ch0[4], cl1[4], ch1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cl0[c] = code_half(lo0, c);
      ch0[c] = code_half(hi0, c);
      cl1[c] = code_half(lo1, c);
      ch1[c] = code_half(hi1, c);
    }
#pragma unroll
    for (int r = 0; r < DROWS; ++r) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xr + r * xstride + 2 * j);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        plo[r][c] = fmaf(xv.x, cl0[c], plo[r][c]);
        phi[r][c] = fmaf(xv.y, ch0[c], phi[r][c]);
        plo[r][c] = fmaf(xv.z, cl1[c], plo[r][c]);
        phi[r][c] = fmaf(xv.w, ch1[c], phi[r][c]);
      }
    }
  }
  const uint8_t* sc = stage + xf_off(0, 1) + 4 * l;
  const uint8_t* mn = stage + xf_off(0, 2) + 4 * l;
  const uint32_t sl = *reinterpret_cast<const uint32_t*>(sc + w * COLS);
  const uint32_t sh = *reinterpret_cast<const uint32_t*>(sc + (4 + w) * COLS);
  const uint32_t ml = *reinterpret_cast<const uint32_t*>(mn + w * COLS);
  const uint32_t mh = *reinterpret_cast<const uint32_t*>(mn + (4 + w) * COLS);
  float dd[4], dm[4];
  load4_half(as_half(stage + xf_off(0, 3)) + 4 * l, dd);
  load4_half(as_half(stage + xf_off(0, 4)) + 4 * l, dm);
#pragma unroll
  for (int r = 0; r < DROWS; ++r) {
    const float xl = xsum_s[r * sstride + w], xh = xsum_s[r * sstride + 4 + w];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float a1 = fmaf((float)byte_of(sl, c), plo[r][c] - 0.5f * xl,
                            (float)byte_of(sh, c) * (phi[r][c] - 0.5f * xh));
      const float a2 =
          fmaf((float)byte_of(ml, c), xl, (float)byte_of(mh, c) * xh);
      acc[r][c] = fmaf(32.f * dd[c], a1, acc[r][c]);
      acc[r][c] = fmaf(-dm[c], a2, acc[r][c]);
    }
  }
}

// Dynamic shared memory of a decode block holding ``nsb`` superblocks: the
// ring (the warps' and the block's sums at the end), then x (DROWS x nsb x
// 256 f32) and its sub-block sums (DROWS x nsb x 8).
__host__ __device__ constexpr size_t decode_smem(int nsb) {
  return (size_t)DSTAGES * stage_bytes(0) + (size_t)DROWS * nsb * (QK + 8) * 4;
}

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS)
    qmatmul_q4k_decode_kernel(const T* __restrict__ x, Fields f,
                              T* __restrict__ out, int M, int K, int N) {
  constexpr int STAGE = stage_bytes(0);
  static_assert(TY * DROWS * COLS * 4 <= DSTAGES * STAGE,
                "the warps' and the block's sums must fit in the ring");
  extern __shared__ __align__(16) uint8_t smem_d[];
  uint8_t* ring = smem_d;
  float* xs = reinterpret_cast<float*>(smem_d + DSTAGES * STAGE);

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int n0 = blockIdx.x * COLS;
  const int rank = blockIdx.y, ks = gridDim.y;
  const int S = (K + QK - 1) / QK;
  const int s0 = (int)((long long)S * rank / ks);
  const int nsb = (int)((long long)S * (rank + 1) / ks) - s0;
  const int xstride = nsb * QK;
  float* xsum = xs + DROWS * xstride;       // DROWS x nsb x 8

  // the first weight stages are in flight while x is staged
  StageCopies<0, V> copies(f, (size_t)s0, N, n0, ring, tid);
#pragma unroll
  for (int st = 0; st < DSTAGES - 1; ++st) {
    if (st < nsb) copies.issue(st, N, 1);
    cp_async_commit();
  }

  // x[:, s0 * 256 ..) as f32 in q4_k's order (xperm), zero past K and M;
  // a thread's loads of a batch are all issued before its stores
  constexpr int XV = 16 / sizeof(T);   // elements of x a load
  constexpr int KV = QK / XV;          // loads a superblock row
  constexpr int XB = 8;                // loads a batch
  const bool vec =
      K % XV == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int per_row = nsb * KV, nload = DROWS * per_row;
  for (int g0 = tid; g0 < nload; g0 += XB * NTHREADS) {
    float v[XB][XV];
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int g = g0 + u * NTHREADS, r = g / per_row;
      if (g < nload && r < M) {
        load_x<T>(x + (size_t)r * K, s0 * QK + (g - r * per_row) * XV, K,
                  vec, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < XV; ++i) v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int g = g0 + u * NTHREADS, r = g / per_row, gr = g - r * per_row;
      if (g < nload) {
        const int base = (gr / KV) * QK, kb = (gr % KV) * XV;
#pragma unroll
        for (int i = 0; i < XV; ++i)
          xs[r * xstride + base + xperm<0>(kb + i)] = v[u][i];
      }
    }
  }
  __syncthreads();
  // the sum of x over each 32-element sub-block
  for (int i = tid; i < DROWS * nsb * 8; i += NTHREADS) {
    const int r = i / (nsb * 8), rem = i - r * nsb * 8;
    const float* src = xs + r * xstride + (rem >> 3) * QK;
    const int k0 = (rem & 7) * 32;
    float v = 0.f;
    for (int j = 0; j < 32; ++j) v += src[xperm<0>(k0 + j)];
    xsum[i] = v;
  }

  float acc[DROWS][4];
#pragma unroll
  for (int r = 0; r < DROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  int slot = 0, fill = DSTAGES - 1;
  for (int s = 0; s < nsb; ++s) {
    cp_async_wait<DSTAGES - 2>();  // this thread's copies of stage s
    __syncthreads();  // everyone's; stage s - 1 is consumed (and xsum made)
    if (s + DSTAGES - 1 < nsb) copies.issue(fill, N, 1);
    cp_async_commit();
    q4k_stage_rows4(ring + slot * STAGE, xs + s * QK, xstride, xsum + 8 * s,
                    nsb * 8, w, l, acc);
    slot = slot == DSTAGES - 1 ? 0 : slot + 1;
    fill = fill == DSTAGES - 1 ? 0 : fill + 1;
  }

  // the block's column sums: the four warps' partial sums in a fixed order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);          // (TY - 1) x DROWS x COLS
  float* blk = red + (TY - 1) * DROWS * COLS;           // DROWS x COLS
  if (w > 0) {
#pragma unroll
    for (int r = 0; r < DROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((w - 1) * DROWS + r) * COLS + 4 * l + c] = acc[r][c];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int r = 0; r < DROWS; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int ww = 0; ww < TY - 1; ++ww)
          v += red[(ww * DROWS + r) * COLS + 4 * l + c];
        const int n = n0 + 4 * l + c;
        if (ks == 1) {
          if (r < M && n < N) out[(size_t)r * N + n] = from_f32<T>(v);
        } else {
          blk[r * COLS + 4 * l + c] = v;
        }
      }
    }
  }
  if (ks == 1) return;

  // the cluster's blocks add their sums in rank order, each writing a slice
  // of the 128 columns' outputs
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_out = DROWS * COLS;
  const int lo = n_out * rank / ks, hi = n_out * (rank + 1) / ks;
  for (int idx = lo + tid; idx < hi; idx += NTHREADS) {
    const int r = idx / COLS, n = n0 + idx % COLS;
    float part[MAX_KSPLIT];
#pragma unroll
    for (int sp = 0; sp < MAX_KSPLIT; ++sp)
      if (sp < ks) part[sp] = cluster.map_shared_rank(blk, sp)[idx];
    float v = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_KSPLIT; ++sp)
      if (sp < ks) v += part[sp];
    if (r < M && n < N) out[(size_t)r * N + n] = from_f32<T>(v);
  }
  cluster.sync();   // each block's shared memory stays until all have read it
}

// ---------------------------------------------------------------------------
// The 2-D forms of q6_k, q3_k, q5_k, q2_k and q8_0 at M <= 4 on tensor
// cores: qmatmul_mma_decode_kernel<T, FMT, V> (see the header).  A cluster
// of ``ks`` blocks (up to 16, a non-portable size) owns 128 columns; block
// ``rank`` walks its share of the stages (md_k(FMT) rows of K each: a
// superblock, MD_Q2_SUPERBLOCKS of q2_k's, or MD_Q8_BLOCKS q8_0 blocks of
// 32).  Warp w (of 8) takes the 64 columns of half w % 2 and group j0 = w /
// 2 of every stage:
//  - q6_k, q3_k, q5_k, q2_k: the 16-element pieces j0, j0 + 4, j0 + 8, j0 +
//    12 of each superblock (elements r + 64p, r = 16 j0 .. 16 j0 + 15:
//    q6_k's and q5_k's ql / qs rows r and r + 64 give their low bits, q6_k's
//    qh row r its high bit-pairs, q3_k's and q2_k's qs row r bit-pair p,
//    q3_k's hmask row r % 32 and q5_k's qh row r % 32 bit r / 32 + 2p, so
//    that the formats share the fragment mapping below); a piece is a
//    sub-block of q6_k, q3_k and q2_k, half of one (j0 / 2 + 2p) of q5_k;
//  - q8_0: blocks j0, j0 + 4, ... of the stage, two 16-element halves each.
// One mma.sync.m16n8k16 a (16 elements, 16 columns): A is the weight tile
// (16 columns x 16 elements, the codes as exact bf16: q - 32 (q6_k), (q - 4)
// 2^q3_shift(p) (q3_k), q (q5_k), q 2^q3_shift(p) (q2_k), q (q8_0)), B the
// elements' x (16 x 8 rows, rows past DROWS zero), D (columns x rows).
// q6_k, q3_k, q5_k, q2_k: D is scaled in f32 by the piece's scale (q3_k and
// q2_k: times 2^-q3_shift(p), folded into the scale's conversion) and, once
// a superblock, by its d; q2_k's min term dmin m sum x takes the
// sub-block's sums of x's rows from the B fragments (md_xsums), times each
// column's m into a second accumulator, scaled once a superblock by -dmin;
// q5_k's is taken by every thread in a layout of its own (q5k_min_stage)
// from x's staged rows.
// q8_0: a block's two mmas accumulate into one D, scaled once by the
// block's d.  mma row g (g + 8) of tile c is column 4g + c (32 + 4g + c) of
// the warp's 64, so that one 4-byte shared load of a byte row gives a row's
// codes for all four tiles.
// ---------------------------------------------------------------------------

constexpr int MD_THREADS = 256;  // 8 warps: 2 column halves x 4 groups
constexpr int MD_PAD = 16;       // bytes a staged byte row is longer than 128
constexpr int MD_PITCH = COLS + MD_PAD;
constexpr int MD_STAGES = 3;     // stages in the ring (two blocks an SM)
constexpr int MD_MAX_KSPLIT = 16;   // blocks a cluster (non-portable)
// q2_k's superblocks a stage and q8_0's blocks a stage, from a scan on an
// H100 SXM (scripts/decode_ablation.py): two q2_k superblocks ran 1-12 %
// slower; q8_0 stages of 8 blocks ran 1 % faster to 8 % slower in a ring
// of 2, and in a ring of 3 (one block an SM) 8-9 % faster at the 56-tile
// shapes (16384 -> 7168, 18432 -> 7168) but 9-13 % slower at 1536 ->
// 24576 and 7168 -> 18432
constexpr int MD_Q2_SUPERBLOCKS = 1;
constexpr int MD_Q8_BLOCKS = 4;

// the formats of this form (all but q4_k), and a stage's format blocks and
// rows of K; a stage is the weights (q6_k 29.5 KB, q5_k 25.3 KB, q3_k 16.0
// KB, q2_k 11.8 KB a superblock, q8_0 19.1 KB for 4 blocks, with their rows
// padded), then x's DROWS rows of it
__host__ __device__ constexpr bool has_mma_decode(int fmt) {
  return fmt != 0;
}
__host__ __device__ constexpr int md_blocks(int fmt) {
  return fmt == Q8_0 ? MD_Q8_BLOCKS : fmt == 4 ? MD_Q2_SUPERBLOCKS : 1;
}
__host__ __device__ constexpr int md_k(int fmt) {
  return block_k(fmt) * md_blocks(fmt);
}
// elements of a staged row of x
__host__ __device__ constexpr int md_xpitch(int fmt) { return md_k(fmt) + 8; }
template <int FMT>
__host__ __device__ constexpr int md_w() {
  return xf_off(FMT, num_fields(FMT), MD_PAD, md_k(FMT));
}
template <typename T, int FMT>
__host__ __device__ constexpr int md_stage_bytes() {
  return md_w<FMT>() + DROWS * md_xpitch(FMT) * (int)sizeof(T);
}
template <typename T, int FMT>
__host__ __device__ constexpr size_t md_smem() {
  return (size_t)MD_STAGES * md_stage_bytes<T, FMT>();
}
// where field G's rows of the stage's superblock bb start
template <int FMT, int G>
__device__ __forceinline__ const uint8_t* md_field(const uint8_t* stage,
                                                   int bb) {
  return stage + xf_off(FMT, G, MD_PAD, md_k(FMT)) +
         bb * field_layout(FMT, G).rows * (COLS * xf_esz(FMT, G) + MD_PAD);
}

// Two codes of at most 7 bits (the bytes of ``w`` that ``sel``, a byte
// permute, takes to bytes 0 and 2) as a bf16 pair less ``bias``, exactly:
// the exponent byte 0x43 above a code makes 128 + q, and one bf16x2 FMA
// adds ``bias`` (Q6_BIAS: q - 32 for q6_k; Q4_BIAS: q for q4_k, q5_k and
// q2_k; Q3_BIAS: q - 4 for q3_k; q3_k's decode form, whose
// code of bit-pair p stands at bit q3_shift(p) of its byte (q3k_codes), (q
// - 4) 2^q3_shift(p): q3_bias(p)).
constexpr uint32_t Q6_BIAS = 0xC320C320u;   // bf16 (-160, -160)
constexpr uint32_t Q4_BIAS = 0xC300C300u;   // bf16 (-128, -128)
constexpr uint32_t Q3_BIAS = 0xC304C304u;   // bf16 (-132, -132)
__device__ __forceinline__ constexpr uint32_t q3_bias(int p) {
  return p == 0 ? Q3_BIAS                   // 128 + q - 132
         : p == 1 ? 0xC310C310u             // 128 + 4q - 144, bf16 -144
                  : 0xC340C340u;            // 128 + 16q - 192, bf16 -192
}
__device__ __forceinline__ uint32_t code_pair(uint32_t w, uint32_t sel,
                                              uint32_t bias) {
  const uint32_t v = __byte_perm(w, 0x43434343u, sel);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(v), "r"(0x3F803F80u), "r"(bias));
  return r;
}
// q8_0: two int8 codes (bytes of ``w`` as ``sel`` takes them) as a bf16
// pair: the low 7 bits by code_pair, the bias -128, or -256 where the sign
// bit is set (the sign bits of ``w & 0x80808080`` under the exponent byte
// 0xC3), as the prefill form converts them
__device__ __forceinline__ uint32_t q8_pair(uint32_t mag, uint32_t sgn,
                                            uint32_t sel) {
  return code_pair(mag, sel, __byte_perm(sgn, 0xC3C3C3C3u, sel));
}
// q2_k: bit-pair p of a word of code bytes, in place (bits 2p; p = 3 moved
// to bits 4-5, so that bit 7 stays clear): the code times 2^q3_shift(p)
__device__ __forceinline__ uint32_t q2k_bits(uint32_t v, int p) {
  return p == 3 ? (v >> 2) & 0x30303030u : v & (0x03030303u << (2 * p));
}

template <typename T>
__host__ __device__ constexpr int x_terms() {
  return sizeof(T) == 4 ? 3 : 1;
}

// The B fragments of the stage's 16 elements 16i ..: lane (g, t) holds
// x[g][16i + 2t, + 1] and x[g][16i + 2t + 8, + 9] (bf16: as staged; f32:
// its three terms); g >= DROWS gives zeros (those lanes read row g - 4, a
// broadcast).  XP: elements of a staged row.
template <typename T, int XP>
__device__ __forceinline__ void md_xfrag(const T* xs, int i, int g, int t,
                                         uint32_t (&b)[x_terms<T>()][2]) {
  const T* row = xs + (g & (DROWS - 1)) * XP + 16 * i + 2 * t;
  const bool live = g < DROWS;
  if constexpr (sizeof(T) == 2) {
    const uint32_t v0 = *reinterpret_cast<const uint32_t*>(row);
    const uint32_t v1 = *reinterpret_cast<const uint32_t*>(row + 8);
    b[0][0] = live ? v0 : 0u;
    b[0][1] = live ? v1 : 0u;
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(row + 8 * h);
      split3(v.x, v.y, b[0][h], b[1][h], b[2][h]);
#pragma unroll
      for (int u = 0; u < 3; ++u) b[u][h] = live ? b[u][h] : 0u;
    }
  }
}

// q2_k: the sums over a sub-block of x's rows 2t and 2t + 1 (the D columns
// of lane (g, t)), from its B fragments ``b``: a row g's 16 elements lie
// in the four lanes of that g (f32 x: as three bf16 terms), two shuffles
// add them, two more bring rows 2t and 2t + 1 to lane t (rows past DROWS
// are B's zero rows).  On an H100 this ran 1-2 % faster than the min term
// as one more mma a sub-block (A the column's m in every element), which
// also spilled (scripts/decode_ablation.py).
template <typename T>
__device__ __forceinline__ void md_xsums(const uint32_t (&b)[x_terms<T>()][2],
                                         int t, float& s0, float& s1) {
  float v = 0.f;
#pragma unroll
  for (int u = 0; u < x_terms<T>(); ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v += __uint_as_float(b[u][h] << 16) +
           __uint_as_float(b[u][h] & 0xFFFF0000u);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
  s0 = __shfl_sync(0xFFFFFFFFu, v, 8 * t);
  s1 = __shfl_sync(0xFFFFFFFFu, v, 8 * t + 4);
}

// Superblock bb of a q6_k, q3_k, q5_k or q2_k stage (128 columns), warp
// (half, j0): see above.
template <typename T, int FMT>
__device__ __forceinline__ void mma_decode_superblock(const uint8_t* stage,
                                                      const T* xs, int bb,
                                                      int half, int j0, int g,
                                                      int t,
                                                      float (&acc)[4][4]) {
  constexpr int NT = x_terms<T>();
  constexpr int XP = md_xpitch(FMT);
  // the fields: q6_k ql, qh, scales, d; q3_k qs, hmask, scales, d; q5_k qs,
  // qh, scales, mins, d, dmin (its min term: q5k_min_stage); q2_k qs, sm
  // (scale and min), d, dmin
  constexpr int SC = FMT == 4 ? 1 : 2;              // scales (q2_k: sm)
  constexpr int DF = FMT == 4 ? 2 : FMT == 3 ? 4 : 3;   // d
  const int col = half * 64 + 4 * g;      // + 32 for mma rows g + 8
  const uint8_t* ql = md_field<FMT, 0>(stage, bb) + col;
  const uint8_t* sc = md_field<FMT, SC>(stage, bb) + col;
  // the codes of elements 16 j0 + 2t + 8h (+ 1) + 64p of the four columns
  // of mma row g (cg = 0) and g + 8 (cg = 1), the two elements' bytes of a
  // column side by side: w[h][cg][p] holds columns 0, 1, w[..][4 + p]
  // columns 2, 3
  uint32_t w[2][2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * j0 + 2 * t + 8 * h;
#pragma unroll
    for (int cg = 0; cg < 2; ++cg) {
      const uint8_t* lp = ql + r * MD_PITCH + 32 * cg;
      if constexpr (FMT == 4) {
        // interleave the two rows' bytes first, then mask each bit-pair
        const uint32_t qa = *reinterpret_cast<const uint32_t*>(lp);
        const uint32_t qb = *reinterpret_cast<const uint32_t*>(lp + MD_PITCH);
        const uint32_t lo = __byte_perm(qa, qb, 0x5140);
        const uint32_t hi = __byte_perm(qa, qb, 0x7362);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          w[h][cg][p] = q2k_bits(lo, p);
          w[h][cg][4 + p] = q2k_bits(hi, p);
        }
      } else {
        const uint8_t* qh = md_field<FMT, 1>(stage, bb) + col;
        uint32_t ta[4], tb[4];
        if constexpr (FMT == 1) {
          const uint8_t* hp = qh + r * MD_PITCH + 32 * cg;
          q6k_codes(*reinterpret_cast<const uint32_t*>(lp),
                    *reinterpret_cast<const uint32_t*>(lp + 64 * MD_PITCH),
                    *reinterpret_cast<const uint32_t*>(hp), ta);
          q6k_codes(*reinterpret_cast<const uint32_t*>(lp + MD_PITCH),
                    *reinterpret_cast<const uint32_t*>(lp + 65 * MD_PITCH),
                    *reinterpret_cast<const uint32_t*>(hp + MD_PITCH), tb);
        } else if constexpr (FMT == 3) {
          // qh rows r % 32 and r % 32 + 1, bits r / 32 + 2p (r / 32 = j0 /
          // 2 for all of the warp's rows), as q3_k's hmask
          const uint8_t* hp = qh + (r & 31) * MD_PITCH + 32 * cg;
          const int hb = j0 >> 1;
          q5k_codes(*reinterpret_cast<const uint32_t*>(lp),
                    *reinterpret_cast<const uint32_t*>(lp + 64 * MD_PITCH),
                    *reinterpret_cast<const uint32_t*>(hp) >> hb, ta);
          q5k_codes(*reinterpret_cast<const uint32_t*>(lp + MD_PITCH),
                    *reinterpret_cast<const uint32_t*>(lp + 65 * MD_PITCH),
                    *reinterpret_cast<const uint32_t*>(hp + MD_PITCH) >> hb,
                    tb);
        } else {
          // hmask rows r % 32 and r % 32 + 1, bits r / 32 + 2p (r / 32 =
          // j0 / 2 for all of the warp's rows)
          const uint8_t* hp = qh + (r & 31) * MD_PITCH + 32 * cg;
          q3k_codes(*reinterpret_cast<const uint32_t*>(lp),
                    *reinterpret_cast<const uint32_t*>(hp), j0 >> 1, ta);
          q3k_codes(*reinterpret_cast<const uint32_t*>(lp + MD_PITCH),
                    *reinterpret_cast<const uint32_t*>(hp + MD_PITCH),
                    j0 >> 1, tb);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          w[h][cg][p] = __byte_perm(ta[p], tb[p], 0x5140);
          w[h][cg][4 + p] = __byte_perm(ta[p], tb[p], 0x7362);
        }
      }
    }
  }
  float part[4][4];    // sum over the stage's pieces of sc x D
  float pmin[4][4];    // q2_k: sum over them of m x sum x
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int v = 0; v < 4; ++v) part[c][v] = pmin[c][v] = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = j0 + 4 * p;   // the piece
    // its row of the scale fields: q5_k's 32-element sub-block i / 2
    const int si = FMT == 3 ? (j0 >> 1) + 2 * p : i;
    uint32_t b[NT][2];
    md_xfrag<T, XP>(xs, 16 * bb + i, g, t, b);
    float xs0 = 0.f, xs1 = 0.f;   // q2_k: the sums of x's rows 2t, 2t + 1
    if constexpr (FMT == 4) md_xsums<T>(b, t, xs0, xs1);
    // the scales of rows g, g + 8: q6_k's and q3_k's int8 ones as 2^23 +
    // 128 + sc (one XOR a word, one byte permute a scale, no
    // int-to-float), q5_k's u8 ones as 2^23 + sc, q2_k's low nibbles as
    // 2^23 + sc
    uint32_t s0 = *reinterpret_cast<const uint32_t*>(sc + si * MD_PITCH);
    uint32_t s1 = *reinterpret_cast<const uint32_t*>(sc + si * MD_PITCH + 32);
    uint32_t m0 = 0, m1 = 0;   // q2_k: sm's high nibbles
    if constexpr (FMT == 4) {
      m0 = (s0 >> 4) & 0x0F0F0F0Fu;
      m1 = (s1 >> 4) & 0x0F0F0F0Fu;
      s0 &= 0x0F0F0F0Fu;
      s1 &= 0x0F0F0F0Fu;
    } else if constexpr (FMT != 3) {
      s0 ^= 0x80808080u;
      s1 ^= 0x80808080u;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // tile c: the pair of bytes c of a column's two elements
      const int k = (c >> 1) * 4 + p;
      const uint32_t sel = c & 1 ? 0x4342 : 0x4140;
      const uint32_t bias = FMT == 1 ? Q6_BIAS : FMT == 2 ? q3_bias(p)
                                                          : Q4_BIAS;
      const uint32_t a[4] = {code_pair(w[0][0][k], sel, bias),
                             code_pair(w[0][1][k], sel, bias),
                             code_pair(w[1][0][k], sel, bias),
                             code_pair(w[1][1][k], sel, bias)};
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < NT; ++u) mma_bf16(d, a, b[u][0], b[u][1]);
      float e0, e1;
      if constexpr (FMT == 1 || FMT == 3) {
        constexpr float off = FMT == 1 ? kMagic + 128.f : kMagic;
        e0 = code_f32(s0, c) - off;
        e1 = code_f32(s1, c) - off;
      } else {
        // sc 2^-q3_shift(p), exactly: D carries the codes' 2^q3_shift(p)
        const float sh = p == 0 ? 1.f : p == 1 ? 0.25f : 0.0625f;
        const float off = FMT == 2 ? kMagic + 128.f : kMagic;
        e0 = fmaf(code_f32(s0, c), sh, -off * sh);
        e1 = fmaf(code_f32(s1, c), sh, -off * sh);
      }
      part[c][0] = fmaf(e0, d[0], part[c][0]);
      part[c][1] = fmaf(e0, d[1], part[c][1]);
      part[c][2] = fmaf(e1, d[2], part[c][2]);
      part[c][3] = fmaf(e1, d[3], part[c][3]);
      if constexpr (FMT == 4) {
        // the min term: columns 4g + c's and 32 + 4g + c's m times the sums
        const float ma = code_f32(m0, c) - kMagic;
        const float mb = code_f32(m1, c) - kMagic;
        pmin[c][0] = fmaf(ma, xs0, pmin[c][0]);
        pmin[c][1] = fmaf(ma, xs1, pmin[c][1]);
        pmin[c][2] = fmaf(mb, xs0, pmin[c][2]);
        pmin[c][3] = fmaf(mb, xs1, pmin[c][3]);
      }
    }
  }
  float d0[4], d1[4];
  const __half* dd = as_half(md_field<FMT, DF>(stage, bb)) + col;
  load4_half(dd, d0);
  load4_half(dd + 32, d1);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[c][0] = fmaf(d0[c], part[c][0], acc[c][0]);
    acc[c][1] = fmaf(d0[c], part[c][1], acc[c][1]);
    acc[c][2] = fmaf(d1[c], part[c][2], acc[c][2]);
    acc[c][3] = fmaf(d1[c], part[c][3], acc[c][3]);
  }
  if constexpr (FMT == 4) {
    const __half* dm = as_half(md_field<FMT, 3>(stage, bb)) + col;
    load4_half(dm, d0);
    load4_half(dm + 32, d1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c][0] = fmaf(-d0[c], pmin[c][0], acc[c][0]);
      acc[c][1] = fmaf(-d0[c], pmin[c][1], acc[c][1]);
      acc[c][2] = fmaf(-d1[c], pmin[c][2], acc[c][2]);
      acc[c][3] = fmaf(-d1[c], pmin[c][3], acc[c][3]);
    }
  }
}

// A q8_0 stage (MD_Q8_BLOCKS blocks of 32 rows, 128 columns), warp (half,
// j0): blocks j0, j0 + 4, ... of the ``nvalid`` that exist (a block past
// the field's last was not copied: neither its codes nor its d are read)
template <typename T>
__device__ __forceinline__ void mma_decode_q8_0(const uint8_t* stage,
                                                const T* xs, int nvalid,
                                                int half, int j0, int g,
                                                int t, float (&acc)[4][4]) {
  constexpr int NT = x_terms<T>();
  constexpr int XP = md_xpitch(Q8_0);
  const int col = half * 64 + 4 * g;
  const uint8_t* qs = md_field<Q8_0, 0>(stage, 0) + col;
#pragma unroll
  for (int j = j0; j < MD_Q8_BLOCKS; j += 4) {
    if (j >= nvalid) break;
    float d[4][4];     // the block's products, both of its k16 steps
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[c][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // rows 32 j + 16 kk + 2t + 8h (+ 1) of columns 4g .. (cg = 0) and 32
      // + 4g .. (cg = 1), interleaved as the K-quants' codes are: a word
      // each for columns 0, 1 and 2, 3, split into low 7 bits and sign
      uint32_t mag[2][2][2], sgn[2][2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * j + 16 * kk + 2 * t + 8 * h;
#pragma unroll
        for (int cg = 0; cg < 2; ++cg) {
          const uint8_t* lp = qs + r * MD_PITCH + 32 * cg;
          const uint32_t qa = *reinterpret_cast<const uint32_t*>(lp);
          const uint32_t qb =
              *reinterpret_cast<const uint32_t*>(lp + MD_PITCH);
          const uint32_t v[2] = {__byte_perm(qa, qb, 0x5140),
                                 __byte_perm(qa, qb, 0x7362)};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            mag[h][cg][q] = v[q] & 0x7F7F7F7Fu;
            sgn[h][cg][q] = v[q] & 0x80808080u;
          }
        }
      }
      uint32_t b[NT][2];
      md_xfrag<T, XP>(xs, 2 * j + kk, g, t, b);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = c >> 1;
        const uint32_t sel = c & 1 ? 0x4342 : 0x4140;
        const uint32_t a[4] = {q8_pair(mag[0][0][q], sgn[0][0][q], sel),
                               q8_pair(mag[0][1][q], sgn[0][1][q], sel),
                               q8_pair(mag[1][0][q], sgn[1][0][q], sel),
                               q8_pair(mag[1][1][q], sgn[1][1][q], sel)};
#pragma unroll
        for (int u = 0; u < NT; ++u) mma_bf16(d[c], a, b[u][0], b[u][1]);
      }
    }
    float d0[4], d1[4];
    const __half* dd = as_half(md_field<Q8_0, 1>(stage, 0) +
                               j * (2 * COLS + MD_PAD)) + col;
    load4_half(dd, d0);
    load4_half(dd + 32, d1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c][0] = fmaf(d0[c], d[c][0], acc[c][0]);
      acc[c][1] = fmaf(d0[c], d[c][1], acc[c][1]);
      acc[c][2] = fmaf(d1[c], d[c][2], acc[c][2]);
      acc[c][3] = fmaf(d1[c], d[c][3], acc[c][3]);
    }
  }
}

// q5_k's min term of one stage (a superblock), off the tensor-core warps'
// fragments: warp w takes row w % 4 of x (staged at ``xr``) and the
// sub-blocks 4 (w / 4) .. 4 (w / 4) + 3, lane l the columns 4l .. 4l + 3.
// The warp sums x over its sub-blocks (lane l four elements, three
// shuffles a group of 8 lanes, four more give every lane the four sums),
// then pm[c] += dmin * sum_sub m * sum x (one 4-byte shared load a mins
// row, conflict-free): ~70 instructions a thread a stage.  The same term
// taken per 16-element piece from the mma fragments (q2_k's way) ran
// 2-10 % slower, one more mma a piece 4-11 % slower with spills, and x's
// sums made once per block from global memory 3-4 % slower
// (scripts/decode_ablation.py); the term still costs 9-17 % of the kernel.
template <typename T>
__device__ __forceinline__ void q5k_min_stage(const uint8_t* stage,
                                              const T* xr, int sh, int l,
                                              float (&pm)[4]) {
  float v = 0.f;
  const T* xe = xr + 128 * sh + 4 * l;
  if constexpr (sizeof(T) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(xe);
    v = (__uint_as_float(u.x << 16) + __uint_as_float(u.x & 0xFFFF0000u)) +
        (__uint_as_float(u.y << 16) + __uint_as_float(u.y & 0xFFFF0000u));
  } else {
    const float4 u = *reinterpret_cast<const float4*>(xe);
    v = (u.x + u.y) + (u.z + u.w);
  }
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
  float xsub[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xsub[i] = __shfl_sync(0xFFFFFFFFu, v, 8 * i);
  const uint8_t* mn = md_field<3, 3>(stage, 0) + 4 * sh * MD_PITCH + 4 * l;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = *reinterpret_cast<const uint32_t*>(mn + i * MD_PITCH);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[c] = fmaf(code_f32(m, c) - kMagic, xsub[i], part[c]);
  }
  float dm[4];
  load4_half(as_half(md_field<3, 5>(stage, 0)) + 4 * l, dm);
#pragma unroll
  for (int c = 0; c < 4; ++c) pm[c] = fmaf(dm[c], part[c], pm[c]);
}

// One stage of warp (half, j0), of which ``nvalid`` format blocks exist
template <typename T, int FMT>
__device__ __forceinline__ void mma_decode_stage(const uint8_t* stage,
                                                 const T* xs, int nvalid,
                                                 int half, int j0, int g,
                                                 int t, float (&acc)[4][4]) {
  static_assert(has_mma_decode(FMT), "every format but q4_k");
  if constexpr (FMT == Q8_0) {
    mma_decode_q8_0<T>(stage, xs, nvalid, half, j0, g, t, acc);
  } else {
#pragma unroll
    for (int bb = 0; bb < md_blocks(FMT); ++bb)
      if (md_blocks(FMT) == 1 || bb < nvalid)
        mma_decode_superblock<T, FMT>(stage, xs, bb, half, j0, g, t, acc);
  }
}

template <typename T, int FMT, int V>
__global__ void __launch_bounds__(MD_THREADS, 2)
    qmatmul_mma_decode_kernel(const T* __restrict__ x, Fields f,
                              T* __restrict__ out, int M, int K, int N) {
  constexpr int SK = md_k(FMT);          // rows of K a stage
  constexpr int SB = md_blocks(FMT);     // format blocks a stage
  constexpr int NST = MD_STAGES;         // stages in the ring
  constexpr int STAGE = md_stage_bytes<T, FMT>();
  constexpr int W = md_w<FMT>();
  constexpr int XP = md_xpitch(FMT);
  static_assert(md_smem<T, FMT>() >= (3 * 2 * 32 * 16 + 3 * DROWS * COLS) * 4,
                "the ring holds the block's sums at the end");
  extern __shared__ __align__(16) uint8_t smem_md[];
  uint8_t* ring = smem_md;

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int g = l >> 2, t = l & 3, half = w & 1, j0 = w >> 1;
  const int n0 = blockIdx.x * COLS;
  const int rank = blockIdx.y, ks = gridDim.y;
  const int S = (K + SK - 1) / SK;
  const int s0 = (int)((long long)S * rank / ks);
  const int nsb = (int)((long long)S * (rank + 1) / ks) - s0;
  // the fields' format blocks, and those of this block's stage s that exist
  const int nblk = (K + block_k(FMT) - 1) / block_k(FMT);
  auto valid = [&](int s) { return min(SB, nblk - (s0 + s) * SB); };

  // x's rows of a stage go into it beside the weights (rows past M and
  // elements past K zero), 16 bytes of a row a piece, XN pieces a thread
  // (pieces past DROWS x SK / XV none): by cp.async in the stage's group
  // where the rows are 16-byte aligned; else loaded a stage ahead into
  // registers and stored after the stage's products
  constexpr int XV = 16 / sizeof(T);
  constexpr int XPR = SK / XV;                 // pieces a row
  constexpr int XN = (DROWS * XPR + MD_THREADS - 1) / MD_THREADS;
  const bool vec = K % XV == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto xon = [&](int i) { return tid + i * MD_THREADS < DROWS * XPR; };
  auto xrow = [&](int i) { return (tid + i * MD_THREADS) / XPR; };
  auto xcol = [&](int i) { return ((tid + i * MD_THREADS) % XPR) * XV; };
  auto issue_x = [&](int s, int slot) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {
      if (!xon(i)) continue;
      const int xr = xrow(i), k = (s0 + s) * SK + xcol(i);
      const bool in = xr < M && k < K;
      cp_async_zfill(smem_u32(ring) + slot * STAGE + W +
                         (xr * XP + xcol(i)) * (int)sizeof(T),
                     in ? x + (size_t)xr * K + k : x, in ? 16 : 0);
    }
  };
  float xv[XN][XV];
  auto load_xs = [&](int s) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {
      if (xon(i) && xrow(i) < M) {
        load_x<T>(x + (size_t)xrow(i) * K, (s0 + s) * SK + xcol(i), K, vec,
                  xv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < XV; ++e) xv[i][e] = 0.f;
      }
    }
  };
  auto store_xs = [&](int slot) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {
      if (!xon(i)) continue;
      T* dst = reinterpret_cast<T*>(ring + slot * STAGE + W) +
               xrow(i) * XP + xcol(i);
      if constexpr (sizeof(T) == 2) {
        uint4 u;
        uint32_t* p = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h2 =
              __floats2bfloat162_rn(xv[i][2 * e], xv[i][2 * e + 1]);
          p[e] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        *reinterpret_cast<uint4*>(dst) = u;
      } else {
        *reinterpret_cast<float4*>(dst) =
            make_float4(xv[i][0], xv[i][1], xv[i][2], xv[i][3]);
      }
    }
  };

  // the first NTHREADS threads copy the weight stages
  const bool copier = tid < NTHREADS;
  StageCopies<FMT, V, MD_PAD, SK, STAGE> copies(
      f, (size_t)s0 * SB, N, n0, ring, tid & (NTHREADS - 1));
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < nsb) {
      if (copier) copies.issue(st, N, valid(st));
      if (vec) issue_x(st, st);
    }
    cp_async_commit();
  }
  if (!vec && nsb > 0) {
    load_xs(0);
    store_xs(0);
  }
  // q5_k's min term of row w % 4, sub-blocks 4 (w / 4) .., columns 4l ..
  const int mr = w & 3, msh = w >> 2;
  float pm[4] = {0.f, 0.f, 0.f, 0.f};

  float acc[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[c][v] = 0.f;
  int slot = 0, fill = NST - 1;
  for (int s = 0; s < nsb; ++s) {
    if (!vec && s + 1 < nsb) load_xs(s + 1);
    cp_async_wait<NST - 2>();  // this thread's copies of stage s
    __syncthreads();  // everyone's, and x of stage s; stage s - 1 consumed
    if (s + NST - 1 < nsb) {
      if (copier) copies.issue(fill, N, valid(s + NST - 1));
      if (vec) issue_x(s + NST - 1, fill);
    }
    cp_async_commit();
    const uint8_t* stage = ring + slot * STAGE;
    mma_decode_stage<T, FMT>(stage, reinterpret_cast<const T*>(stage + W),
                             valid(s), half, j0, g, t, acc);
    // (ahead of the mma work and without the branch it ran 0-2 % slower)
    if constexpr (FMT == 3)
      if (mr < M)
        q5k_min_stage<T>(stage,
                         reinterpret_cast<const T*>(stage + W) + mr * XP,
                         msh, l, pm);
    // the next stage's slot: its x region was last read at stage s + 1 -
    // NST, before this stage's barrier
    if (!vec && s + 1 < nsb) store_xs(slot == NST - 1 ? 0 : slot + 1);
    slot = slot == NST - 1 ? 0 : slot + 1;
    fill = fill == NST - 1 ? 0 : fill + 1;
  }

  // the block's column sums: the four warps of each half added in a fixed
  // order (q5_k: less the two halves of its min term); lanes t < 2 hold
  // rows 2t, 2t + 1 (D columns past DROWS are the zero rows of B)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);   // 3 x 2 halves x 32 x 16
  float* blk = red + 3 * 2 * 32 * 16;            // DROWS x COLS
  float* mins = blk + DROWS * COLS;              // q5_k: 2 x DROWS x COLS
  if (j0 > 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red[(((j0 - 1) * 2 + half) * 32 + l) * 16 + 4 * c + v] = acc[c][v];
  }
  if constexpr (FMT == 3)
    if (mr < M)
      *reinterpret_cast<float4*>(mins + (msh * DROWS + mr) * COLS + 4 * l) =
          make_float4(pm[0], pm[1], pm[2], pm[3]);
  __syncthreads();
  if (j0 == 0 && t < 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float val = acc[c][v];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          val += red[((j * 2 + half) * 32 + l) * 16 + 4 * c + v];
        const int r = 2 * t + (v & 1);
        const int cl = half * 64 + (v >= 2 ? 32 : 0) + 4 * g + c;
        if constexpr (FMT == 3)
          if (r < M)
            val -= mins[r * COLS + cl] + mins[(DROWS + r) * COLS + cl];
        if (ks == 1) {
          if (r < M && n0 + cl < N)
            out[(size_t)r * N + n0 + cl] = from_f32<T>(val);
        } else {
          blk[r * COLS + cl] = val;
        }
      }
    }
  }
  if (ks == 1) return;

  // the cluster's blocks add their sums in rank order, each writing a slice
  // of the 128 columns' outputs
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_out = DROWS * COLS;
  const int lo = n_out * rank / ks, hi = n_out * (rank + 1) / ks;
  for (int idx = lo + tid; idx < hi; idx += MD_THREADS) {
    const int r = idx / COLS, n = n0 + idx % COLS;
    float part[MD_MAX_KSPLIT];
#pragma unroll
    for (int sp = 0; sp < MD_MAX_KSPLIT; ++sp)
      if (sp < ks) part[sp] = cluster.map_shared_rank(blk, sp)[idx];
    float v = 0.f;
#pragma unroll
    for (int sp = 0; sp < MD_MAX_KSPLIT; ++sp)
      if (sp < ks) v += part[sp];
    if (r < M && n < N) out[(size_t)r * N + n] = from_f32<T>(v);
  }
  cluster.sync();   // each block's shared memory stays until all have read it
}

// ---------------------------------------------------------------------------
// The 2-D form at M > 4 of every format on tensor cores:
// qmatmul_prefill_kernel<T, FMT, V, ROWS> (see the header).  A block of 8
// warps owns ROWS rows of x and 128 columns, each warp a part of the
// output in f32 registers (PfWarps).  K is
// walked a stage at a time: a part of a superblock (PARTS = 2 halves of
// 128 elements for bf16 x, 4 quarters of 64 for f32 x), in an order of
// the superblock's elements that makes a part whole byte rows of the
// fields.  q4_k part q: qs rows q * QR .. + QR - 1 (QR = 128 / PARTS),
// whose low nibbles are elements q * QR + r (stage row r) and high ones
// 128 + q * QR + r (stage row QR + r).  q5_k takes q4_k's order: the high
// bits of its elements q * QR + r and 128 + q * QR + r are bits (q * QR +
// r) / 32 and 4 above it of qh row r % 32, so all 32 qh rows are copied
// every stage.  q6_k part q: ql rows q * QR + r and
// 64 + q * QR + r and qh row q * QR + r (QR = 64 / PARTS), elements q * QR
// + r + 64 p (stage row p * QR + r).  q3_k takes q6_k's order: qs row q *
// QR + r holds elements q * QR + r + 64 p in bit-pair p, and their high
// bits are bits (q * QR) / 32 + 2 p of hmask row (q * QR + r) % 32, so all
// 32 hmask rows are copied every stage.  q2_k takes q3_k's order without
// hmask: qs row q * QR + r holds elements q * QR + r + 64 p in bit-pair p,
// so a part copies its own QR rows of qs (not all 64).  q8_0 part q: the
// superblock's elements q * KST .. + KST - 1 in order (its blocks q * KST
// / 32 ..), blocks past the field's last (K % 256 != 0) zero.  Every way a
// part's sub-blocks are whole, and stage row u's sub-block is the part's
// row u / 32 (q4_k, q5_k, q8_0) or u / 16 (q6_k, q3_k, q2_k) of its scale fields
// (q8_0: of d; q2_k: of sm, scale and min), copied in that order.
// ---------------------------------------------------------------------------

constexpr int PF_WARPS = 8;
constexpr int PF_THREADS = 32 * PF_WARPS;
constexpr int PF_ROWS = 128;        // rows of x a block (64 for few tiles)
constexpr int PF_STAGES = 3;        // slots of the ring of copies
// sub-blocks of a bf16 stage unrolled (3-7 % faster than 1 on an H100 SXM)
constexpr int PF_UNROLL = 2;
// The warp layout of a ROWS x 128 tile: WM warps along its rows and WN
// along its columns (128 rows: 4 x 2 warps of 32 x 64; 64 rows: 2 x 4 of
// 32 x 32), MT m16 and NT n8 tiles a warp; and where a sub-block's f32
// scales lie in shared memory: lane t of the warps of column group wn
// reads its 2 NT (columns 8 nt + 2t, + 1 of each n8 tile) as NT / 2
// 16-byte loads, the lanes' runs padded to SLANE floats so that the four
// of a load hit distinct banks.
template <int ROWS>
struct PfWarps {
  static constexpr int WN = ROWS == 128 ? 2 : 4;
  static constexpr int WM = PF_WARPS / WN;
  static constexpr int MT = ROWS / WM / 16;
  static constexpr int NT = COLS / WN / 8;
  static constexpr int SLANE = 2 * NT + 4;
  static constexpr int SROW = WN * 4 * SLANE;   // floats a sub-block
  __host__ __device__ static constexpr int spos(int n) {
    return ((n / (8 * NT)) * 4 + (n % 8) / 2) * SLANE +
           ((n % (8 * NT)) / 8) * 2 + n % 2;
  }
};
constexpr int PF_MAX_KSPLIT = 8;    // blocks a cluster (the portable size)
constexpr int PF_WPITCH = 2 * COLS + 16;   // bytes of a converted weight row
constexpr int PF_RED_PITCH = COLS + 8;     // floats of a row of block sums

template <typename T>
__host__ __device__ constexpr int pf_parts() {
  return sizeof(T) == 2 ? 2 : 4;
}
// elements of K a stage, and bytes of a staged row of x (its 256 bytes,
// padded so that ldmatrix (bf16) or a warp's 8-byte loads (f32) of eight
// rows hit 32 banks)
template <typename T>
__host__ __device__ constexpr int pf_kst() {
  return QK / pf_parts<T>();
}
template <typename T>
__host__ __device__ constexpr int pf_xpitch() {
  return pf_kst<T>() * (int)sizeof(T) + (sizeof(T) == 2 ? 16 : 32);
}
// the groups of a field's rows of which each part takes its share: q4_k's
// and q5_k's scales and mins (sub-blocks 0-3 of the low nibbles, 4-7 of the
// high); q6_k ql (rows 0-63, 64-127) and the scales of q6_k, q3_k and q2_k
// (sub-blocks 4p .. 4p + 3).  A field of one row a superblock (d, dmin),
// q3_k's hmask and q5_k's qh are copied whole every stage.
__host__ __device__ constexpr int pf_runs(int fmt, int g) {
  return fmt == 0   ? (g == 1 || g == 2 ? 2 : 1)
         : fmt == 1 ? (g == 0 ? 2 : g == 2 ? 4 : 1)
         : fmt == 2 ? (g == 2 ? 4 : 1)
         : fmt == 3 ? (g == 2 || g == 3 ? 2 : 1)
         : fmt == 4 ? (g == 1 ? 4 : 1)
                    : 1;
}
__host__ __device__ constexpr bool pf_whole(int fmt, int g) {
  return field_layout(fmt, g).rows == 1 || ((fmt == 2 || fmt == 3) && g == 1);
}
__host__ __device__ constexpr int pf_rows(int fmt, int g, int parts) {
  return pf_whole(fmt, g) ? field_layout(fmt, g).rows
                          : field_layout(fmt, g).rows / parts;
}
__host__ __device__ constexpr int pf_off(int fmt, int g, int parts) {
  int off = 0;
  for (int i = 0; i < g; ++i)
    off += pf_rows(fmt, i, parts) * COLS * field_layout(fmt, i).esz;
  return off;
}
// elements of a sub-block, the unit of a scale (q8_0: of a d): 16 (q6_k,
// q3_k, q2_k) or 32 (q4_k, q5_k, q8_0); and the sub-blocks of a stage
__host__ __device__ constexpr int pf_sub(int fmt) {
  return fmt == 1 || fmt == 2 || fmt == 4 ? 16 : 32;
}
template <typename T, int FMT>
__host__ __device__ constexpr int pf_nsub() {
  return pf_kst<T>() / pf_sub(FMT);
}
// the formats with a min term (-m * dmin)
__host__ __device__ constexpr bool pf_mins(int fmt) {
  return fmt == 0 || fmt == 3 || fmt == 4;
}
// field g of q4_k's list (qs, scales, mins, d, dmin) in q5_k's, which has
// qh at 1
__host__ __device__ constexpr int pf_nib_field(int fmt, int g) {
  return fmt == 3 && g > 0 ? g + 1 : g;
}
// Shared memory: the ring of PF_STAGES slots (x's rows of the stage,
// then the stage's fields), then two buffers (one converted while the
// other is multiplied) of the bf16 weight tile (stage rows x 128 columns)
// and its f32 scales (sc * d per sub-block and column, q8_0 d; q4_k, q5_k
// and q2_k also -m * dmin).
template <typename T, int FMT, int ROWS>
__host__ __device__ constexpr int pf_slot() {
  return ROWS * pf_xpitch<T>() + pf_off(FMT, num_fields(FMT), pf_parts<T>());
}
// bf16 x: a buffer holds the code tile and the scales; f32 x: the three
// bf16 terms' tiles of the dequantized weights, and one buffer serves
template <typename T, int FMT, int ROWS>
__host__ __device__ constexpr int pf_wbuf() {
  return sizeof(T) == 4
             ? 3 * pf_kst<T>() * PF_WPITCH
             : pf_kst<T>() * PF_WPITCH + pf_nsub<T, FMT>() *
                                             PfWarps<ROWS>::SROW * 4 *
                                             (pf_mins(FMT) ? 2 : 1);
}
template <typename T>
__host__ __device__ constexpr int pf_wbufs() {
  return sizeof(T) == 4 ? 1 : 2;
}
template <typename T, int FMT, int ROWS>
__host__ __device__ constexpr size_t pf_smem() {
  return (size_t)PF_STAGES * pf_slot<T, FMT, ROWS>() +
         pf_wbufs<T>() * (size_t)pf_wbuf<T, FMT, ROWS>();
}

// Start the copies of stage ``st`` (superblock sb = st / PARTS, part q =
// st % PARTS) into ring slot ``slot``: the fields' rows of the part, V
// bytes a copy (q8_0 rows of blocks past the field's last stored as
// zeros), and x's 128 rows of the part's elements, 16 bytes a copy where
// x's rows are 16-byte aligned (zero past M and K), else loaded and stored
// here.
template <typename T, int FMT, int V, int ROWS>
__device__ __forceinline__ void pf_issue(const T* __restrict__ x,
                                         const Fields& f, uint8_t* slot,
                                         int st, int m0, int M, int K, int N,
                                         int n0, int tid, bool vec) {
  constexpr int PARTS = pf_parts<T>();
  constexpr int KST = pf_kst<T>();
  const int sb = st / PARTS, q = st % PARTS;
  uint8_t* wdst = slot + ROWS * pf_xpitch<T>();
#pragma unroll
  for (int g = 0; g < num_fields(FMT); ++g) {
    const int R = field_layout(FMT, g).rows, ES = field_layout(FMT, g).esz;
    const int rows = pf_rows(FMT, g, PARTS);
    const int L = rows / pf_runs(FMT, g);         // rows a run of a part
    const int cpr = COLS * ES / V;                // copies a row
    const int n_copy = rows * cpr;
#pragma unroll
    for (int i = 0; i < (n_copy + PF_THREADS - 1) / PF_THREADS; ++i) {
      const int c = tid + i * PF_THREADS;
      const int row = c / cpr, b = (c % cpr) * V;
      if (c < n_copy && n0 + b / ES < N) {
        const int grow = pf_whole(FMT, g)
                             ? row
                             : (row / L) * (R / pf_runs(FMT, g)) + q * L +
                                   row % L;
        uint8_t* dst = wdst + pf_off(FMT, g, PARTS) + row * COLS * ES + b;
        // (q8_0: a block is R / 8 rows of the field, ceil(K / 32) blocks)
        bool present = true;
        if constexpr (FMT == Q8_0)
          present = (sb * R + grow) / (R / 8) < (K + 31) / 32;
        if (!present) {
          if constexpr (V == 16)
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          else
            *reinterpret_cast<uint32_t*>(dst) = 0u;
        } else {
          cp_async<V>(smem_u32(dst),
                      f.p[g] + ((size_t)(sb * R + grow) * N + n0) * ES + b);
        }
      }
    }
  }
  // x: thread tid copies 16 bytes (XV elements, stage elements u = 16-byte
  // piece cc) of rows tid / CPR + (PF_THREADS / CPR) i
  constexpr int XV = 16 / sizeof(T);
  constexpr int CPR = KST / XV;             // 16-byte pieces a row
  // runs of x a part takes (q4_k, q5_k: low and high nibbles; q6_k, q3_k,
  // q2_k: four bit-pairs; q8_0: its elements in order)
  constexpr int NRX = FMT == 0 || FMT == 3 ? 2 : FMT == Q8_0 ? 1 : 4;
  constexpr int RL = KST / NRX;             // elements a run
  const int cc = tid % CPR, u = cc * XV;
  const int k = sb * QK + (u / RL) * (QK / NRX) + q * RL + u % RL;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / PF_THREADS; ++i) {
    const int m = tid / CPR + (PF_THREADS / CPR) * i;
    uint8_t* dst = slot + m * pf_xpitch<T>() + cc * 16;
    const bool in = m0 + m < M && k < K;
    if (vec) {
      cp_async_zfill(smem_u32(dst), in ? x + (size_t)(m0 + m) * K + k : x,
                     in ? 16 : 0);
    } else {
      alignas(16) T v[XV];
#pragma unroll
      for (int e = 0; e < XV; ++e)
        v[e] = m0 + m < M && k + e < K ? x[(size_t)(m0 + m) * K + k + e]
                                       : from_f32<T>(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// q3_k: the four columns' codes of elements part * QR + r + 64 p (t[p],
// one code a byte, in bits 0-2), from qs row part * QR + r (``q``, its
// bit-pair p) and hmask row (part * QR + r) % 32 shifted right by (part *
// QR) / 32 (``h``, its bit 2 p)
__device__ __forceinline__ void q3k_pf_codes(uint32_t q, uint32_t h,
                                             uint32_t (&t)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
    t[p] = ((q >> (2 * p)) & 0x03030303u) |
           (((h >> (2 * p)) & 0x01010101u) << 2);
}

// Convert the fields of the stage in ``slot`` (part ``part`` of its
// superblock) into buffer ``wb``: the codes as the bf16 tile (stage row u,
// column n), byte permutes and one bf16x2 FMA a pair, no int-to-float; per
// sub-block and column sc * d (q4_k, q5_k and q2_k also -m * dmin; q8_0 d) in
// f32, each product rounded as the plain version rounds it.
template <typename T, int FMT, int ROWS>
__device__ __forceinline__ void pf_convert(const uint8_t* slot, uint8_t* wb,
                                           int tid, int part) {
  static_assert(sizeof(T) == 2, "f32 x takes pf_convert_f32");
  constexpr int PARTS = pf_parts<T>();
  constexpr int KST = pf_kst<T>();
  constexpr int NSUB = pf_nsub<T, FMT>();
  const uint8_t* raw = slot + ROWS * pf_xpitch<T>();
  // NSUB rows of SROW floats (spos), q4_k then NSUB of -m * dmin
  using L = PfWarps<ROWS>;
  float* scl = reinterpret_cast<float*>(wb + KST * PF_WPITCH);
  const int w = tid >> 5, l = tid & 31;
  if constexpr (FMT == 0 || FMT == 3) {
    constexpr int QR = 128 / PARTS;
    // q5_k: the high bit of element part * QR + r (stage row r) is bit
    // (part * QR + r) / 32 of qh row r % 32, of element 128 + part * QR + r
    // (stage row QR + r) bit 4 above it
    const uint8_t* hf = raw + pf_off(FMT, 1, PARTS) + 4 * l;
#pragma unroll
    for (int i = 0; i < QR / PF_WARPS; ++i) {
      const int r = w + PF_WARPS * i;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(raw + r * COLS +
                                                            4 * l);
      uint32_t lo = v & 0x0F0F0F0Fu, hi = (v >> 4) & 0x0F0F0F0Fu;
      if constexpr (FMT == 3) {
        const uint32_t h =
            *reinterpret_cast<const uint32_t*>(hf + (r & 31) * COLS) >>
            ((part * QR + r) >> 5);
        lo |= (h & 0x01010101u) << 4;
        hi |= h & 0x10101010u;
      }
      *reinterpret_cast<uint2*>(wb + r * PF_WPITCH + 8 * l) =
          make_uint2(code_pair(lo, 0x4140, Q4_BIAS),
                     code_pair(lo, 0x4342, Q4_BIAS));
      *reinterpret_cast<uint2*>(wb + (QR + r) * PF_WPITCH + 8 * l) =
          make_uint2(code_pair(hi, 0x4140, Q4_BIAS),
                     code_pair(hi, 0x4342, Q4_BIAS));
    }
  } else if constexpr (FMT == 1 || FMT == 2 || FMT == 4) {
    constexpr int QR = 64 / PARTS;
    // q6_k: qh; q3_k: hmask, its rows from (part * QR) % 32, its bits from
    // (part * QR) / 32; q2_k: none
    const uint8_t* hf = raw + pf_off(FMT, 1, PARTS) +
                        (FMT == 2 ? part * QR % 32 : 0) * COLS + 4 * l;
    const int hb = FMT == 2 ? part * QR / 32 : 0;
#pragma unroll
    for (int i = 0; i < QR / PF_WARPS; ++i) {
      const int r = w + PF_WARPS * i;
      uint32_t t[4];
      const uint32_t q = *reinterpret_cast<const uint32_t*>(raw + r * COLS +
                                                            4 * l);
      if constexpr (FMT == 1) {
        q6k_codes(q,
                  *reinterpret_cast<const uint32_t*>(raw + (QR + r) * COLS +
                                                     4 * l),
                  *reinterpret_cast<const uint32_t*>(hf + r * COLS), t);
      } else if constexpr (FMT == 2) {
        q3k_pf_codes(q, *reinterpret_cast<const uint32_t*>(hf + r * COLS) >> hb,
                     t);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) t[p] = (q >> (2 * p)) & 0x03030303u;
      }
      constexpr uint32_t BIAS =
          FMT == 1 ? Q6_BIAS : FMT == 2 ? Q3_BIAS : Q4_BIAS;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        *reinterpret_cast<uint2*>(wb + (p * QR + r) * PF_WPITCH + 8 * l) =
            make_uint2(code_pair(t[p], 0x4140, BIAS),
                       code_pair(t[p], 0x4342, BIAS));
    }
  } else {
    // q8_0: an int8 code as 128 + its low 7 bits (code_pair) plus a bias
    // of -128, or -256 where its sign bit is set: the bias pair's low
    // bytes are the codes' sign bits under the exponent byte 0xC3
#pragma unroll
    for (int i = 0; i < KST / PF_WARPS; ++i) {
      const int r = w + PF_WARPS * i;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(raw + r * COLS +
                                                            4 * l);
      const uint32_t mag = v & 0x7F7F7F7Fu, sgn = v & 0x80808080u;
      *reinterpret_cast<uint2*>(wb + r * PF_WPITCH + 8 * l) = make_uint2(
          code_pair(mag, 0x4140, __byte_perm(sgn, 0xC3C3C3C3u, 0x4140)),
          code_pair(mag, 0x4342, __byte_perm(sgn, 0xC3C3C3C3u, 0x4342)));
    }
  }
  // scales: unit (sub-block, four columns); d is field 3 of q4_k, q6_k and
  // q3_k, field 4 of q5_k, field 1 of q8_0 (a row a block), field 2 of q2_k
  // (dmin 3)
  for (int idx = tid; idx < NSUB * 32; idx += PF_THREADS) {
    const int s = idx >> 5, c4 = 4 * (idx & 31);
    float dd[4];
    float4 e;
    if constexpr (FMT == Q8_0) {
      load4_half(as_half(raw + pf_off(FMT, 1, PARTS)) + s * COLS + c4, dd);
      e = make_float4(dd[0], dd[1], dd[2], dd[3]);
    } else if constexpr (FMT == 4) {
      // sm: the scale code in the low nibble, the min code in the high one
      float dm[4];
      load4_half(as_half(raw + pf_off(4, 2, PARTS)) + c4, dd);
      load4_half(as_half(raw + pf_off(4, 3, PARTS)) + c4, dm);
      const uint32_t sm = *reinterpret_cast<const uint32_t*>(
          raw + pf_off(4, 1, PARTS) + s * COLS + c4);
      e = make_float4(__fmul_rn(dd[0], (float)(byte_of(sm, 0) & 15u)),
                      __fmul_rn(dd[1], (float)(byte_of(sm, 1) & 15u)),
                      __fmul_rn(dd[2], (float)(byte_of(sm, 2) & 15u)),
                      __fmul_rn(dd[3], (float)(byte_of(sm, 3) & 15u)));
      float* nm = scl + (NSUB + s) * L::SROW;
      *reinterpret_cast<float2*>(nm + L::spos(c4)) =
          make_float2(-__fmul_rn(dm[0], (float)(byte_of(sm, 0) >> 4)),
                      -__fmul_rn(dm[1], (float)(byte_of(sm, 1) >> 4)));
      *reinterpret_cast<float2*>(nm + L::spos(c4 + 2)) =
          make_float2(-__fmul_rn(dm[2], (float)(byte_of(sm, 2) >> 4)),
                      -__fmul_rn(dm[3], (float)(byte_of(sm, 3) >> 4)));
    } else {
      // q4_k and q5_k: scales, mins, d and dmin at pf_nib_field 1-4
      constexpr bool NIB = FMT == 0 || FMT == 3;
      load4_half(as_half(raw + pf_off(FMT, pf_nib_field(FMT, 3), PARTS)) +
                     c4,
                 dd);
      const uint32_t sc = *reinterpret_cast<const uint32_t*>(
          raw + pf_off(FMT, NIB ? pf_nib_field(FMT, 1) : 2, PARTS) +
          s * COLS + c4);
      if constexpr (NIB) {
        e = make_float4(__fmul_rn(dd[0], (float)byte_of(sc, 0)),
                        __fmul_rn(dd[1], (float)byte_of(sc, 1)),
                        __fmul_rn(dd[2], (float)byte_of(sc, 2)),
                        __fmul_rn(dd[3], (float)byte_of(sc, 3)));
        float dm[4];
        load4_half(as_half(raw + pf_off(FMT, pf_nib_field(FMT, 4), PARTS)) +
                       c4,
                   dm);
        const uint32_t mn = *reinterpret_cast<const uint32_t*>(
            raw + pf_off(FMT, pf_nib_field(FMT, 2), PARTS) + s * COLS + c4);
        float* nm = scl + (NSUB + s) * L::SROW;
        *reinterpret_cast<float2*>(nm + L::spos(c4)) =
            make_float2(-__fmul_rn(dm[0], (float)byte_of(mn, 0)),
                        -__fmul_rn(dm[1], (float)byte_of(mn, 1)));
        *reinterpret_cast<float2*>(nm + L::spos(c4 + 2)) =
            make_float2(-__fmul_rn(dm[2], (float)byte_of(mn, 2)),
                        -__fmul_rn(dm[3], (float)byte_of(mn, 3)));
      } else {
        e = make_float4(__fmul_rn(dd[0], (float)(int8_t)byte_of(sc, 0)),
                        __fmul_rn(dd[1], (float)(int8_t)byte_of(sc, 1)),
                        __fmul_rn(dd[2], (float)(int8_t)byte_of(sc, 2)),
                        __fmul_rn(dd[3], (float)(int8_t)byte_of(sc, 3)));
      }
    }
    *reinterpret_cast<float2*>(scl + s * L::SROW + L::spos(c4)) =
        make_float2(e.x, e.y);
    *reinterpret_cast<float2*>(scl + s * L::SROW + L::spos(c4 + 2)) =
        make_float2(e.z, e.w);
  }
}

// The A fragment (16 rows x 16 elements of x at row ``row0``, element
// ``k0`` of the stage) of each of x's bf16 terms: bf16 x by ldmatrix, f32 x
// as three terms (hi + mid + lo) from its 8-byte pairs.
template <typename T>
__device__ __forceinline__ void pf_afrag(const uint8_t* xs, int row0, int k0,
                                         int l,
                                         uint32_t (&a)[x_terms<T>()][4]) {
  if constexpr (sizeof(T) == 2) {
    ldmatrix_x4<false>(a[0], smem_u32(xs + (row0 + (l & 15)) * pf_xpitch<T>() +
                                      (k0 + 8 * (l >> 4)) * 2));
  } else {
    const int g = l >> 2, t = l & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a[j]: rows g (j even) or g + 8, elements 2t (j < 2) or 2t + 8
      const float2 v = *reinterpret_cast<const float2*>(
          xs + (row0 + g + 8 * (j & 1)) * pf_xpitch<T>() +
          (k0 + 2 * t + 8 * (j >> 1)) * 4);
      split3(v.x, v.y, a[0][j], a[1][j], a[2][j]);
    }
  }
}

// The products of one stage for warp (wm, wn): per sub-block (q8_0: per
// block) the exact products of codes and x summed by the tensor cores (f32,
// zeroed for each sub-block and row tile), then scaled into the
// accumulators in f32; for q4_k, q5_k and q2_k also the sub-block's sums of x's
// rows, an mma against a B of ones (bf16 1.0: exact) a k16 step, times -m
// * dmin.
template <typename T, int FMT, int ROWS>
__device__ __forceinline__ void pf_stage_mma(
    const uint8_t* xs, const uint8_t* wb, int wm, int wn, int l,
    float (&acc)[PfWarps<ROWS>::MT][PfWarps<ROWS>::NT][4]) {
  using L = PfWarps<ROWS>;
  constexpr int MT = L::MT, NT8 = L::NT;
  static_assert(sizeof(T) == 2, "f32 x takes pf_stage_mma_f32");
  constexpr int KST = pf_kst<T>();
  constexpr int NSUB = pf_nsub<T, FMT>();
  constexpr int KK = pf_sub(FMT) / 16;      // k16 steps a sub-block
  constexpr bool MINS = pf_mins(FMT);
  constexpr uint32_t ONES = 0x3F803F80u;    // bf16 (1.0, 1.0)
  const float* scl = reinterpret_cast<const float*>(wb + KST * PF_WPITCH);
  const int t = l & 3;
  // ldmatrix.trans rows of the B fragments: lane l gives row k16 + 8 (l /
  // 8 % 2) + l % 8 of columns wn * (8 NT8) + 16 np + 8 (l / 16)
  const uint8_t* bsrc = wb + (8 * ((l >> 3) & 1) + (l & 7)) * PF_WPITCH +
                        (wn * 8 * NT8 + 8 * (l >> 4)) * 2;
  static_assert(NSUB % PF_UNROLL == 0, "a stage's sub-blocks in steps");
#pragma unroll 1
  for (int s0 = 0; s0 < NSUB; s0 += PF_UNROLL)
#pragma unroll
  for (int j = 0; j < PF_UNROLL; ++j) {
    const int s = s0 + j;   // the sub-block
    uint32_t b[KK][NT8][2];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4<true>(r, smem_u32(bsrc + (16 * (KK * s + kk)) * PF_WPITCH +
                                      32 * np));
        b[kk][2 * np][0] = r[0];
        b[kk][2 * np][1] = r[1];
        b[kk][2 * np + 1][0] = r[2];
        b[kk][2 * np + 1][1] = r[3];
      }
    // the sub-block's scales of this lane's columns (q4_k, q5_k, q2_k also -m
    // * dmin)
    float2 e[NT8], nm[MINS ? NT8 : 1];
    const float* sp = scl + s * L::SROW + (wn * 4 + t) * L::SLANE;
#pragma unroll
    for (int j = 0; j < NT8 / 2; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(sp + 4 * j);
      e[2 * j] = make_float2(v.x, v.y);
      e[2 * j + 1] = make_float2(v.z, v.w);
      if constexpr (MINS) {
        const float4 u =
            *reinterpret_cast<const float4*>(sp + NSUB * L::SROW + 4 * j);
        nm[2 * j] = make_float2(u.x, u.y);
        nm[2 * j + 1] = make_float2(u.z, u.w);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row0 = (wm * MT + mt) * 16;
      float d[NT8][4], xd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) d[nt][v] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t a[1][4];
        pf_afrag<T>(xs, row0, 16 * (KK * s + kk), l, a);
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
          mma_bf16(d[nt], a[0], b[kk][nt][0], b[kk][nt][1]);
        if constexpr (MINS) mma_bf16(xd, a[0], ONES, ONES);
      }
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        float (&o)[4] = acc[mt][nt];
        o[0] = fmaf(e[nt].x, d[nt][0], o[0]);
        o[1] = fmaf(e[nt].y, d[nt][1], o[1]);
        o[2] = fmaf(e[nt].x, d[nt][2], o[2]);
        o[3] = fmaf(e[nt].y, d[nt][3], o[3]);
        if constexpr (MINS) {
          // xd: rows g (xd[0]) and g + 8 (xd[2]), the same in every column
          o[0] = fmaf(nm[nt].x, xd[0], o[0]);
          o[1] = fmaf(nm[nt].y, xd[0], o[1]);
          o[2] = fmaf(nm[nt].x, xd[2], o[2]);
          o[3] = fmaf(nm[nt].y, xd[2], o[3]);
        }
      }
    }
  }
}

// f32 x (the parity and test path): the plain version's function to f32
// rounding.  Each weight of the stage (part ``part`` of its superblock) is
// dequantized as qmatmul_plain does it (q4_k, q5_k and q2_k: q * (sc * d) -
// m * dmin, q6_k: (q - 32) * (sc * d), q3_k: (q - 4) * (sc * d), q8_0: q * d,
// each product and difference rounded to f32) and split, like x, into three
// bf16 terms (split3); ``wb`` holds the terms' tiles one after the other.
template <int FMT, int ROWS>
__device__ __forceinline__ void pf_convert_f32(const uint8_t* slot,
                                               uint8_t* wb, int tid,
                                               int part) {
  constexpr int PARTS = pf_parts<float>();
  constexpr int KST = pf_kst<float>();
  constexpr int TILE = KST * PF_WPITCH;
  const uint8_t* raw = slot + ROWS * pf_xpitch<float>();
  const int w = tid >> 5, l = tid & 31, c4 = 4 * l;
  // a thread's four columns of stage row r, as three bf16 terms
  auto put = [&](int r, const float (&v)[4]) {
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(v[0], v[1], h0, m0, l0);
    split3(v[2], v[3], h1, m1, l1);
    uint8_t* p = wb + r * PF_WPITCH + 8 * l;
    *reinterpret_cast<uint2*>(p) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(p + TILE) = make_uint2(m0, m1);
    *reinterpret_cast<uint2*>(p + 2 * TILE) = make_uint2(l0, l1);
  };
  if constexpr (FMT == Q8_0) {
    // stage row r lies in the part's block r / 32 (row r / 32 of its d);
    // a code as 2^23 + (q + 128) in one XOR and one byte permute, less
    // 2^23 + 128 exactly
    float dd[KST / 32][4];
#pragma unroll
    for (int b = 0; b < KST / 32; ++b)
      load4_half(as_half(raw + pf_off(Q8_0, 1, PARTS)) + b * COLS + c4,
                 dd[b]);
#pragma unroll
    for (int i = 0; i < KST / PF_WARPS; ++i) {
      const int r = w + PF_WARPS * i;
      const uint32_t u =
          *reinterpret_cast<const uint32_t*>(raw + r * COLS + c4) ^
          0x80808080u;
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = __fmul_rn(code_f32(u, c) - (kMagic + 128.f),
                          dd[PF_WARPS * i / 32][c]);
      put(r, wv);
    }
  } else if constexpr (FMT == 0 || FMT == 3) {
    // stage rows r (low nibbles) and QR + r (high ones) lie in the part's
    // sub-blocks of row 0 and row 1 of its scale fields; q5_k's high bits
    // as in pf_convert
    constexpr int QR = 128 / PARTS;
    float dd[4], dm[4], e[2][4], mn[2][4];
    load4_half(as_half(raw + pf_off(FMT, pf_nib_field(FMT, 3), PARTS)) + c4,
               dd);
    load4_half(as_half(raw + pf_off(FMT, pf_nib_field(FMT, 4), PARTS)) + c4,
               dm);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t sc = *reinterpret_cast<const uint32_t*>(
          raw + pf_off(FMT, pf_nib_field(FMT, 1), PARTS) + h * COLS + c4);
      const uint32_t m = *reinterpret_cast<const uint32_t*>(
          raw + pf_off(FMT, pf_nib_field(FMT, 2), PARTS) + h * COLS + c4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        e[h][c] = __fmul_rn(dd[c], (float)byte_of(sc, c));
        mn[h][c] = __fmul_rn(dm[c], (float)byte_of(m, c));
      }
    }
#pragma unroll
    for (int i = 0; i < QR / PF_WARPS; ++i) {
      const int r = w + PF_WARPS * i;
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(raw + r * COLS + c4);
      uint32_t q[2] = {v & 0x0F0F0F0Fu, (v >> 4) & 0x0F0F0F0Fu};
      if constexpr (FMT == 3) {
        const uint32_t hb =
            *reinterpret_cast<const uint32_t*>(raw + pf_off(3, 1, PARTS) +
                                               (r & 31) * COLS + c4) >>
            ((part * QR + r) >> 5);
        q[0] |= (hb & 0x01010101u) << 4;
        q[1] |= hb & 0x10101010u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float wv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wv[c] = __fsub_rn(__fmul_rn(code_f32(q[h], c) - kMagic, e[h][c]),
                            mn[h][c]);
        put(h * QR + r, wv);
      }
    }
  } else if constexpr (FMT == 4) {
    // q2_k: stage row p * QR + r (bit-pair p of qs row r) lies in the
    // sub-block of row p of the part's sm
    constexpr int QR = 64 / PARTS;
    float dd[4], dm[4], e[4][4], mn[4][4];
    load4_half(as_half(raw + pf_off(4, 2, PARTS)) + c4, dd);
    load4_half(as_half(raw + pf_off(4, 3, PARTS)) + c4, dm);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t sm = *reinterpret_cast<const uint32_t*>(
          raw + pf_off(4, 1, PARTS) + p * COLS + c4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        e[p][c] = __fmul_rn(dd[c], (float)(byte_of(sm, c) & 15u));
        mn[p][c] = __fmul_rn(dm[c], (float)(byte_of(sm, c) >> 4));
      }
    }
#pragma unroll
    for (int i = 0; i < QR / PF_WARPS; ++i) {
      const int r = w + PF_WARPS * i;
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(raw + r * COLS + c4);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t q = (v >> (2 * p)) & 0x03030303u;
        float wv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wv[c] = __fsub_rn(__fmul_rn(code_f32(q, c) - kMagic, e[p][c]),
                            mn[p][c]);
        put(p * QR + r, wv);
      }
    }
  } else {
    // q6_k and q3_k: stage row p * QR + r lies in the sub-block of row p
    // of the part's scales
    constexpr int QR = 64 / PARTS;
    const uint8_t* hf = raw + pf_off(FMT, 1, PARTS) +
                        (FMT == 2 ? part * QR % 32 : 0) * COLS + c4;
    const int hb = FMT == 2 ? part * QR / 32 : 0;
    float dd[4], e[4][4];
    load4_half(as_half(raw + pf_off(FMT, 3, PARTS)) + c4, dd);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t sc = *reinterpret_cast<const uint32_t*>(
          raw + pf_off(FMT, 2, PARTS) + p * COLS + c4);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        e[p][c] = __fmul_rn(dd[c], (float)(int8_t)byte_of(sc, c));
    }
#pragma unroll
    for (int i = 0; i < QR / PF_WARPS; ++i) {
      const int r = w + PF_WARPS * i;
      uint32_t t[4];
      const uint32_t h = *reinterpret_cast<const uint32_t*>(hf + r * COLS);
      if constexpr (FMT == 1)
        q6k_codes(*reinterpret_cast<const uint32_t*>(raw + r * COLS + c4),
                  *reinterpret_cast<const uint32_t*>(raw + (QR + r) * COLS +
                                                     c4),
                  h, t);
      else
        q3k_pf_codes(*reinterpret_cast<const uint32_t*>(raw + r * COLS + c4),
                     h >> hb, t);
      // the code's offset: q6_k 32, q3_k 4
      constexpr float OFF = kMagic + (FMT == 1 ? 32.f : 4.f);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float wv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wv[c] = __fmul_rn(code_f32(t[p], c) - OFF, e[p][c]);
        put(p * QR + r, wv);
      }
    }
  }
}

// The products of one f32 stage for warp (wm, wn): per k16 step the six
// products of x's and the weights' terms whose sum carries f32 precision
// (the three below it dropped), smallest first, summed by the tensor cores
// and added into the accumulators in f32.
template <int ROWS>
__device__ __forceinline__ void pf_stage_mma_f32(
    const uint8_t* xs, const uint8_t* wb, int wm, int wn, int l,
    float (&acc)[PfWarps<ROWS>::MT][PfWarps<ROWS>::NT][4]) {
  using L = PfWarps<ROWS>;
  constexpr int MT = L::MT, NT8 = L::NT;
  constexpr int TILE = pf_kst<float>() * PF_WPITCH;
  const uint8_t* bsrc = wb + (8 * ((l >> 3) & 1) + (l & 7)) * PF_WPITCH +
                        (wn * 8 * NT8 + 8 * (l >> 4)) * 2;
#pragma unroll 1
  for (int kk = 0; kk < pf_kst<float>() / 16; ++kk) {
    uint32_t b[3][NT8][2];   // the weights' hi, mid and lo terms
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4<true>(r, smem_u32(bsrc + j * TILE +
                                      16 * kk * PF_WPITCH + 32 * np));
        b[j][2 * np][0] = r[0];
        b[j][2 * np][1] = r[1];
        b[j][2 * np + 1][0] = r[2];
        b[j][2 * np + 1][1] = r[3];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[3][4];   // x's hi, mid and lo terms
      pf_afrag<float>(xs, (wm * MT + mt) * 16, 16 * kk, l, a);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, a[2], b[0][nt][0], b[0][nt][1]);   // x lo, w hi
        mma_bf16(d, a[1], b[1][nt][0], b[1][nt][1]);   // mid, mid
        mma_bf16(d, a[0], b[2][nt][0], b[2][nt][1]);   // hi, lo
        mma_bf16(d, a[1], b[0][nt][0], b[0][nt][1]);   // mid, hi
        mma_bf16(d, a[0], b[1][nt][0], b[1][nt][1]);   // hi, mid
        mma_bf16(d, a[0], b[0][nt][0], b[0][nt][1]);   // hi, hi
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] += d[v];
      }
    }
  }
}

template <typename T, int FMT, int V, int ROWS>
__global__ void __launch_bounds__(PF_THREADS, 1)
    qmatmul_prefill_kernel(const T* __restrict__ x, Fields f,
                           T* __restrict__ out, int M, int K, int N) {
  using L = PfWarps<ROWS>;
  constexpr int MT = L::MT, NT8 = L::NT;
  constexpr int SLOT = pf_slot<T, FMT, ROWS>();
  constexpr int WBUF = pf_wbuf<T, FMT, ROWS>();
  constexpr int PARTS = pf_parts<T>();
  constexpr int NST = PF_STAGES;
  static_assert(NST >= 3, "a stage multiplied, one converted, one copied");
  static_assert(ROWS * PF_RED_PITCH * 4 <= NST * SLOT,
                "the block's sums must fit in the ring");
  extern __shared__ __align__(16) uint8_t smem_pf[];
  uint8_t* ring = smem_pf;
  uint8_t* wbufs = smem_pf + NST * SLOT;

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int wm = w / L::WN, wn = w % L::WN;
  const int n0 = blockIdx.x * COLS, m0 = blockIdx.y * ROWS;
  // the cluster's blocks split the K dimension's half superblocks: block
  // ``rank`` takes stages st0 .. st0 + nst - 1
  const int rank = blockIdx.z, ks = gridDim.z;
  const int halves = 2 * ((K + QK - 1) / QK);
  const int h0 = (int)((long long)halves * rank / ks);
  const int st0 = h0 * (PARTS / 2);
  const int nst = ((int)((long long)halves * (rank + 1) / ks) - h0) *
                  (PARTS / 2);
  const bool vec = K % (16 / (int)sizeof(T)) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // stages 0 .. NST - 2 in flight
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < nst)
      pf_issue<T, FMT, V, ROWS>(x, f, ring + st * SLOT, st0 + st, m0, M, K,
                                N, n0, tid, vec);
    cp_async_commit();
  }
  float acc[MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

  int slot = 0;
  if constexpr (sizeof(T) == 2) {
    // Stage s is multiplied while stage s + 1 is converted and stages s + 2
    // .. s + NST - 1 are copied: one barrier a stage.
    if (nst > 0) {
      cp_async_wait<NST - 2>();
      __syncthreads();
      // stage 0 (part st0 % PARTS), buffer 0
      pf_convert<T, FMT, ROWS>(ring, wbufs, tid, st0 % PARTS);
    }
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<NST - 3>();   // this thread's copies of stage s + 1
      __syncthreads();  // everyone's; stage s converted, s - 1 multiplied
      const int next = slot == NST - 1 ? 0 : slot + 1;
      const int fill = slot == 0 ? NST - 1 : slot - 1;   // stage s - 1's
      if (s + NST - 1 < nst)
        pf_issue<T, FMT, V, ROWS>(x, f, ring + fill * SLOT,
                                  st0 + s + NST - 1, m0, M, K, N, n0, tid,
                                  vec);
      cp_async_commit();
      if (s + 1 < nst)
        pf_convert<T, FMT, ROWS>(ring + next * SLOT,
                                 wbufs + ((s + 1) & 1) * WBUF, tid,
                                 (st0 + s + 1) % PARTS);
      pf_stage_mma<T, FMT, ROWS>(ring + slot * SLOT, wbufs + (s & 1) * WBUF,
                                 wm, wn, l, acc);
      slot = next;
    }
  } else {
    // f32 x: stage s is converted into the one buffer, then multiplied,
    // behind a barrier each, while stages s + 1 .. s + NST - 1 are copied
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<NST - 2>();   // this thread's copies of stage s
      __syncthreads();  // everyone's; stage s - 1 multiplied
      const int next = slot == NST - 1 ? 0 : slot + 1;
      const int fill = slot == 0 ? NST - 1 : slot - 1;   // stage s - 1's
      if (s + NST - 1 < nst)
        pf_issue<T, FMT, V, ROWS>(x, f, ring + fill * SLOT,
                                  st0 + s + NST - 1, m0, M, K, N, n0, tid,
                                  vec);
      cp_async_commit();
      pf_convert_f32<FMT, ROWS>(ring + slot * SLOT, wbufs, tid,
                                (st0 + s) % PARTS);
      __syncthreads();
      pf_stage_mma_f32<ROWS>(ring + slot * SLOT, wbufs, wm, wn, l, acc);
      slot = next;
    }
  }

  // acc[mt][nt]: rows m0 + (wm * MT + mt) * 16 + g (+ 8), columns n0 +
  // (wn * NT8 + nt) * 8 + 2t (+ 1)
  const int g = l >> 2, t = l & 3;
  if (ks == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const int n = n0 + (wn * NT8 + nt) * 8 + 2 * t;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + (wm * MT + mt) * 16 + g + 8 * h;
          if (m >= M) continue;
          const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if constexpr (sizeof(T) == 2)
            *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) =
                bf16x2(v0, v1);
          else
            *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
                make_float2(v0, v1);
        }
      }
    return;
  }

  // the cluster's blocks add their sums in rank order, each writing a slice
  // of the tile, four columns a load
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);   // 128 x PF_RED_PITCH
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            red + ((wm * MT + mt) * 16 + g + 8 * h) * PF_RED_PITCH +
            (wn * NT8 + nt) * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int NG = ROWS * COLS / 4;     // groups of four columns
  const int lo = NG * rank / ks, hi = NG * (rank + 1) / ks;
  for (int idx = lo + tid; idx < hi; idx += PF_THREADS) {
    const int r = idx / (COLS / 4), c = 4 * (idx % (COLS / 4));
    const int off = r * PF_RED_PITCH + c;
    float4 part[PF_MAX_KSPLIT];
#pragma unroll
    for (int sp = 0; sp < PF_MAX_KSPLIT; ++sp)
      if (sp < ks)
        part[sp] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, sp) + off);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < PF_MAX_KSPLIT; ++sp)
      if (sp < ks) {
        v.x += part[sp].x;
        v.y += part[sp].y;
        v.z += part[sp].z;
        v.w += part[sp].w;
      }
    if (m0 + r < M && n0 + c < N) {   // N % 4 == 0: all four columns
      T* o = out + (size_t)(m0 + r) * N + n0 + c;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint2*>(o) = make_uint2(bf16x2(v.x, v.y),
                                                  bf16x2(v.z, v.w));
      else
        *reinterpret_cast<float4*>(o) = v;
    }
  }
  cluster.sync();   // each block's shared memory stays until all have read it
}

// launches of qmatmul_experts_kernel, of the decode forms and of the
// prefill form, made by this library
long long g_experts_launches = 0;
long long g_decode_launches = 0;
long long g_prefill_launches = 0;

// One launch of a decode form: the column tiles along x, a cluster of
// ``ks`` blocks along y that split the superblocks.
template <typename T, typename Kernel>
cudaError_t launch_cluster(Kernel kernel, int threads, size_t smem,
                           const void* x, const Fields& f, void* out, int M,
                           int K, int N, int ks, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + COLS - 1) / COLS, ks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), f, static_cast<T*>(out), M, K,
      N);
  if (err != cudaSuccess) return err;
  ++g_decode_launches;
  return cudaSuccess;
}

// q4_k's decode form: a cluster of 1..MAX_KSPLIT blocks, each staging x's
// rows of its superblocks whole
template <typename T, int V>
cudaError_t launch_q4k_decode(const void* x, const Fields& f, void* out,
                              int M, int K, int N, int ks,
                              cudaStream_t stream) {
  auto kernel = qmatmul_q4k_decode_kernel<T, V>;
  const int S = (K + QK - 1) / QK;
  const size_t smem = decode_smem((S + ks - 1) / ks);
  if (ks < 1 || ks > MAX_KSPLIT || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  static size_t configured = 0;   // the largest size allowed so far
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  return launch_cluster<T>(kernel, NTHREADS, smem, x, f, out, M, K, N, ks,
                           stream);
}

// the tensor-core decode form (every format but q4_k): a cluster of
// 1..MD_MAX_KSPLIT blocks (a non-portable size past 8), each with its fixed
// ring of stages
template <typename T, int FMT, int V>
cudaError_t launch_mma_decode(const void* x, const Fields& f, void* out,
                              int M, int K, int N, int ks,
                              cudaStream_t stream) {
  auto kernel = qmatmul_mma_decode_kernel<T, FMT, V>;
  if (ks < 1 || ks > MD_MAX_KSPLIT) return cudaErrorInvalidValue;
  constexpr size_t smem = md_smem<T, FMT>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return launch_cluster<T>(kernel, MD_THREADS, smem, x, f, out, M, K, N, ks,
                           stream);
}

// Rows of x a tile of the prefill form: 64 where 128-row tiles would be
// at most PF_FEW_TILES (the smallest weights: more blocks, each half the
// products), else 128.
constexpr int PF_FEW_TILES = 8;
__host__ __device__ constexpr int pf_rows_for(int M, int N) {
  return ((N + COLS - 1) / COLS) * ((M + PF_ROWS - 1) / PF_ROWS) <=
                 PF_FEW_TILES
             ? 64
             : PF_ROWS;
}

// The prefill form (every format): ROWS x 128 output
// tiles, each a cluster of 1..PF_MAX_KSPLIT blocks along z that split its
// half superblocks
template <typename T, int FMT, int V, int ROWS>
cudaError_t launch_prefill_rows(const void* x, const Fields& f, void* out,
                                int M, int K, int N, int ks,
                                cudaStream_t stream) {
  auto kernel = qmatmul_prefill_kernel<T, FMT, V, ROWS>;
  constexpr size_t smem = pf_smem<T, FMT, ROWS>();
  static_assert(smem <= 227 * 1024, "a block's shared memory");
  const int row_tiles = (M + ROWS - 1) / ROWS;
  if (ks < 1 || ks > PF_MAX_KSPLIT || row_tiles > 65535)
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + COLS - 1) / COLS, row_tiles, ks);
  cfg.blockDim = dim3(PF_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), f,
                         static_cast<T*>(out), M, K, N);
  if (err != cudaSuccess) return err;
  ++g_prefill_launches;
  return cudaSuccess;
}

template <typename T, int FMT, int V>
cudaError_t launch_prefill(const void* x, const Fields& f, void* out, int M,
                           int K, int N, int ks, cudaStream_t stream) {
  return pf_rows_for(M, N) == 64
             ? launch_prefill_rows<T, FMT, V, 64>(x, f, out, M, K, N, ks,
                                                  stream)
             : launch_prefill_rows<T, FMT, V, PF_ROWS>(x, f, out, M, K, N, ks,
                                                       stream);
}

template <typename T, int ROWS, int FMT, int V>
cudaError_t launch_experts_rows(const void* x, const Fields& f, void* out,
                                int E, int M, int K, int N,
                                cudaStream_t stream) {
  auto kernel = qmatmul_experts_kernel<T, ROWS, FMT, V>;
  const size_t smem =
      experts_smem<ROWS, FMT>((K + stage_k(FMT) - 1) / stage_k(FMT));
  static size_t configured = 0;   // the largest size allowed so far
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const int row_tiles = (M + ROWS - 1) / ROWS;
  const dim3 grid((N + COLS - 1) / COLS, E * row_tiles);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), f, static_cast<T*>(out), M, K, N, row_tiles);
  ++g_experts_launches;
  return cudaSuccess;
}

// C = 1 keeps one row and all of x (up to XWHOLE_MAX bytes); C > 1 takes
// XROWS rows.  16-byte copies where N allows, else 4-byte ones.
template <typename T, int FMT>
cudaError_t launch_experts(const void* x, const Fields& f, void* out, int E,
                           int M, int K, int N, cudaStream_t stream) {
  constexpr int SK = stage_k(FMT);
  const bool whole = M == 1 && (size_t)((K + SK - 1) / SK) * SK * 4 <=
                                   XWHOLE_MAX;
  if (N % 16 == 0)
    return whole ? launch_experts_rows<T, 1, FMT, 16>(x, f, out, E, M, K, N,
                                                      stream)
                 : launch_experts_rows<T, XROWS, FMT, 16>(x, f, out, E, M, K,
                                                          N, stream);
  return whole ? launch_experts_rows<T, 1, FMT, 4>(x, f, out, E, M, K, N,
                                                   stream)
               : launch_experts_rows<T, XROWS, FMT, 4>(x, f, out, E, M, K, N,
                                                       stream);
}

#ifndef QMATMUL_FMT
#error "build with -DQMATMUL_FMT=<format id>"
#endif

// whether a (K, N) weight at M rows takes its format's decode form (q4_k:
// qmatmul_q4k_decode_kernel; the others: qmatmul_mma_decode_kernel); every
// other (K, N) weight takes the prefill form (qmatmul_prefill_kernel)
constexpr bool decode_form(int E, int M, int K) {
  return E == 1 && M <= DROWS && K <= DECODE_MAX_K;
}

template <typename T>
int launch_fmt(const void* x, const Fields& f, void* out, int E, int M,
               int K, int N, int splits, cudaStream_t st) {
  constexpr int F = QMATMUL_FMT;
  cudaError_t err;
  if (E > 1) {
    err = launch_experts<T, F>(x, f, out, E, M, K, N, st);
  } else if (decode_form(E, M, K)) {
    if constexpr (F == 0)
      err = N % 16 == 0
                ? launch_q4k_decode<T, 16>(x, f, out, M, K, N, splits, st)
                : launch_q4k_decode<T, 4>(x, f, out, M, K, N, splits, st);
    else
      err = N % 16 == 0
                ? launch_mma_decode<T, F, 16>(x, f, out, M, K, N, splits, st)
                : launch_mma_decode<T, F, 4>(x, f, out, M, K, N, splits, st);
  } else {
    err = N % 16 == 0
              ? launch_prefill<T, F, 16>(x, f, out, M, K, N, splits, st)
              : launch_prefill<T, F, 4>(x, f, out, M, K, N, splits, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = q4_k, 1 = q6_k, 2 = q3_k, 3 = q5_k, 4 = q2_k, 5 = q8_0, and
// must be the QMATMUL_FMT this library was built for; ``fields`` holds the
// format's ``nfields`` field pointers in the order of field_layout.  dtype
// of x and out: 0 = float32, 1 = bfloat16.  E experts: x (E, M, K), fields
// with a leading E, out (E, M, N); E = 1 for one weight.  Experts (E > 1)
// go to qmatmul_experts_kernel (``splits`` must be 1); one weight at M <=
// 4 (K <= 65536) to its format's decode form (qmatmul_q4k_decode_kernel
// for q4_k, qmatmul_mma_decode_kernel for the others), its stages split
// over a cluster of ``splits`` blocks (q4_k 1..8, the others 1..16); one
// weight at any other M or K to the prefill form (qmatmul_prefill_kernel,
// a cluster of 1..8 blocks a tile).  N must be a multiple of 4.  Returns
// cudaGetLastError() after the launch.
extern "C" int qmatmul(int fmt, int dtype, const void* x,
                       const void* const* fields, int nfields, void* out,
                       int E, int M, int K, int N, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt != QMATMUL_FMT || nfields != num_fields(fmt) || E < 1 ||
      (E > 1 && splits != 1))
    return (int)cudaErrorInvalidValue;
  Fields f{};
  for (int i = 0; i < nfields; ++i)
    f.p[i] = static_cast<const uint8_t*>(fields[i]);
  if (dtype == 0)
    return launch_fmt<float>(x, f, out, E, M, K, N, splits, st);
  if (dtype == 1)
    return launch_fmt<__nv_bfloat16>(x, f, out, E, M, K, N, splits, st);
  return (int)cudaErrorInvalidValue;
}

// How many times this library launched qmatmul_experts_kernel, its decode
// form (qmatmul_q4k_decode_kernel or qmatmul_mma_decode_kernel) and its
// prefill form (qmatmul_prefill_kernel): the card tests and chip_smoke.py
// read them to see which kernels ran.
extern "C" long long qmatmul_experts_kernel_launches(void) {
  return g_experts_launches;
}
extern "C" long long qmatmul_decode_kernel_launches(void) {
  return g_decode_launches;
}
extern "C" long long qmatmul_prefill_kernel_launches(void) {
  return g_prefill_launches;
}
