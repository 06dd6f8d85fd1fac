#!/usr/bin/env python3
"""Ablations of the MLA decode and prefill kernels, of the GQA prefill
kernel, of the q4_k, q6_k, q3_k, q5_k, q2_k and q8_0 decode forms and of
the prefill form (q4_k, q6_k, q3_k, q2_k, q8_0) on one CUDA card.

    python3 scripts/decode_ablation.py            # prints JSON lines
    python3 scripts/decode_ablation.py --only q6k_decode,mla_prefill
    python3 scripts/decode_ablation.py --only q4k_prefill,q6k_prefill
    python3 scripts/decode_ablation.py --only q3k_prefill,q8_0_prefill
    python3 scripts/decode_ablation.py --only q2k_prefill,gqa_prefill
    python3 scripts/decode_ablation.py --only q3k_decode
    python3 scripts/decode_ablation.py --only q2k_decode,q8_0_decode
    python3 scripts/decode_ablation.py --only q5k_decode

Builds variants of ``csrc/paged_mla.cu`` (``paged_mla_decode_kernel``) and
of ``csrc/qmatmul.cu`` for q4_k (``qmatmul_q4k_decode_kernel``), each the
source with one part of the kernel taken out by a text substitution, and
times every variant with CUDA events (20 calls queued behind a spin
kernel) at ``chip_smoke.py``'s shapes:

  MLA decode   4 lanes x 128 heads, R = 512, Dr = 64, 16-token pages, bf16
               and q8_0 pools, f32 queries: the serve case (lanes of
               100/217/333/400 tokens, a 32-page bucket) and the horizon
               (4 x 1,000 tokens, a 64-page bucket), at 6, 7 and 8 blocks a
               cluster; variants: the kernel, no tiles (launch, query tile
               and merge only), no scores, no p . c_kv, no conversion of
               the stage; and how many clusters of each size are resident
               at once (cudaOccupancyMaxActiveClusters).
  MLA prefill  ``chip_smoke.py``'s case (4 lanes of a 128-token chunk
               ending at 100/217/333/400 tokens, lane 0's chunk 60 tokens,
               128 heads, 16-token pages, q8_0 pools, bf16 queries);
               variants: the kernel (``paged_mla_prefill_kernel``), no mma
               (the operands still made), no conversion of the stage, no
               scores, no p . c_kv, no query tile, the page stream alone.
  GQA prefill  ``chip_smoke.py``'s case (4 lanes of a 128-token chunk
               ending at 100/217/333/400 tokens, lane 0's chunk 60 tokens,
               12 / 2 heads, D = 128, 16-token pages, bf16 queries), q8_0
               and q4_0 pools; variants: the kernel
               (``paged_attn_prefill_kernel``, also at clusters of 1, 2, 3,
               4, 6 and 8 blocks), no mma (the operands still made), no
               conversion of the stage, no scores, no p . V, no query
               tile, the page stream alone.
  q6_k decode  M = 4 bf16 at 8960->1536, 18432->7168, 1536->256,
               7168->576, 7168->129280 (``qmatmul_mma_decode_kernel`` at
               its ``decode_ksplit_q6k``); variants: the kernel, no mma (the
               operands still made), no conversion (codes not made into
               bf16 pairs), no x staging, the weight stream alone.
  q3_k decode  M = 4 bf16 at the DeepSeek cut's eight q3_k shapes (the
               same kernel's q3_k instance at ``decode_ksplit_q3k``);
               variants: the kernel, no mma, no conversion, the weight
               stream alone, and 3 or 4 blocks an SM asked of ptxas
               (``__launch_bounds__``); each variant's registers and
               spills.
  q2_k decode  M = 4 bf16 at the DeepSeek cut's four q2_k shapes (the
               kernel's q2_k instance at ``decode_ksplit_q2k``); variants:
               the kernel, the min term by one more mma a sub-block (in
               place of the sums of x from the B fragments), two
               superblocks a stage, four stages in the ring, no mma, no
               conversion, the weight stream alone; the variants that
               change the stage also at every cluster size of KS_SCAN;
               each variant's registers and spills.
  q5_k decode  M = 4 bf16 at its two served shapes (Q3_K_M's dense down
               18432->7168 and qwen2's down 8960->1536; the kernel's q5_k
               instance at ``decode_ksplit_q5k``); variants: the kernel
               (at every cluster size 1..16), no min term
               (``q5k_min_stage``), no mma, no conversion, the weight
               stream alone; each variant's registers and spills.
  q8_0 decode  M = 4 bf16 at the cut's nine q8_0 shapes (the output head
               included); variants: the kernel (4 blocks a stage, 3
               stages), 4 blocks x 4 stages, 8 blocks x 2 and x 3 stages
               (each also at every cluster size of KS_SCAN), no mma, no
               conversion, the weight stream alone.
  q4_k decode  M = 4 bf16 at 1536->1536, 1536->8960, 1536->152064,
               7168->18432, 16384->7168, 1536->24576, each at its K split
               (``decode_ksplit``) and at the other divisors of its
               superblocks; variants: the kernel, no compute, no x staging
               and no merge, neither (the weight stream alone), no barrier
               a stage; and the expert kernel (``qmatmul_experts_kernel``,
               C = 1) streaming the same fields of two 7168->9216 experts.

  q4_k, q6_k, q3_k, q2_k, q8_0 prefill  M = 512 (bf16 x; f32 x also at the
               first shape) at qwen2's and DeepSeek's 2-D shapes of the
               format (``qmatmul_prefill_kernel`` at its
               ``prefill_ksplit``, and at the other split sizes where the
               128-row tiles are fewer than the SMs); variants (of the
               bf16 path; the f32 one keeps its own): the kernel,
               128-row tiles only, 64-row tiles only, 64-row tiles of 4 x
               2 warps (16 x 64 each) instead of 2 x 4, the sub-blocks
               not unrolled, no scaling (each sub-block's products
               straight into the accumulators), no mma, the copies alone;
               each variant's ptxas registers and spills.

A variant that leaves work out computes a wrong result: only its time is
read (the prefill groups print each variant's error beside its time).  Weights rotate over copies of more than 120 MB, so that each call
reads them from HBM.  The builds go to ``src/repro_torch/_build/ablation``.
Needs ``nvcc`` (``CUDA_HOME``, ``/usr/local/cuda`` or the ``PATH``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core.apply import quantize_in_groups  # noqa: E402
from repro_torch.core.qtensor import QTensor, quantize  # noqa: E402
from repro_torch.kernels import build, paged_attn  # noqa: E402
from repro_torch.kernels import qmatmul as qm  # noqa: E402
from repro_torch.models import paged  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "src", "repro_torch", "_build", "ablation")

# cudaOccupancyMaxActiveClusters for the bf16 and q8_0 decode kernels
OCCUPANCY = r'''
extern "C" int resident_clusters(int kind, int R, int Dr, int bt_cap,
                                 int splits, int tiles, int lanes) {
  auto kernel = kind == 2 ? paged_mla_decode_kernel<2, 2>
                          : paged_mla_decode_kernel<1, 1>;
  const DecodeSmem L = decode_smem(kind, kind, R, Dr, bt_cap);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       L.total);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, lanes);
  cfg.blockDim = dim3(DNT);
  cfg.dynamicSmemBytes = L.total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess
             ? n : -1;
}
'''

MLA_VARIANTS = {
    "kernel": [],
    "no tiles": [("const int ntiles = (ntok + TT - 1) / TT;",
                  "const int ntiles = 0;")],
    "no scores": [("      for (int k = 0; k < kslice; k += 8) {",
                   "      for (int k = 0; k < 0; k += 8) {")],
    "no p.c_kv": [("        for (int t = 0; t < nt; ++t) {\n"
                   "          const float4 cv",
                   "        for (int t = 0; t < 0; ++t) {\n"
                   "          const float4 cv")],
    "no conversion": [("        for (int c = lane; c < nc; c += 32) {",
                       "        for (int c = lane; c < 0; c += 32) {")],
}
NO_COMPUTE = ("    q4k_stage_rows4(ring + slot * STAGE, xs + s * QK, xstride, "
              "xsum + 8 * s,\n                    nsb * 8, w, l, acc);", "")
NO_X = ("  for (int g0 = tid; g0 < nload; g0 += XB * NTHREADS) {",
        "  for (int g0 = tid; g0 < 0; g0 += XB * NTHREADS) {")
NO_MERGE = ("  const int lo = n_out * rank / ks, hi = n_out * (rank + 1) / ks;\n"
            "  for (int idx = lo + tid; idx < hi; idx += NTHREADS) {",
            "  const int lo = 0, hi = 0;\n"
            "  for (int idx = lo + tid; idx < hi; idx += NTHREADS) {")
NO_BARRIER = ("    __syncthreads();  // everyone's; stage s - 1 is consumed "
              "(and xsum made)", "")
Q4_VARIANTS = {
    "kernel": [],
    "no compute": [NO_COMPUTE],
    "no x, no merge": [NO_X, NO_MERGE],
    "weight stream only": [NO_COMPUTE, NO_X, NO_MERGE],
    "no barrier a stage": [NO_BARRIER],
}


# the q6_k decode kernel (qmatmul_mma_decode_kernel<T, 1, V>): its mma, its
# code conversion, its x staging
Q6_NO_MMA = ("      for (int u = 0; u < NT; ++u) mma_bf16(d, a, b[u][0], b[u][1]);",
             "      for (int u = 0; u < NT; ++u) d[u & 3] += __uint_as_float("
             "(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[u][0] ^ b[u][1]) & 0x3FFFFFFFu);")
Q6_NO_CONVERSION = [
    ("      const uint32_t a[4] = {code_pair(w[0][0][k], sel, bias),\n"
     "                             code_pair(w[0][1][k], sel, bias),\n"
     "                             code_pair(w[1][0][k], sel, bias),\n"
     "                             code_pair(w[1][1][k], sel, bias)};",
     "      const uint32_t a[4] = {w[0][0][k] ^ sel, w[0][1][k], w[1][0][k], "
     "w[1][1][k]};")]
Q6_NO_X = ("      const bool in = xr < M && k < K;",
           "      const bool in = false;")
Q6_NO_COMPUTE = ("    mma_decode_stage<T, FMT>(stage, reinterpret_cast<const "
                 "T*>(stage + W),\n                             valid(s), "
                 "half, j0, g, t, acc);", "")
Q6_NO_MERGE = ("  const int lo = n_out * rank / ks, hi = n_out * (rank + 1) / ks;\n"
               "  for (int idx = lo + tid; idx < hi; idx += MD_THREADS) {",
               "  const int lo = 0, hi = 0;\n"
               "  for (int idx = lo + tid; idx < hi; idx += MD_THREADS) {")
Q6_VARIANTS = {
    "kernel": [],
    "no mma": [Q6_NO_MMA],
    "no conversion": Q6_NO_CONVERSION,
    "no x staging": [Q6_NO_X],
    "weight stream only": [Q6_NO_COMPUTE, Q6_NO_X, Q6_NO_MERGE],
}
# the same kernel's q3_k instance (qmatmul_mma_decode_kernel<T, 2, V>), also
# with 3 or 4 blocks an SM asked of the register allocator
MD_BOUNDS = ("__global__ void __launch_bounds__(MD_THREADS, 2)\n"
             "    qmatmul_mma_decode_kernel(")
Q3_VARIANTS = {
    "kernel": [],
    "no mma": [Q6_NO_MMA],
    "no conversion": Q6_NO_CONVERSION,
    "weight stream only": [Q6_NO_COMPUTE, Q6_NO_X, Q6_NO_MERGE],
    "3 blocks an SM": [(MD_BOUNDS, MD_BOUNDS.replace(", 2)", ", 3)"))],
    "4 blocks an SM": [(MD_BOUNDS, MD_BOUNDS.replace(", 2)", ", 4)"))],
}
# the same kernel's q2_k instance (FMT 4): two superblocks a stage, four
# stages in the ring, and its min term as one more mma a sub-block (A the
# column's m in every element, summed in the tensor core) in place of the
# sums of x from the B fragments
Q2_MIN_MMA = [
    ("    if constexpr (FMT == 4) md_xsums<T>(b, t, xs0, xs1);", ""),
    ("        const float ma = code_f32(m0, c) - kMagic;\n"
     "        const float mb = code_f32(m1, c) - kMagic;\n"
     "        pmin[c][0] = fmaf(ma, xs0, pmin[c][0]);\n"
     "        pmin[c][1] = fmaf(ma, xs1, pmin[c][1]);\n"
     "        pmin[c][2] = fmaf(mb, xs0, pmin[c][2]);\n"
     "        pmin[c][3] = fmaf(mb, xs1, pmin[c][3]);",
     "        const uint32_t msel = 0x4040u | (c << 8) | c;\n"
     "        const uint32_t lo = code_pair(m0, msel, Q4_BIAS);\n"
     "        const uint32_t hi = code_pair(m1, msel, Q4_BIAS);\n"
     "        const uint32_t am[4] = {lo, hi, lo, hi};\n"
     "#pragma unroll\n"
     "        for (int u = 0; u < NT; ++u) mma_bf16(pmin[c], am, b[u][0], "
     "b[u][1]);")]
Q2_TWO_SB = ("constexpr int MD_Q2_SUPERBLOCKS = 1;",
             "constexpr int MD_Q2_SUPERBLOCKS = 2;")
MD_RING = "constexpr int MD_STAGES = 3;"
Q2_VARIANTS = {
    "kernel": [],
    "min term by an mma": Q2_MIN_MMA,
    "two superblocks a stage": [Q2_TWO_SB],
    "four stages": [(MD_RING, MD_RING.replace("3;", "4;"))],
    "no mma": [Q6_NO_MMA],
    "no conversion": Q6_NO_CONVERSION,
    "weight stream only": [Q6_NO_COMPUTE, Q6_NO_X, Q6_NO_MERGE],
}
# its q8_0 instance (FMT 5): blocks a stage and stages in the ring (4 x 3:
# 128 rows, 62 KB at bf16; 4 x 4; 8 x 2: 256 rows, 81 KB; 8 x 3: one block
# an SM), and parts taken out
Q8_BLOCKS = "constexpr int MD_Q8_BLOCKS = 4;"
Q8_VARIANTS = {
    "kernel": [],
    "4 blocks x 4 stages": [(MD_RING, MD_RING.replace("3;", "4;"))],
    "8 blocks x 2 stages": [(Q8_BLOCKS, Q8_BLOCKS.replace("4;", "8;")),
                            (MD_RING, MD_RING.replace("3;", "2;"))],
    "8 blocks x 3 stages": [(Q8_BLOCKS, Q8_BLOCKS.replace("4;", "8;"))],
    "no mma": [(
        "        for (int u = 0; u < NT; ++u) mma_bf16(d[c], a, b[u][0], "
        "b[u][1]);",
        "        for (int u = 0; u < NT; ++u) d[c][u & 3] += __uint_as_float("
        "(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[u][0] ^ b[u][1]) & 0x3FFFFFFFu);")],
    "no conversion": [(
        "        const uint32_t a[4] = {q8_pair(mag[0][0][q], sgn[0][0][q], "
        "sel),",
        "        const uint32_t a[4] = {mag[0][0][q] ^ sel, mag[0][1][q], "
        "mag[1][0][q], mag[1][1][q]};\n        const uint32_t a_[4] = "
        "{q8_pair(mag[0][0][q], sgn[0][0][q], sel),")],
    "weight stream only": [Q6_NO_COMPUTE, Q6_NO_X, Q6_NO_MERGE],
}
# its q5_k instance (FMT 3): its min term (q5k_min_stage and x's sub-block
# sums) left out, and parts taken out
Q5_NO_MIN = [("      if (mr < M)\n        q5k_min_stage<T>(stage,",
              "      if (false)\n        q5k_min_stage<T>(stage,")]
Q5_VARIANTS = {
    "kernel": [],
    "no min term": Q5_NO_MIN,
    "no mma": [Q6_NO_MMA],
    "no conversion": Q6_NO_CONVERSION,
    "weight stream only": [Q6_NO_COMPUTE, Q6_NO_X, Q6_NO_MERGE, *Q5_NO_MIN],
}
# the variants of the q2_k and q8_0 groups that change the stage, whose
# cluster size is scanned (the rules were fitted to the kernel's stage)
STAGE_SCAN = ("kernel", "two superblocks a stage", "four stages",
              "4 blocks x 4 stages", "8 blocks x 2 stages",
              "8 blocks x 3 stages")
KS_SCAN = (1, 2, 3, 4, 6, 8, 12, 16)


# the MLA prefill kernel
PF_NO_MMA = [
    ("                mma_bf16(d[j], qf[u], kf[2 * jt], kf[2 * jt + 1]);",
     "                d[j][u & 3] += __uint_as_float((qf[u][0] ^ qf[u][3] ^ "
     "kf[2 * jt] ^ kf[2 * jt + 1]) & 0x3FFFFFFFu);"),
    ("              mma_bf16(d, pf[kk][u], vf[kk][2 * jt], vf[kk][2 * jt + "
     "1]);",
     "              d[u & 3] += __uint_as_float((pf[kk][u][0] ^ pf[kk][u][3] "
     "^ vf[kk][2 * jt] ^ vf[kk][2 * jt + 1]) & 0x3FFFFFFFu);")]
PF_NO_CONVERSION = ("      for (int r = w; r < PKT; r += PNT / 32) {",
                    "      for (int r = w; r < 0; r += PNT / 32) {")
PF_NO_SCORES = ("    scores(0, nkc, sc);\n    scores(nkc, nkc + nkr, sr);", "")
PF_NO_PV = ("    for (int cp = 0; cp < MAXP; ++cp) {\n      if (p0 + cp < p1) {",
            "    for (int cp = 0; cp < 0; ++cp) {\n      if (p0 + cp < p1) {")
PF_NO_Q = [("  if (!QF32 && a.qcopy) {", "  if (false) {"),
           ("  if (QF32 || !a.qcopy) {", "  if (false) {")]
PF_VARIANTS = {
    "kernel": [],
    "no mma": PF_NO_MMA,
    "no conversion": [PF_NO_CONVERSION],
    "no scores": [PF_NO_SCORES],
    "no p.c_kv": [PF_NO_PV],
    "no query tile": PF_NO_Q,
    "page stream only": [PF_NO_CONVERSION, PF_NO_SCORES, PF_NO_PV, *PF_NO_Q],
}


# the GQA prefill kernel
GQ_NO_MMA = [
    ("            } else {\n"
     "              mma_bf16(d[j], qf[0], k[0][h][c], k[0][h][c + 1]);",
     "            } else {\n"
     "              d[j][c] += __uint_as_float((qf[0][0] ^ qf[0][3] ^ "
     "k[0][h][c] ^ k[0][h][c + 1]) & 0x3FFFFFFFu);"),
    ("                mma_bf16(d, pf[kk][u], vf[0][kk][c], vf[0][kk][c + 1]);",
     "                d[u] += __uint_as_float((pf[kk][u][0] ^ pf[kk][u][3] "
     "^ vf[0][kk][c] ^ vf[0][kk][c + 1]) & 0x3FFFFFFFu);")]
GQ_NO_CONVERSION = ("      for (int r = w; r < PKT; r += PNT / 32) {\n"
                    "        for (int ch = lane; ch < nck + ncv; ch += 32) {",
                    "      for (int r = w; r < 0; r += PNT / 32) {\n"
                    "        for (int ch = lane; ch < nck + ncv; ch += 32) {")
GQ_NO_SCORES = ("    for (int kg = 0; kg < nkd; kg += KG) {",
                "    for (int kg = 0; kg < 0; kg += KG) {")
GQ_NO_PV = ("    for (int cp = 0; cp < NV / 2; ++cp) {\n      if (cp < nvp) {\n"
            "        uint32_t vf[NQ][2][4];",
            "    for (int cp = 0; cp < 0; ++cp) {\n      if (cp < nvp) {\n"
            "        uint32_t vf[NQ][2][4];")
GQ_VARIANTS = {
    "kernel": [],
    "no mma": GQ_NO_MMA,
    "no conversion": [GQ_NO_CONVERSION],
    "no scores": [GQ_NO_SCORES],
    "no p.V": [GQ_NO_PV],
    "no query tile": PF_NO_Q,
    "page stream only": [GQ_NO_CONVERSION, GQ_NO_SCORES, GQ_NO_PV, *PF_NO_Q],
}


# the prefill form (qmatmul_prefill_kernel): its warp layout, the unroll of
# a stage's sub-blocks, and parts taken out
PRE_NO_MMA = ("          mma_bf16(d[nt], a[0], b[kk][nt][0], b[kk][nt][1]);",
              "          d[nt][kk] += __uint_as_float((a[0][0] ^ a[0][3] ^ "
              "b[kk][nt][0] ^ b[kk][nt][1]) & 0x3FFFFFFFu);")
PRE_NO_CONVERT = ("      if (s + 1 < nst)\n        pf_convert<T, FMT, ROWS>(",
                  "      if (false)\n        pf_convert<T, FMT, ROWS>(")
PRE_NO_MULTIPLY = ("      pf_stage_mma<T, FMT, ROWS>(ring + slot * SLOT, wbufs + "
                   "(s & 1) * WBUF,\n                                 wm, wn, "
                   "l, acc);", "")
WARPS64 = [("static constexpr int WN = ROWS == 128 ? 2 : 4;",
            "static constexpr int WN = 2;")]
# each sub-block's products straight into the accumulators, unscaled
PRE_NO_SCALE = [
    ("          mma_bf16(d[nt], a[0], b[kk][nt][0], b[kk][nt][1]);",
     "          mma_bf16(acc[mt][nt], a[0], b[kk][nt][0], b[kk][nt][1]);"),
    ("      for (int nt = 0; nt < NT8; ++nt) {\n        float (&o)[4]",
     "      for (int nt = 0; nt < 0; ++nt) {\n        float (&o)[4]")]
ROWS128 = [("  return pf_rows_for(M, N) == 64\n", "  return false\n")]
ROWS64 = [("  return pf_rows_for(M, N) == 64\n", "  return true\n")]
UNROLL1 = [("constexpr int PF_UNROLL = 2;", "constexpr int PF_UNROLL = 1;")]
PRE_VARIANTS = {
    "kernel": [],
    "128-row tiles": ROWS128,
    "64-row tiles": ROWS64,
    "64-row tiles of 4 x 2 warps": WARPS64,
    "sub-blocks not unrolled": UNROLL1,
    "no scaling": PRE_NO_SCALE,
    "no mma": [PRE_NO_MMA],
    "copies only": [PRE_NO_CONVERT, PRE_NO_MULTIPLY],
}
# the variants whose cluster size is scanned at the shapes of few tiles
# (fewer 128-row tiles at M = 512 than SMs)
PRE_SCAN = ("kernel", "128-row tiles", "64-row tiles")
# (K, N) at M = 512: qwen2's and DeepSeek's 2-D weights of the format
# (q3_k: the DeepSeek cut's under Q3_K_M and Q2_K_L; q2_k: the cut's under
# Q2_K_L; q8_0: qwen2's gate/up and the cut's under Q8_0)
PRE_SHAPES = {"q4_k": ((1536, 1536), (1536, 8960), (7168, 18432),
                       (16384, 7168), (7168, 2048)),
              "q6_k": ((1536, 256), (8960, 1536), (7168, 576),
                       (18432, 7168)),
              "q3_k": ((7168, 1536), (7168, 576), (7168, 18432),
                       (18432, 7168), (7168, 2048)),
              "q2_k": ((7168, 1536), (1536, 24576), (7168, 18432),
                       (7168, 2048)),
              "q8_0": ((1536, 8960), (7168, 576), (7168, 18432),
                       (18432, 7168), (7168, 2048))}


def start_build(source: str, name: str, subs, flags=(), append: str = ""):
    text = open(os.path.join(CSRC, source)).read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old[:60]!r} not in {source}")
        text = text.replace(old, new)
    if append:
        i = text.rindex("}  // namespace")
        text = text[:i + len("}  // namespace")] + "\n" + append + text[
            i + len("}  // namespace"):]
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, name + ".cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    cmd = [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", *flags,
           "-I", CSRC, "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def device_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mla_case(gen, live, nj):
    """4 lanes of ``live`` tokens in an ``nj``-page bucket."""
    dev = torch.device("cuda")
    B, H, R, DR, P = 4, 128, 512, 64, 16
    n_lp = [-(-n // P) for n in live]
    bt = torch.full((B, nj), paged.GARBAGE_PAGE, dtype=torch.int32)
    nxt = 2
    for b in range(B):
        for j in range(n_lp[b]):
            bt[b, j] = nxt
            nxt += 1
    ckv = torch.randn((nxt, P, R), generator=gen, device=dev)
    kr = torch.randn((nxt, P, DR), generator=gen, device=dev)
    pools = {"bf16": (1, ckv.to(torch.bfloat16), kr.to(torch.bfloat16),
                      None, None)}
    cq, cd = paged.quantize_rows(ckv, "q8_0")
    kq, kd = paged.quantize_rows(kr, "q8_0")
    pools["q8_0"] = (2, cq, kq, cd, kd)
    return dict(bt=bt.to(dev), nj=nj, pools=pools,
                pos=torch.tensor([n - 1 for n in live], dtype=torch.int32,
                                 device=dev),
                lp=torch.tensor(n_lp, dtype=torch.int32, device=dev),
                qe=torch.randn((B, H, R), generator=gen, device=dev),
                qr=torch.randn((B, H, DR), generator=gen, device=dev))


def mla(libs, gen) -> dict:
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    res = {}
    out = torch.empty((4, 128, 512), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for case, live, nj in (("serve", [100, 217, 333, 400], 32),
                           ("horizon", [1000] * 4, 64)):
        c = mla_case(gen, live, nj)
        for kind, (kid, ckv, kr, cd, kd) in c["pools"].items():
            for splits in (6, 7, 8):
                for name, lib in libs.items():
                    fn = lib.paged_mla_decode
                    fn.argtypes = [i, i, i] + [v] * 10 + [i] * 8 + [f, v]

                    def call():
                        return fn(kid, kid, 0, c["qe"].data_ptr(),
                                  c["qr"].data_ptr(), ckv.data_ptr(),
                                  kr.data_ptr(), build.ptr(cd),
                                  build.ptr(kd), c["bt"].data_ptr(),
                                  c["pos"].data_ptr(), c["lp"].data_ptr(),
                                  out.data_ptr(), 4, 128, 512, 64, 16, nj, nj,
                                  splits, 0.07, stream)
                    if call() != 0:
                        raise SystemExit(f"MLA {name} refused")
                    res[f"{case} {kind} splits={splits} {name}"] = \
                        device_ms(call)
    occ = libs["kernel"].resident_clusters
    occ.restype = i
    for kid, kind in ((1, "bf16"), (2, "q8_0")):
        for splits in (6, 7, 8):
            res[f"resident clusters, {kind}, {splits} blocks"] = occ(
                kid, 512, 64, 8, splits, 8, 4)
    return res


def q4k(libs, gen) -> dict:
    v, i = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for k, n in ((1536, 1536), (1536, 8960), (1536, 152064), (7168, 18432),
                 (16384, 7168), (1536, 24576)):
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        qt = quantize(w, "q4_k")
        del w
        copies = [qt] + [QTensor({a: b.clone() for a, b in qt.fields.items()},
                                 qt.fmt, qt.shape)
                         for _ in range(math.ceil(120e6 / qt.packed_bytes())
                                        - 1)]
        ptrs = [(v * 5)(*[c.fields[f].data_ptr()
                          for f in qm.FIELDS["q4_k"]]) for c in copies]
        x = torch.randn((4, k), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((4, n), dtype=torch.bfloat16, device=dev)
        s = -(-k // 256)
        chosen = qm.decode_ksplit(n, k, build.sm_count(dev))
        splits = sorted({d for d in range(1, min(8, s) + 1) if s % d == 0
                         and -(-s // d) <= 32} | {chosen})
        for name, lib in libs.items():
            fn = lib.qmatmul
            fn.argtypes = [i, i, v, ctypes.POINTER(v), i, v] + [i] * 5 + [v]
            for ks in splits if name == "kernel" else (chosen,):
                it = [0]

                def call():
                    it[0] = (it[0] + 1) % len(ptrs)
                    return fn(0, 1, x.data_ptr(), ptrs[it[0]], 5,
                              out.data_ptr(), 1, 4, k, n, ks, stream)
                if call() != 0:
                    raise SystemExit(f"q4_k {name} refused")
                mark = " (decode_ksplit)" if ks == chosen else ""
                res[f"{k}->{n} ks={ks}{mark} {name}"] = device_ms(call)
        del copies, qt, ptrs
        torch.cuda.empty_cache()
    # the expert kernel streaming the same fields: E = 2, C = 1
    e, k, n = 2, 7168, 9216
    qt = quantize_in_groups(
        lambda r: torch.randn((len(r), k, n), generator=gen, device=dev)
        / math.sqrt(k), e, "q4_k", group=1, dim=0)
    x = torch.randn((e, 1, k), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((e, 1, n), dtype=torch.bfloat16, device=dev)
    fn = libs["kernel"].qmatmul
    ptrs = (v * 5)(*[qt.fields[f].data_ptr() for f in qm.FIELDS["q4_k"]])
    res[f"experts E={e} C=1 {k}->{n} ({qt.packed_bytes() / 1e6:.1f} MB)"] = \
        device_ms(lambda: fn(0, 1, x.data_ptr(), ptrs, 5, out.data_ptr(), e,
                             1, k, n, 1, stream))
    return res


def q6k(libs, gen) -> dict:
    return mma_decode(libs, gen, "q6_k", (
        (8960, 1536), (18432, 7168), (1536, 256), (7168, 576),
        (7168, 129280)))


def q3k(libs, gen) -> dict:
    return mma_decode(libs, gen, "q3_k", (
        (7168, 576), (7168, 1536), (1536, 24576), (7168, 2048), (2048, 7168),
        (7168, 18432), (16384, 7168), (18432, 7168)))


def q5k(libs, gen) -> dict:
    return mma_decode(libs, gen, "q5_k", ((18432, 7168), (8960, 1536)),
                      scan=("kernel",), sizes=range(1, 17))


def q2k(libs, gen) -> dict:
    return mma_decode(libs, gen, "q2_k", (
        (7168, 1536), (1536, 24576), (7168, 18432), (7168, 2048)),
        scan=STAGE_SCAN)


def q80(libs, gen) -> dict:
    return mma_decode(libs, gen, "q8_0", (
        (7168, 1536), (1536, 24576), (7168, 576), (16384, 7168),
        (7168, 18432), (18432, 7168), (7168, 2048), (2048, 7168),
        (7168, 129280)), scan=STAGE_SCAN)


def mma_decode(libs, gen, fmt: str, shapes, scan=(), sizes=KS_SCAN) -> dict:
    """The tensor-core decode form of ``fmt`` at M = 4, bf16, at its split
    rule's cluster size (the kernel also at 8, the portable size); the
    variants named in ``scan`` at every cluster size of ``sizes`` up to the
    stages of the kernel (or of twice its stage, a variant that doubles
    it)."""
    v, i = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fid, nf = build.QMATMUL_FORMATS.index(fmt), len(qm.FIELDS[fmt])
    res = {}
    for k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        qt = quantize(w, fmt)
        del w
        copies = [qt] + [QTensor({a: b.clone() for a, b in qt.fields.items()},
                                 qt.fmt, qt.shape)
                         for _ in range(math.ceil(120e6 / qt.packed_bytes())
                                        - 1)]
        ptrs = [(v * nf)(*[c.fields[f].data_ptr()
                           for f in qm.FIELDS[fmt]]) for c in copies]
        x = torch.randn((4, k), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((4, n), dtype=torch.bfloat16, device=dev)
        chosen = qm.DECODE_KSPLIT[fmt](n, k, build.sm_count(dev))
        for name, lib in libs.items():
            fn = lib.qmatmul
            fn.argtypes = [i, i, v, ctypes.POINTER(v), i, v] + [i] * 5 + [v]
            # the kernel also at the portable cluster size, 8
            ks_set = ({chosen, min(8, chosen)} if name == "kernel"
                      else {chosen})
            if name in scan:
                ks_set |= {c for c in sizes
                           if c <= qm.decode_stages(fmt, k)}
            for ks in sorted(ks_set):
                it = [0]

                def call():
                    it[0] = (it[0] + 1) % len(ptrs)
                    return fn(fid, 1, x.data_ptr(), ptrs[it[0]], nf,
                              out.data_ptr(), 1, 4, k, n, ks, stream)
                if call() != 0:
                    raise SystemExit(f"{fmt} {name} refused")
                mark = " (decode_ksplit)" if ks == chosen else ""
                res[f"{k}->{n} ks={ks}{mark} {name}"] = device_ms(call)
        del copies, qt, ptrs
        torch.cuda.empty_cache()
    return res


def mla_prefill(libs, gen) -> dict:
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    B, C, H, R, DR, P, nj = 4, 128, 128, 512, 64, 16, 64
    live = [100, 217, 333, 400]
    bt = torch.full((B, nj), paged.GARBAGE_PAGE, dtype=torch.int32)
    nxt = 2
    for b in range(B):
        for j in range(-(-live[b] // P)):
            bt[b, j] = nxt
            nxt += 1
    qp = torch.stack([torch.arange(n - C, n) for n in live]).to(torch.int32)
    qp[0, :C - 60] = -1
    cq, cd = paged.quantize_rows(
        torch.randn((nxt, P, R), generator=gen, device=dev), "q8_0")
    kq, kd = paged.quantize_rows(
        torch.randn((nxt, P, DR), generator=gen, device=dev), "q8_0")
    qe = torch.randn((B, C, H, R), generator=gen, device=dev).to(
        torch.bfloat16)
    qr = torch.randn((B, C, H, DR), generator=gen, device=dev).to(
        torch.bfloat16)
    bt, qp = bt.to(dev), qp.to(dev)
    out = torch.empty((B, C, H, R), device=dev)
    res = {}
    for name, lib in libs.items():
        fn = lib.paged_mla_prefill
        fn.argtypes = [i, i, i] + [v] * 9 + [i] * 8 + [f, v]

        def call():
            return fn(2, 2, 1, qe.data_ptr(), qr.data_ptr(), cq.data_ptr(),
                      kq.data_ptr(), cd.data_ptr(), kd.data_ptr(),
                      bt.data_ptr(), qp.data_ptr(), out.data_ptr(), B, C, H,
                      R, DR, P, nj, nj, 192 ** -0.5, stream)
        if call() != 0:
            raise SystemExit(f"MLA prefill {name} refused")
        res[name] = device_ms(call, iters=5)
    return res


def gqa_prefill(libs, gen) -> dict:
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    B, C, H, HKV, D, P, nj = 4, 128, 12, 2, 128, 16, 64
    live = [100, 217, 333, 400]
    bt = torch.full((B, nj), paged.GARBAGE_PAGE, dtype=torch.int32)
    pos_pool = torch.full((2 + sum(-(-n // P) for n in live), P), -1,
                          dtype=torch.int32)
    nxt = 2
    for b in range(B):
        for j in range(-(-live[b] // P)):
            bt[b, j] = nxt
            hi = min(P, live[b] - j * P)
            pos_pool[nxt, :hi] = torch.arange(j * P, j * P + hi)
            nxt += 1
    qp = torch.stack([torch.arange(n - C, n) for n in live]).to(torch.int32)
    qp[0, :C - 60] = -1
    q = torch.randn((B, C, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    bt, qp, pos_pool = bt.to(dev), qp.to(dev), pos_pool.to(dev)
    out = torch.empty((B, C, H, D), device=dev)
    chosen = paged_attn.attn_prefill_tiles(B, C, H, HKV, nj=nj, page_size=P,
                                           sms=build.sm_count(dev))[1]
    res = {}
    for mode in ("q8_0", "q4_0"):
        kq, kd = paged.quantize_rows(torch.randn(
            (nxt, P, HKV, D), generator=gen, device=dev), mode)
        vq, vd = paged.quantize_rows(torch.randn(
            (nxt, P, HKV, D), generator=gen, device=dev), mode)
        kind = 2 if mode == "q8_0" else 3
        for name, lib in libs.items():
            fn = lib.paged_attn_prefill
            fn.argtypes = [i, i] + [v] * 9 + [i] * 11 + [f, f, v]
            for splits in (1, 2, 3, 4, 6, 8) if name == "kernel" else (
                    chosen,):
                def call():
                    return fn(kind, 1, q.data_ptr(), kq.data_ptr(),
                              vq.data_ptr(), kd.data_ptr(), vd.data_ptr(),
                              pos_pool.data_ptr(), bt.data_ptr(),
                              qp.data_ptr(), out.data_ptr(), B, C, H, HKV, D,
                              D, P, nj, nj, splits, 0, D ** -0.5, 0.0,
                              stream)
                if call() != 0:
                    raise SystemExit(f"GQA prefill {name} refused")
                mark = " (attn_prefill_tiles)" if splits == chosen else ""
                res[f"{mode} splits={splits}{mark} {name}"] = device_ms(call)
    return res


def prefill(fmt: str):
    """The prefill form of ``fmt`` at M = 512 (bf16 x; f32 x at the first
    shape), each shape at its ``prefill_ksplit``: every variant's time and
    its largest error relative to max|y| of the plain version (a variant
    that leaves work out is wrong by design)."""
    def run(libs, gen) -> dict:
        v, i = ctypes.c_void_p, ctypes.c_int
        dev = torch.device("cuda")
        stream = torch.cuda.current_stream().cuda_stream
        nf = len(qm.FIELDS[fmt])
        fid = build.QMATMUL_FORMATS.index(fmt)
        res = {}
        for j, (k, n) in enumerate(PRE_SHAPES[fmt]):
            w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
            qt = quantize(w, fmt)
            del w
            copies = [qt] + [
                QTensor({a: b.clone() for a, b in qt.fields.items()},
                        qt.fmt, qt.shape)
                for _ in range(math.ceil(120e6 / qt.packed_bytes()) - 1)]
            ptrs = [(v * nf)(*[c.fields[f].data_ptr()
                               for f in qm.FIELDS[fmt]]) for c in copies]
            ks0 = qm.prefill_ksplit(n, 512, k, build.sm_count(dev))
            halves = 2 * -(-k // 256)
            for dt in (torch.bfloat16, torch.float32) if j == 0 else (
                    torch.bfloat16,):
                x = torch.randn((512, k), generator=gen, device=dev).to(dt)
                ref = qm.qmatmul_plain(x, qt).float()
                out = torch.empty((512, n), dtype=dt, device=dev)
                did = 1 if dt == torch.bfloat16 else 0
                for name, lib in libs.items():
                    fn = lib.qmatmul
                    fn.argtypes = [i, i, v, ctypes.POINTER(v), i, v] + \
                        [i] * 5 + [v]
                    scan = (ks0,)
                    if (name in PRE_SCAN and -(-n // 128) * 4
                            < build.sm_count(dev)):
                        scan = sorted({ks0} | {c for c in (1, 2, 3, 4, 6, 8)
                                               if c <= halves})
                    for ks in scan:
                        it = [0]

                        def call():
                            it[0] = (it[0] + 1) % len(ptrs)
                            return fn(fid, did, x.data_ptr(), ptrs[it[0]],
                                      nf, out.data_ptr(), 1, 512, k, n, ks,
                                      stream)
                        it[0] = len(ptrs) - 1
                        if call() != 0:
                            raise SystemExit(f"{fmt} prefill {name} refused")
                        torch.cuda.synchronize()
                        err = ((out.float() - ref).abs().max()
                               / ref.abs().max()).item()
                        mark = " (prefill_ksplit)" if ks == ks0 else ""
                        key = f"{k}->{n} ks={ks}{mark} {str(dt)[6:]} {name}"
                        res[key] = {"ms": device_ms(call), "rel_err": err}
            del copies, qt, ptrs
            torch.cuda.empty_cache()
        return res
    return run


# group -> (source, library name prefix, variants, nvcc flags, run)
GROUPS = {
    "mla_decode": ("paged_mla.cu", "mla_", MLA_VARIANTS, (), mla),
    "q4k_decode": ("qmatmul.cu", "q4k_", Q4_VARIANTS,
                   ("-DQMATMUL_FMT=0",), q4k),
    "q6k_decode": ("qmatmul.cu", "q6k_", Q6_VARIANTS,
                   ("-DQMATMUL_FMT=1",), q6k),
    "q3k_decode": ("qmatmul.cu", "q3k_", Q3_VARIANTS,
                   ("-DQMATMUL_FMT=2", "-Xptxas", "-v"), q3k),
    "q5k_decode": ("qmatmul.cu", "q5k_", Q5_VARIANTS,
                   ("-DQMATMUL_FMT=3", "-Xptxas", "-v"), q5k),
    "q2k_decode": ("qmatmul.cu", "q2k_", Q2_VARIANTS,
                   ("-DQMATMUL_FMT=4", "-Xptxas", "-v"), q2k),
    "q8_0_decode": ("qmatmul.cu", "q80_", Q8_VARIANTS,
                    ("-DQMATMUL_FMT=5", "-Xptxas", "-v"), q80),
    "mla_prefill": ("paged_mla.cu", "mlap_", PF_VARIANTS, (), mla_prefill),
    "gqa_prefill": ("paged_attn.cu", "gqap_", GQ_VARIANTS,
                    ("-Xptxas", "-v"), gqa_prefill),
    "q4k_prefill": ("qmatmul.cu", "q4kp_", PRE_VARIANTS,
                    ("-DQMATMUL_FMT=0", "-Xptxas", "-v"), prefill("q4_k")),
    "q6k_prefill": ("qmatmul.cu", "q6kp_", PRE_VARIANTS,
                    ("-DQMATMUL_FMT=1", "-Xptxas", "-v"), prefill("q6_k")),
    "q3k_prefill": ("qmatmul.cu", "q3kp_", PRE_VARIANTS,
                    ("-DQMATMUL_FMT=2", "-Xptxas", "-v"), prefill("q3_k")),
    "q2k_prefill": ("qmatmul.cu", "q2kp_", PRE_VARIANTS,
                    ("-DQMATMUL_FMT=4", "-Xptxas", "-v"), prefill("q2_k")),
    "q8_0_prefill": ("qmatmul.cu", "q80p_", PRE_VARIANTS,
                     ("-DQMATMUL_FMT=5", "-Xptxas", "-v"), prefill("q8_0")),
}


# the groups whose ptxas lines of qmatmul_mma_decode_kernel are printed
MMA_DECODE_GROUPS = ("q3k_decode", "q5k_decode", "q2k_decode",
                     "q8_0_decode")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated subset of {','.join(GROUPS)}")
    groups = [g for g in ap.parse_args().only.split(",") if g]
    if set(groups) - set(GROUPS):
        raise SystemExit(f"decode_ablation: unknown group in {groups}")
    if not torch.cuda.is_available():
        raise SystemExit("decode_ablation: needs a CUDA card")
    jobs = {}
    for group in groups:
        source, prefix, variants, flags, _ = GROUPS[group]
        for j, (name, subs) in enumerate(variants.items()):
            append = OCCUPANCY if (group, name) == ("mla_decode",
                                                    "kernel") else ""
            jobs[group, name] = start_build(source, prefix + str(j), subs,
                                            flags=flags, append=append)
    libs = {group: {} for group in groups}
    for (group, name), (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {group} {name}:\n{log}")
        libs[group][name] = ctypes.CDLL(lib)
        if group.endswith("_prefill") or group in MMA_DECODE_GROUPS:
            lines = log.splitlines()
            key = "mma_decode" if group in MMA_DECODE_GROUPS else "prefill"
            regs = [lines[j + 2].strip() + " " + lines[j + 3].strip()
                    for j, line in enumerate(lines[:-3])
                    if "Compiling entry" in line and key in line]
            print(json.dumps({"ptxas": f"{group} {name}", "kernels": regs}),
                  flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for group in groups:
        print(json.dumps({"ablation": group,
                          "ms": GROUPS[group][4](libs[group], gen)}),
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
