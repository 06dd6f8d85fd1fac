#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py                 # every phase, as the checks run it
    python3 chip_smoke.py --phases build,kernels

Phases (each prints JSON lines; any failure raises, exit code != 0):

  1. build    — compile every CUDA library of the port from this checkout
                (one nvcc process each, started together).
  2. kernels  — each kernel against its plain PyTorch version on the card at
                the main paths' shapes (qwen2-1.5b and DeepSeek-V3 under
                DQ3_K_M, Q3_K_M, Q2_K_L and Q8_0, P=16), the attention
                kernels with each tile loader the serves use (bf16, q8_0,
                q4_0 pools; MLA also q8_0 latents beside q4_0 rope keys;
                every expert form also with the decode's routing, 32 of
                256 experts live, where no expert kernel reads an empty
                expert), with times, the roofline bound and the
                stated tolerance (B1 also at every 2-D shape the DeepSeek
                cut multiplies by q3_k, q2_k or q8_0 at a chunk's 512 rows,
                and at a decode step's 1 and 4 rows, q5_k at both of its
                served shapes at 1, 4 and 512 rows; B1's
                M = 512 lines also carry ``gemm_ms``, a bf16 torch.matmul
                by the weight already dequantized, for context); the GQA
                and MLA decodes also at the engine's horizon (4 lanes x
                1,000 tokens, a 64-page bucket), each on a line of its own.
  3. parity   — full width, f32, weights from one seed, card (kernels)
                against CPU (plain versions): qwen2-1.5b at depth 2 (a
                64-token prefill chunk, 4 decode steps) under DQ3_K_M with
                model-dtype and q8_0 pools, at depth 3 with q4_0 and dq
                pools, and under Q3_K_M and Q8_0 with model-dtype pools;
                DeepSeek-V3 at depth 4 (3 dense + 1 MoE layer; an 8-token
                chunk, 2 decode steps) under DQ3_K_M with model-dtype, q8_0
                and dq pools and under Q2_K_L with model-dtype pools.
  4. serve    — 8 greedy requests through the engine, weights made and
                quantized on the card: qwen2-1.5b at full width and depth
                under DQ3_K_M, then the DeepSeek-V3 cut at full width and 7
                layers (3 dense + 4 MoE) under DQ3_K_M, each with q8_0,
                bf16, q4_0 and dq pools (dq with the quant probe), and the
                cut under Q4_K_M, Q3_K_M, Q2_K_L and Q8_0 with q8_0 pools.
                Every
                kernel of each path must have been launched in its run
                (and each 2-D format of the path, q5_k under Q3_K_M
                included, must have taken its decode form),
                and the DeepSeek weights must pack to the reference size
                calculator's bytes; one traced 4 x 128-token prefill
                chunk (``prefill_profile``) and one traced decode step
                (``decode_profile``) per path and pool kind (q8_0, bf16,
                dq) say where the time goes.

The last three lines are the ``{"kernels": [...]}`` summary, the card's name
and power limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``.  It needs one CUDA card and imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

PHASES = ("build", "kernels", "parity", "serve")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, op_type: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_ms(torch, prof, calls: int) -> dict:
    """Each kernel ``prof`` recorded over ``calls`` identical calls: key ->
    (device ms per call, launches per call).  The ms are the kernel's mean
    time over the launches recorded, times its launches per call: CUPTI
    has been seen to miss some of a session's launches, and the session's
    sum over ``calls`` then fell short."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count:
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            per_call = max(1, round(ev.count / calls))
            out[ev.key] = (us / 1e3 / ev.count * per_call, per_call)
    return out


def profiler_ready(torch, tries: int = 10) -> bool:
    """Whether ``torch.profiler`` records device activity, waiting for it
    up to ``tries`` sessions of a few bf16 matmuls: CUPTI has been seen to
    record none in a process's first sessions."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.ones((2048, 2048), dtype=torch.bfloat16, device="cuda")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                a @ a
            torch.cuda.synchronize()
        if kernel_ms(torch, prof, 20):
            return True
        time.sleep(1.0)
    return False


# GPU clock cycles of the spin that the timed calls queue behind (~50 ms)
SPIN_CYCLES = 100_000_000


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call of ``fn`` (ms): CUDA events around ``iters``
    calls, after a warm-up call.  The calls are queued behind a spin
    kernel, so the host's time to launch them is not counted, unless a
    call waits for the card itself (the plain expert path reads which
    experts are used).  CUDA events, not ``torch.profiler``: on the card's
    machine CUPTI missed some or all of a session's launches in some
    runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# every kernel of the main paths: C++ source, and the Pallas kernel it
# replaces
KERNELS = {
    "qmatmul_q4_k": ("src/repro_torch/csrc/qmatmul.cu",
                     "src/repro/kernels/common.py:82"),
    "qmatmul_q6_k": ("src/repro_torch/csrc/qmatmul.cu",
                     "src/repro/kernels/common.py:82"),
    # the same wrappers' prefill form (qmatmul_prefill_kernel, M > 4): its
    # launches are its library's count, not the wrapper's
    "qmatmul_q4_k_prefill": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/common.py:82"),
    "qmatmul_q6_k_prefill": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/common.py:82"),
    "qmatmul_q3_k_prefill": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/q3_k.py:27"),
    "qmatmul_q5_k_prefill": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/q5_k.py:25"),
    "qmatmul_q2_k_prefill": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/q2_k.py:26"),
    "qmatmul_q8_0_prefill": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/q8_0.py:23"),
    "qmatmul_q3_k": ("src/repro_torch/csrc/qmatmul.cu",
                     "src/repro/kernels/q3_k.py:27"),
    "qmatmul_q5_k": ("src/repro_torch/csrc/qmatmul.cu",
                     "src/repro/kernels/q5_k.py:25"),
    "qmatmul_q2_k": ("src/repro_torch/csrc/qmatmul.cu",
                     "src/repro/kernels/q2_k.py:26"),
    "qmatmul_q8_0": ("src/repro_torch/csrc/qmatmul.cu",
                     "src/repro/kernels/q8_0.py:23"),
    "paged_attn_decode": ("src/repro_torch/csrc/paged_attn.cu",
                          "src/repro/kernels/paged_attn.py:267"),
    "paged_attn_decode_quant": ("src/repro_torch/csrc/paged_attn.cu",
                                "src/repro/kernels/paged_attn.py:267"),
    "paged_attn_prefill_quant": ("src/repro_torch/csrc/paged_attn.cu",
                                 "src/repro/kernels/paged_attn.py:831"),
    "qmatmul_experts_q3_k": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/common.py:82"),
    "qmatmul_experts_q4_k": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/common.py:82"),
    "qmatmul_experts_q6_k": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/common.py:82"),
    "qmatmul_experts_q5_k": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/q5_k.py:25"),
    "qmatmul_experts_q2_k": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/q2_k.py:26"),
    "qmatmul_experts_q8_0": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/q8_0.py:23"),
    "paged_mla_decode": ("src/repro_torch/csrc/paged_mla.cu",
                         "src/repro/kernels/paged_attn.py:535"),
    "paged_mla_decode_quant": ("src/repro_torch/csrc/paged_mla.cu",
                               "src/repro/kernels/paged_attn.py:535"),
    "paged_mla_prefill_quant": ("src/repro_torch/csrc/paged_mla.cu",
                                "src/repro/kernels/paged_attn.py:982"),
    # B5: the q4_0 tile loaders of B3, B4, B6 and B7 (the reference unpacks
    # with unpack_q4_rows :692 inside each kernel's loader)
    "paged_attn_decode_quant_q4_0": ("src/repro_torch/csrc/paged_attn.cu",
                                     "src/repro/kernels/paged_attn.py:267"),
    "paged_attn_prefill_quant_q4_0": ("src/repro_torch/csrc/paged_attn.cu",
                                      "src/repro/kernels/paged_attn.py:831"),
    "paged_mla_decode_quant_q4_0": ("src/repro_torch/csrc/paged_mla.cu",
                                    "src/repro/kernels/paged_attn.py:535"),
    "paged_mla_decode_quant_q8_0_q4_0": ("src/repro_torch/csrc/paged_mla.cu",
                                         "src/repro/kernels/paged_attn.py:535"),
    "paged_mla_prefill_quant_q4_0": ("src/repro_torch/csrc/paged_mla.cu",
                                     "src/repro/kernels/paged_attn.py:982"),
    "paged_mla_prefill_quant_q8_0_q4_0": (
        "src/repro_torch/csrc/paged_mla.cu",
        "src/repro/kernels/paged_attn.py:982"),
}
# the rows of the quantized attention wrappers, one per tile loader: the
# wrapper and its ``loaders`` key (the mode, or the MLA (latent, rope) pair)
Q8, Q4, MIXED = ("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q8_0", "q4_0")
LOADER_ROWS = {
    "paged_attn_decode_quant": ("paged_attn_decode_quant", "q8_0"),
    "paged_attn_decode_quant_q4_0": ("paged_attn_decode_quant", "q4_0"),
    "paged_attn_prefill_quant": ("paged_attn_prefill_quant", "q8_0"),
    "paged_attn_prefill_quant_q4_0": ("paged_attn_prefill_quant", "q4_0"),
    "paged_mla_decode_quant": ("paged_mla_decode_quant", Q8),
    "paged_mla_decode_quant_q4_0": ("paged_mla_decode_quant", Q4),
    "paged_mla_decode_quant_q8_0_q4_0": ("paged_mla_decode_quant", MIXED),
    "paged_mla_prefill_quant": ("paged_mla_prefill_quant", Q8),
    "paged_mla_prefill_quant_q4_0": ("paged_mla_prefill_quant", Q4),
    "paged_mla_prefill_quant_q8_0_q4_0": ("paged_mla_prefill_quant", MIXED),
}


def launch_counters() -> dict:
    """Each summary row's launch count: the wrapper's ``launches``, or for
    a quantized attention row the count of its tile loader."""
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.kernels import qmatmul as qm

    out = {}
    for name in KERNELS:
        if name.endswith("_prefill"):
            continue
        if name in LOADER_ROWS:
            fn, key = LOADER_ROWS[name]
            out[name] = getattr(pa, fn).loaders[key]
        else:
            out[name] = getattr(qm, name, None) or getattr(pa, name)
    return out


def kernel_entry(name: str, **measured) -> dict:
    """One kernel's entry of the summary line, with every key present;
    ``launches`` stays null unless the serve phase ran."""
    source, replaces = KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "shape": None, "launches": None,
             "max_abs_err": None, "max_rel_err": None, "tol": None,
             "tol_of": None, "ms": None, "kernel_ms": None, "plain_ms": None,
             "bound_ms": None, "bound_by": None, "library_ms": None}
    entry.update(measured)
    return entry


def case(shape: str, y, ref, tol: float, tol_of: str, ms: float,
         plain_ms: float, moved: float, ops: float, op_type: str) -> dict:
    """One timed case: errors against the plain version, times, bound.
    No single PyTorch call computes any of these functions, so
    ``library_ms`` is null."""
    err = (y.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    b_ms, b_by = bound(moved, ops, op_type)
    res = {"shape": shape, "max_abs_err": err, "max_rel_err": rel,
           "tol": tol, "tol_of": tol_of, "ms": ms, "kernel_ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    if not res[tol_of] <= tol:
        fail(f"{shape}: {tol_of} {res[tol_of]} > {tol}")
    return res


# (K, N, format, what it is in the 28-layer qwen2 model or the DeepSeek
# cut, and under which policy where it is not DQ3_K_M)
B1_SHAPES = [(1536, 1536, "q4_k", "q_proj, o_proj"),
             (1536, 256, "q6_k", "k_proj, v_proj"),
             (1536, 8960, "q4_k", "gate, up"),
             (8960, 1536, "q6_k", "down"),
             (1536, 152064, "q4_k", "tied head"),
             (7168, 18432, "q4_k", "DeepSeek dense gate, up"),
             (16384, 7168, "q4_k", "DeepSeek attn_output"),
             (18432, 7168, "q6_k", "DeepSeek dense down"),
             (7168, 576, "q6_k", "DeepSeek attn_kv_a_mqa"),
             (7168, 129280, "q6_k", "DeepSeek output"),
             (7168, 2048, "q3_k", "DeepSeek shexp gate, up, Q3_K_M"),
             (7168, 1536, "q3_k", "DeepSeek attn_q_a, Q3_K_M"),
             (18432, 7168, "q5_k", "DeepSeek dense down, Q3_K_M"),
             (8960, 1536, "q5_k", "qwen2 down, Q3_K_M"),
             (1536, 24576, "q2_k", "DeepSeek attn_q_b, Q2_K_L"),
             (7168, 18432, "q2_k", "DeepSeek dense gate, up, Q2_K_L"),
             (1536, 8960, "q8_0", "qwen2 gate, up, Q8_0"),
             (7168, 18432, "q8_0", "DeepSeek dense gate, up, Q8_0")]
B1_ROWS = (1, 4, 512)
# the other 2-D weights that the DeepSeek cut multiplies by the decode form
# of q3_k (Q3_K_M, Q2_K_L), q2_k (Q2_K_L) or q8_0 (Q8_0, the output head
# included) at a decode step, timed at M = 1 and 4 only (their M = 512 form
# is timed below)
B1_DECODE_SHAPES = [
    (7168, 576, "q3_k", "DeepSeek attn_kv_a_mqa, Q3_K_M"),
    (1536, 24576, "q3_k", "DeepSeek attn_q_b, Q3_K_M"),
    (7168, 18432, "q3_k", "DeepSeek dense gate, up, Q3_K_M"),
    (2048, 7168, "q3_k", "DeepSeek shexp down, Q2_K_L"),
    (16384, 7168, "q3_k", "DeepSeek attn_output, Q2_K_L"),
    (18432, 7168, "q3_k", "DeepSeek dense down, Q2_K_L"),
    (7168, 1536, "q2_k", "DeepSeek attn_q_a, Q2_K_L"),
    (7168, 2048, "q2_k", "DeepSeek shexp gate, up, Q2_K_L"),
    (7168, 1536, "q8_0", "DeepSeek attn_q_a, Q8_0"),
    (1536, 24576, "q8_0", "DeepSeek attn_q_b, Q8_0"),
    (7168, 576, "q8_0", "DeepSeek attn_kv_a_mqa, Q8_0"),
    (16384, 7168, "q8_0", "DeepSeek attn_output, Q8_0"),
    (18432, 7168, "q8_0", "DeepSeek dense down, Q8_0"),
    (7168, 2048, "q8_0", "DeepSeek shexp gate, up, Q8_0"),
    (2048, 7168, "q8_0", "DeepSeek shexp down, Q8_0"),
    (7168, 129280, "q8_0", "DeepSeek output, Q8_0")]
B1_DECODE_ROWS = (1, 4)
# the other 2-D weights that the DeepSeek cut multiplies by the prefill
# form's q3_k (Q3_K_M, Q2_K_L), q2_k (Q2_K_L) and q8_0 (Q8_0) at a chunk's
# 512 rows, timed at M = 512 only (their M <= 4 form is the one timed above)
B1_PREFILL_SHAPES = [
    (1536, 24576, "q3_k", "DeepSeek attn_q_b, Q3_K_M"),
    (7168, 576, "q3_k", "DeepSeek attn_kv_a_mqa, Q3_K_M"),
    (7168, 18432, "q3_k", "DeepSeek dense gate, up, Q3_K_M"),
    (16384, 7168, "q3_k", "DeepSeek attn_output, Q2_K_L"),
    (18432, 7168, "q3_k", "DeepSeek dense down, Q2_K_L"),
    (2048, 7168, "q3_k", "DeepSeek shexp down, Q2_K_L"),
    (7168, 1536, "q2_k", "DeepSeek attn_q_a, Q2_K_L"),
    (7168, 2048, "q2_k", "DeepSeek shexp gate, up, Q2_K_L"),
    (7168, 1536, "q8_0", "DeepSeek attn_q_a, Q8_0"),
    (1536, 24576, "q8_0", "DeepSeek attn_q_b, Q8_0"),
    (7168, 576, "q8_0", "DeepSeek attn_kv_a_mqa, Q8_0"),
    (16384, 7168, "q8_0", "DeepSeek attn_output, Q8_0"),
    (18432, 7168, "q8_0", "DeepSeek dense down, Q8_0"),
    (7168, 2048, "q8_0", "DeepSeek shexp gate, up, Q8_0"),
    (2048, 7168, "q8_0", "DeepSeek shexp down, Q8_0")]
# the case that stands for each format in the summary line: the decode
# shape (M = 4, bf16) that moves most of the format's weight bytes per step
# on its path; for the prefill form, the chunk shape (M = 512, bf16) with
# the most device time a chunk: qwen2's for q4_k and q6_k, the DeepSeek
# cut's dense gate/up for q3_k (Q3_K_M), q2_k (Q2_K_L) and q8_0 (Q8_0), its
# dense down for q5_k (Q3_K_M)
B1_PREFILL_SUMMARY = {"q4_k": (512, 1536, 8960), "q6_k": (512, 8960, 1536),
                      "q3_k": (512, 7168, 18432),
                      "q5_k": (512, 18432, 7168),
                      "q2_k": (512, 7168, 18432),
                      "q8_0": (512, 7168, 18432)}
B1_SUMMARY = {"q4_k": (4, 1536, 8960), "q6_k": (4, 8960, 1536),
              "q3_k": (4, 7168, 1536), "q5_k": (4, 18432, 7168),
              "q2_k": (4, 7168, 18432), "q8_0": (4, 7168, 18432)}
# DeepSeek-V3 expert weights (E = 256): (K, N, what they are).  C = 1 is an
# expert's capacity at decode (4 lanes x top-8 / 256, at least 1), C = 20
# at a 4 x 128-token prefill chunk (1.25 x 512 x 8 / 256).
EXPERTS = 256
EXPERT_SHAPES = [(7168, 2048, "gate_exps, up_exps"), (2048, 7168, "down_exps")]
EXPERT_ROWS = (1, 20)
# the case that stands for each expert format in the summary line: C = 1,
# the shape of the format's experts in the DeepSeek cut under DQ3_K_M (q3_k:
# gate/up of every MoE layer; q4_k, q6_k: down of the 3rd / 1st-2nd MoE
# layers), Q2_K_L (q2_k: gate/up) and Q8_0 (q8_0: gate/up, as down);
# no policy puts q5_k on experts
EXPERT_SUMMARY = {"q3_k": (7168, 2048), "q4_k": (2048, 7168),
                  "q6_k": (2048, 7168), "q5_k": (7168, 2048),
                  "q2_k": (7168, 2048), "q8_0": (7168, 2048)}
# decode routing: at 4 lanes x top-8 at most 32 of the 256 experts have a
# row, the rest are zero; every expert form is timed that way too, at
# seeded positions, and the formats whose expert kernel skips empty experts
# must give them the plain version's +0 bitwise
LIVE_EXPERTS = 32
SKIPS_EMPTY = ("q3_k", "q2_k", "q4_k", "q6_k", "q5_k", "q8_0")
B1_TOL = 8e-3      # bf16 output: one bf16 ulp (2^-8) of the largest value
B1_TOL_F32 = 1e-5  # f32 output: f32 summation order only
ATTN_TOL = 1e-5    # f32 output: summation order and the online softmax;
# the q4_0 loaders dequantize each element bitwise as the plain version


def phase_kernels(torch, summary: dict) -> None:
    from repro_torch.core.qtensor import QTensor, quantize
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.kernels import qmatmul as qm
    from repro_torch.models import paged
    from repro_torch.serving.engine import _bucket_pages

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    detail = []
    for k, n, fmt, use, rows in (
            [(*c, B1_ROWS) for c in B1_SHAPES]
            + [(*c, B1_DECODE_ROWS) for c in B1_DECODE_SHAPES]
            + [(*c, (max(B1_ROWS),)) for c in B1_PREFILL_SHAPES]):
        name = f"qmatmul_{fmt}"
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        qt = quantize(w, fmt)
        del w
        wbytes = qt.packed_bytes()
        # rotate over enough weight copies that each launch reads its
        # weights from HBM, not from the 50 MB L2, as a decode step does
        copies = [qt] + [QTensor({kk: v.clone() for kk, v in
                                  qt.fields.items()}, qt.fmt, qt.shape)
                         for _ in range(math.ceil(120e6 / wbytes) - 1)]
        kern = qm.KERNELS[fmt]
        for m in rows:
            for dt in (torch.bfloat16, torch.float32) if m == 4 else (
                    torch.bfloat16,):
                dt_name = str(dt).split(".")[-1]
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                y = kern(x, qt)
                ref = qm.qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                if y.shape != (m, n) or y.dtype != dt:
                    fail(f"{name} shape/dtype {y.shape} {y.dtype}")
                i = [0]

                def run_kernel():
                    i[0] = (i[0] + 1) % len(copies)
                    kern(x, copies[i[0]])
                ms = device_ms(torch, run_kernel)
                plain_ms = device_ms(
                    torch, lambda: qm.qmatmul_plain(x, qt), iters=3)
                res = case(
                    f"M={m} K={k} N={n} {dt_name} ({use})", y, ref,
                    B1_TOL if dt == torch.bfloat16 else B1_TOL_F32,
                    "max_rel_err", ms, plain_ms,
                    wbytes + nbytes(x) + m * n * x.element_size(),
                    2.0 * m * k * n, dt_name)
                extra = {}
                if m == max(B1_ROWS):
                    # context only: a bf16 GEMM of x by the weight already
                    # dequantized to bf16 (no function of the port)
                    wb = qt.dequantize(torch.bfloat16)
                    xb = x.to(torch.bfloat16)
                    extra["gemm_ms"] = device_ms(
                        torch, lambda: torch.matmul(xb, wb))
                    del wb, xb
                detail.append(dict(res, kernel=name, **extra))
                if (m, k, n) == B1_SUMMARY.get(fmt) and dt == torch.bfloat16:
                    summary[name] = kernel_entry(name, **res)
                if ((m, k, n) == B1_PREFILL_SUMMARY.get(fmt)
                        and dt == torch.bfloat16):
                    summary[f"{name}_prefill"] = kernel_entry(
                        f"{name}_prefill", **res)
        del copies, qt
        torch.cuda.empty_cache()

    # --- paged attention as the serve phase calls it -----------------------
    # its engine: max_len 1024 (block tables 64 wide); decode bounds the page
    # loop by the engine's power-of-two bucket of the live horizon, prefill
    # passes no bound
    B, H, HKV, D, P, max_len = 4, 12, 2, 128, 16, 1024
    live = torch.tensor([100, 217, 333, 400], dtype=torch.int32)
    nj = paged.pages_for(max_len, P)
    n_lp = (live + P - 1) // P
    num_pages = 2 + int(n_lp.sum())
    bt = torch.full((B, nj), paged.GARBAGE_PAGE, dtype=torch.int32)
    pos_pool = torch.full((num_pages, P), -1, dtype=torch.int32)
    nxt = 2
    for i in range(B):
        for lp in range(int(n_lp[i])):
            bt[i, lp] = nxt
            hi = min(P, int(live[i]) - lp * P)
            pos_pool[nxt, :hi] = torch.arange(lp * P, lp * P + hi)
            nxt += 1
    pos = live - 1
    # every lane's page loop stops at its own pages, short of the bucket
    lane_pages = n_lp.clone().to(torch.int32)
    active = _bucket_pages(int(n_lp.max()), nj)
    bt, pos_pool, pos, lane_pages = (t.to(dev) for t in (bt, pos_pool, pos,
                                                         lane_pages))
    q = torch.randn((B, H, D), generator=gen, device=dev)
    kf = torch.randn((num_pages, P, HKV, D), generator=gen, device=dev)
    vf = torch.randn((num_pages, P, HKV, D), generator=gen, device=dev)
    quantized = {mode: (*paged.quantize_rows(kf, mode),
                        *paged.quantize_rows(vf, mode))
                 for mode in paged.KV_QUANT_MODES}
    visited = int(n_lp.sum())
    # the queries and the arithmetic are f32 (the results must agree with
    # the plain version to 1e-5), so f32 is the peak that bounds the ops
    attn_ops = 4.0 * H * D * float(live.sum())
    tok_bytes = {"float32": 2 * HKV * D * 4, "bfloat16": 2 * HKV * D * 2,
                 "q8_0": 2 * HKV * (D + 4), "q4_0": 2 * HKV * (D // 2 + 4)}
    cases = [
        ("paged_attn_decode", "float32", (kf, vf), None),
        ("paged_attn_decode", "bfloat16",
         (kf.to(torch.bfloat16), vf.to(torch.bfloat16)), None),
        ("paged_attn_decode_quant", "q8_0", quantized["q8_0"], "q8_0"),
        ("paged_attn_decode_quant_q4_0", "q4_0", quantized["q4_0"], "q4_0"),
    ]
    for name, kv_type, kv, mode in cases:
        res = time_decode(
            torch, name, q, kv, mode, pos_pool, bt, pos, lane_pages, active,
            int(live.sum()) * tok_bytes[kv_type] + visited * (4 + P * 4),
            attn_ops, f"B={B} H={H} Hkv={HKV} D={D} P={P} live "
            f"{live.tolist()} active_pages={active} table {nj} wide, "
            f"{kv_type} pages")
        detail.append(dict(res, kernel=name))
        if kv_type != "float32":        # the serve path's pool types
            summary[name] = kernel_entry(name, **res)
    decode_horizon(torch, gen, cases[1:])

    # prefill: a 128-token chunk per lane, ending at each lane's frontier;
    # lane 0's chunk is short (padded rows have qpos = -1); queries drawn in
    # f32 (so the f32 case runs all three bf16 terms of each), the serve's
    # bf16 queries the same values rounded
    C = 128
    qp = torch.stack([torch.arange(int(p) - C + 1, int(p) + 1) for p in live - 1])
    qp[0, :C - 60] = -1
    qp = qp.to(torch.int32).to(dev)
    qc = torch.randn((B, C, H, D), generator=gen, device=dev)
    queries = {torch.float32: qc, torch.bfloat16: qc.to(torch.bfloat16)}
    valid_q = (qp >= 0).sum(dim=1).cpu()
    keys = sum(int(v) * (int(p) + 1) - int(v) * (int(v) - 1) // 2
               for v, p in zip(valid_q, live - 1))      # causal pairs
    # the tensor-core kernel: the function's operations bound it at the
    # bf16 peak (its bytes bound it first); beside that bound, the former
    # f32 CUDA-core one and the mma passes it runs over its whole tiles of
    # (query, rep head) rows and keys (the scores with f32 queries as three
    # bf16 terms, P . V as three), each row tile walking the keys up to its
    # rows' largest position
    ops = 4.0 * H * D * keys
    rep, rows, kt = H // HKV, pa._PREFILL_ROWS, pa._PREFILL_KEYS
    qmax = torch.stack([qp[:, r0 // rep:min(C, -(-(r0 + rows) // rep))]
                        .amax(dim=1) for r0 in range(0, C * rep, rows)])
    key_tiles = int((torch.clamp(qmax.to(torch.int64) + 1, 0, nj * P)
                     + kt - 1).div(kt, rounding_mode="floor").sum()) * HKV
    for name, mode, qdt in (
            ("paged_attn_prefill_quant", "q8_0", torch.bfloat16),
            ("paged_attn_prefill_quant", "q8_0", torch.float32),
            ("paged_attn_prefill_quant_q4_0", "q4_0", torch.bfloat16),
            ("paged_attn_prefill_quant_q4_0", "q4_0", torch.float32)):
        qq = queries[qdt]
        args = (qq, *quantized[mode], pos_pool, bt, qp)

        def plain():
            return pa.attn_prefill_plain(
                qq, quantized[mode], pos_pool, bt, qp, window=0,
                softcap=0.0, scale=D ** -0.5, nj=nj, quant=mode)
        y = pa.paged_attn_prefill_quant(*args, mode=mode)
        ref = plain()
        torch.cuda.synchronize()
        ms = device_ms(torch, lambda: pa.paged_attn_prefill_quant(
            *args, mode=mode))
        plain_ms = device_ms(torch, plain, iters=5)
        moved = (int(live.sum()) * tok_bytes[mode] + nbytes(qq, qp)
                 + visited * (4 + P * 4) + B * C * H * D * 4)
        q_terms = 3 if qdt == torch.float32 else 1
        mma_ops = key_tiles * rows * kt * (2.0 * D * q_terms + 3 * 2.0 * D)
        qname = str(qdt).split(".")[-1]
        res = case(f"B={B} C={C} H={H} Hkv={HKV} D={D} P={P} live "
                   f"{live.tolist()} table {nj} wide, {mode} pages, {qname} "
                   f"queries", y, ref, ATTN_TOL, "max_abs_err", ms, plain_ms,
                   moved, ops, "bfloat16")
        if qdt == torch.bfloat16:      # the serve passes bf16 queries
            summary[name] = kernel_entry(name, **res)
        # the other bounds go on the detail line only
        detail.append(dict(res, kernel=name,
                           bound_f32_ms=ops / PEAK_OPS["float32"] * 1e3,
                           mma_pass_ms=mma_ops / PEAK_OPS["bfloat16"] * 1e3,
                           bytes_ms=moved / HBM_BYTES_S * 1e3))
    del kf, vf, quantized, qc, queries
    kernels_experts(torch, summary, detail, gen)
    kernels_mla(torch, summary, detail, gen, live, n_lp, num_pages, bt, pos,
                lane_pages, active, nj, qp)
    emit({"phase": "kernels", "detail": detail})


def time_decode(torch, name, q, kv, mode, pos_pool, bt, pos, lane_pages,
                active, kv_bytes, ops, shape) -> dict:
    """One GQA decode case (B2, B3 or B5a by ``mode``): the kernel against
    its plain version, timed; ``kv_bytes`` are the live K/V rows and the
    visited pages' table entries and positions, to which the bound adds
    q, pos, lane_pages and the output."""
    from repro_torch.kernels import paged_attn as pa

    fn = pa.paged_attn_decode_quant if mode else pa.paged_attn_decode
    kw = dict(active_pages=active, lane_pages=lane_pages)
    if mode:
        kw["mode"] = mode

    def plain():
        return pa.attn_decode_plain(
            q, kv, pos_pool, bt, pos, lane_pages, window=0, softcap=0.0,
            scale=q.shape[-1] ** -0.5, nj=active, quant=mode)
    y = fn(q, *kv, pos_pool, bt, pos, **kw)
    ref = plain()
    torch.cuda.synchronize()
    if y.shape != q.shape:
        fail(f"{name} ({shape}): shape {y.shape}")
    ms = device_ms(torch, lambda: fn(q, *kv, pos_pool, bt, pos, **kw),
                   iters=20)
    moved = kv_bytes + nbytes(q, pos, lane_pages) + q.numel() * 4
    return case(shape, y, ref, ATTN_TOL, "max_abs_err", ms,
                device_ms(torch, plain), moved, ops, "float32")


def decode_horizon(torch, gen, cases) -> None:
    """The GQA decode (B2, B3, B5a) at the engine's horizon: 4 lanes of
    1,000 tokens each (63 pages of 16) in a 64-page bucket, the length a
    max_len 1024 serve reaches; one detail line, not in the summary."""
    from repro_torch.models import paged

    dev = torch.device("cuda")
    B, H, HKV, D, P, n_tok = 4, 12, 2, 128, 16, 1000
    nj = paged.pages_for(1024, P)
    n_lp = -(-n_tok // P)
    num_pages = 2 + B * n_lp
    bt = torch.full((B, nj), paged.GARBAGE_PAGE, dtype=torch.int32)
    bt[:, :n_lp] = 2 + torch.arange(B * n_lp, dtype=torch.int32).reshape(
        B, n_lp)
    pos_pool = torch.full((num_pages, P), -1, dtype=torch.int32)
    pos_pool[2:].view(-1)[:] = torch.arange(n_lp * P, dtype=torch.int32).repeat(
        B)
    pos_pool[pos_pool >= n_tok] = -1
    bt, pos_pool = bt.to(dev), pos_pool.to(dev)
    pos = torch.full((B,), n_tok - 1, dtype=torch.int32, device=dev)
    lane_pages = torch.full((B,), n_lp, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    kf = torch.randn((num_pages, P, HKV, D), generator=gen, device=dev)
    vf = torch.randn((num_pages, P, HKV, D), generator=gen, device=dev)
    tok_bytes = {"bfloat16": 2 * HKV * D * 2, "q8_0": 2 * HKV * (D + 4),
                 "q4_0": 2 * HKV * (D // 2 + 4)}
    rows = []
    for name, kv_type, _, mode in cases:
        kv = ((kf.to(torch.bfloat16), vf.to(torch.bfloat16)) if mode is None
              else (*paged.quantize_rows(kf, mode),
                    *paged.quantize_rows(vf, mode)))
        res = time_decode(
            torch, name, q, kv, mode, pos_pool, bt, pos, lane_pages, nj,
            B * n_tok * tok_bytes[kv_type] + B * n_lp * (4 + P * 4),
            4.0 * H * D * B * n_tok, f"B={B} H={H} Hkv={HKV} D={D} P={P} "
            f"live {n_tok} a lane active_pages={nj}, {kv_type} pages")
        rows.append(dict(res, kernel=name))
        del kv
    emit({"phase": "decode_horizon", "detail": rows})


def kernels_experts(torch, summary: dict, detail: list, gen) -> None:
    """B1's expert form: all 256 experts of one weight in one launch, and
    the decode's routing, 32 experts live and the rest zero."""
    from repro_torch.core.apply import quantize_in_groups
    from repro_torch.kernels import qmatmul as qm

    dev = torch.device("cuda")
    for fmt in EXPERT_SUMMARY:
        name = f"qmatmul_experts_{fmt}"
        kern = qm.EXPERT_KERNELS[fmt]
        for k, n, use in EXPERT_SHAPES:
            qt = quantize_in_groups(
                lambda r, k=k, n=n: torch.randn(
                    (len(r), k, n), generator=gen, device=dev) / math.sqrt(k),
                EXPERTS, fmt, group=16, dim=0)
            wbytes = qt.packed_bytes()        # > 1 GB: every launch is cold
            cases = [(c, EXPERTS) for c in EXPERT_ROWS] + [
                (1, LIVE_EXPERTS)]
            for c, live in cases:
                x = torch.randn((EXPERTS, c, k), generator=gen,
                                device=dev).to(torch.bfloat16)
                shape = f"E={EXPERTS} C={c} K={k} N={n} bfloat16 ({use})"
                if live < EXPERTS:
                    keep = torch.zeros(EXPERTS, dtype=torch.bool, device=dev)
                    keep[torch.randperm(EXPERTS, generator=gen,
                                        device=dev)[:live]] = True
                    x[~keep] = 0
                    shape = (f"E={EXPERTS} C={c} K={k} N={n} bfloat16, "
                             f"{live} experts live at seeded positions, the "
                             f"rest zero; bound from the live experts' "
                             f"weight bytes ({use})")
                y = kern(x, qt)
                ref = qm.qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                if y.shape != (EXPERTS, c, n) or y.dtype != torch.bfloat16:
                    fail(f"{name} shape/dtype {y.shape} {y.dtype}")
                if live < EXPERTS and fmt in SKIPS_EMPTY and not torch.equal(
                        y[~keep].view(torch.int16),
                        ref[~keep].view(torch.int16)):
                    fail(f"{name}: an empty expert's output is not the "
                         "plain version's +0")
                ms = device_ms(torch, lambda: kern(x, qt))
                plain_ms = device_ms(torch, lambda: qm.qmatmul_plain(x, qt),
                                     iters=2)
                res = case(shape, y, ref, B1_TOL, "max_rel_err", ms,
                           plain_ms, wbytes * live // EXPERTS + nbytes(x)
                           + EXPERTS * c * n * 2,
                           2.0 * live * c * k * n, "bfloat16")
                detail.append(dict(res, kernel=name))
                if (c, live, k, n) == (1, EXPERTS, *EXPERT_SUMMARY[fmt]):
                    summary[name] = kernel_entry(name, **res)
                del x, y, ref
            del qt
            torch.cuda.empty_cache()


def kernels_mla(torch, summary: dict, detail: list, gen, live, n_lp,
                num_pages, bt, pos, lane_pages, active, nj, qp) -> None:
    """B6 and B7 at the DeepSeek serve's shapes: the same 4 lanes, block
    tables and page bucket as the GQA cases, 128 heads, latent 512, rope
    64; quantized pools in each (latent, rope) mode pair a serve uses."""
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import paged

    dev = torch.device("cuda")
    B, H, R, DR, P, C = 4, 128, 512, 64, 16, 128
    scale = (128 + 64) ** -0.5
    ckv = torch.randn((num_pages, P, R), generator=gen, device=dev)
    kr = torch.randn((num_pages, P, DR), generator=gen, device=dev)

    def pools(modes):
        return (*paged.quantize_rows(ckv, modes[0]),
                *paged.quantize_rows(kr, modes[1]))
    # the serve passes the queries in the model dtype
    q_eff = torch.randn((B, H, R), generator=gen, device=dev).to(
        torch.bfloat16)
    q_rope = torch.randn((B, H, DR), generator=gen, device=dev).to(
        torch.bfloat16)
    visited = int(n_lp.sum())
    n_live = int(live.sum())
    # bytes of one token's latent and rope rows (a quantized row: its codes
    # and one f32 scale)
    row = {"q8_0": lambda w: w + 4, "q4_0": lambda w: w // 2 + 4}
    tok_bytes = {"float32": (R + DR) * 4, "bfloat16": (R + DR) * 2,
                 **{m: row[m[0]](R) + row[m[1]](DR) for m in (Q8, Q4, MIXED)}}
    # per head and key: scores 2 (R + Dr), p . c_kv 2 R; f32 arithmetic
    per_pair = 4.0 * R + 2.0 * DR
    cases = [("paged_mla_decode", "float32", (ckv, kr), None),
             ("paged_mla_decode", "bfloat16",
              (ckv.to(torch.bfloat16), kr.to(torch.bfloat16)), None),
             ("paged_mla_decode_quant", Q8, pools(Q8), Q8),
             ("paged_mla_decode_quant_q4_0", Q4, pools(Q4), Q4),
             ("paged_mla_decode_quant_q8_0_q4_0", MIXED, pools(MIXED), MIXED)]
    for name, kv_type, kv, modes in cases:
        fn = pa.paged_mla_decode_quant if modes else pa.paged_mla_decode
        kw = dict(scale=scale, active_pages=active, lane_pages=lane_pages)
        if modes:
            kw.update(latent_mode=modes[0], rope_mode=modes[1])
        label = "/".join(kv_type) if modes else kv_type

        def plain():
            return pa.mla_decode_plain(q_eff, q_rope, kv, bt, pos,
                                       scale=scale, nj=active, quant=modes)
        y = fn(q_eff, q_rope, *kv, bt, pos, **kw)
        ref = plain()
        torch.cuda.synchronize()
        if y.shape != (B, H, R):
            fail(f"{name} ({label} pools): shape {y.shape}")
        ms = device_ms(torch, lambda: fn(q_eff, q_rope, *kv, bt, pos, **kw),
                       iters=20)
        plain_ms = device_ms(torch, plain)
        moved = (n_live * tok_bytes[kv_type] + nbytes(q_eff, q_rope, pos,
                                                      lane_pages)
                 + visited * 4 + B * H * R * 4)
        res = case(f"B={B} H={H} R={R} Dr={DR} P={P} live {live.tolist()} "
                   f"active_pages={active} table {nj} wide, {label} pools",
                   y, ref, ATTN_TOL, "max_abs_err", ms, plain_ms, moved,
                   per_pair * H * n_live, "float32")
        detail.append(dict(res, kernel=name))
        if kv_type != "float32":        # the serve path's pool types
            summary[name] = kernel_entry(name, **res)
    mla_decode_horizon(torch, gen, cases, tok_bytes, per_pair)

    # prefill: one 128-token chunk per lane ending at its frontier, lane 0's
    # chunk short (padded rows have qpos = -1), as the GQA case; queries
    # drawn in f32 (so the f32 case runs all three bf16 terms of each), the
    # serve's bf16 queries the same values rounded
    q32 = {torch.float32: (
        torch.randn((B, C, H, R), generator=gen, device=dev),
        torch.randn((B, C, H, DR), generator=gen, device=dev))}
    q32[torch.bfloat16] = tuple(t.to(torch.bfloat16)
                                for t in q32[torch.float32])
    valid_q = (qp >= 0).sum(dim=1).cpu()
    keys = sum(int(v) * (int(p) + 1) - int(v) * (int(v) - 1) // 2
               for v, p in zip(valid_q, live - 1))      # causal pairs
    # the tensor-core kernel: the function's operations bound it at the
    # bf16 peak; beside that bound, the former f32 CUDA-core one and the
    # mma passes it runs over its whole tiles of heads and keys (the scores
    # with f32 queries as three bf16 terms, P . c_kv as three)
    ops = per_pair * H * keys
    for name, modes, qdt in (
            ("paged_mla_prefill_quant", Q8, torch.bfloat16),
            ("paged_mla_prefill_quant", Q8, torch.float32),
            ("paged_mla_prefill_quant_q4_0", Q4, torch.bfloat16),
            ("paged_mla_prefill_quant_q8_0_q4_0", MIXED, torch.bfloat16)):
        kv = pools(modes)
        kw = dict(scale=scale, latent_mode=modes[0], rope_mode=modes[1])
        qa, qb = q32[qdt]

        def plain():
            return pa.mla_prefill_plain(qa, qb, kv, bt, qp, scale=scale,
                                        nj=nj, quant=modes)
        y = pa.paged_mla_prefill_quant(qa, qb, *kv, bt, qp, **kw)
        ref = plain()
        torch.cuda.synchronize()
        ms = device_ms(torch, lambda: pa.paged_mla_prefill_quant(
            qa, qb, *kv, bt, qp, **kw), iters=5)
        plain_ms = device_ms(torch, plain, iters=3)
        moved = (n_live * tok_bytes[modes] + nbytes(qa, qb, qp)
                 + visited * 4 + B * C * H * R * 4)
        q_terms = 3 if qdt == torch.float32 else 1
        head_tiles, key_tiles = pa.mla_prefill_tiles(qp, H, page_size=P,
                                                     nj=nj, q_dtype=qdt)
        rows = head_tiles * pa._MLA_PREFILL_ROWS[qdt]
        tiled = rows * int(key_tiles.sum()) * pa._MLA_PREFILL_KEYS
        mma_ops = tiled * (2.0 * (R + DR) * q_terms + 3 * 2.0 * R)
        qname = str(qdt).split(".")[-1]
        res = case(f"B={B} C={C} H={H} R={R} Dr={DR} P={P} live "
                   f"{live.tolist()} table {nj} wide, {'/'.join(modes)} "
                   f"pools, {qname} queries", y, ref, ATTN_TOL,
                   "max_abs_err", ms, plain_ms, moved, ops, "bfloat16")
        if qdt == torch.bfloat16:      # the serve passes bf16 queries
            summary[name] = kernel_entry(name, **res)
        # the other bounds go on the detail line only
        detail.append(dict(res, kernel=name,
                           bound_f32_ms=ops / PEAK_OPS["float32"] * 1e3,
                           mma_pass_ms=mma_ops / PEAK_OPS["bfloat16"] * 1e3,
                           bytes_ms=moved / HBM_BYTES_S * 1e3))


def mla_decode_horizon(torch, gen, cases, tok_bytes, per_pair) -> None:
    """The MLA decode (B6, B5c) at the engine's horizon: 4 lanes of 1,000
    tokens each (63 pages of 16) in a 64-page bucket, 128 heads, each
    serve pool kind of ``cases``; one detail line, not in the summary."""
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import paged

    dev = torch.device("cuda")
    B, H, R, DR, P, n_tok = 4, 128, 512, 64, 16, 1000
    nj = paged.pages_for(1024, P)
    n_lp = -(-n_tok // P)
    num_pages = 2 + B * n_lp
    bt = torch.full((B, nj), paged.GARBAGE_PAGE, dtype=torch.int32)
    bt[:, :n_lp] = 2 + torch.arange(B * n_lp, dtype=torch.int32).reshape(
        B, n_lp)
    bt = bt.to(dev)
    pos = torch.full((B,), n_tok - 1, dtype=torch.int32, device=dev)
    lane_pages = torch.full((B,), n_lp, dtype=torch.int32, device=dev)
    ckv = torch.randn((num_pages, P, R), generator=gen, device=dev)
    kr = torch.randn((num_pages, P, DR), generator=gen, device=dev)
    q_eff = torch.randn((B, H, R), generator=gen, device=dev).to(
        torch.bfloat16)
    q_rope = torch.randn((B, H, DR), generator=gen, device=dev).to(
        torch.bfloat16)
    scale = (128 + 64) ** -0.5
    rows = []
    for name, kv_type, _, modes in cases:
        if kv_type == "float32":
            continue
        kv = ((ckv.to(torch.bfloat16), kr.to(torch.bfloat16)) if modes is None
              else (*paged.quantize_rows(ckv, modes[0]),
                    *paged.quantize_rows(kr, modes[1])))
        fn = pa.paged_mla_decode_quant if modes else pa.paged_mla_decode
        kw = dict(scale=scale, active_pages=nj, lane_pages=lane_pages)
        if modes:
            kw.update(latent_mode=modes[0], rope_mode=modes[1])
        y = fn(q_eff, q_rope, *kv, bt, pos, **kw)

        def plain():
            return pa.mla_decode_plain(q_eff, q_rope, kv, bt, pos,
                                       scale=scale, nj=nj, quant=modes)
        ref = plain()
        torch.cuda.synchronize()
        label = "/".join(kv_type) if modes else kv_type
        ms = device_ms(torch, lambda: fn(q_eff, q_rope, *kv, bt, pos, **kw),
                       iters=20)
        moved = (B * n_tok * tok_bytes[kv_type] + nbytes(q_eff, q_rope, pos,
                                                         lane_pages)
                 + B * n_lp * 4 + B * H * R * 4)
        res = case(f"B={B} H={H} R={R} Dr={DR} P={P} live {n_tok} a lane "
                   f"active_pages={nj}, {label} pools", y, ref, ATTN_TOL,
                   "max_abs_err", ms, device_ms(torch, plain), moved,
                   per_pair * H * B * n_tok, "float32")
        rows.append(dict(res, kernel=name))
        del kv
    emit({"phase": "mla_decode_horizon", "detail": rows})


# ---------------------------------------------------------------------------
# phase 3: full-width models at a cut depth, card vs CPU
# ---------------------------------------------------------------------------

# max|d logits| / max|logit|, card vs CPU.  f32 pools: the two sides differ
# only in f32 summation order.  Quantized pools: where that order moves a
# K/V (or latent) value across a rounding boundary, the card and the CPU
# store codes one step apart, and the attention output moves with it.
# ``paged.parity_limit`` holds a run at the f32 limit where no code is
# apart, and at the q8_0 limit where the first layer whose codes differ
# has q8_0 codes one step apart (later layers' codes, q4_0 ones too, move
# with them).  It fails the run where that first layer has a q4_0 code
# apart or any code two steps apart.  The q8_0 limit is fixed, 3.5x the
# largest reading of sound runs (qwen2 dq 2.84e-3, DeepSeek q8_0 2.71e-3).
PARITY_TOL = {"f32": 1e-3, "q8_0": 1e-2}


def phase_parity(torch) -> None:
    from repro_torch.configs import get_config

    qwen = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    qwen_kw = dict(B=2, C=64, max_len=128, steps_n=4, short=9)
    parity_model(torch, qwen, "DQ3_K_M", (None, "q8_0"), **qwen_kw)
    # q4_0 and dq pools at depth 3: dq keeps layers 0 and 2 at q8_0 and
    # packs layer 1 (at depth 2 it would be uniform q8_0)
    parity_model(torch, dataclasses.replace(qwen, n_layers=3), "DQ3_K_M",
                 ("q4_0", "dq"), **qwen_kw)
    # q5_k (ffn_down) and q8_0 weights; the pool kinds were covered above
    for policy in ("Q3_K_M", "Q8_0"):
        parity_model(torch, qwen, policy, (None,), **qwen_kw)
    # DeepSeek-V3 at depth 4: the 3 dense layers and the first MoE layer.
    # The CPU side dequantizes every weight it multiplies on every call
    # (~3 G weights per forward, the experts of the tokens routed to them
    # on top), so the chunk is short and the decode steps few.
    deepseek = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4)
    ds_kw = dict(B=2, C=8, max_len=64, steps_n=2, short=3)
    # dq: q8_0 latents, q4_0 rope keys on layers 1 and 2
    parity_model(torch, deepseek, "DQ3_K_M", (None, "q8_0", "dq"), **ds_kw)
    # q2_k 2-D and experts, q3_k 2-D and experts
    parity_model(torch, deepseek, "Q2_K_L", (None,), **ds_kw)


def parity_model(torch, cfg, policy: str, pools: tuple, *, B: int, C: int,
                 max_len: int, steps_n: int, short: int) -> None:
    """One prefill chunk (lane 1 ``short`` tokens short) and ``steps_n``
    decode steps of ``cfg`` under ``policy`` on the card and on the CPU,
    per pool kind in ``pools`` (None: model-dtype pools)."""
    from repro_torch.convert import tree_to
    from repro_torch.core import get_policy, init_quantized_params
    from repro_torch.models import paged
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    qparams = init_quantized_params(cfg, get_policy(policy), 0,
                                    dtype=torch.float32, device=dev)
    cpu_params = tree_to(qparams, "cpu")
    model = Model(cfg, dtype=torch.float32)
    P = 16
    n = paged.pages_for(max_len, P)
    bt = torch.tensor([[2 + i * n + j for j in range(n)] for i in range(B)],
                      dtype=torch.int32)
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(4, cfg.vocab_size, (B, C), generator=rng,
                         dtype=torch.int32)
    # decode inputs are fixed, not sampled, so a near-tie argmax cannot
    # send the two devices down different streams
    dec_toks = torch.randint(4, cfg.vocab_size, (steps_n, B), generator=rng,
                             dtype=torch.int32)
    clen = torch.tensor([C, C - short], dtype=torch.int32)
    for kv_quant in pools:
        label = kv_quant or "f32"
        logits, caches, secs = {}, {}, {}
        for side, device, prm in (("card", dev, qparams),
                                  ("cpu", torch.device("cpu"), cpu_params)):
            t0 = time.perf_counter()
            cache = model.init_paged_cache(2 + B * n, P, B,
                                           dtype=torch.float32,
                                           kv_quant=kv_quant, device=device)
            tables = {"full": bt.to(device)}
            out, cache = model.prefill_chunk(
                prm, cache, toks.to(device), torch.zeros(B, dtype=torch.int32,
                                                         device=device),
                clen.to(device), max_len=max_len, block_tables=tables,
                page_size=P, kv_quant=kv_quant, active_pages=(n, 0))
            steps = [out]
            pos = clen.to(device).clone()
            for i in range(steps_n):
                lp = (pos // P + 1).to(torch.int32)
                out, cache = model.decode_step_paged(
                    prm, cache, dec_toks[i].to(device), pos, tables,
                    page_size=P, max_len=max_len, active_pages=(n, 0),
                    lane_pages={"full": lp}, kv_quant=kv_quant)
                steps.append(out)
                pos = pos + 1
            logits[side] = torch.stack(steps).cpu()
            caches[side] = {k: v.cpu() for k, v in cache.items()}
            secs[side] = time.perf_counter() - t0
        a, b = logits["card"], logits["cpu"]
        if (a.shape != (steps_n + 1, B, cfg.vocab_size)
                or not torch.isfinite(a).all()):
            fail(f"parity ({cfg.name}, {policy}, {label}): bad logits "
                 f"{a.shape}")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        result = {"phase": "parity", "arch": cfg.name, "policy": policy,
                  "kv": label, "layers": cfg.n_layers, "chunk": C,
                  "decode_steps": steps_n,
                  "max_abs": (a - b).abs().max().item(),
                  "max_abs_logit": b.abs().max().item(), "rel": rel,
                  "card_s": secs["card"], "cpu_s": secs["cpu"]}
        # every page but GARBAGE, the sink of padded writes, whose order
        # among duplicates is unspecified and which is never read
        read = [i for i in range(2 + B * n) if i != paged.GARBAGE_PAGE]
        ca, cb = caches["card"], caches["cpu"]
        if any(not torch.equal(ca[k][read], cb[k][read]) for k in ca
               if k.endswith("/pos")):
            fail(f"parity ({cfg.name}, {policy}, {label}): the caches' "
                 "positions differ")
        try:    # skips GARBAGE too
            tol, apart = paged.parity_limit(
                cfg, kv_quant, ca, cb, exact=PARITY_TOL["f32"],
                stepped=PARITY_TOL["q8_0"])
        except ValueError as e:
            fail(f"parity ({cfg.name}, {policy}, {label}): {e}")
        if apart:
            result.update(codes_apart=apart["apart"],
                          first_layer_apart=apart["first_layer"],
                          max_step_all=apart["max_step_all"])
            if kv_quant == "q8_0" and apart["max_step_all"] > 1:
                fail(f"parity ({cfg.name}, {policy}, {label}): q8_0 codes "
                     "more than one step apart")
        result["tol"] = tol
        emit(result)
        if not rel <= tol:
            fail(f"parity ({cfg.name}, {policy}, {label}): max|d| / "
                 f"max|logit| = {rel}")
    del qparams, cpu_params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the full model through the engine
# ---------------------------------------------------------------------------

def short_name(key: str) -> str:
    """A CUDA kernel's profiler key without its namespace and arguments."""
    return key.replace("void ", "").replace("(anonymous namespace)::",
                                            "").split("(")[0]


# kernel families of a traced decode step or prefill chunk:
# qmatmul_q4k_decode_kernel and qmatmul_mma_decode_kernel (the 2-D forms
# at M <= 4), qmatmul_prefill_kernel (the 2-D form at M > 4),
# qmatmul_experts_kernel<T, rows, format, copy bytes> (format ids as in
# csrc/qmatmul.cu), and the attention kernels (the MLA decode and prefill
# kernels both "B6/B7 paged_mla")
B1_FORMATS = {"0": "q4_k", "1": "q6_k", "2": "q3_k", "3": "q5_k", "4": "q2_k",
              "5": "q8_0"}


def family(key: str) -> str:
    m = re.search(r"qmatmul_experts_kernel<[^,]+, *\d+, *(\d),", key)
    if m:
        return f"B1 experts {B1_FORMATS[m.group(1)]}"
    if re.search(r"qmatmul_(q4k_decode|mma_decode|prefill)_kernel", key):
        return "B1 dense"
    if "paged_mla" in key:
        return "B6/B7 paged_mla"
    if "paged_attn" in key:
        return "B2-B4 paged_attn"
    return "other"


def profile_decode(torch, model, qparams, kv_quant, lanes=4, live=256,
                   steps=5) -> tuple:
    """Where one 4 x 128-token prefill chunk's time goes, and one batched
    decode step's: ``lanes`` lanes with ``live`` cached tokens each (built
    by two 128-token prefill chunks, the second run again on the host
    clock and then traced: the ``prefill_profile`` line), then ``steps``
    decode steps, timed on the host clock and then traced.
    Device time is summed by kernel family; the idle share is 1 - device
    time / wall time; the host side is the count of kernels launched per
    step and the operators with the most host time (profiler self time,
    which the tracing itself inflates)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import paged

    dev = torch.device("cuda")
    P, max_len = 16, 1024
    n = paged.pages_for(max_len, P)
    bt = torch.tensor([[2 + i * n + j for j in range(n)]
                       for i in range(lanes)], dtype=torch.int32, device=dev)
    cache = model.init_paged_cache(2 + lanes * n, P, lanes, dtype=model.dtype,
                                   kv_quant=kv_quant, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    C = 128
    chunk_args = []
    for c0 in range(0, live, C):
        toks = torch.randint(4, model.cfg.vocab_size, (lanes, C),
                             generator=gen, device=dev, dtype=torch.int32)
        start = torch.full((lanes,), c0, dtype=torch.int32, device=dev)
        clen = torch.full((lanes,), C, dtype=torch.int32, device=dev)
        chunk_args.append((toks, start, clen, paged.pages_for(c0 + C, P)))

    def chunk(i):
        nonlocal cache
        toks, start, clen, pages = chunk_args[i]
        out, cache = model.prefill_chunk(
            qparams, cache, toks, start, clen, max_len=max_len,
            block_tables={"full": bt}, page_size=P, kv_quant=kv_quant,
            active_pages=(pages, 0))
        return out

    for i in range(len(chunk_args)):
        logits = chunk(i)
    # the last chunk again (it writes the same pages with the same values),
    # on the host clock and then traced: a 4 x 128-token prefill chunk
    last = len(chunk_args) - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(last)
    torch.cuda.synchronize()
    chunk_wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk(last)
        torch.cuda.synchronize()
    pfams: dict[str, float] = {}
    p_kernels, p_counts, p_launches = {}, {}, 0
    for key, (ms, cnt) in kernel_ms(torch, prof, 1).items():
        p_kernels[key] = ms
        p_counts[key] = cnt
        p_launches += cnt
        pfams[family(key)] = pfams.get(family(key), 0.0) + ms
    p_busy = sum(pfams.values()) or None
    prefill = {"phase": "prefill_profile", "arch": model.cfg.name,
               "layers": model.cfg.n_layers, "kv": kv_quant or "bf16",
               "lanes": lanes, "chunk_tokens": C, "chunk_wall_ms": chunk_wall,
               "device_ms": p_busy,
               "idle_share": p_busy and max(0.0, 1 - p_busy / chunk_wall),
               "by_family_ms": pfams, "kernels_per_chunk": p_launches,
               "port_kernels_ms": {short_name(k): v
                                   for k, v in p_kernels.items()
                                   if family(k) != "other"},
               "port_kernel_launches": {short_name(k): v
                                        for k, v in p_counts.items()
                                        if family(k) != "other"}}
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pos_h = [live] * lanes

    def step():
        # as the engine does: positions and page counts live on the host,
        # and the sampled tokens come back once per step
        nonlocal tok, cache, pos_h
        lp_h = [p // P + 1 for p in pos_h]
        out, cache = model.decode_step_paged(
            qparams, cache, tok,
            torch.tensor(pos_h, dtype=torch.int32, device=dev),
            {"full": bt}, page_size=P, max_len=max_len,
            active_pages=(max(lp_h), 0),
            lane_pages={"full": torch.tensor(lp_h, dtype=torch.int32,
                                             device=dev)},
            kv_quant=kv_quant)
        tok = torch.argmax(out, dim=-1).to(torch.int32)
        tok.cpu()
        pos_h = [p + 1 for p in pos_h]

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    fams: dict[str, float] = {}
    per_kernel, launches = {}, 0
    for key, (ms, n) in kernel_ms(torch, prof, steps).items():
        per_kernel[key] = ms
        launches += n
        fams[family(key)] = fams.get(family(key), 0.0) + ms
    host = {ev.key: ev.self_cpu_time_total / 1e3 / steps
            for ev in prof.key_averages()
            if ev.device_type != torch.autograd.DeviceType.CUDA}
    # CUPTI recorded nothing: the device side is not measured
    busy = sum(fams.values()) or None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    ours = {short_name(k): v for k, v in per_kernel.items()
            if family(k) != "other"}
    return prefill, {"phase": "decode_profile", "arch": model.cfg.name,
            "layers": model.cfg.n_layers, "kv": kv_quant or "bf16",
            "lanes": lanes, "live_tokens": live, "step_wall_ms": wall,
            "device_ms": busy,
            "idle_share": busy and max(0.0, 1 - busy / wall),
            "by_family_ms": fams, "kernels_per_step": launches,
            "port_kernels_ms": ours,
            "top_kernels_ms": {k[:80]: v for k, v in top},
            "top_host_ops_ms": {k[:60]: v for k, v in top_host}}


# what ``repro.core.size.model_size`` gives for the 7-layer DeepSeek-V3 cut
# per policy: GGUF bytes and the structure-of-arrays layout both packages
# store (8-bit scale fields); the serve checks the packed bytes against the
# latter
REFERENCE_BYTES = {
    "DQ3_K_M": {"gguf": 25783579136, "soa": 26417660416},
    "Q3_K_M": {"gguf": 23930701312, "soa": 24691620352},
    "Q2_K_L": {"gguf": 18656924160, "soa": 18926240256},
    "Q8_0": {"gguf": 52756695040, "soa": 52756695040},
    "Q4_K_M": {"gguf": 30230380544, "soa": 30867207168}}
# the B1 forms each policy's DeepSeek path takes: (2-D formats, expert
# formats); under every policy the output head is q6_k but for Q8_0
DEEPSEEK_B1 = {"DQ3_K_M": (("q4_k", "q6_k"), ("q3_k", "q4_k", "q6_k")),
               "Q3_K_M": (("q3_k", "q4_k", "q5_k", "q6_k"), ("q3_k", "q4_k")),
               "Q2_K_L": (("q2_k", "q3_k", "q6_k"), ("q2_k", "q3_k")),
               "Q8_0": (("q8_0",), ("q8_0",)),
               "Q4_K_M": (("q4_k", "q6_k"), ("q4_k", "q6_k"))}


# the formats whose one-weight calls at M > 4 take qmatmul_prefill_kernel
# (all), and those of them each path multiplies at a prefill chunk's 512
# rows (qwen2 under DQ3_K_M; the DeepSeek cut per policy: under Q3_K_M q6_k
# is only the output head, which takes one row a lane, as the Q8_0 head
# does, and Q2_K_L has no q4_k); the one-weight calls of every format at
# M <= 4 take its decode form
PREFILL_FORMS = ("q4_k", "q6_k", "q3_k", "q5_k", "q2_k", "q8_0")
QWEN2_PREFILL = ("q4_k", "q6_k")
DEEPSEEK_PREFILL = {"DQ3_K_M": ("q4_k", "q6_k"), "Q4_K_M": ("q4_k", "q6_k"),
                    "Q3_K_M": ("q4_k", "q3_k", "q5_k"),
                    "Q2_K_L": ("q6_k", "q3_k", "q2_k"), "Q8_0": ("q8_0",)}


DECODE_FORMS = ("q4_k", "q6_k", "q3_k", "q5_k", "q2_k", "q8_0")


def b1_path(policy: str) -> tuple:
    dense, experts = DEEPSEEK_B1[policy]
    return (tuple(f"qmatmul_{f}" for f in dense)
            + tuple(f"qmatmul_{f}_prefill" for f in DEEPSEEK_PREFILL[policy])
            + tuple(f"qmatmul_experts_{f}" for f in experts))


def phase_serve(torch, summary: dict) -> None:
    from repro_torch.configs import get_config

    counters = launch_counters()
    totals = {k: 0 for k in KERNELS}
    dense = ("qmatmul_q4_k", "qmatmul_q6_k") + tuple(
        f"qmatmul_{f}_prefill" for f in QWEN2_PREFILL)
    gqa_q8 = ("paged_attn_decode_quant", "paged_attn_prefill_quant")
    gqa_q4 = ("paged_attn_decode_quant_q4_0", "paged_attn_prefill_quant_q4_0")
    # dq: the quant probe's shadow bf16 pools decode through B2
    serve_model(torch, get_config("qwen2-1.5b"), "DQ3_K_M", counters,
                totals, {
                    "q8_0": dense + gqa_q8,
                    None: dense + ("paged_attn_decode",),
                    "q4_0": dense + gqa_q4,
                    "dq": dense + gqa_q8 + gqa_q4 + ("paged_attn_decode",)},
                profiled=("q8_0", None, "dq"))
    # DeepSeek-V3 cut to 7 layers: the 3 dense layers of the published
    # config and 4 MoE layers, where ffn_down_exps takes all three of
    # DQ3_K_M's formats; every width is the published one
    deepseek = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=7)
    mla_q8 = ("paged_mla_decode_quant", "paged_mla_prefill_quant")
    mla_q4 = ("paged_mla_decode_quant_q4_0", "paged_mla_prefill_quant_q4_0")
    mla_dq = ("paged_mla_decode_quant_q8_0_q4_0",
              "paged_mla_prefill_quant_q8_0_q4_0")
    serve_model(torch, deepseek, "DQ3_K_M", counters, totals, {
        "q8_0": b1_path("DQ3_K_M") + mla_q8,
        None: b1_path("DQ3_K_M") + ("paged_mla_decode",),
        "q4_0": b1_path("DQ3_K_M") + mla_q4,
        "dq": b1_path("DQ3_K_M") + mla_q8 + mla_dq + ("paged_mla_decode",)},
        profiled=("q8_0", None, "dq"))
    # the paper's other policies, q8_0 pools (the pool kinds are covered
    # above); each policy's weights are freed before the next is made
    for policy in ("Q4_K_M", "Q3_K_M", "Q2_K_L", "Q8_0"):
        serve_model(torch, deepseek, policy, counters, totals,
                    {"q8_0": b1_path(policy) + mla_q8}, profiled=("q8_0",))
    for name in KERNELS:
        summary.setdefault(name, kernel_entry(name))["launches"] = totals[name]


def serve_model(torch, cfg, policy: str, counters: dict, totals: dict,
                path_kernels: dict, profiled: tuple) -> None:
    """Weights from seed 0 made and quantized on the card (``policy``,
    bf16), then 8 greedy requests per pool kind of ``path_kernels`` (a
    ``kv_quant``, or None for bf16 pools), which also lists the kernels
    each run must launch; the counts are set to 0 just before each serve
    and read just after.  The "dq" serve runs the quant probe, whose
    shadow bf16 pools are served through the same steps (its step times
    include them).  One decode step per pool kind of ``profiled`` is
    traced."""
    from repro_torch.core import QTensor, get_policy, init_quantized_params
    from repro_torch.kernels import qmatmul as qm
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SamplerConfig

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = init_quantized_params(cfg, get_policy(policy), 0,
                                    dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    packed = sum(v.packed_bytes() if isinstance(v, QTensor)
                 else v.numel() * v.element_size() for v in qparams.values())
    if cfg.mla and packed != REFERENCE_BYTES[policy]["soa"]:
        fail(f"serve ({cfg.name}, {policy}): packed {packed} bytes, the "
             f"reference calculator {REFERENCE_BYTES[policy]['soa']}")
    model = Model(cfg, dtype=torch.bfloat16)
    for kv_quant in path_kernels:
        engine = Engine(model, qparams, max_len=1024, device=dev,
                        sampler=SamplerConfig(greedy=True), page_size=16,
                        prefill_chunk=128, kv_quant=kv_quant,
                        quant_probe=kv_quant == "dq")
        # a short serve first, so that loading PyTorch's kernels at their
        # first use is not timed as serving
        engine.serve(build_requests(2, cfg.vocab_size, 20, 40, 4, seed=1),
                     slots=4, seed=0)
        reqs = build_requests(8, cfg.vocab_size, 100, 400, 32, seed=0)
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        # the forms' counts are their libraries', read before and after
        lib = [(f, w) for f in qm.FIELDS for w in ("decode", "prefill")]
        forms = {fw: qm.library_launches(*fw) for fw in lib}
        done = engine.serve(reqs, slots=4, seed=0)
        torch.cuda.synchronize()
        forms = {fw: qm.library_launches(*fw) - n for fw, n in forms.items()}
        launches = {k: c.launches for k, c in counters.items()}
        launches.update({f"qmatmul_{f}_prefill": forms[f, "prefill"]
                         for f in PREFILL_FORMS})
        st = engine.last_stats
        label = kv_quant or "bf16"
        res = {"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
               "policy": policy, "kv": label, "quantize_s": quant_s,
               "init_peak_mem_gib": init_peak, "packed_gib": packed / 2**30,
               "requests": len(done),
               "out_tokens": [len(r.out) for r in sorted(done,
                                                         key=lambda r: r.rid)],
               "prompt_tokens": [len(r.prompt) for r in reqs],
               "wall_s": st.wall_s, "throughput_tok_s": st.throughput_tok_s,
               "decode_tok_s": st.decode_tok_s,
               "decode_step_ms_p50": st.decode_step_ms(0.5),
               "decode_step_ms_p90": st.decode_step_ms(0.9),
               "decode_steps": st.decode_iterations,
               "prefill_chunks": st.prefill_iterations,
               "ttft_ms_mean": st.mean_admission_s * 1e3,
               "ttft_ms": [r.admission_s * 1e3 for r in st.requests],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "pages_leaked": st.pages_leaked, "peak_pages": st.peak_pages,
               "bytes_per_live_token": st.bytes_per_live_token,
               "dense_cache_bytes": st.dense_cache_bytes,
               "kv_bytes_per_decoded_token": st.kv_bytes_per_decoded_token,
               "page_bytes": st.page_bytes,
               "launches": {k: v for k, v in launches.items() if v},
               "library_launches": {f"{f} {w}": v
                                    for (f, w), v in forms.items() if v}}
        if engine.quant_probe:
            res["quant_probe_steps"] = st.quant_probe_steps
            res["quant_logit_gap_per_lane"] = st.quant_logit_gap_per_lane
        if cfg.mla:
            res["reference_size_gib"] = {
                k: v / 2**30 for k, v in REFERENCE_BYTES[policy].items()}
        emit(res)
        what = f"serve ({cfg.name}, {policy}, {label})"
        if len(done) != 8 or any(r.status != "ok" or len(r.out) != 32
                                 for r in done):
            fail(f"{what}: not every request completed")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
            fail(f"{what}: token outside the vocabulary")
        if st.pages_leaked:
            fail(f"{what}: {st.pages_leaked} pages leaked")
        missing = [k for k in path_kernels[kv_quant] if launches[k] <= 0]
        if missing:
            fail(f"{what}: kernels never launched: {missing}")
        # every 2-D format of the path: its decode steps take its decode
        # form
        for f in DECODE_FORMS:
            if f"qmatmul_{f}" not in path_kernels[kv_quant]:
                continue
            if forms[f, "decode"] <= 0:
                fail(f"{what}: {f} took its decode form "
                     f"{forms[f, 'decode']} times")
        gaps = st.quant_logit_gap_per_lane
        if engine.quant_probe and not (
                st.quant_probe_steps and gaps
                and all(math.isfinite(g) and g > 0 for g in gaps)):
            fail(f"{what}: quant probe gaps {gaps} over "
                 f"{st.quant_probe_steps} steps")
        for k, v in launches.items():
            totals[k] += v
    for kv_quant in profiled:
        for line in profile_decode(torch, model, qparams, kv_quant,
                                   steps=3 if cfg.mla else 5):
            emit(dict(line, policy=policy))
    del qparams, model, engine
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        fail(f"unknown phase in {phases}")

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    summary: dict = {}
    if "build" in phases:
        t0 = time.perf_counter()
        secs = build.build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "per_library_s": secs})
        for name in build.LIBRARIES:
            for line in build.ptxas_report(name).splitlines():
                if any(w in line for w in ("properties for", "registers",
                                           "spill")):
                    print(f"ptxas[{name}] {line.strip()}", file=sys.stderr)
    if "serve" in phases and not profiler_ready(torch):
        emit({"warning": "torch.profiler records no device activity: the "
                         "decode profiles' device times are not measured"})
    seconds = {}
    for name, run in (("kernels", lambda: phase_kernels(torch, summary)),
                      ("parity", lambda: phase_parity(torch)),
                      ("serve", lambda: phase_serve(torch, summary))):
        if name in phases:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
    emit({"phase_seconds": seconds})
    emit({"kernels": list(summary.values())})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
