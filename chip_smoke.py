#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py                 # every phase, as the checks run it
    python3 chip_smoke.py --phases build,kernels

Phases (each prints JSON lines; any failure raises, exit code != 0):

  1. build    — compile every CUDA library of the port from this checkout
                (one nvcc process each, started together).
  2. kernels  — each kernel against its plain PyTorch version on the card at
                the served models' shapes, with times, the roofline bound
                and the stated tolerance: B1's 2-D forms at every weight
                shape of qwen2-1.5b, deepseek-r1-distill-qwen-32b,
                qwen2-72b, phi3-mini-3.8b and llama4-scout-17b-a16e under
                DQ3_K_M at 1, 4 and 512 rows, and of the DeepSeek-V3 cut
                under DQ3_K_M, Q3_K_M, Q2_K_L and Q8_0 at the rows each
                form takes (K = 29568, qwen2-72b's ragged down, in all six
                formats), and qwen2's and the cut's shapes also at the
                one-shot forward's 2,048 rows; B1's M = 512 lines also
                carry ``gemm_ms``, a bf16 torch.matmul by the weight
                already dequantized, for context; the expert form at
                DeepSeek's E = 256 (C = 1 and 20, and in DQ3_K_M's formats
                the forward's 80) and
                llama4's E = 16 (C = 1 and 40), each also with the
                decode's routing, a few experts live, where no expert
                kernel reads an empty expert; the GQA decode and prefill
                with each tile loader the serves use (bf16, q8_0, q4_0
                pools) at (H, Hkv, D) = (12, 2, 128), (40, 8, 128),
                (64, 8, 128) and (32, 32, 96); the MLA ones at DeepSeek's
                shapes (also q8_0 latents beside q4_0 rope keys); the GQA
                and MLA decodes also at the engine's horizon (4 lanes x
                1,000 tokens, a 64-page bucket), each on a line of its own.
  3. parity   — full width, f32, weights from one seed, card (kernels)
                against CPU (plain versions), one prefill chunk and a few
                decode steps (``PARITY_CASES``): qwen2-1.5b at depth 2 (a
                64-token chunk, 4 decode steps) under DQ3_K_M with
                model-dtype and q8_0 pools, at depth 3 with q4_0 and dq
                pools, and under Q3_K_M and Q8_0 with model-dtype pools;
                DeepSeek-V3 at depth 4 (3 dense + 1 MoE layer; an 8-token
                chunk, 2 decode steps) under DQ3_K_M with model-dtype, q8_0
                and dq pools and under Q2_K_L with model-dtype pools; the
                four other models at depth 2 (as DeepSeek's run) under
                DQ3_K_M with model-dtype and q8_0 pools, phi3 also q4_0.
                A rounding tie that the two sides broke apart in a q4_0
                pool is broken as the card did (``PARITY_TIE``).  The
                qwen2 depth-2 and DeepSeek depth-4 DQ3_K_M weights also
                take ``Model.forward`` over 1 x 64 tokens
                (``FORWARD_PARITY``), held to the f32 limit.
  4. serve    — 8 greedy requests through the engine, weights made and
                quantized on the card: qwen2-1.5b at full width and depth,
                and the DeepSeek-V3 cut at full width and 7 layers (3 dense
                + 4 MoE), under DQ3_K_M, each with q8_0, bf16, q4_0 and dq
                pools (dq with the quant probe), and the cut under Q4_K_M,
                Q3_K_M, Q2_K_L and Q8_0 with q8_0 pools; then, whole (full
                width and depth), deepseek-r1-distill-qwen-32b (64 layers)
                under DQ3_K_M with q8_0 and dq pools and under Q4_K_M with
                q8_0, phi3-mini-3.8b (32) with q8_0 and q4_0,
                llama4-scout-17b-a16e (48) and qwen2-72b (80) with q8_0.
                Every kernel of each path must have been launched in its
                run (each 2-D format of the path must have taken its decode
                form, and a ragged K's format both forms), and every
                model's weights must pack to the size calculator's bytes
                (``core.size``); one traced 4 x 128-token prefill chunk
                (``prefill_profile``) and one traced decode step
                (``decode_profile``) per pool kind of qwen2-1.5b and the
                DeepSeek cut (q8_0, bf16, dq), and with q8_0 pools of the
                cut's other policies, distill-32B (DQ3_K_M) and
                llama4-scout say where the time goes.
  5. sched   — the serve phase's 8 requests (its weights made again, once
                for this phase and the next: ``held_weights``), in two priority
                classes, through ``scheduler="preempt"`` over a pool of 60
                usable pages (``SCHED_PAGES``): qwen2-1.5b with q8_0 and
                q4_0 pools, the DeepSeek-V3 cut with q8_0; every request
                completes, lanes are evicted and swapped back in, swap
                bytes balance, no page leaks, every kernel of the path
                launches, one lane's pages of every leaf round-trip to the
                host byte for byte, and qwen2's streams equal the reserve
                serve's or part only at a near-tie (``SCHED_TIE_STEPS``).
                Then qwen2 with q8_0 pools under ``SCHED_PLAN``, one fault
                of each kind: the statuses, the two quarantines, the
                watchdog's slow step, and the bystanders' streams held to
                the fault-free preempt serve's by the same rule.
  6. dense   — the one-shot and dense entry points, on the sched phase's
                weights: for qwen2-1.5b and the DeepSeek-V3 cut, under
                DQ3_K_M, bf16, ``Model.loss`` over 2 x 1024 tokens (every
                2-D weight on B1's prefill form, the experts at the
                reference's capacity, C = 80; no attention kernel), the
                serve phase's 8 requests through ``Engine(page_size=0)``
                (bf16 dense caches) and through ``Engine(kernel="gather")``
                over q8_0 and over bf16 pools (none launches an attention
                kernel; the gather bf16 serve's streams equal the dense
                serve's bitwise), two of them through ``serve_sequential``
                over the dense layout and over q8_0 pools, and two others'
                prompts through one ``generate`` call.  Then each of these
                runs again in f32, teacher-forced with the paged bf16
                serve's first tokens (``DENSE_FORCED``), its logits held row
                by row to a reference run that batches the same tokens the
                same way, under PARITY_TOL (``dense_forced``), at the
                depths of ``DENSE_FORCED_LAYERS``: qwen2 whole (q8_0 pools
                at 2 layers), DeepSeek-V3's 3 dense layers.

The last three lines are the ``{"kernels": [...]}`` summary, the card's name
and power limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``.  It needs one CUDA card and imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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

PHASES = ("build", "kernels", "parity", "serve", "sched", "dense")


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
# the one-shot forward's rows: a loss over 2 x 1024 tokens (the dense
# phase), timed at qwen2's and the DeepSeek cut's shapes
B1_FORWARD_ROWS = 2048
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
# the 2-D weights of deepseek-r1-distill-qwen-32b, qwen2-72b, phi3-mini-3.8b
# and llama4-scout-17b-a16e that no other path multiplies, each at a decode
# step's 1 and 4 rows and a chunk's 512 (DQ3_K_M, and Q4_K_M's q4_k k/v)
B1_MODEL_SHAPES = [
    (5120, 5120, "q4_k", "distill-32B, llama4 q_proj, o_proj"),
    (5120, 1024, "q6_k", "distill-32B, llama4 k_proj, v_proj"),
    (5120, 1024, "q4_k", "distill-32B k_proj, v_proj, Q4_K_M"),
    (5120, 27648, "q4_k", "distill-32B gate, up"),
    (27648, 5120, "q6_k", "distill-32B down"),
    (5120, 152064, "q6_k", "distill-32B output"),
    (8192, 8192, "q4_k", "qwen2-72b q_proj, o_proj"),
    (8192, 1024, "q6_k", "qwen2-72b k_proj, v_proj"),
    (8192, 29568, "q4_k", "qwen2-72b gate, up"),
    (8192, 152064, "q6_k", "qwen2-72b output"),
    (3072, 3072, "q4_k", "phi3 q_proj, o_proj"),
    (3072, 3072, "q6_k", "phi3 k_proj, v_proj"),
    (3072, 8192, "q4_k", "phi3 gate, up"),
    (8192, 3072, "q6_k", "phi3 down"),
    (3072, 32256, "q6_k", "phi3 output (vocab 32064 padded)"),
    (5120, 8192, "q4_k", "llama4 shexp gate, up"),
    (8192, 5120, "q6_k", "llama4 shexp down"),
    (5120, 202240, "q6_k", "llama4 output (vocab 202048 padded)")]
# K = 29568, qwen2-72b's down (115.5 superblocks: x's last superblock half
# empty), in every format, each form: q6_k is DQ3_K_M's and Q4_K_M's
B1_RAGGED_SHAPES = [(29568, 8192, fmt, "qwen2-72b down, ragged K")
                    for fmt in ("q6_k", "q4_k", "q3_k", "q5_k", "q2_k",
                                "q8_0")]
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
# expert weights: (E, K, N, format, what they are, C values, live experts
# of the decode's routing).  DeepSeek-V3 (E = 256): C = 1 is an expert's
# capacity at decode (4 lanes x top-8 / 256, at least 1), C = 20 at a 4 x
# 128-token prefill chunk (1.25 x 512 x 8 / 256), C = 80 at the loss's
# 2 x 1024-token forward (1.25 x 2048 x 8 / 256); at 4 lanes x top-8 at
# most 32 of the 256 experts have a row.  llama4-scout (E = 16, top-1): C
# = 1 at decode, 40 at a chunk (1.25 x 512 / 16), at most 4 experts live;
# its DQ3_K_M formats (gate/up q3_k; down q3_k, q4_k and q6_k by layer).
# Every form is also timed with only the live experts' rows non-zero, at
# seeded positions, and must give the empty experts the plain version's
# +0 bitwise.
EXPERT_FORMATS = ("q3_k", "q4_k", "q6_k", "q5_k", "q2_k", "q8_0")
# the expert formats of the DeepSeek cut under DQ3_K_M, the loss's (C = 80)
DQ3_EXPERTS = ("q3_k", "q4_k", "q6_k")
EXPERT_CASES = (
    [(256, k, n, fmt, use, (1, 20) + ((80,) if fmt in DQ3_EXPERTS else ()),
      32) for fmt in EXPERT_FORMATS
     for k, n, use in ((7168, 2048, "DeepSeek gate_exps, up_exps"),
                       (2048, 7168, "DeepSeek down_exps"))]
    + [(16, 5120, 8192, "q3_k", "llama4 gate_exps, up_exps", (1, 40), 4)]
    + [(16, 8192, 5120, fmt, "llama4 down_exps", (1, 40), 4)
       for fmt in ("q3_k", "q4_k", "q6_k")])
# the case that stands for each expert format in the summary line: C = 1,
# all 256 live, the shape of the format's experts in the DeepSeek cut under
# DQ3_K_M (q3_k: gate/up of every MoE layer; q4_k, q6_k: down of the 3rd /
# 1st-2nd MoE layers), Q2_K_L (q2_k: gate/up) and Q8_0 (q8_0: gate/up, as
# down); no policy puts q5_k on experts
EXPERT_SUMMARY = {"q3_k": (7168, 2048), "q4_k": (2048, 7168),
                  "q6_k": (2048, 7168), "q5_k": (7168, 2048),
                  "q2_k": (7168, 2048), "q8_0": (7168, 2048)}
B1_TOL = 8e-3      # bf16 output: one bf16 ulp (2^-8) of the largest value
B1_TOL_F32 = 1e-5  # f32 output: f32 summation order only
ATTN_TOL = 1e-5    # f32 output: summation order and the online softmax;
# the q4_0 loaders dequantize each element bitwise as the plain version


def phase_kernels(torch, summary: dict) -> None:
    from repro_torch.core.qtensor import QTensor, quantize
    from repro_torch.kernels import qmatmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    detail = []
    for k, n, fmt, use, rows in (
            [(*c, B1_ROWS + (B1_FORWARD_ROWS,)) for c in B1_SHAPES]
            + [(*c, B1_DECODE_ROWS) for c in B1_DECODE_SHAPES]
            + [(*c, (max(B1_ROWS),)) for c in B1_PREFILL_SHAPES]
            + [(*c, B1_ROWS) for c in B1_MODEL_SHAPES + B1_RAGGED_SHAPES]):
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

    lanes = attn_lanes(torch)
    for h, hkv, d, use in GQA_SHAPES:
        kernels_gqa(torch, summary if use == "qwen2-1.5b" else None, detail,
                    gen, lanes, h, hkv, d, use)
    kernels_experts(torch, summary, detail, gen)
    kernels_mla(torch, summary, detail, gen, lanes)
    emit({"phase": "kernels", "detail": detail})


# the GQA attention shapes of the served models: (H, Hkv, D, models); the
# first is the one in the summary line and at the engine's horizon
GQA_SHAPES = [(12, 2, 128, "qwen2-1.5b"),
              (40, 8, 128, "deepseek-r1-distill-qwen-32b, llama4-scout"),
              (64, 8, 128, "qwen2-72b"),
              (32, 32, 96, "phi3-mini-3.8b")]


def attn_lanes(torch) -> dict:
    """The attention cases' lanes as the serve phase's engine holds them:
    max_len 1024 (block tables 64 wide), pages of 16, 4 lanes of 100, 217,
    333 and 400 tokens; decode bounds the page loop by the engine's
    power-of-two bucket of the live horizon, prefill passes no bound.  A
    prefill chunk is 128 tokens a lane ending at each lane's frontier,
    lane 0's short (padded rows have qpos = -1)."""
    from repro_torch.models import paged
    from repro_torch.serving.engine import _bucket_pages

    dev = torch.device("cuda")
    B, P, max_len, C = 4, 16, 1024, 128
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
    qp = torch.stack([torch.arange(int(p) - C + 1, int(p) + 1)
                      for p in live - 1])
    qp[0, :C - 60] = -1
    # every lane's page loop stops at its own pages, short of the bucket
    return {"B": B, "P": P, "C": C, "live": live, "nj": nj, "n_lp": n_lp,
            "num_pages": num_pages, "bt": bt.to(dev),
            "pos_pool": pos_pool.to(dev), "pos": (live - 1).to(dev),
            "lane_pages": n_lp.clone().to(torch.int32).to(dev),
            "active": _bucket_pages(int(n_lp.max()), nj),
            "qp": qp.to(torch.int32).to(dev)}


def kernels_gqa(torch, summary, detail: list, gen, lanes: dict, H: int,
                HKV: int, D: int, use: str) -> None:
    """B2/B3/B5a (decode) and B4/B5b (prefill) at (H, Hkv, D) over
    ``lanes``, each tile loader the serves use; into the summary line
    (and at the engine's horizon) when ``summary`` is given."""
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import paged

    dev = torch.device("cuda")
    B, P, C, nj = lanes["B"], lanes["P"], lanes["C"], lanes["nj"]
    live, n_lp, qp = lanes["live"], lanes["n_lp"], lanes["qp"]
    bt, pos_pool, pos = lanes["bt"], lanes["pos_pool"], lanes["pos"]
    lane_pages, active = lanes["lane_pages"], lanes["active"]
    num_pages = lanes["num_pages"]
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
            f"{kv_type} pages ({use})")
        detail.append(dict(res, kernel=name))
        if summary is not None and kv_type != "float32":
            summary[name] = kernel_entry(name, **res)
    if summary is not None:
        decode_horizon(torch, gen, cases[1:])

    # prefill: queries drawn in f32 (so the f32 case runs all three bf16
    # terms of each), the serve's bf16 queries the same values rounded
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
                   f"queries ({use})", y, ref, ATTN_TOL, "max_abs_err", ms,
                   plain_ms, moved, ops, "bfloat16")
        # the serve passes bf16 queries
        if summary is not None and qdt == torch.bfloat16:
            summary[name] = kernel_entry(name, **res)
        # the other bounds go on the detail line only
        detail.append(dict(res, kernel=name,
                           bound_f32_ms=ops / PEAK_OPS["float32"] * 1e3,
                           mma_pass_ms=mma_ops / PEAK_OPS["bfloat16"] * 1e3,
                           bytes_ms=moved / HBM_BYTES_S * 1e3))
    del kf, vf, quantized, qc, queries


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
    """B1's expert form: all E experts of one weight in one launch at each
    C of EXPERT_CASES, and the decode's routing, a few experts live and
    the rest zero."""
    from repro_torch.core.apply import quantize_in_groups
    from repro_torch.kernels import qmatmul as qm

    dev = torch.device("cuda")
    for e, k, n, fmt, use, rows, n_live in EXPERT_CASES:
        name = f"qmatmul_experts_{fmt}"
        kern = qm.EXPERT_KERNELS[fmt]
        qt = quantize_in_groups(
            lambda r, k=k, n=n: torch.randn(
                (len(r), k, n), generator=gen, device=dev) / math.sqrt(k),
            e, fmt, group=16, dim=0)
        wbytes = qt.packed_bytes()        # > 400 MB: every launch is cold
        for c, live in [(c, e) for c in rows] + [(1, n_live)]:
            x = torch.randn((e, c, k), generator=gen,
                            device=dev).to(torch.bfloat16)
            shape = f"E={e} C={c} K={k} N={n} bfloat16 ({use})"
            if live < e:
                keep = torch.zeros(e, dtype=torch.bool, device=dev)
                keep[torch.randperm(e, generator=gen,
                                    device=dev)[:live]] = True
                x[~keep] = 0
                shape = (f"E={e} C={c} K={k} N={n} bfloat16, {live} experts "
                         f"live at seeded positions, the rest zero; bound "
                         f"from the live experts' weight bytes ({use})")
            y = kern(x, qt)
            ref = qm.qmatmul_plain(x, qt)
            torch.cuda.synchronize()
            if y.shape != (e, c, n) or y.dtype != torch.bfloat16:
                fail(f"{name} shape/dtype {y.shape} {y.dtype}")
            if live < e and not torch.equal(y[~keep].view(torch.int16),
                                            ref[~keep].view(torch.int16)):
                fail(f"{name}: an empty expert's output is not the plain "
                     "version's +0")
            ms = device_ms(torch, lambda: kern(x, qt))
            plain_ms = device_ms(torch, lambda: qm.qmatmul_plain(x, qt),
                                 iters=2)
            res = case(shape, y, ref, B1_TOL, "max_rel_err", ms, plain_ms,
                       wbytes * live // e + nbytes(x) + e * c * n * 2,
                       2.0 * live * c * k * n, "bfloat16")
            detail.append(dict(res, kernel=name))
            if (e, c, live, k, n) == (256, 1, 256, *EXPERT_SUMMARY[fmt]):
                summary[name] = kernel_entry(name, **res)
            del x, y, ref
        del qt
        torch.cuda.empty_cache()


def kernels_mla(torch, summary: dict, detail: list, gen, lanes: dict
                ) -> None:
    """B6 and B7 at the DeepSeek serve's shapes: the same 4 lanes, block
    tables and page bucket as the GQA cases, 128 heads, latent 512, rope
    64; quantized pools in each (latent, rope) mode pair a serve uses."""
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import paged

    dev = torch.device("cuda")
    H, R, DR = 128, 512, 64
    B, P, C, nj = lanes["B"], lanes["P"], lanes["C"], lanes["nj"]
    live, n_lp, qp = lanes["live"], lanes["n_lp"], lanes["qp"]
    bt, pos = lanes["bt"], lanes["pos"]
    lane_pages, active = lanes["lane_pages"], lanes["active"]
    num_pages = lanes["num_pages"]
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
# Where the rule refuses a run because the first layer whose codes differ
# holds a q4_0 code one step apart, the CPU side is run again and breaks
# each rounding tie as the card did: a code one step from the card's, whose
# value lies within PARITY_TIE of a step of the boundary between the two
# codes on both devices, takes the card's code as it is written; any other
# code apart fails the run.  With no code left apart, the logits are held
# to the f32 limit.  So every prompt decides: a fault shows as a code off
# a boundary or as logits apart, a tie broken the other way does not.
PARITY_TIE = 1e-3
# The parity cases: (arch, depth, policy, pool kinds (None: model-dtype
# pools), run shape), each at full width.  qwen2-1.5b: q4_0 and dq pools
# at depth 3, where dq keeps layers 0 and 2 at q8_0 and packs layer 1 (at
# depth 2 it would be uniform q8_0); Q3_K_M for q5_k (ffn_down), Q8_0 for
# q8_0 weights.  DeepSeek-V3 at depth 4, its 3 dense layers and first MoE
# layer: dq pools hold q8_0 latents and q4_0 rope keys on layers 1 and 2;
# Q2_K_L runs q2_k and q3_k 2-D weights and experts.  The four other
# full-attention models at depth 2: head_dim 96 at a group of 1 (phi3),
# groups of 5 and 8, QKV bias, untied heads over vocabularies of 32064 to
# 202048, 16 experts at top-1 beside a shared expert (llama4), the ragged
# K = 29568 (qwen2-72b).  A forward of the wide models multiplies 2 to 3 G
# weights, and the plain version dequantizes the experts that tokens were
# routed to on every call, so their chunk is short and their steps few.
QWEN_RUN = dict(B=2, C=64, max_len=128, steps_n=4, short=9)
WIDE_RUN = dict(B=2, C=8, max_len=64, steps_n=2, short=3)
PARITY_CASES = (
    ("qwen2-1.5b", 2, "DQ3_K_M", (None, "q8_0"), QWEN_RUN),
    ("qwen2-1.5b", 3, "DQ3_K_M", ("q4_0", "dq"), QWEN_RUN),
    ("qwen2-1.5b", 2, "Q3_K_M", (None,), QWEN_RUN),
    ("qwen2-1.5b", 2, "Q8_0", (None,), QWEN_RUN),
    ("deepseek-v3-671b", 4, "DQ3_K_M", (None, "q8_0", "dq"), WIDE_RUN),
    ("deepseek-v3-671b", 4, "Q2_K_L", (None,), WIDE_RUN),
    ("deepseek-r1-distill-qwen-32b", 2, "DQ3_K_M", (None, "q8_0"), WIDE_RUN),
    ("phi3-mini-3.8b", 2, "DQ3_K_M", (None, "q8_0", "q4_0"), WIDE_RUN),
    ("llama4-scout-17b-a16e", 2, "DQ3_K_M", (None, "q8_0"), WIDE_RUN),
    ("qwen2-72b", 2, "DQ3_K_M", (None, "q8_0"), WIDE_RUN))


# the cases whose weights also take the one-shot forward (``Model.forward``,
# 1 x FORWARD_PARITY_TOKENS tokens from seed 1): the dense phase's models
# at the parity depths
FORWARD_PARITY = {("qwen2-1.5b", 2, "DQ3_K_M"),
                  ("deepseek-v3-671b", 4, "DQ3_K_M")}
FORWARD_PARITY_TOKENS = 64


def phase_parity(torch) -> None:
    from repro_torch.configs import get_config

    for arch, depth, policy, pools, run in PARITY_CASES:
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        weights = parity_weights(torch, cfg, policy)
        inputs = parity_inputs(torch, cfg, seed=1, **run)
        for kv_quant in pools:
            result, error = parity_check(torch, weights, policy, kv_quant,
                                         inputs)
            emit(result)
            if error:
                fail(f"parity ({arch}, {policy}, {kv_quant or 'f32'}): "
                     f"{error}")
        if (arch, depth, policy) in FORWARD_PARITY:
            result = forward_parity(torch, weights, policy)
            emit(result)
            if not result["rel"] <= result["tol"]:
                fail(f"parity ({arch}, {policy}, forward): max|d| / "
                     f"max|logit| = {result['rel']}")
        del weights
        torch.cuda.empty_cache()


def forward_parity(torch, weights: tuple, policy: str) -> dict:
    """``Model.forward`` of 1 x FORWARD_PARITY_TOKENS tokens from seed 1 on
    the card (kernels) and the CPU (plain versions), f32: the logits of
    every position held to PARITY_TOL["f32"]."""
    model, qparams, cpu_params = weights
    cfg = model.cfg
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(4, cfg.vocab_size, (1, FORWARD_PARITY_TOKENS),
                         generator=gen, dtype=torch.int32)
    t0 = time.perf_counter()
    a, aux_a = model.forward(qparams, {"tokens": toks.cuda()})
    a, aux_a = a.cpu(), aux_a.item()
    t1 = time.perf_counter()
    b, aux_b = model.forward(cpu_params, {"tokens": toks})
    if a.shape != b.shape or not torch.isfinite(a).all():
        fail(f"parity ({cfg.name}, forward): bad logits {tuple(a.shape)}")
    return {"phase": "parity", "arch": cfg.name, "policy": policy,
            "entry": "forward", "layers": cfg.n_layers,
            "tokens": FORWARD_PARITY_TOKENS, "prompt_seed": 1,
            "max_abs": (a - b).abs().max().item(),
            "max_abs_logit": b.abs().max().item(), "rel": rel_apart(a, b),
            "aux": [aux_a, aux_b.item()], "tol": PARITY_TOL["f32"],
            "card_s": t1 - t0, "cpu_s": time.perf_counter() - t1}


def parity_weights(torch, cfg, policy: str) -> tuple:
    """``(model, card params, CPU params)``: ``cfg``'s weights from seed 0
    under ``policy``, f32, made on the card, and the CPU side's copy with
    every 2-D weight it multiplies dequantized to f32 once.  The plain
    version (``qmatmul_plain``) dequantizes such a weight on every call
    and then makes this same ``torch.matmul``; dequantizing took most of
    the CPU side's time.  Expert weights stay packed (the plain version
    dequantizes only the experts tokens were routed to), as does an
    untied token embedding (only its tokens' columns are dequantized)."""
    from repro_torch.convert import tree_to
    from repro_torch.core import QTensor, get_policy, init_quantized_params
    from repro_torch.models.model import Model

    qparams = init_quantized_params(cfg, get_policy(policy), 0,
                                    dtype=torch.float32,
                                    device=torch.device("cuda"))
    cpu = tree_to(qparams, "cpu")
    for k, v in cpu.items():
        if (isinstance(v, QTensor) and len(v.shape) == 2
                and (k != "token_embd" or cfg.tie_embeddings)):
            cpu[k] = v.dequantize(torch.float32)
    return Model(cfg, dtype=torch.float32), qparams, cpu


def parity_inputs(torch, cfg, *, B: int, C: int, max_len: int, steps_n: int,
                  short: int, seed: int) -> dict:
    """One prefill chunk of prompt tokens from ``seed`` (lane 1 ``short``
    tokens short) over pages of 16, then ``steps_n`` decode steps whose
    tokens are fixed, not sampled, so that a near-tie argmax cannot send
    the two devices down different streams."""
    from repro_torch.models import paged

    P = 16
    n = paged.pages_for(max_len, P)
    rng = torch.Generator().manual_seed(seed)
    toks = torch.randint(4, cfg.vocab_size, (B, C), generator=rng,
                         dtype=torch.int32)
    dec = torch.randint(4, cfg.vocab_size, (steps_n, B), generator=rng,
                        dtype=torch.int32)
    return {"B": B, "C": C, "P": P, "n": n, "max_len": max_len, "seed": seed,
            "toks": toks, "dec": dec,
            "clen": torch.tensor([C, C - short], dtype=torch.int32),
            "bt": torch.tensor([[2 + i * n + j for j in range(n)]
                                for i in range(B)], dtype=torch.int32)}


def parity_side(torch, model, params, kv_quant, inputs: dict, device
                ) -> tuple:
    """The chunk and the decode steps on ``device``: the logits of each
    (stacked, on the CPU) and the final cache's leaves on the CPU."""
    B, P, n, max_len = inputs["B"], inputs["P"], inputs["n"], inputs["max_len"]
    cache = model.init_paged_cache(2 + B * n, P, B, dtype=torch.float32,
                                   kv_quant=kv_quant, device=device)
    tables = {"full": inputs["bt"].to(device)}
    clen = inputs["clen"].to(device)
    out, cache = model.prefill_chunk(
        params, cache, inputs["toks"].to(device),
        torch.zeros(B, dtype=torch.int32, device=device), clen,
        max_len=max_len, block_tables=tables, page_size=P, kv_quant=kv_quant,
        active_pages=(n, 0))
    steps = [out]
    pos = clen.clone()
    for tok in inputs["dec"]:
        out, cache = model.decode_step_paged(
            params, cache, tok.to(device), pos, tables, page_size=P,
            max_len=max_len, active_pages=(n, 0),
            lane_pages={"full": (pos // P + 1).to(torch.int32)},
            kv_quant=kv_quant)
        steps.append(out)
        pos = pos + 1
    return (torch.stack(steps).cpu(),
            {k: v.cpu() for k, v in cache.items()})


@contextlib.contextmanager
def kv_writes(torch, log: list, card: list | None = None,
              ties: dict | None = None):
    """Every quantize-on-write of the pools (``paged.quantize_rows``, which
    each prefill and decode write calls) recorded into ``log`` in call
    order as ``(mode, value, codes, scale)`` on the CPU, q4_0 codes
    unpacked.  Given the card's record ``card``, each write takes the
    card's code where its own is a rounding tie broken the other way
    (``PARITY_TIE``), counted into ``ties`` (``broken``, the largest
    ``distance`` from the boundary in steps, ``refused``: codes apart
    that are no such tie, left as they are)."""
    from repro_torch.kernels.paged_attn import pack_q4_rows, unpack_q4_rows
    from repro_torch.models import paged

    own = paged.quantize_rows

    def write(val, mode):
        qs, d = own(val, mode)
        codes = (unpack_q4_rows(qs) if mode == "q4_0" else qs).cpu()
        x, scale = val.to(torch.float32).cpu(), d.cpu()
        if card is not None:
            cmode, cx, ccodes, cscale = card[len(log)]
            if (cmode, cx.shape) != (mode, x.shape):
                fail(f"write {len(log)}: {mode} {tuple(x.shape)} on the "
                     f"CPU, {cmode} {tuple(cx.shape)} on the card")
            apart = codes != ccodes
            if bool(apart.any()):
                mid = (codes.to(torch.float32) + ccodes) / 2
                dist = torch.maximum(
                    (x / scale.clamp(min=1e-30)[..., None] - mid).abs(),
                    (cx / cscale.clamp(min=1e-30)[..., None] - mid).abs())
                tie = apart & ((codes.int() - ccodes.int()).abs() == 1) & (
                    dist <= PARITY_TIE)
                ties["refused"] += int((apart & ~tie).sum())
                ties["broken"] += int(tie.sum())
                if bool(tie.any()):
                    ties["distance"] = max(ties["distance"],
                                           float(dist[tie].max()))
                codes = torch.where(tie, ccodes, codes)
                packed = pack_q4_rows(codes) if mode == "q4_0" else codes
                qs = packed.to(qs.device)
        log.append((mode, x, codes, scale))
        return qs, d

    paged.quantize_rows = write
    try:
        yield
    finally:
        paged.quantize_rows = own


def parity_check(torch, weights: tuple, policy: str, kv_quant,
                 inputs: dict) -> tuple:
    """``parity_inputs`` through the card (kernels) and the CPU (plain
    versions) over ``kv_quant`` pools (None: model-dtype): the result line
    and what failed (None if nothing did)."""
    from repro_torch.models import paged

    model, qparams, cpu_params = weights
    cfg = model.cfg
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    steps_n = len(inputs["dec"])
    card_log, cpu_log, secs = [], [], {}
    t0 = time.perf_counter()
    with kv_writes(torch, card_log):
        a, ca = parity_side(torch, model, qparams, kv_quant, inputs, dev)
    secs["card"] = time.perf_counter() - t0
    with kv_writes(torch, cpu_log):
        b, cb = parity_side(torch, model, cpu_params, kv_quant, inputs, cpu)
    secs["cpu"] = time.perf_counter() - secs["card"] - t0
    result = {"phase": "parity", "arch": cfg.name, "policy": policy,
              "kv": kv_quant or "f32", "layers": cfg.n_layers,
              "chunk": inputs["C"], "prompt_seed": inputs["seed"],
              "decode_steps": steps_n}
    if (a.shape != (steps_n + 1, inputs["B"], cfg.vocab_size)
            or not torch.isfinite(a).all()):
        return result, f"bad logits {tuple(a.shape)}"
    stats = (paged.codes_apart(cfg, kv_quant, ca, cb) if kv_quant
             else {"first_layer": None})
    if (stats["first_layer"] is not None and stats["max_step_first"] == 1
            and "q4_0" in stats["first_modes"]):
        result.update(own_ties={"rel": rel_apart(a, b),
                                "codes_apart": stats["apart"],
                                "first_layer_apart": stats["first_layer"]})
        ties = {"broken": 0, "distance": 0.0, "refused": 0}
        with kv_writes(torch, [], card_log, ties):
            b, cb = parity_side(torch, model, cpu_params, kv_quant, inputs,
                                cpu)
        result["card_ties"] = ties
        if ties["refused"]:
            return result, (f"{ties['refused']} codes apart that are no "
                            f"rounding tie")
    result.update(max_abs=(a - b).abs().max().item(),
                  max_abs_logit=b.abs().max().item(), rel=rel_apart(a, b),
                  card_s=secs["card"], cpu_s=secs["cpu"])
    # every page but GARBAGE, the sink of padded writes, whose order among
    # duplicates is unspecified and which is never read
    read = [i for i in range(2 + inputs["B"] * inputs["n"])
            if i != paged.GARBAGE_PAGE]
    if any(not torch.equal(ca[k][read], cb[k][read]) for k in ca
           if k.endswith("/pos")):
        return result, "the caches' positions differ"
    try:    # skips GARBAGE too
        tol, apart = paged.parity_limit(cfg, kv_quant, ca, cb,
                                        exact=PARITY_TOL["f32"],
                                        stepped=PARITY_TOL["q8_0"])
    except ValueError as e:
        return result, str(e)
    if apart:
        result.update(codes_apart=apart["apart"],
                      first_layer_apart=apart["first_layer"],
                      max_step_all=apart["max_step_all"])
        if kv_quant == "q8_0" and apart["max_step_all"] > 1:
            return result, "q8_0 codes more than one step apart"
    result["tol"] = tol
    if not result["rel"] <= tol:
        return result, f"max|d| / max|logit| = {result['rel']}"
    return result, None


def rel_apart(a, b) -> float:
    """max|a - b| / max|b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


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


# the attention kernels a serve launches per pool kind (None: model-dtype
# pools, whose GQA and MLA prefill attention is plain PyTorch); dq's quant
# probe serves shadow bf16 pools through the same steps
GQA_POOLS = {"q8_0": ("paged_attn_decode_quant", "paged_attn_prefill_quant"),
             None: ("paged_attn_decode",),
             "q4_0": ("paged_attn_decode_quant_q4_0",
                      "paged_attn_prefill_quant_q4_0")}
GQA_POOLS["dq"] = GQA_POOLS["q8_0"] + GQA_POOLS["q4_0"] + GQA_POOLS[None]
MLA_POOLS = {"q8_0": ("paged_mla_decode_quant", "paged_mla_prefill_quant"),
             None: ("paged_mla_decode",),
             "q4_0": ("paged_mla_decode_quant_q4_0",
                      "paged_mla_prefill_quant_q4_0")}
MLA_POOLS["dq"] = MLA_POOLS["q8_0"] + MLA_POOLS[None] + (
    "paged_mla_decode_quant_q8_0_q4_0", "paged_mla_prefill_quant_q8_0_q4_0")


def b1_path(cfg, policy: str) -> tuple:
    """The B1 wrappers a serve of ``cfg`` under ``policy`` launches, from
    its format map: ``qmatmul_<f>`` for every format of a multiplied 2-D
    weight (the decode form at a step's M <= 4 rows; an untied token
    embedding is only gathered), ``qmatmul_<f>_prefill`` for those that
    also multiply a chunk's 512 rows (all but the output head, which takes
    one row a lane), ``qmatmul_experts_<f>`` for every expert format; and
    (K, format) -> roles of the multiplied 2-D weights whose K is not a
    whole number of the format's blocks (qwen2-72b's down: K = 29568)."""
    from repro_torch.core import FORMATS, format_map, get_policy
    from repro_torch.models.spec import model_specs

    specs = model_specs(cfg)
    head = "token_embd" if cfg.tie_embeddings else "output"
    dense, prefill, experts, ragged = set(), set(), set(), {}
    for path, f in format_map(cfg, get_policy(policy)).items():
        if f not in FORMATS or (path == "token_embd"
                                and not cfg.tie_embeddings):
            continue
        s = specs[path]
        if len(s.shape) == 3:
            experts.add(f)
            continue
        dense.add(f)
        if path != head:
            prefill.add(f)
        if s.shape[0] % FORMATS[f].block:
            ragged.setdefault((s.shape[0], f), set()).add(s.role)
    return (tuple(f"qmatmul_{f}" for f in sorted(dense))
            + tuple(f"qmatmul_{f}_prefill" for f in sorted(prefill))
            + tuple(f"qmatmul_experts_{f}" for f in sorted(experts)),
            ragged)


def phase_serve(torch, summary: dict, streams: dict, reads: dict) -> None:
    from repro_torch.configs import get_config

    counters = launch_counters()
    totals = {k: 0 for k in KERNELS}
    serve = functools.partial(serve_model, torch, counters=counters,
                              totals=totals, streams=streams, reads=reads)
    # dq: the quant probe's shadow bf16 pools decode through B2 (B7 for MLA)
    serve(get_config("qwen2-1.5b"), "DQ3_K_M", ("q8_0", None, "q4_0", "dq"),
          profiled=("q8_0", None, "dq"))
    deepseek = deepseek_cut()
    serve(deepseek, "DQ3_K_M", ("q8_0", None, "q4_0", "dq"),
          profiled=("q8_0", None, "dq"))
    # the paper's other policies, q8_0 pools (the pool kinds are covered
    # above); each policy's weights are freed before the next is made
    for policy in ("Q4_K_M", "Q3_K_M", "Q2_K_L", "Q8_0"):
        serve(deepseek, policy, ("q8_0",), profiled=("q8_0",))
    # the other full-attention models, whole: the paper's distilled 32B
    # under DQ3_K_M and its 4-bit comparator Q4_K_M (dq with the quant
    # probe), phi3 at head_dim 96 (a group of 1) with q8_0 and q4_0 pools,
    # llama4-scout (GQA beside 16 experts, top-1), qwen2-72b (80 layers,
    # the ragged K = 29568)
    distill = get_config("deepseek-r1-distill-qwen-32b")
    serve(distill, "DQ3_K_M", ("q8_0", "dq"), profiled=("q8_0",))
    serve(distill, "Q4_K_M", ("q8_0",), profiled=())
    serve(get_config("phi3-mini-3.8b"), "DQ3_K_M", ("q8_0", "q4_0"),
          profiled=())
    serve(get_config("llama4-scout-17b-a16e"), "DQ3_K_M", ("q8_0",),
          profiled=("q8_0",))
    serve(get_config("qwen2-72b"), "DQ3_K_M", ("q8_0",), profiled=())
    for name in KERNELS:
        summary.setdefault(name, kernel_entry(name))["launches"] = totals[name]


def counted_serve(torch, counters: dict, engine, reqs) -> tuple:
    """``engine.serve(reqs)`` on 4 slots, counted (:func:`counted_run`)."""
    return counted_run(torch, counters,
                       lambda: engine.serve(reqs, slots=4, seed=0))


def counted_run(torch, counters: dict, run) -> tuple:
    """``run()`` with every launch counter set to 0 just before and read
    just after: (its result, launches by summary row, B1's launches by
    (format, form), the libraries' own counts)."""
    from repro_torch.kernels import qmatmul as qm

    for c in counters.values():
        c.launches = 0
    lib = [(f, w) for f in qm.FIELDS for w in ("decode", "prefill",
                                                  "experts")]
    forms = {fw: qm.library_launches(*fw) for fw in lib}
    done = run()
    torch.cuda.synchronize()
    forms = {fw: qm.library_launches(*fw) - n for fw, n in forms.items()}
    launches = {k: c.launches for k, c in counters.items()}
    launches.update({f"qmatmul_{f}_prefill": forms[f, "prefill"]
                     for f in qm.FIELDS})
    return done, launches, forms


def serve_model(torch, cfg, policy: str, pools: tuple, *, counters: dict,
                totals: dict, profiled: tuple, streams: dict,
                reads: dict) -> None:
    """Weights from seed 0 made and quantized on the card (``policy``,
    bf16), packed to the bytes of the size calculator, then 8 greedy
    requests per pool kind of ``pools`` (a ``kv_quant``, or None for bf16
    pools); each run must launch its path's B1 forms (:func:`b1_path`) and
    attention kernels, counted from 0 just before each serve and read just
    after.  The "dq" serve runs the quant probe, whose
    shadow bf16 pools are served through the same steps (its step times
    include them).  One decode step per pool kind of ``profiled`` is
    traced.  Each serve's streams go into ``streams`` by (model, policy,
    pool kind), for the sched and dense phases, and its ``decode_kv_bytes``
    into ``reads``."""
    from repro_torch.core import (QTensor, get_policy, init_quantized_params,
                                  model_size)
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
    # the packed layout of both packages: every QTensor field and float
    # leaf, the tied head counted once (it is one leaf, token_embd)
    size = model_size(cfg, get_policy(policy))
    if packed != size.tpu_bytes:
        fail(f"serve ({cfg.name}, {policy}): packed {packed} bytes, the "
             f"size calculator {size.tpu_bytes}")
    attn = MLA_POOLS if cfg.mla else GQA_POOLS
    b1, ragged = b1_path(cfg, policy)
    path_kernels = {kv: b1 + attn[kv] for kv in pools}
    model = Model(cfg, dtype=torch.bfloat16)
    for kv_quant in pools:
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
        done, launches, forms = counted_serve(torch, counters, engine, reqs)
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
                                    for (f, w), v in forms.items()
                                    if v and w != "experts"}}
        if engine.quant_probe:
            res["quant_probe_steps"] = st.quant_probe_steps
            res["quant_logit_gap_per_lane"] = st.quant_logit_gap_per_lane
        res["size_gib"] = {"gguf": size.gib, "soa": size.tpu_gib}
        res["avg_bits"] = size.avg_bits
        if ragged:
            res["ragged_k"] = [
                {"K": k, "format": f, "roles": sorted(roles),
                 "decode_launches": forms[f, "decode"],
                 "prefill_launches": forms[f, "prefill"]}
                for (k, f), roles in sorted(ragged.items())]
        emit(res)
        streams[cfg.name, policy, label] = {r.rid: r.out for r in done}
        reads[cfg.name, policy, label] = st.decode_kv_bytes
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
        # form (qmatmul_prefill_kernel takes every one-weight call at M > 4)
        for f in qm.FIELDS:
            if f"qmatmul_{f}" not in path_kernels[kv_quant]:
                continue
            if forms[f, "decode"] <= 0:
                fail(f"{what}: {f} took its decode form "
                     f"{forms[f, 'decode']} times")
        # a ragged K's format took both forms (its weight is multiplied at
        # every step and every chunk)
        for k, f in ragged:
            if forms[f, "decode"] <= 0 or forms[f, "prefill"] <= 0:
                fail(f"{what}: K = {k} in {f}: decode form "
                     f"{forms[f, 'decode']}, prefill form "
                     f"{forms[f, 'prefill']} launches")
        gaps = st.quant_logit_gap_per_lane
        if engine.quant_probe and not (
                st.quant_probe_steps and gaps
                and all(math.isfinite(g) and g > 0 for g in gaps)):
            fail(f"{what}: quant probe gaps {gaps} over "
                 f"{st.quant_probe_steps} steps")
        for k, v in launches.items():
            totals[k] += v
    for kv_quant in profiled:
        # (tracing a step of 8,000-9,000 kernels takes seconds)
        steps = 5 if cfg.n_layers <= 32 and not cfg.is_moe else 3
        for line in profile_decode(torch, model, qparams, kv_quant,
                                   steps=steps):
            emit(dict(line, policy=policy))
    del qparams, model, engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the preempt scheduler, KV swap and the fault plane
# ---------------------------------------------------------------------------

# the serve phase's traffic on a pool too small for four live lanes: 60
# usable pages of 16 tokens (plus the two reserved), against 26 pages for
# the largest request (378 + 32 tokens) and 4 x 64 for the worst case
SCHED_PAGES = 2 + 60
# a preempt serve's greedy stream may part from the reserve serve's (or a
# bystander's from the fault-free run's) only at a near-tie: where, in the
# logits the serve sampled the parting token from, the other run's token
# lies within this many bf16 steps (2^-7 of the larger's binade) of the
# token taken.  A resumed lane meets other batch mixes, and the kernels'
# splits follow the batch, so its sums run in another order; with random
# weights the top two of qwen2's 151,936 logits often lie only a few steps
# apart (scripts/stream_partings.py measures where streams part).
SCHED_TIE_STEPS = 4
# one of each fault kind on qwen2-1.5b with q8_0 pools; the steps fall in
# the schedule these requests take through SCHED_PAGES (the first live
# eviction near step 14, swap-ins after it): a corrupted page (rid 3), a
# NaN logits row (rid 5) and a cancel (rid 7)
SCHED_PLAN = (dict(kind="swap_out_fail", step=0),
              dict(kind="swap_in_fail", step=0),
              dict(kind="alloc_fail", step=20),
              dict(kind="latency", step=30, value=0.2),
              dict(kind="corrupt_page", step=55, rid=3),
              dict(kind="nan_logits", step=68, rid=5),
              dict(kind="cancel", step=40, rid=7))
SCHED_FAILED, SCHED_CANCELLED = (3, 5), (7,)


def phase_sched(torch, summary: dict, streams: dict, held: dict) -> None:
    from repro_torch.configs import get_config

    emit({"phase": "sched", "pages": SCHED_PAGES,
          "tie_limit": (f"the two tokens' logits within {SCHED_TIE_STEPS} "
                        "bf16 steps"),
          "plan": list(SCHED_PLAN)})
    counters = launch_counters()
    sched_model(torch, get_config("qwen2-1.5b"), ("q8_0", "q4_0"),
                counters=counters, summary=summary, reserve=streams,
                held=held)
    sched_model(torch, deepseek_cut(), ("q8_0",), counters=counters,
                summary=summary, reserve=None, held=held)


def deepseek_cut():
    """DeepSeek-V3 cut to 7 layers at full width: the 3 dense layers of the
    published config and 4 MoE layers, where ffn_down_exps takes all three
    of DQ3_K_M's formats."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=7)


def held_weights(torch, cfg, held: dict) -> dict:
    """``cfg``'s weights from seed 0 under DQ3_K_M, bf16, made on the card
    once for the sched and dense phases (``held``, by model name)."""
    from repro_torch.core import get_policy, init_quantized_params

    if cfg.name not in held:
        held[cfg.name] = init_quantized_params(
            cfg, get_policy("DQ3_K_M"), 0, dtype=torch.bfloat16,
            device=torch.device("cuda"))
    return held[cfg.name]


def sched_model(torch, cfg, pools: tuple, *, counters: dict, summary: dict,
                reserve: dict | None, held: dict) -> None:
    """The serve phase's weights (seed 0, DQ3_K_M, bf16) and requests, in
    two classes, through ``scheduler="preempt"`` on SCHED_PAGES pages per
    pool kind of ``pools``: every request completes, lanes are evicted and
    swapped back in, the swap bytes balance, no page leaks, every kernel of
    the path launches (counted from 0 around the serve), and one lane's
    pages round-trip byte for byte.  With ``reserve`` (the serve phase's
    streams, by (model, policy, pool kind)) the streams are also held to
    the reserve serve's (served here when the serve phase did not run),
    and the first pool kind serves SCHED_PLAN."""
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine, FaultPlan, Fault, SamplerConfig
    from repro_torch.serving.faults import KINDS

    dev = torch.device("cuda")
    qparams = held_weights(torch, cfg, held)
    model = Model(cfg, dtype=torch.bfloat16)
    attn = MLA_POOLS if cfg.mla else GQA_POOLS
    b1, _ = b1_path(cfg, "DQ3_K_M")

    def requests():
        reqs = build_requests(8, cfg.vocab_size, 100, 400, 32, seed=0)
        for r in reqs:
            r.priority = r.rid % 2
        return reqs

    def engine(kv_quant, **kw):
        return Engine(model, qparams, max_len=1024, device=dev,
                      sampler=SamplerConfig(greedy=True), page_size=16,
                      prefill_chunk=128, kv_quant=kv_quant, **kw)

    for n, kv_quant in enumerate(pools):
        label = kv_quant or "bf16"
        what = f"sched ({cfg.name}, {label})"
        emit(dict(page_roundtrip(torch, model, kv_quant), phase="sched",
                  arch=cfg.name, kv=label))
        want = None if reserve is None else reserve.get(
            (cfg.name, "DQ3_K_M", label))
        if reserve is not None and want is None:
            ref = engine(kv_quant)
            want = {r.rid: r.out for r in ref.serve(requests(), slots=4)}
            rst = ref.last_stats
            emit({"phase": "sched", "arch": cfg.name, "kv": label,
                  "scheduler": "reserve", "wall_s": rst.wall_s,
                  "decode_steps": rst.decode_iterations,
                  "prefill_chunks": rst.prefill_iterations,
                  "decode_step_ms_p50": rst.decode_step_ms(0.5),
                  "decode_step_ms_p90": rst.decode_step_ms(0.9),
                  "ttft_ms_mean": rst.mean_admission_s * 1e3})
        eng = engine(kv_quant, scheduler="preempt", num_pages=SCHED_PAGES)
        reqs = requests()
        with recording(model) as calls:
            done, launches, _ = counted_serve(torch, counters, eng, reqs)
        st = eng.last_stats
        got = {r.rid: r.out for r in done}
        res = sched_line(st, what)
        res.update(arch=cfg.name, layers=cfg.n_layers, kv=label,
                   launches={k: v for k, v in launches.items() if v})
        if want is not None:
            res["streams_equal_reserve"] = sum(got[k] == want[k]
                                               for k in want)
            res["splits"] = hold_streams(torch, reqs, got, want, calls, what,
                                         "reserve")
        del calls
        emit(res)
        if any(r.status != "ok" or len(r.out) != 32 for r in done):
            fail(f"{what}: not every request completed: "
                 f"{[(r.rid, r.status, len(r.out)) for r in done]}")
        if st.preemptions < 2 or not st.swap_in_s:
            fail(f"{what}: {st.preemptions} preemptions, "
                 f"{len(st.swap_in_s)} swap-ins")
        missing = [k for k in b1 + attn[kv_quant] if launches[k] <= 0]
        if missing:
            fail(f"{what}: kernels never launched: {missing}")
        for k, v in launches.items():
            entry = summary.setdefault(k, kernel_entry(k))
            entry["launches"] = (entry["launches"] or 0) + v
        if reserve is None or n:
            continue
        # the fixed fault plan, held to the fault-free preempt serve
        plan = FaultPlan([Fault(**f) for f in SCHED_PLAN])
        ceng = engine(kv_quant, scheduler="preempt", num_pages=SCHED_PAGES,
                      faults=plan, watchdog_factor=2.0)
        creqs = requests()
        with recording(model) as calls:
            cdone = ceng.serve(creqs, slots=4)
        cst = ceng.last_stats
        cwhat = f"{what} under SCHED_PLAN"
        statuses = {r.rid: r.status for r in cdone}
        cres = sched_line(cst, cwhat)
        cres.update(arch=cfg.name, kv=label, chaos=True,
                    statuses=statuses, fault_log=cst.fault_log,
                    slow_steps=cst.slow_steps,
                    nan_quarantines=cst.nan_quarantines,
                    pages_corrupted=cst.pages_corrupted,
                    alloc_stalls=cst.alloc_stalls,
                    swap_failures=cst.swap_failures,
                    swap_retries=cst.swap_retries)
        bystanders = {r.rid: r.out for r in cdone if r.status == "ok"}
        cres["splits"] = hold_streams(torch, creqs, bystanders, got, calls,
                                      cwhat, "fault-free")
        del calls
        emit(cres)
        expect = {rid: ("failed" if rid in SCHED_FAILED else "cancelled"
                        if rid in SCHED_CANCELLED else "ok")
                  for rid in range(8)}
        if statuses != expect:
            fail(f"{cwhat}: statuses {statuses}, expected {expect}")
        if cst.nan_quarantines != 2 or cst.slow_steps < 1:
            fail(f"{cwhat}: {cst.nan_quarantines} quarantines, "
                 f"{cst.slow_steps} slow steps")
        landed = {f["kind"] for f in cst.fault_log}
        if landed != set(KINDS) or cst.faults_injected != len(cst.fault_log):
            fail(f"{cwhat}: faults landed {sorted(landed)}")


def sched_line(st, what: str) -> dict:
    """A preempt serve's detail line; fails on unbalanced swap bytes or a
    leaked page."""
    swaps = st.swap_out_s + st.swap_in_s
    res = {"phase": "sched", "scheduler": "preempt", "wall_s": st.wall_s,
           "preemptions": st.preemptions, "swap_outs": len(st.swap_out_s),
           "swap_ins": len(st.swap_in_s), "swap_restarts": st.swap_restarts,
           "swap_out_bytes": st.swap_out_bytes,
           "swap_in_bytes": st.swap_in_bytes,
           "swap_dropped_bytes": st.swap_dropped_bytes,
           "swap_held_bytes": st.swap_held_bytes,
           "swap_mib_per_swap": (st.swap_out_bytes / 2**20
                                 / max(len(st.swap_out_s), 1)),
           "swap_out_ms": [t * 1e3 for t in st.swap_out_s],
           "swap_in_ms": [t * 1e3 for t in st.swap_in_s],
           "swap_ms_mean": 1e3 * sum(swaps) / max(len(swaps), 1),
           "decode_steps": st.decode_iterations,
           "prefill_chunks": st.prefill_iterations,
           "decode_step_ms_p50": st.decode_step_ms(0.5),
           "decode_step_ms_p90": st.decode_step_ms(0.9),
           "ttft_ms_mean": st.mean_admission_s * 1e3,
           "class_queue_wait_ms": {
               c: v["mean_queue_wait_s"] * 1e3
               for c, v in st.class_stats.items()},
           "pages_leaked": st.pages_leaked, "peak_pages": st.peak_pages}
    if st.swap_out_bytes != st.swap_in_bytes + st.swap_dropped_bytes:
        fail(f"{what}: swapped out {st.swap_out_bytes} B, in "
             f"{st.swap_in_bytes} B, dropped {st.swap_dropped_bytes} B")
    if st.pages_leaked:
        fail(f"{what}: {st.pages_leaked} pages leaked")
    return res


def page_roundtrip(torch, model, kv_quant) -> dict:
    """Random bytes in every leaf of a full-width SCHED_PAGES pool; one
    lane's 26 pages out to the host and back in at other page ids, as a
    swap moves them (``paged.extract_pages`` / ``inject_pages``): byte for
    byte, timed (CUDA synchronized around each direction)."""
    from repro_torch.models import paged

    dev = torch.device("cuda")
    cache = model.init_paged_cache(SCHED_PAGES, 16, 4, dtype=model.dtype,
                                   kv_quant=kv_quant, device=dev)
    twin = {k: torch.zeros_like(v) for k, v in cache.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    for v in cache.values():
        b = v.view(torch.uint8)
        b.copy_(torch.randint(0, 256, b.shape, dtype=torch.uint8,
                              device=dev, generator=gen))
    src = list(range(2, 28))
    dst = list(range(SCHED_PAGES - 26, SCHED_PAGES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = {k: paged.extract_pages(v, src).cpu() for k, v in cache.items()}
    t1 = time.perf_counter()
    for k, v in twin.items():
        paged.inject_pages(v, dst, rows[k])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bad = [k for k in cache if not torch.equal(
        twin[k][dst].view(torch.uint8), cache[k][src].view(torch.uint8))]
    if bad:
        fail(f"page round trip ({model.cfg.name}, {kv_quant}): {bad[:4]}")
    return {"roundtrip": "exact", "pages": len(src), "leaves": len(cache),
            "leaf_kinds": sorted({f"{k.rsplit('/', 1)[1]}:{v.dtype}"
                                  for k, v in cache.items()}),
            "mib": sum(r.numel() * r.element_size()
                       for r in rows.values()) / 2**20,
            "out_ms": (t1 - t0) * 1e3, "in_ms": (t2 - t1) * 1e3}


def hold_streams(torch, reqs, got: dict, want: dict, calls: list,
                 what: str, other: str) -> list:
    """Every stream of ``got`` against ``want``'s (by rid): where one parts
    from the other, the logits ``got``'s serve sampled the first parting
    token from (``calls``, kept by :func:`recording`) must hold ``want``'s
    token within SCHED_TIE_STEPS bf16 steps of the token taken, a near-tie;
    returns the partings."""
    splits = []
    prompts = {r.rid: r.prompt for r in reqs}
    for rid, a in sorted(got.items()):
        b = want[rid]
        if a == b:
            continue
        if len(a) != len(b):
            fail(f"{what}: rid {rid} gave {len(a)} tokens, the {other} "
                 f"serve {len(b)}")
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = sampled_logits(calls, prompts[rid], a, i)
        if logits is None:
            fail(f"{what}: rid {rid}: no logits recorded for token {i}")
        logits = logits.float()
        la, lb = logits[a[i]].item(), logits[b[i]].item()
        step = 2.0 ** (math.floor(math.log2(max(abs(la), abs(lb)) or 1.0))
                       - 7)
        gap, limit = la - lb, SCHED_TIE_STEPS * step
        two = torch.topk(logits, 2).values.tolist()
        splits.append({"rid": rid, "at": i, "tokens": [a[i], b[i]],
                       "gap": gap, "limit": limit,
                       "top2_gap": two[0] - two[1]})
        if not gap <= limit:
            fail(f"{what}: rid {rid} parts from the {other} serve at token "
                 f"{i}: the two tokens' logits lie {gap} apart > {limit}")
    return splits


@contextlib.contextmanager
def recording(model):
    """Keep every decode step's and prefill chunk's inputs and logits, on
    the card and without a copy, while the model serves: a list of
    ``(kind, tokens, positions or (start, length), logits)``."""
    calls = []
    decode, prefill = model.decode_step_paged, model.prefill_chunk

    def decode_rec(params, cache, toks, pos, *args, **kw):
        logits, cache = decode(params, cache, toks, pos, *args, **kw)
        calls.append(("decode", toks, pos, logits))
        return logits, cache

    def prefill_rec(params, cache, toks, start, clen, *args, **kw):
        logits, cache = prefill(params, cache, toks, start, clen, *args,
                                **kw)
        calls.append(("prefill", toks, (start, clen), logits))
        return logits, cache

    model.decode_step_paged, model.prefill_chunk = decode_rec, prefill_rec
    try:
        yield calls
    finally:
        del model.decode_step_paged, model.prefill_chunk


def sampled_logits(calls: list, prompt: list, out: list, i: int):
    """The logits row ``out[i]`` was sampled from: the prefill chunk that
    ended the prompt (i = 0) or the decode step fed ``out[i - 1]`` at its
    position; the last such call, as a restarted lane recomputes."""
    n = len(prompt)
    for kind, toks, where, logits in reversed(calls):
        if kind == "decode" and i:
            for s, (t, p) in enumerate(zip(toks.tolist(), where.tolist())):
                if t == out[i - 1] and p == n + i - 1:
                    return logits[s]
        elif kind == "prefill" and not i:
            start, clen = (w.tolist() for w in where)
            for s, (lo, c) in enumerate(zip(start, clen)):
                if c and lo + c == n and toks[s, :c].tolist() == prompt[lo:]:
                    return logits[s]
    return None


# ---------------------------------------------------------------------------
# phase 6: the one-shot and dense entry points
# ---------------------------------------------------------------------------

# the loss's batch: DENSE_LOSS_SHAPE token ids from seed 0, next-token
# labels, -1 at each row's last position and the first DENSE_MASKED of
# row 0
DENSE_LOSS_SHAPE = (2, 1024)
DENSE_MASKED = 100
# of the serve phase's 8 requests: the 2 that serve_sequential serves, and
# the 2 whose prompts (of unequal length) one generate call takes
DENSE_SEQ_RIDS = (0, 1)
DENSE_GEN_RIDS = (2, 3)
ATTN_ROWS = tuple(k for k in KERNELS if k.startswith("paged_"))
# The runs' numbers are held in f32 and teacher-forced (:func:`forcing`):
# each request is fed the first DENSE_FORCED tokens of the paged bf16
# serve's stream in place of the tokens it samples, so a run and its
# reference compute each logits row from the same tokens, and the rows are
# held to each other at PARITY_TOL (max|d| / max|logit| a row).  No limit
# on bf16 rows at these depths would tell a fault from rounding: under
# another summation order the card's bf16 logits lie 0.8-7.0 apart of ~9
# (PERF.md, PR 28, run SP).  DENSE_FORCED_LAYERS gives each model's depth
# for these runs: (model-dtype caches, q8_0 pools).  Over q8_0 pools a
# value that a rounding difference moves across a rounding boundary moves
# its code by one step, which moves the logits by up to ~3e-3 at the
# parity phase's depths (the readings behind PARITY_TOL["q8_0"]), and
# every layer after it moves them further.  DeepSeek-V3 runs its 3 dense
# layers: its MoE layers couple the rows of a batch through expert
# capacity, padding rows and free lanes included, and those rows hold
# other values under plain than under fused attention, so a real token's
# expert can be dropped in one run and not the other (at 7 layers a
# prefill's logits lay 0.13 apart, PERF.md, PR 29, run W1).
DENSE_FORCED = 8
DENSE_FORCED_LAYERS = {"qwen2-1.5b": (28, 2), "deepseek-v3-671b": (3, 3)}


def phase_dense(torch, summary: dict, streams: dict, reads: dict,
                held: dict) -> None:
    from repro_torch.configs import get_config

    emit({"phase": "dense", "loss_tokens": list(DENSE_LOSS_SHAPE),
          "sequential_rids": list(DENSE_SEQ_RIDS),
          "generate_rids": list(DENSE_GEN_RIDS),
          "forced_tokens": DENSE_FORCED,
          "forced_q8_0_layers": DENSE_FORCED_LAYERS,
          "tol": PARITY_TOL})
    counters = launch_counters()
    for cfg in (get_config("qwen2-1.5b"), deepseek_cut()):
        dense_model(torch, cfg, counters=counters, summary=summary,
                    streams=streams, reads=reads, held=held)


def dense_model(torch, cfg, *, counters: dict, summary: dict, streams: dict,
                reads: dict, held: dict) -> None:
    """``cfg`` under DQ3_K_M (the sched phase's weights) through the
    one-shot and dense entry points in bf16: ``Model.loss`` over 2 x 1024
    tokens; the serve phase's 8 requests through ``Engine(page_size=0)``
    and through ``Engine(kernel="gather")`` over q8_0 and over bf16 pools;
    two of them through ``serve_sequential`` over the dense layout and over
    q8_0 pools; two others' prompts through one ``generate`` call.  Every
    request completes, every kernel of the path launches and no attention
    kernel where the path has none, the KV bytes follow the layout, and
    the dense serve's streams equal the gather bf16 serve's bitwise (the
    same values through the same operations).  Then each run's numbers,
    in f32 and teacher-forced (:func:`dense_forced`)."""
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SamplerConfig

    dev = torch.device("cuda")
    qparams = held_weights(torch, cfg, held)
    model = Model(cfg, dtype=torch.bfloat16)
    b1, _ = b1_path(cfg, "DQ3_K_M")
    attn = MLA_POOLS if cfg.mla else GQA_POOLS
    emit(dense_loss(torch, model, qparams, counters, b1, summary))

    def engine(**kw):
        return Engine(model, qparams, max_len=1024, device=dev,
                      sampler=SamplerConfig(greedy=True), prefill_chunk=128,
                      **kw)

    def requests(rids=range(8)):
        return [r for r in build_requests(8, cfg.vocab_size, 100, 400, 32,
                                          seed=0) if r.rid in rids]

    for label in ("bf16", "q8_0"):
        # the paged serve's streams and reads (the serve phase's)
        key = (cfg.name, "DQ3_K_M", label)
        if key not in streams:
            ref = engine(page_size=16,
                         kv_quant=None if label == "bf16" else label)
            streams[key] = {r.rid: r.out for r in ref.serve(requests(),
                                                            slots=4)}
            reads[key] = ref.last_stats.decode_kv_bytes

    def run(what: str, go, reqs, *, attention: bool):
        """``go()`` counted; every request complete; the attention kernels
        launched only where ``attention``; B1 on every path."""
        done, launches, forms = counted_run(torch, counters, go)
        served = reqs is None
        got = ({r.rid: r.out for r in done} if served
               else {r.rid: out for r, out in zip(reqs, done)})
        res = {"phase": "dense", "arch": cfg.name, "layers": cfg.n_layers,
               "run": what, "requests": len(got),
               "launches": {k: v for k, v in launches.items() if v},
               "library_launches": {f"{f} {w}": v
                                    for (f, w), v in forms.items() if v}}
        if any(len(out) != 32 for out in got.values()) or (
                served and any(r.status != "ok" for r in done)):
            fail(f"{what}: not every request completed")
        if any(not 0 <= t < cfg.vocab_size for o in got.values() for t in o):
            fail(f"{what}: token outside the vocabulary")
        ran = [k for k in ATTN_ROWS if launches[k]]
        if attention and not ran:
            fail(f"{what}: no attention kernel launched")
        if not attention and ran:
            fail(f"{what}: attention kernels launched: {ran}")
        missing = [k for k in b1 if not launches[k]]
        if missing:
            fail(f"{what}: kernels never launched: {missing}")
        for k, v in launches.items():
            entry = summary.setdefault(k, kernel_entry(k))
            entry["launches"] = (entry["launches"] or 0) + v
        return res, got

    dense_streams = None
    for label, kw in (("bf16", dict(page_size=0)),
                      ("q8_0", dict(page_size=16, kernel="gather",
                                    kv_quant="q8_0")),
                      ("gather bf16", dict(page_size=16, kernel="gather"))):
        eng = engine(**kw)
        reqs = requests()
        what = (f"dense ({cfg.name}, "
                f"{'page_size=0' if label == 'bf16' else label})")
        res, got = run(what, lambda: eng.serve(reqs, slots=4, seed=0), None,
                       attention=False)
        st = eng.last_stats
        res.update(wall_s=st.wall_s, decode_steps=st.decode_iterations,
                   prefill_chunks=st.prefill_iterations,
                   decode_step_ms_p50=st.decode_step_ms(0.5),
                   decode_step_ms_p90=st.decode_step_ms(0.9),
                   ttft_ms_mean=st.mean_admission_s * 1e3,
                   dense_cache_bytes=st.dense_cache_bytes,
                   decode_kv_bytes=st.decode_kv_bytes,
                   kv_bytes_per_decoded_token=st.kv_bytes_per_decoded_token,
                   pages_leaked=st.pages_leaked)
        if label == "q8_0":
            res["fused_decode_kv_bytes"] = reads[cfg.name, "DQ3_K_M", label]
        if label == "gather bf16":
            # the same values through the same operations as page_size=0
            res["streams_equal_page_size_0"] = sum(
                got[k] == dense_streams[k] for k in got)
        emit(res)
        if label == "bf16":
            dense_streams = got
            if st.decode_kv_bytes != (eng._dense_kv_read_bytes(4)
                                      * st.decode_iterations):
                fail(f"{what}: decode_kv_bytes {st.decode_kv_bytes} is not "
                     f"{st.decode_iterations} steps of the dense cache")
        if label == "q8_0" and st.decode_kv_bytes < reads[
                cfg.name, "DQ3_K_M", label]:
            fail(f"{what}: decode_kv_bytes {st.decode_kv_bytes} below the "
                 "fused serve's")
        if label == "gather bf16" and got != dense_streams:
            fail(f"{what}: {res['streams_equal_page_size_0']} of "
                 f"{len(got)} streams equal the page_size=0 serve's")
        if st.pages_leaked:
            fail(f"{what}: {st.pages_leaked} pages leaked")

    for label, kw in (("bf16", dict(page_size=0)),
                      ("q8_0", dict(page_size=16, kv_quant="q8_0"))):
        eng = engine(**kw)
        reqs = requests(DENSE_SEQ_RIDS)
        what = f"dense ({cfg.name}, serve_sequential {label})"
        t0 = time.perf_counter()
        res, _ = run(what, lambda: eng.serve_sequential(reqs, seed=0), None,
                     attention=label != "bf16")
        emit(dict(res, wall_s=time.perf_counter() - t0,
                  decode_steps=eng.last_stats.decode_iterations))
        # over q8_0 pools each request runs alone through the fused serve
        missing = [k for k in attn["q8_0"] if label == "q8_0"
                   and k not in res["launches"]]
        if missing:
            fail(f"{what}: kernels never launched: {missing}")

    eng = engine(page_size=0)
    reqs = requests(DENSE_GEN_RIDS)
    what = f"dense ({cfg.name}, generate)"
    t0 = time.perf_counter()
    res, _ = run(what,
                 lambda: eng.generate([r.prompt for r in reqs], 32, seed=0),
                 reqs, attention=False)
    emit(dict(res, wall_s=time.perf_counter() - t0,
              prompt_tokens=[len(r.prompt) for r in reqs]))

    want = streams[cfg.name, "DQ3_K_M", "bf16"]
    layers, q8_layers = DENSE_FORCED_LAYERS[cfg.name]
    dense_forced(torch, cfg, qparams,
                 {rid: out[:DENSE_FORCED] for rid, out in want.items()},
                 layers=layers, q8_layers=q8_layers, device=dev)


def dense_forced(torch, cfg, qparams, forced: dict, *, layers: int,
                 q8_layers: int, device) -> None:
    """The dense phase's runs in f32 on ``qparams`` on ``device``, at
    ``layers`` (those over q8_0 pools at ``q8_layers``), teacher-forced
    with ``forced`` (by rid),
    each held to a reference run that batches the same tokens the same way
    (the experts' capacity couples the rows of a batch, free lanes too):
    the page_size=0 serve to the fused paged serve; the gather serve over
    q8_0 pools to the fused one; serve_sequential over the dense layout
    (one row, the whole prompt prefilled at once) to the fused serve of
    each request alone on one slot, its chunk as long as its prompt;
    serve_sequential over q8_0 pools to the gather one; generate, the
    longer prompt first (its padding rows come last, behind every real
    token), to the fused serve of both on two slots, the chunk as long as
    the longer prompt.  Every row of both within PARITY_TOL of its pool
    kind."""
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SamplerConfig

    prompts = {r.rid: r.prompt for r in build_requests(
        8, cfg.vocab_size, 100, 400, DENSE_FORCED, seed=0)}
    models = {kv: Model(dataclasses.replace(
        cfg, n_layers=q8_layers if kv else layers),
        dtype=torch.float32) for kv in (None, "q8_0")}

    def forced_run(kv, rids, go, **kw):
        """``go(engine, requests)`` over ``rids`` (in that order), forced:
        the logits rows by (rid, token index)."""
        from repro_torch.serving import Request

        reqs = [Request(rid=i, prompt=prompts[i], max_new=DENSE_FORCED)
                for i in rids]
        eng = Engine(models[kv], qparams, max_len=1024, device=device,
                     sampler=SamplerConfig(greedy=True), kv_quant=kv, **kw)
        with forcing(torch, models[kv], reqs, forced) as rows:
            go(eng, reqs)
        return rows

    def serve(slots):
        return lambda eng, reqs: eng.serve(reqs, slots=slots, seed=0)

    def sequential(eng, reqs):
        eng.serve_sequential(reqs, seed=0)

    def generate(eng, reqs):
        eng.generate([r.prompt for r in reqs], DENSE_FORCED, seed=0)

    everyone = tuple(range(8))
    gen = sorted(DENSE_GEN_RIDS, key=lambda i: -len(prompts[i]))
    alone = {}
    for rid in DENSE_SEQ_RIDS:
        alone.update(forced_run(None, (rid,), serve(1), page_size=16,
                                prefill_chunk=len(prompts[rid])))
    cases = (
        ("serve page_size=0", None,
         lambda: forced_run(None, everyone, serve(4), page_size=0,
                            prefill_chunk=128),
         "the fused paged serve",
         lambda: forced_run(None, everyone, serve(4), page_size=16,
                            prefill_chunk=128)),
        ("serve gather q8_0", "q8_0",
         lambda: forced_run("q8_0", everyone, serve(4), page_size=16,
                            kernel="gather", prefill_chunk=128),
         "the fused q8_0 serve",
         lambda: forced_run("q8_0", everyone, serve(4), page_size=16,
                            prefill_chunk=128)),
        ("serve_sequential bf16", None,
         lambda: forced_run(None, DENSE_SEQ_RIDS, sequential, page_size=0),
         "each request's fused serve on one slot, one chunk",
         lambda: alone),
        ("serve_sequential q8_0", "q8_0",
         lambda: forced_run("q8_0", DENSE_SEQ_RIDS, sequential,
                            page_size=16, prefill_chunk=128),
         "the gather q8_0 serve_sequential",
         lambda: forced_run("q8_0", DENSE_SEQ_RIDS, sequential,
                            page_size=16, kernel="gather",
                            prefill_chunk=128)),
        ("generate", None,
         lambda: forced_run(None, gen, generate, page_size=0),
         "the fused serve on two slots, one chunk",
         lambda: forced_run(None, gen, serve(2), page_size=16,
                            prefill_chunk=len(prompts[gen[0]]))))
    for what, kv, go, other, ref in cases:
        t0 = time.perf_counter()
        got, want = go(), ref()
        tol = PARITY_TOL["q8_0" if kv else "f32"]
        keys = sorted(want)
        if sorted(got) != keys or len(keys) != len(
                {r for r, _ in keys}) * DENSE_FORCED:
            fail(f"dense ({cfg.name}, forced {what}): rows {sorted(got)} "
                 f"against {keys}")
        a = torch.stack([got[k] for k in keys]).float()
        b = torch.stack([want[k] for k in keys]).float()
        rel = ((a - b).abs().amax(-1) / b.abs().amax(-1)).cpu()
        worst = int(rel.argmax())
        res = {"phase": "dense", "arch": cfg.name, "run": f"forced {what}",
               "dtype": "f32", "layers": models[kv].cfg.n_layers,
               "held_to": other, "rows": len(keys),
               "rel_max": rel.max().item(), "rel_p50": rel.median().item(),
               "worst": list(keys[worst]), "tol": tol,
               "seconds": time.perf_counter() - t0}
        emit(res)
        if not (torch.isfinite(a).all() and rel.max().item() <= tol):
            fail(f"dense ({cfg.name}, forced {what}): a row lies "
                 f"{res['rel_max']} apart (> {tol}) at {res['worst']}")


@contextlib.contextmanager
def forcing(torch, model, reqs, forced: dict):
    """Teacher forcing while an engine serves ``reqs`` on ``model``
    (``Engine.serve``, ``serve_sequential``, or ``generate`` over their
    prompts in order): each token the engine samples for request ``rid``
    becomes ``forced[rid][j]``, the j-th, as the next step's input and in
    its stream.  Yields ``{(rid, j): the logits row that token was sampled
    from}``.  A lane is told by the prompt its prefill writes; a decode
    row's token index follows from its position."""
    from repro_torch.serving import engine as engine_mod

    prompts = {r.rid: r.prompt for r in reqs}
    lane: dict = {}       # slot or row -> rid
    pending: dict = {}    # slot or row -> (rid, j) of the next sample
    rows: dict = {}
    names = ("prefill_chunk", "prefill", "decode_step", "decode_step_paged")
    own = {n: getattr(model, n) for n in names}
    sample = engine_mod.sample_per_slot

    def whose(toks: list, n: int) -> int:
        hits = [rid for rid, p in prompts.items() if p[:n] == toks[:n]]
        if len(hits) != 1:
            fail(f"forcing: a prefill row matches requests {hits}")
        return hits[0]

    def chunk(params, cache, toks, start, clen, *args, **kw):
        out = own["prefill_chunk"](params, cache, toks, start, clen, *args,
                                   **kw)
        pending.clear()
        for s, (t, lo, n) in enumerate(zip(toks.tolist(), start.tolist(),
                                           clen.tolist())):
            if n and not lo:
                lane[s] = whose(t, n)
            if n and lo + n == len(prompts[lane[s]]):
                pending[s] = (lane[s], 0)
        return out

    def prefill(params, batch, max_len, **kw):
        out = own["prefill"](params, batch, max_len, **kw)
        toks = batch["tokens"].tolist()
        lengths = kw["lengths"].tolist()
        pending.clear()
        for s, (t, n) in enumerate(zip(toks, lengths)):
            lane[s] = whose(t, n)
            pending[s] = (lane[s], 0)
        return out

    def step(name):
        def fn(params, cache, toks, pos, *args, **kw):
            out = own[name](params, cache, toks, pos, *args, **kw)
            live = kw.get("live")
            live = ([True] * len(toks) if live is None else live.tolist())
            pending.clear()
            for s, (t, p, on) in enumerate(zip(toks.tolist(), pos.tolist(),
                                               live)):
                if not on:
                    continue
                rid = lane[s]
                j = p - len(prompts[rid]) + 1
                if t != forced[rid][j - 1]:
                    fail(f"forcing: rid {rid} was fed {t} at token {j - 1}")
                pending[s] = (rid, j)
            return out
        return fn

    def forced_sample(logits, seeds, sampler):
        tok = sample(logits, seeds, sampler)
        if pending:
            at = sorted(pending)
            tok = tok.clone()
            for s in at:
                rows[pending[s]] = logits[s]
            tok[at] = torch.tensor([forced[r][j] for r, j in
                                    (pending[s] for s in at)],
                                   dtype=tok.dtype, device=tok.device)
        pending.clear()
        return tok

    model.prefill_chunk, model.prefill = chunk, prefill
    model.decode_step = step("decode_step")
    model.decode_step_paged = step("decode_step_paged")
    engine_mod.sample_per_slot = forced_sample
    try:
        yield rows
    finally:
        engine_mod.sample_per_slot = sample
        for n in names:
            delattr(model, n)


def dense_loss(torch, model, qparams, counters: dict, b1: tuple,
               summary: dict) -> dict:
    """``Model.loss`` over DENSE_LOSS_SHAPE token ids from seed 0 (some
    labels -1): finite, every 2-D weight on the prefill form (M = 2048
    rows), every expert weight on the expert form at the reference's
    capacity, no attention kernel; wall and device ms of one call, B1's
    launches by format and form, and the device time by kernel family
    of one traced call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe

    cfg = model.cfg
    dev = torch.device("cuda")
    b, t = DENSE_LOSS_SHAPE
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(4, cfg.vocab_size, (b, t), generator=gen,
                         dtype=torch.int32)
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    labels[0, :DENSE_MASKED] = -1
    batch = {"tokens": toks.to(dev), "labels": labels.to(dev)}
    # a short forward first, so that loading kernels is not timed
    model.loss(qparams, {k: v[:1, :64] for k, v in batch.items()})
    capacities = []
    own = moe.moe_dispatch

    def spy(x, gates, idx, n_experts, capacity):
        capacities.append(capacity)
        return own(x, gates, idx, n_experts, capacity)

    moe.moe_dispatch = spy
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        def go():
            start.record()
            out = model.loss(qparams, batch)
            end.record()
            return out
        t0 = time.perf_counter()
        (total, parts), launches, forms = counted_run(torch, counters, go)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        moe.moe_dispatch = own
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.loss(qparams, batch)
        torch.cuda.synchronize()
    fams: dict[str, float] = {}
    n_kernels = 0
    for key, (ms, n) in kernel_ms(torch, prof, 1).items():
        fams[family(key)] = fams.get(family(key), 0.0) + ms
        n_kernels += n
    busy = sum(fams.values()) or None
    want_c = (max(1, int(cfg.capacity_factor * b * t * cfg.top_k
                         / cfg.n_experts)) if cfg.is_moe else None)
    res = {"phase": "dense", "arch": cfg.name, "layers": cfg.n_layers,
           "run": "loss", "tokens": [b, t], "masked_labels": DENSE_MASKED + b,
           "loss": total.item(), "nll": parts["nll"].item(),
           "aux": parts["aux"].item(), "wall_ms": wall,
           "events_ms": start.elapsed_time(end), "device_ms": busy,
           "idle_share": busy and max(0.0, 1 - busy / wall),
           "by_family_ms": fams, "kernels": n_kernels,
           "moe_capacity": sorted(set(capacities)),
           "launches": {k: v for k, v in launches.items() if v},
           "library_launches": {f"{f} {w}": v
                                for (f, w), v in forms.items() if v}}
    what = f"dense ({cfg.name}, loss)"
    if not all(math.isfinite(res[k]) for k in ("loss", "nll", "aux")):
        fail(f"{what}: loss {res['loss']}, nll {res['nll']}")
    if cfg.is_moe and capacities != [want_c] * len(capacities):
        fail(f"{what}: expert capacity {sorted(set(capacities))}, the "
             f"reference's {want_c}")
    for name in b1:
        if name.startswith("qmatmul_experts_"):
            f = name[len("qmatmul_experts_"):]
            ok = forms[f, "experts"] > 0
        else:
            f = name[len("qmatmul_"):].removesuffix("_prefill")
            ok = forms[f, "prefill"] > 0 and forms[f, "decode"] == 0
        if not ok:
            fail(f"{what}: {name}: forms {forms}")
    ran = [k for k in ATTN_ROWS if launches[k]]
    if ran:
        fail(f"{what}: attention kernels launched: {ran}")
    for k, v in launches.items():
        entry = summary.setdefault(k, kernel_entry(k))
        entry["launches"] = (entry["launches"] or 0) + v
    return res


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
    streams: dict = {}      # the serve phase's, for the sched and dense phases
    reads: dict = {}        # the serve phase's decode_kv_bytes, for dense
    held: dict = {}         # the sched and dense phases' weights
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
                      ("serve", lambda: phase_serve(torch, summary, streams,
                                                    reads)),
                      ("sched", lambda: phase_sched(torch, summary, streams,
                                                    held)),
                      ("dense", lambda: phase_dense(torch, summary, streams,
                                                    reads, held))):
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
