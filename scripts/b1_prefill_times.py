#!/usr/bin/env python3
"""One launch of B1's 2-D form at a prefill chunk's 512 rows (bf16 x), on
one CUDA card, for the port found under ``--root``.

    python3 scripts/b1_prefill_times.py                  # this checkout
    python3 scripts/b1_prefill_times.py --root DIR       # another checkout
    python3 scripts/b1_prefill_times.py --formats q2_k   # one format's shapes

Times ``qmatmul_<fmt>`` at every 2-D shape (K, N) that the DeepSeek-V3 cut
multiplies by q3_k (under Q3_K_M and Q2_K_L), q2_k (under Q2_K_L) or q8_0
(under Q8_0) at 512 rows, and qwen2-1.5b's q8_0 gate/up, with CUDA events (10 calls queued
behind a spin kernel, the weights rotating over copies of more than 120 MB
so that each call reads them from HBM, as ``chip_smoke.py`` does).  Each
line says which kernel ran (the library's count of prefill-form launches
before and after the call), the error against the plain version relative
to max|y|, and the bound (the larger of the operations at the bf16 peak
and the bytes at the HBM rate).  To compare two trees on one card, run
both in one command, in turns (parent, change, change, parent), each from
its own checkout: only ``--root``'s ``src`` is imported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
ROWS = 512
# (K, N, format, what it is)
SHAPES = [
    (7168, 1536, "q3_k", "attn_q_a, Q3_K_M"),
    (1536, 24576, "q3_k", "attn_q_b, Q3_K_M"),
    (7168, 576, "q3_k", "attn_kv_a_mqa, Q3_K_M"),
    (7168, 18432, "q3_k", "dense gate, up, Q3_K_M"),
    (7168, 2048, "q3_k", "shexp gate, up, Q3_K_M"),
    (16384, 7168, "q3_k", "attn_output, Q2_K_L"),
    (18432, 7168, "q3_k", "dense down, Q2_K_L"),
    (2048, 7168, "q3_k", "shexp down, Q2_K_L"),
    (7168, 1536, "q2_k", "attn_q_a, Q2_K_L"),
    (1536, 24576, "q2_k", "attn_q_b, Q2_K_L"),
    (7168, 18432, "q2_k", "dense gate, up, Q2_K_L"),
    (7168, 2048, "q2_k", "shexp gate, up, Q2_K_L"),
    (7168, 1536, "q8_0", "attn_q_a, Q8_0"),
    (1536, 24576, "q8_0", "attn_q_b, Q8_0"),
    (7168, 576, "q8_0", "attn_kv_a_mqa, Q8_0"),
    (16384, 7168, "q8_0", "attn_output, Q8_0"),
    (7168, 18432, "q8_0", "dense gate, up, Q8_0"),
    (18432, 7168, "q8_0", "dense down, Q8_0"),
    (7168, 2048, "q8_0", "shexp gate, up, Q8_0"),
    (2048, 7168, "q8_0", "shexp down, Q8_0"),
    (1536, 8960, "q8_0", "qwen2 gate, up, Q8_0"),
]


def device_ms(torch, fn, iters: int = 10) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose src/ is timed")
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--formats", default="q3_k,q2_k,q8_0",
                    help="comma-separated formats whose shapes are timed")
    args = ap.parse_args()
    formats = args.formats.split(",")
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("b1_prefill_times: needs a CUDA card")
    from repro_torch.core.qtensor import QTensor, quantize
    from repro_torch.kernels import build
    from repro_torch.kernels import qmatmul as qm

    build.build_all()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for k, n, fmt, use in (c for c in SHAPES if c[2] in formats):
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        qt = quantize(w, fmt)
        del w
        wbytes = qt.packed_bytes()
        copies = [qt] + [QTensor({a: b.clone() for a, b in qt.fields.items()},
                                 qt.fmt, qt.shape)
                         for _ in range(math.ceil(120e6 / wbytes) - 1)]
        x = torch.randn((ROWS, k), generator=gen, device=dev).to(
            torch.bfloat16)
        kern = qm.KERNELS[fmt]
        pre = qm.library_launches(fmt, "prefill")
        y = kern(x, qt)
        torch.cuda.synchronize()
        prefill_form = qm.library_launches(fmt, "prefill") - pre
        ref = qm.qmatmul_plain(x, qt).float()
        err = ((y.float() - ref).abs().max() / ref.abs().max()).item()
        i = [0]

        def call():
            i[0] = (i[0] + 1) % len(copies)
            kern(x, copies[i[0]])
        ms = device_ms(torch, call)
        moved = wbytes + 2 * ROWS * (k + n)
        bound = max(moved / HBM_BYTES_S, 2.0 * ROWS * k * n / BF16_OPS_S)
        print(json.dumps({
            "label": args.label, "root": root, "fmt": fmt, "K": k, "N": n,
            "M": ROWS, "use": use, "ms": ms, "bound_ms": bound * 1e3,
            "prefill_form_launches": prefill_form, "max_rel_err": err,
            "gpu": gpu}), flush=True)
        del copies, qt, x, y, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
