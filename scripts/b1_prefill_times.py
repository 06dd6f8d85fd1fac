#!/usr/bin/env python3
"""One launch of B1's 2-D form at a prefill chunk's 512 rows or at a decode
step's 4 rows, on one CUDA card, for the port found under ``--root``.

    python3 scripts/b1_prefill_times.py                  # this checkout
    python3 scripts/b1_prefill_times.py --root DIR       # another checkout
    python3 scripts/b1_prefill_times.py --formats q2_k   # one format's shapes
    python3 scripts/b1_prefill_times.py --rows 4         # the decode shapes
    python3 scripts/b1_prefill_times.py --rows 4 --formats q3_k \
        --ksplits 1,2,4,8                                # a scan of q3_k's split

At 512 rows (bf16 x) it times ``qmatmul_<fmt>`` at every 2-D shape (K, N)
that the DeepSeek-V3 cut multiplies by q3_k (under Q3_K_M and Q2_K_L),
q5_k (Q3_K_M's dense down), q2_k (under Q2_K_L) or q8_0 (under Q8_0), and
qwen2-1.5b's q5_k down and q8_0 gate/up; at 4 rows, every shape that the
cut multiplies by q3_k, q5_k, q2_k or q8_0 at a decode step, qwen2's q5_k
down, and the q6_k shapes of ``chip_smoke.py``'s kernels phase.  CUDA events time 10 calls queued behind
a spin kernel, the weights rotating over copies of more than 120 MB so
that each call reads them from HBM, as ``chip_smoke.py`` does.  Each line
says which kernels ran (the library's counts of its forms' launches before
and after the call), the error against the plain version relative to
max|y|, a checksum of the output's bytes (equal between two checkouts
where the kernel computes the same bits), and the bound (the larger of the
operations at the bf16 peak and the bytes at the HBM rate).  ``--ksplits``
times each given cluster size of the decode form in turn, in place of the
wrapper's rule.  To compare two trees on one card, run both in one
command, in turns (parent, change, change, parent), each from its own
checkout: only ``--root``'s ``src`` is imported.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys

HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
# (K, N, format, what it is): at a prefill chunk's 512 rows
SHAPES = [
    (7168, 1536, "q3_k", "attn_q_a, Q3_K_M"),
    (1536, 24576, "q3_k", "attn_q_b, Q3_K_M"),
    (7168, 576, "q3_k", "attn_kv_a_mqa, Q3_K_M"),
    (7168, 18432, "q3_k", "dense gate, up, Q3_K_M"),
    (7168, 2048, "q3_k", "shexp gate, up, Q3_K_M"),
    (16384, 7168, "q3_k", "attn_output, Q2_K_L"),
    (18432, 7168, "q3_k", "dense down, Q2_K_L"),
    (2048, 7168, "q3_k", "shexp down, Q2_K_L"),
    (18432, 7168, "q5_k", "dense down, Q3_K_M"),
    (8960, 1536, "q5_k", "qwen2 down, Q3_K_M"),
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
# at a decode step's 4 rows: q3_k's served shapes (Q3_K_M's attn_kv_a_mqa,
# attn_q_a, attn_q_b, dense and shared gate/up; Q2_K_L's attn_output, dense
# and shared down), q5_k's (Q3_K_M's dense down, qwen2's down), q2_k's
# (Q2_K_L's attn_q_a, attn_q_b, dense and shared gate/up), q8_0's (every
# 2-D weight of the cut under Q8_0, the output head included) and the q6_k
# shapes of chip_smoke.py's kernels phase
DECODE_SHAPES = [
    (7168, 576, "q3_k", "attn_kv_a_mqa, Q3_K_M"),
    (7168, 1536, "q3_k", "attn_q_a, Q3_K_M"),
    (1536, 24576, "q3_k", "attn_q_b, Q3_K_M"),
    (7168, 2048, "q3_k", "shexp gate, up, Q3_K_M"),
    (2048, 7168, "q3_k", "shexp down, Q2_K_L"),
    (7168, 18432, "q3_k", "dense gate, up, Q3_K_M"),
    (16384, 7168, "q3_k", "attn_output, Q2_K_L"),
    (18432, 7168, "q3_k", "dense down, Q2_K_L"),
    (18432, 7168, "q5_k", "dense down, Q3_K_M"),
    (8960, 1536, "q5_k", "qwen2 down, Q3_K_M"),
    (1536, 256, "q6_k", "qwen2 k_proj, v_proj"),
    (8960, 1536, "q6_k", "qwen2 down"),
    (18432, 7168, "q6_k", "dense down"),
    (7168, 576, "q6_k", "attn_kv_a_mqa"),
    (7168, 129280, "q6_k", "output"),
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
    (7168, 129280, "q8_0", "output, Q8_0"),
]
FORMS = ("decode", "prefill")


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


def launches(qm, fmt: str) -> dict:
    """The library's count of each form's launches (a parent checkout may
    lack some)."""
    out = {}
    for form in FORMS:
        try:
            out[form] = qm.library_launches(fmt, form)
        except (KeyError, AttributeError):
            pass
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose src/ is timed")
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--formats", default=None,
                    help="comma-separated formats whose shapes are timed "
                         "(default: all of the table)")
    ap.add_argument("--rows", type=int, default=512, choices=(4, 512),
                    help="rows of x: 512 (a prefill chunk) or 4 (a decode "
                         "step)")
    ap.add_argument("--ksplits", default=None,
                    help="comma-separated cluster sizes of the decode form "
                         "to time in place of the wrapper's rule")
    args = ap.parse_args()
    rows = args.rows
    table = SHAPES if rows == 512 else DECODE_SHAPES
    formats = (args.formats.split(",") if args.formats
               else sorted({c[2] for c in table}))
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
    for k, n, fmt, use in (c for c in table if c[2] in formats):
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        qt = quantize(w, fmt)
        del w
        wbytes = qt.packed_bytes()
        copies = [qt] + [QTensor({a: b.clone() for a, b in qt.fields.items()},
                                 qt.fmt, qt.shape)
                         for _ in range(math.ceil(120e6 / wbytes) - 1)]
        x = torch.randn((rows, k), generator=gen, device=dev).to(
            torch.bfloat16)
        kern = qm.KERNELS[fmt]
        rule = getattr(qm, "DECODE_KSPLIT", {}).get(fmt)
        splits = ([None] if not args.ksplits or rule is None
                  else [int(v) for v in args.ksplits.split(",")])
        ref = qm.qmatmul_plain(x, qt).float()
        for ks in splits:
            if ks is not None:
                if ks > qm.decode_stages(fmt, k):
                    continue
                qm.DECODE_KSPLIT[fmt] = lambda n_, k_, sms_, ks=ks: ks
            before = launches(qm, fmt)
            y = kern(x, qt)
            torch.cuda.synchronize()
            ran = {f: c - before[f] for f, c in launches(qm, fmt).items()}
            err = ((y.float() - ref).abs().max() / ref.abs().max()).item()
            digest = hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
            i = [0]

            def call():
                i[0] = (i[0] + 1) % len(copies)
                kern(x, copies[i[0]])
            ms = device_ms(torch, call)
            moved = wbytes + 2 * rows * (k + n)
            bound = max(moved / HBM_BYTES_S, 2.0 * rows * k * n / BF16_OPS_S)
            print(json.dumps({
                "label": args.label, "root": root, "fmt": fmt, "K": k,
                "N": n, "M": rows, "use": use, "ms": ms,
                "bound_ms": bound * 1e3, "ksplit": ks,
                "rule_ksplit": (rule(n, k, build.sm_count(dev))
                                if rule and rows <= 4 else None),
                "launches": ran,
                "max_rel_err": err, "checksum": digest, "gpu": gpu}),
                flush=True)
            del y
        if rule is not None:
            qm.DECODE_KSPLIT[fmt] = rule
        del copies, qt, x, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
