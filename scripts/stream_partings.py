#!/usr/bin/env python3
"""Where greedy streams of the same requests part between serves whose
batches differ, on one CUDA card.

    python3 scripts/stream_partings.py                  # qwen2-1.5b
    python3 scripts/stream_partings.py --kv q8_0 --slots 2,3

Serves ``chip_smoke.py``'s sched traffic (8 requests, two classes, page
16, chunk 128, max_len 1024, greedy; qwen2-1.5b DQ3_K_M weights from seed
0) with the reserve scheduler on 4 slots, then again with the preempt
scheduler over ``chip_smoke.SCHED_PAGES`` pages (and with every freed
page zeroed, an empty fault plan, to rule out stale page contents), and
with the reserve scheduler on each of ``--slots``.  For every stream that
parts from the first serve's it prints, from the logits each serve
sampled the parting token from (``chip_smoke.recording``), both tokens'
logits in both serves, their top two, and max|d logits| between the two
serves there and one token earlier, at the same context.  The last line
per pool kind counts the streams equal to the first serve's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv", default="q4_0,q8_0",
                    help="comma-separated pool kinds")
    ap.add_argument("--slots", default="2,3",
                    help="slot counts of the reserve serves compared")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stream_partings: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import get_policy, init_quantized_params
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine, FaultPlan, SamplerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("qwen2-1.5b")
    params = init_quantized_params(cfg, get_policy("DQ3_K_M"), 0,
                                   dtype=torch.bfloat16, device=dev)
    model = Model(cfg, dtype=torch.bfloat16)
    reqs = build_requests(8, cfg.vocab_size, 100, 400, 32, seed=0)
    for r in reqs:
        r.priority = r.rid % 2
    prompts = {r.rid: r.prompt for r in reqs}

    def serve(kv_quant, slots=4, **kw):
        eng = Engine(model, params, max_len=1024, device=dev,
                     sampler=SamplerConfig(greedy=True), page_size=16,
                     prefill_chunk=128, kv_quant=kv_quant, **kw)
        with cs.recording(model) as calls:
            done = eng.serve(reqs, slots=slots)
        return {r.rid: list(r.out) for r in done}, calls

    def logits_at(calls, rid, out, i):
        row = cs.sampled_logits(calls, prompts[rid], out, i)
        return None if row is None else row.float()

    for kv_quant in args.kv.split(","):
        base, base_calls = serve(kv_quant)
        runs = {"preempt": dict(scheduler="preempt",
                                num_pages=cs.SCHED_PAGES),
                "preempt_zeroed": dict(scheduler="preempt",
                                       num_pages=cs.SCHED_PAGES,
                                       faults=FaultPlan([]))}
        runs.update({f"reserve_slots{n}": dict(slots=int(n))
                     for n in args.slots.split(",")})
        equal = {}
        for name, kw in runs.items():
            out, calls = serve(kv_quant, **kw)
            equal[name] = sum(out[k] == base[k] for k in base)
            for rid in sorted(base):
                a, b = out[rid], base[rid]
                if a == b:
                    continue
                i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
                line = {"kv": kv_quant, "run": name, "rid": rid, "at": i,
                        "token": a[i], "base_token": b[i]}
                la, lb = (logits_at(calls, rid, a, i),
                          logits_at(base_calls, rid, b, i))
                if la is not None and lb is not None:
                    line.update(
                        run_logits=[la[a[i]].item(), la[b[i]].item()],
                        base_logits=[lb[a[i]].item(), lb[b[i]].item()],
                        run_top2=torch.topk(la, 2).values.tolist(),
                        base_top2=torch.topk(lb, 2).values.tolist(),
                        max_abs_diff=(la - lb).abs().max().item(),
                        max_abs_logit=lb.abs().max().item())
                    if i:
                        pa = logits_at(calls, rid, a, i - 1)
                        pb = logits_at(base_calls, rid, b, i - 1)
                        if pa is not None and pb is not None:
                            line["max_abs_diff_before"] = (
                                pa - pb).abs().max().item()
                print(json.dumps(line), flush=True)
        print(json.dumps({"kv": kv_quant, "streams_equal": equal}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
