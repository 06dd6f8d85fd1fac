#!/usr/bin/env python3
"""How often the card and the CPU store a KV code a step apart, on one
CUDA card, for the port found under ``--root``.

    python3 scripts/parity_flips.py                      # this checkout
    python3 scripts/parity_flips.py --root DIR --seeds 8 --label parent

Runs ``chip_smoke.py``'s parity case of qwen2-1.5b (DQ3_K_M weights from
seed 0, f32, depth 3, two lanes of a 64-token chunk, lane 1 nine tokens
short, then 4 decode steps over 16-token pages) once per prompt seed
1..``--seeds``, on the card and on the CPU (the plain versions), over the
pools of ``--kv`` (default q4_0), and prints per seed the codes the two
caches store apart (``paged.codes_apart``: the first layer whose codes
differ, its largest step, the count over all layers), whether
``paged.parity_limit`` refuses them, and max|d logits| / max|logit|; the
last line counts the refusals.  ``chip_smoke.py`` runs seed 1.  A run
differs from the CPU in summation order only, so a code apart is a value
that order moved across a rounding boundary: comparing the counts of two
checkouts in one command (parent, change) says whether a change of
summation order moved codes more often.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose src/ is run")
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--kv", default="q4_0", help="comma-separated pools")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("parity_flips: needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_to
    from repro_torch.core import get_policy, init_quantized_params
    from repro_torch.models import paged
    from repro_torch.models.model import Model

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=3)
    B, C, max_len, steps_n, short, P = 2, 64, 128, 4, 9, 16
    dev = torch.device("cuda")
    qparams = init_quantized_params(cfg, get_policy("DQ3_K_M"), 0,
                                    dtype=torch.float32, device=dev)
    cpu_params = tree_to(qparams, "cpu")
    model = Model(cfg, dtype=torch.float32)
    n = paged.pages_for(max_len, P)
    bt = torch.tensor([[2 + i * n + j for j in range(n)] for i in range(B)],
                      dtype=torch.int32)
    clen = torch.tensor([C, C - short], dtype=torch.int32)
    refused = {}
    for kv in args.kv.split(","):
        refused[kv] = 0
        for seed in range(1, args.seeds + 1):
            rng = torch.Generator().manual_seed(seed)
            toks = torch.randint(4, cfg.vocab_size, (B, C), generator=rng,
                                 dtype=torch.int32)
            dec = torch.randint(4, cfg.vocab_size, (steps_n, B),
                                generator=rng, dtype=torch.int32)
            logits, caches = {}, {}
            for side, device, prm in (("card", dev, qparams),
                                      ("cpu", torch.device("cpu"),
                                       cpu_params)):
                cache = model.init_paged_cache(2 + B * n, P, B,
                                               dtype=torch.float32,
                                               kv_quant=kv, device=device)
                tables = {"full": bt.to(device)}
                out, cache = model.prefill_chunk(
                    prm, cache, toks.to(device),
                    torch.zeros(B, dtype=torch.int32, device=device),
                    clen.to(device), max_len=max_len, block_tables=tables,
                    page_size=P, kv_quant=kv, active_pages=(n, 0))
                steps = [out]
                pos = clen.to(device).clone()
                for i in range(steps_n):
                    lp = (pos // P + 1).to(torch.int32)
                    out, cache = model.decode_step_paged(
                        prm, cache, dec[i].to(device), pos, tables,
                        page_size=P, max_len=max_len, active_pages=(n, 0),
                        lane_pages={"full": lp}, kv_quant=kv)
                    steps.append(out)
                    pos = pos + 1
                logits[side] = torch.stack(steps).cpu()
                caches[side] = {k: v.cpu() for k, v in cache.items()}
            a, b = logits["card"], logits["cpu"]
            stats = paged.codes_apart(cfg, kv, caches["card"],
                                      caches["cpu"])
            try:
                paged.parity_limit(cfg, kv, caches["card"], caches["cpu"],
                                   exact=1e-3, stepped=1e-2)
                refuse = ""
            except ValueError as e:
                refuse = str(e)
                refused[kv] += 1
            print(json.dumps({
                "label": args.label, "kv": kv, "seed": seed,
                "first_layer": stats["first_layer"],
                "first_modes": stats["first_modes"],
                "max_step_first": stats["max_step_first"],
                "codes_apart": stats["apart"],
                "rel": ((a - b).abs().max() / b.abs().max()).item(),
                "refused": refuse, "gpu": gpu}), flush=True)
    print(json.dumps({"label": args.label, "seeds": args.seeds,
                      "refused": refused, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
