#!/usr/bin/env python3
"""How often the card and the CPU store a KV code a step apart, on one
CUDA card, for the port found under ``--root``.

    python3 scripts/parity_flips.py                      # this checkout
    python3 scripts/parity_flips.py --root DIR --seeds 8 --label parent
    python3 scripts/parity_flips.py --arch phi3-mini-3.8b

Runs ``chip_smoke.py``'s parity case of ``--arch`` (``PARITY_CASES``:
its depth, policy and run shape; the first case of the arch whose pools
include ``--kv``, default q4_0 — for qwen2-1.5b the depth-3 one) once per
prompt seed 1..``--seeds`` through ``chip_smoke.parity_check``, on the
card and on the CPU (the plain versions), over the pools of ``--kv``, and
prints per seed the codes the two caches store apart (``own_ties``: where
``paged.parity_limit`` refuses them, the first layer whose codes differ
and max|d logits| / max|logit| before the CPU breaks the ties as the card
did; ``card_ties``: the ties so broken and any codes apart that are no
tie), the check's reading and whether it failed; the last line counts the
seeds the rule refused and those that failed.  ``chip_smoke.py`` runs
seed 1.  A run differs from the CPU in summation order only, so a code
apart is a value that order moved across a rounding boundary: comparing
the counts of two checkouts in one command (parent, change) says whether
a change of summation order moved codes more often.  ``--root`` is a
checkout whose ``chip_smoke.py`` has ``PARITY_CASES`` and
``parity_check``.
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
    ap.add_argument("--arch", default="qwen2-1.5b")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("parity_flips: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.configs import get_config

    kvs = args.kv.split(",")
    cases = [c for c in cs.PARITY_CASES if c[0] == args.arch]
    if not cases:
        raise SystemExit(f"parity_flips: no parity case of {args.arch}")
    arch, depth, policy, _, run = next(
        (c for c in cases if kvs[0] in c[3]), cases[0])
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    weights = cs.parity_weights(torch, cfg, policy)
    refused = {kv: 0 for kv in kvs}
    failed = {kv: 0 for kv in kvs}
    for kv in kvs:
        for seed in range(1, args.seeds + 1):
            inputs = cs.parity_inputs(torch, cfg, seed=seed, **run)
            result, error = cs.parity_check(torch, weights, policy, kv,
                                            inputs)
            refused[kv] += "own_ties" in result
            failed[kv] += error is not None
            print(json.dumps(dict(result, label=args.label, error=error,
                                  gpu=gpu)), flush=True)
    print(json.dumps({"label": args.label, "arch": arch, "layers": depth,
                      "policy": policy, "seeds": args.seeds,
                      "rule_refused": refused, "failed": failed,
                      "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
