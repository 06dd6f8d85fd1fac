"""Serving launcher: make seeded weights, quantize, serve batched requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --policy DQ3_K_M --page-size 16 --prefill-chunk 128 --kv-quant q8_0
      (or --kv-quant q4_0 / dq)
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v3-671b --reduced --device cpu --dtype f32
  (any registered --arch: qwen2-1.5b, qwen2-72b, phi3-mini-3.8b,
  deepseek-r1-distill-qwen-32b, llama4-scout-17b-a16e, deepseek-v3-671b)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --kv-quant q8_0 --prefill-chunk 128 --greedy --scheduler preempt \
      --priority-classes 2 --oversubscribe 0.3 --chaos 0
      (preemption with KV swap-out over an undersized pool, under a
      seeded fault plan)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --page-size 0 --sequential
      (the dense cache layout, one request at a time through one-shot
      generate; --kernel gather runs the paged decode's reference path)

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the kernels' plain PyTorch versions (add ``--reduced`` there).  Weights
are made and quantized one at a time (expert weights a group of experts
at a time) on the serving device, so the unquantized tree is never held:
the full-width deepseek-v3-671b needs several cards at its 61 layers;
every other registered model fits one 80 GB card whole under DQ3_K_M.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core import get_policy, init_quantized_params, model_size
from ..models import paged
from ..models.model import Model
from ..serving.engine import Engine, Request
from ..serving.faults import FaultPlan
from ..serving.sampler import SamplerConfig

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_requests(n: int, vocab: int, lo: int, hi: int, max_new: int,
                   seed: int) -> list[Request]:
    """``n`` requests with seeded random prompts of ``lo..hi`` tokens."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
                4, vocab, int(rng.integers(lo, hi + 1)))], max_new=max_new)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="DQ3_K_M")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bf16", choices=tuple(_DTYPES))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-min", type=int, default=100)
    ap.add_argument("--prompt-max", type=int, default=400)
    ap.add_argument("--sequential", action="store_true",
                    help="serve one request at a time (the throughput "
                         "baseline): one-shot generate over a dense cache, "
                         "or with --kv-quant each request alone through "
                         "the batched path")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV-cache page; 0 keeps the dense "
                         "slots x max-len layout")
    ap.add_argument("--num-pages", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--kernel", default=None, choices=Model.KERNELS,
                    help="paged decode: 'fused' (default) attends the pages "
                         "in place through the fused kernels, 'gather' "
                         "attends the dense view of every lane's whole "
                         "block table (the reference path)")
    ap.add_argument("--kv-quant", default=None,
                    choices=("q8_0", "q4_0", "dq"),
                    help="quantize the paged KV pools: 'q8_0' int8 values + "
                         "per-row f32 scales, 'q4_0' two int4 values a "
                         "byte, 'dq' per layer (q8_0 on the first/last "
                         "layers and MLA latents, q4_0 elsewhere)")
    ap.add_argument("--scheduler", default="reserve",
                    choices=Engine.SCHEDULERS,
                    help="'reserve' admits only when the pool can hold a "
                         "request's worst case (never preempts); 'preempt' "
                         "admits in (priority, arrival) order, lets the "
                         "pool oversubscribe, and swaps the lowest-class/"
                         "youngest lane's KV pages to host memory when it "
                         "runs dry")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="number of request classes; request i gets class "
                         "i %% N (0 = most urgent)")
    ap.add_argument("--oversubscribe", type=float, default=0.0,
                    help="size the page pool to this fraction of the "
                         "worst case for --slots lanes (e.g. 0.5 = half), "
                         "forcing preemption pressure; overrides "
                         "--num-pages")
    ap.add_argument("--swap-budget-bytes", type=int, default=None,
                    help="cap on host bytes held by swapped-out lanes; "
                         "evictions past the cap restart the request "
                         "instead of swapping (--scheduler preempt)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline from serve start; requests "
                         "that exceed it retire with status='timeout'")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission cap: requests past this bound are "
                         "shed at once with status='shed'")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="serve under a seeded random fault plan (swap "
                         "failures, allocator outages, latency spikes, "
                         "page corruption, NaN logits, cancels) and report "
                         "what landed; same seed, same schedule")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = _DTYPES[args.dtype]
    policy = get_policy(args.policy)
    rep = model_size(cfg, policy)
    print(f"quantizing {cfg.name} with {policy.name}: "
          f"{rep.gib:.2f} GiB @ {rep.avg_bits:.2f} bits/weight "
          f"(bf16 would be {rep.total_params * 2 / 1024**3:.2f} GiB)")
    qparams = init_quantized_params(cfg, policy, args.seed, dtype=dtype,
                                    device=device)
    model = Model(cfg, dtype=dtype)
    plan = None
    if args.chaos is not None:
        plan = FaultPlan.random(args.chaos, rids=list(range(args.requests)))
        print(f"chaos mode: seed {args.chaos}, {len(plan.faults)} faults "
              f"armed ({', '.join(f.kind for f in plan.faults)})")
    num_pages = args.num_pages
    if args.oversubscribe and args.page_size:
        n_full = paged.pages_for(args.max_len, args.page_size)
        worst = paged.RESERVED_PAGES + args.slots * n_full
        # floor: one request's worst case must always fit
        num_pages = max(paged.RESERVED_PAGES + n_full,
                        int(args.oversubscribe * worst))
        print(f"oversubscribed pool: {num_pages} pages "
              f"({args.oversubscribe:.2f}x of the {worst}-page worst case)")
    engine = Engine(model, qparams, max_len=args.max_len, device=device,
                    sampler=SamplerConfig(args.temperature, args.top_p,
                                          greedy=args.greedy),
                    page_size=args.page_size, num_pages=num_pages,
                    prefill_chunk=args.prefill_chunk, kernel=args.kernel,
                    kv_quant=args.kv_quant,
                    scheduler=args.scheduler,
                    swap_budget_bytes=args.swap_budget_bytes, faults=plan,
                    max_queue=args.max_queue)
    reqs = build_requests(args.requests, cfg.vocab_size, args.prompt_min,
                          min(args.prompt_max, args.max_len - 2),
                          args.max_new, args.seed)
    for r in reqs:
        r.priority = r.rid % max(args.priority_classes, 1)
        r.deadline_s = args.deadline_s
    if args.sequential:
        done = engine.serve_sequential(reqs, seed=args.seed)
    else:
        done = engine.serve(reqs, slots=args.slots, seed=args.seed)
    for r in sorted(done, key=lambda r: r.rid):
        tag = "" if r.status == "ok" else f"  [{r.status}]"
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {len(r.out)} tokens "
              f"{r.out[:8]}{'...' if len(r.out) > 8 else ''}{tag}")
    stats = engine.last_stats
    print(stats.report())
    if plan is not None:
        hits = ", ".join(f"{f['kind']}@{f['step']}" for f in stats.fault_log)
        print(f"chaos: {stats.faults_injected} faults landed"
              + (f" ({hits})" if hits else ""))
    return done


if __name__ == "__main__":
    main()
