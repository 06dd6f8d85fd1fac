"""The tensor-core kernels' split of f32 operands into bf16 terms, for the
port's CPU models of those kernels."""

import torch


def bf16_terms(x, n):
    """x (f32) as ``n`` bf16 terms (as f32 tensors), each the rounded
    remainder of the ones before: the split ``csrc/mma.cuh::split3`` makes
    of f32 x in the q6_k decode form and of f32 queries and P in the MLA
    prefill."""
    terms = []
    for _ in range(n):
        t = x.to(torch.bfloat16).to(torch.float32)
        terms.append(t)
        x = x - t
    return terms
