"""PyTorch / CUDA port of the quantized-serving main path.

Mirrors the module layout of the JAX package ``repro`` (the reference it is
tested against) for the slice it ports: the K-quant weight formats and
policies, the dense GQA and DeepSeek MLA + MoE forwards over a paged
(f32/bf16 or q8_0) KV cache, and the continuous-batching engine with the
``reserve`` scheduler.  The
kernels on that path are hand-written CUDA for Hopper (``csrc/``); every
kernel wrapper runs its plain PyTorch version for CPU tensors and launches
the kernel (or raises) for CUDA tensors.

Entry points (``serving.engine.Engine``, ``launch.serve``) run on the card
unless the caller asks for ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise.

    ``None`` means ``"cuda"``; asking for the card where there is none
    raises instead of carrying on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
