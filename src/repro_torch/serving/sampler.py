"""Token samplers: greedy / temperature / top-p.

Every sampled token of a request draws from its own ``torch.Generator``
seeded from ``(seed, rid, token_index)``, so a request's stochastic stream
never depends on which other requests share its batch.  (The reference
uses JAX threefry keys, whose bits PyTorch cannot reproduce, so stochastic
streams are not compared across the two packages; greedy streams are.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.6
    top_p: float = 0.95
    greedy: bool = False

    @property
    def is_greedy(self) -> bool:
        return self.greedy or self.temperature <= 0


def stream_seed(seed: int, rid: int, index: int) -> int:
    """Generator seed for the ``index``-th sampled token of request ``rid``:
    a function of ``(seed, rid, index)`` only."""
    state = np.random.SeedSequence([seed, rid, index]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def _filter_top_p(lf: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the smallest set with cumulative prob >= top_p."""
    sorted_l = torch.sort(lf, dim=-1, descending=True).values
    csum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    cutoff_idx = torch.clamp(torch.sum(csum < top_p, dim=-1, keepdim=True),
                             max=lf.shape[-1] - 1)
    cutoff = torch.gather(sorted_l, -1, cutoff_idx)
    return torch.where(lf < cutoff, torch.full_like(lf, -torch.inf), lf)


def sample(logits: torch.Tensor, generator: torch.Generator,
           cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """logits: (B, V) -> tokens (B,) int32 (one generator for the batch)."""
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lf = logits.to(torch.float32) / cfg.temperature
    if cfg.top_p < 1.0:
        lf = _filter_top_p(lf, cfg.top_p)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_per_slot(logits: torch.Tensor, seeds: list[int | None],
                    cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """Row-independent sampling: row ``i`` draws from a generator seeded
    with ``seeds[i]`` (rows with ``None`` are free lanes: argmax).  Greedy
    ignores the seeds.  Returns (B,) int32 on ``logits``' device."""
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    rows = []
    for i, s in enumerate(seeds):
        if s is None:
            rows.append(torch.argmax(logits[i:i + 1], dim=-1).to(torch.int32))
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(s)
        rows.append(sample(logits[i:i + 1], gen, cfg))
    return torch.cat(rows)
