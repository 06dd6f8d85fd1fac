"""WeightSpec registry for the ported families: dense GQA and DeepSeek's
MLA + MoE.

Every architecture enumerates its weight inventory as ``WeightSpec``s —
logical shape, quantization role, absolute layer index — exactly as the
reference's ``repro.models.spec`` does, so paths, roles and the policy's
per-layer format choices agree path for path.  Params are a flat dict
``{path: tensor-or-QTensor}``; layers are prefixed ``dec/L000/``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..core.policy import Policy, ROLES_FLOAT

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    path: str
    shape: tuple[int, ...]
    role: str
    layer: int | None = None          # absolute layer index within its stack
    stack: str = "dec"                # "dec" | "global"
    dtype: str = "bf16"
    init: str = "fan_in"              # fan_in | zeros | ones

    @property
    def num_params(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def quantizable(self) -> bool:
        return self.role not in ROLES_FLOAT and len(self.shape) >= 2


class SpecBuilder:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs: dict[str, WeightSpec] = {}

    def add(self, path: str, shape, role: str, *, layer=None, stack="global",
            dtype="bf16", init="fan_in") -> None:
        if path in self.specs:
            raise ValueError(f"duplicate spec {path}")
        self.specs[path] = WeightSpec(
            path=path, shape=tuple(int(s) for s in shape), role=role,
            layer=layer, stack=stack, dtype=dtype, init=init)


def _attn_specs(b: SpecBuilder, cfg: ModelConfig, prefix: str, layer: int,
                stack: str) -> None:
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    kw = dict(layer=layer, stack=stack)
    b.add(f"{prefix}/attn_norm", (d,), "norm", init="ones", **kw)
    b.add(f"{prefix}/q_proj", (d, nh * hd), "attn_q", **kw)
    b.add(f"{prefix}/k_proj", (d, nkv * hd), "attn_k", **kw)
    b.add(f"{prefix}/v_proj", (d, nkv * hd), "attn_v", **kw)
    b.add(f"{prefix}/o_proj", (nh * hd, d), "attn_output", **kw)
    if cfg.qkv_bias:
        for nm, width in (("q_bias", nh * hd), ("k_bias", nkv * hd),
                          ("v_bias", nkv * hd)):
            b.add(f"{prefix}/{nm}", (width,), "bias", init="zeros", **kw)


def _ffn_specs(b: SpecBuilder, cfg: ModelConfig, prefix: str, layer: int,
               stack: str) -> None:
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(layer=layer, stack=stack)
    b.add(f"{prefix}/ffn_norm", (d,), "norm", init="ones", **kw)
    b.add(f"{prefix}/gate", (d, ff), "ffn_gate", **kw)
    b.add(f"{prefix}/up", (d, ff), "ffn_up", **kw)
    b.add(f"{prefix}/down", (ff, d), "ffn_down", **kw)


def _mla_specs(b: SpecBuilder, cfg: ModelConfig, prefix: str, layer: int,
               stack: str) -> None:
    d, nh = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    kw = dict(layer=layer, stack=stack)
    b.add(f"{prefix}/attn_norm", (d,), "norm", init="ones", **kw)
    b.add(f"{prefix}/q_a", (d, cfg.q_lora_rank), "attn_q_a", **kw)
    b.add(f"{prefix}/q_a_norm", (cfg.q_lora_rank,), "norm", init="ones", **kw)
    b.add(f"{prefix}/q_b", (cfg.q_lora_rank, nh * qk), "attn_q_b", **kw)
    b.add(f"{prefix}/kv_a", (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
          "attn_kv_a_mqa", **kw)
    b.add(f"{prefix}/kv_a_norm", (cfg.kv_lora_rank,), "norm", init="ones",
          **kw)
    b.add(f"{prefix}/kv_b",
          (cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
          "attn_kv_b", **kw)
    b.add(f"{prefix}/o_proj", (nh * cfg.v_head_dim, d), "attn_output", **kw)


def _moe_specs(b: SpecBuilder, cfg: ModelConfig, prefix: str, layer: int,
               stack: str) -> None:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    kw = dict(layer=layer, stack=stack)
    b.add(f"{prefix}/ffn_norm", (d,), "norm", init="ones", **kw)
    b.add(f"{prefix}/router", (d, e), "router", dtype="f32", **kw)
    b.add(f"{prefix}/gate_exps", (e, d, fe), "ffn_gate_exps", **kw)
    b.add(f"{prefix}/up_exps", (e, d, fe), "ffn_up_exps", **kw)
    b.add(f"{prefix}/down_exps", (e, fe, d), "ffn_down_exps", **kw)
    if cfg.n_shared_experts:
        fs = cfg.d_shared_expert * cfg.n_shared_experts
        b.add(f"{prefix}/gate_shexp", (d, fs), "ffn_gate_shexp", **kw)
        b.add(f"{prefix}/up_shexp", (d, fs), "ffn_up_shexp", **kw)
        b.add(f"{prefix}/down_shexp", (fs, d), "ffn_down_shexp", **kw)


def layer_prefix(stack: str, layer: int) -> str:
    return f"{stack}/L{layer:03d}"


def check_supported(cfg: ModelConfig) -> None:
    """The port serves full-attention decoders (GQA or MLA) with a dense
    SwiGLU FFN or routed experts; other families raise."""
    kinds = {cfg.block_kind(layer) for layer in range(cfg.n_layers)}
    if (kinds != {"attn"} or cfg.is_encdec or cfg.frontend or cfg.window
            or cfg.attn_softcap or cfg.logit_softcap or cfg.embed_scale
            or cfg.dense_residual or (cfg.d_ff == 0 and not cfg.is_moe)):
        raise NotImplementedError(
            f"{cfg.name}: only full-attention decoders (GQA or MLA, dense "
            "FFN or MoE) are ported (ROADMAP D6, the other block families)")


def decoder_layer_specs(b: SpecBuilder, cfg: ModelConfig, layer: int,
                        stack: str = "dec") -> None:
    """Emit the specs of one decoder layer: attention, then FFN or MoE."""
    p = layer_prefix(stack, layer)
    if cfg.mla:
        _mla_specs(b, cfg, p, layer, stack)
    else:
        _attn_specs(b, cfg, p, layer, stack)
    if cfg.moe_layer(layer):
        _moe_specs(b, cfg, p, layer, stack)
    else:
        _ffn_specs(b, cfg, p, layer, stack)


def model_specs(cfg: ModelConfig) -> dict[str, WeightSpec]:
    """The complete weight inventory of one architecture."""
    check_supported(cfg)
    b = SpecBuilder(cfg)
    d = cfg.d_model
    # embeddings / head stored (d_model, vocab): quant blocks along d_model
    b.add("token_embd", (d, cfg.padded_vocab), "token_embd")
    if not cfg.tie_embeddings:
        b.add("output", (d, cfg.padded_vocab), "output")
    b.add("output_norm", (d,), "norm", init="ones")
    for layer in range(cfg.n_layers):
        decoder_layer_specs(b, cfg, layer)
    return b.specs


def role_layer_tables(specs: dict[str, WeightSpec]) -> dict:
    """Per (stack, role): sorted list of layers containing it."""
    table: dict[tuple[str, str], list[int]] = {}
    for s in specs.values():
        if s.layer is None or not s.quantizable:
            continue
        layers = table.setdefault((s.stack, s.role), [])
        if s.layer not in layers:
            layers.append(s.layer)
    for v in table.values():
        v.sort()
    return table


def resolve_format(spec: WeightSpec, policy: Policy, tables: dict) -> str:
    """Format for one weight under one policy (fp formats pass through)."""
    if not spec.quantizable:
        if policy.unquantized:
            return spec.dtype
        return policy.float_fmt if spec.dtype == "bf16" else spec.dtype
    if spec.layer is None:
        return policy.resolve(spec.role, 0, 1)
    layers = tables[(spec.stack, spec.role)]
    return policy.resolve(spec.role, layers.index(spec.layer), len(layers))


def _generator(seed: int, name: str, device) -> torch.Generator:
    """A generator of its own for one weight (or one expert of one), so a
    weight's numbers do not depend on which others are made, or in what
    order or grouping."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + zlib.crc32(name.encode()))
    return gen


def make_weight(s: WeightSpec, seed: int = 0, dtype=torch.bfloat16,
                device=None, experts: range | None = None) -> torch.Tensor:
    """One weight of the seeded random init, on ``device``.

    Fan-in normal, as the reference; the numbers come from
    ``torch.Generator``s and so differ from ``jax.random`` (the parity
    tests carry the reference's weights across with
    ``convert.from_jax_params``) and between the CPU and the card.  An
    expert weight ``(E, K, N)`` draws each expert from its own generator:
    ``experts`` makes only that range of experts, and the groups of any
    split concatenate to the whole weight.
    """
    device = torch.device("cpu" if device is None else device)
    dt = DTYPES[s.dtype] if s.dtype != "bf16" else dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=device)
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    if len(s.shape) == 3:
        rows = range(s.shape[0]) if experts is None else experts
        w = torch.empty((len(rows), *s.shape[1:]), dtype=dt, device=device)
        for i, e in enumerate(rows):
            w[i] = (torch.randn(s.shape[1:], dtype=torch.float32,
                                device=device,
                                generator=_generator(seed, f"{s.path}#{e}",
                                                     device))
                    / fan_in ** 0.5).to(dt)
        return w
    w = torch.randn(s.shape, dtype=torch.float32, device=device,
                    generator=_generator(seed, s.path, device))
    return w.div_(fan_in ** 0.5).to(dt)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> dict[str, torch.Tensor]:
    """Random init of the full (unquantized) parameter tree on ``device``
    (:func:`make_weight` for every spec).  At full width a MoE model's
    tree does not fit on one card: ``core.apply.init_quantized_params``
    makes and quantizes one weight at a time instead."""
    return {path: make_weight(s, seed, dtype, device)
            for path, s in sorted(model_specs(cfg).items())}


def subview(params: dict[str, Any], prefix: str) -> dict[str, Any]:
    """All params under ``prefix/``, with the prefix stripped."""
    pl = len(prefix) + 1
    return {k[pl:]: v for k, v in params.items() if k.startswith(prefix + "/")}
