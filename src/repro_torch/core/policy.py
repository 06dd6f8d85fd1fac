"""Quantization policies: per-module (and per-layer) format allocation.

This module encodes the paper's central contribution — **dynamic bit-width
allocation by module role** (Table 7 / §3) — as a small rule engine:

  * a *role* is a canonical llama.cpp-style module class
    (``token_embd``, ``output``, ``attn_kv_b``, ``ffn_down_exps``, ...);
  * a *rule* maps ``(layer_index_within_role, n_layers_with_role)`` to a
    format name;
  * a *policy* is a named role→rule table with a fall-back chain for roles
    Table 7 does not mention (dense GQA attention, recurrent blocks, ...).

The DQ3_K_M ``ffn_down_exps`` rule reproduces the stated distribution exactly
on DeepSeek-R1 (58 MoE layers): q6_k for the first two layers, q4_k every
fifth subsequent layer, q3_k elsewhere -> 2 / 12 / 44 = 3.4 % / 20.7 % / 75.9 %.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from .formats import FORMATS, FLOAT_BITS

# ---------------------------------------------------------------------------
# canonical module roles
# ---------------------------------------------------------------------------

# Quantizable 2-D weight roles.
ROLES_GENERIC = (
    "token_embd", "output",
    "attn_q", "attn_k", "attn_v", "attn_qkv", "attn_output",
    "ffn_gate", "ffn_up", "ffn_down",
)
ROLES_MLA = ("attn_q_a", "attn_q_b", "attn_kv_a_mqa", "attn_kv_b")
ROLES_MOE = (
    "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps",
    "ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp",
)
# Never quantized (kept in bf16/f32): tiny and/or numerically critical.
# "rnn" covers Griffin/xLSTM block-diagonal gate matrices (~0.1 % of params).
ROLES_FLOAT = ("norm", "bias", "router", "scalar", "frontend", "conv", "rope",
               "rnn")

ALL_QUANT_ROLES = ROLES_GENERIC + ROLES_MLA + ROLES_MOE

# Roles that Table 7 does not list, mapped onto the nearest listed class
# (documented extension; DESIGN.md §5).  GQA K/V projections are few-headed
# and critical, like MLA's kv modules; recurrent-state projections behave
# like attention projections.
ROLE_FALLBACK = {
    "attn_q": "attn_q_b",
    "attn_k": "attn_kv_b",
    "attn_v": "attn_kv_b",
    "attn_qkv": "attn_q_b",
}


Rule = Callable[[int, int], str]


def fixed(fmt: str) -> Rule:
    def rule(i: int, n: int) -> str:
        return fmt
    rule.__name__ = f"fixed_{fmt}"
    return rule


def largest_remainder(fracs: Sequence[float], n: int) -> list[int]:
    raw = [f * n for f in fracs]
    counts = [int(x) for x in raw]
    rem = n - sum(counts)
    order = sorted(range(len(fracs)), key=lambda j: raw[j] - counts[j],
                   reverse=True)
    for j in order[:rem]:
        counts[j] += 1
    return counts


def mix(pairs: Sequence[tuple[str, float]], strategy: str = "spread") -> Rule:
    """Assign formats across the role's layers at fixed fractions.

    ``strategy="spread"`` interleaves evenly (Bresenham; llama.cpp's
    use_more_bits-style dispersion), ``strategy="first"`` gives the
    higher-precision formats (listed first) to the earliest layers
    (Unsloth-style early-layer protection).
    """
    fmts = [p[0] for p in pairs]
    fracs = [p[1] for p in pairs]

    def rule(i: int, n: int) -> str:
        counts = largest_remainder(fracs, n)
        if strategy == "first":
            acc = 0
            for fmt, c in zip(fmts, counts):
                acc += c
                if i < acc:
                    return fmt
            return fmts[-1]
        # spread: at each position pick the format with the largest deficit
        assigned = [0] * len(fmts)
        choice = fmts[-1]
        for pos in range(i + 1):
            deficits = [fracs[j] * (pos + 1) - assigned[j]
                        for j in range(len(fmts))]
            j = max(range(len(fmts)), key=lambda j: (deficits[j], -j))
            assigned[j] += 1
            choice = fmts[j]
        return choice

    rule.__name__ = f"mix_{strategy}_" + "_".join(fmts)
    return rule


def dq3_down_exps(q6_first: int = 2, q4_period: int = 5) -> Rule:
    """The paper's DQ3_K_M rule for ``ffn_down_exps`` (§3).

    q6_k for the first ``q6_first`` MoE layers; among the remainder, every
    ``q4_period``-th layer gets q4_k; q3_k otherwise.  On 58 MoE layers this
    yields exactly 2x q6_k, 12x q4_k, 44x q3_k (3.4 / 20.7 / 75.9 %).
    """

    def rule(i: int, n: int) -> str:
        if i < q6_first:
            return "q6_k"
        if (i - q6_first) % q4_period == 0:
            return "q4_k"
        return "q3_k"

    rule.__name__ = "dq3_down_exps"
    return rule


@dataclasses.dataclass(frozen=True)
class Policy:
    """A named per-role quantization policy."""

    name: str
    rules: dict[str, Rule]
    float_fmt: str = "bf16"   # format for never-quantized roles
    # Source-precision baseline policies (no quantization) set this:
    unquantized: bool = False

    def resolve(self, role: str, layer_in_role: int = 0,
                n_layers_with_role: int = 1) -> str:
        """Format name for one weight."""
        if self.unquantized or role in ROLES_FLOAT:
            return self.float_fmt
        r = self.rules.get(role)
        if r is None:
            fb = ROLE_FALLBACK.get(role)
            if fb is not None:
                r = self.rules.get(fb)
        if r is None:
            raise KeyError(f"policy {self.name!r} has no rule for role {role!r}")
        fmt = r(layer_in_role, n_layers_with_role)
        if fmt not in FORMATS and fmt not in FLOAT_BITS:
            raise ValueError(f"unknown format {fmt!r} from rule for {role!r}")
        return fmt


def _table7(output, token_embd, kv_a, kv_b, attn_out, q_a, q_b, down, gate,
            up, down_exps, down_shexp, gate_exps, gate_shexp, up_exps,
            up_shexp) -> dict[str, Rule]:
    """Build a role->rule table in Table 7's row order."""
    return {
        "output": output,
        "token_embd": token_embd,
        "attn_kv_a_mqa": kv_a,
        "attn_kv_b": kv_b,
        "attn_output": attn_out,
        "attn_q_a": q_a,
        "attn_q_b": q_b,
        "ffn_down": down,
        "ffn_gate": gate,
        "ffn_up": up,
        "ffn_down_exps": down_exps,
        "ffn_down_shexp": down_shexp,
        "ffn_gate_exps": gate_exps,
        "ffn_gate_shexp": gate_shexp,
        "ffn_up_exps": up_exps,
        "ffn_up_shexp": up_shexp,
    }


F = fixed

POLICIES: dict[str, Policy] = {}


def _register(p: Policy) -> Policy:
    POLICIES[p.name] = p
    return p


# --- Table 7, column by column ---------------------------------------------

Q4_K_M = _register(Policy("Q4_K_M", _table7(
    output=F("q6_k"), token_embd=F("q4_k"),
    kv_a=F("q4_k"), kv_b=F("q4_k"), attn_out=F("q4_k"),
    q_a=F("q4_k"), q_b=F("q4_k"),
    down=F("q6_k"), gate=F("q4_k"), up=F("q4_k"),
    down_exps=mix([("q6_k", 0.466), ("q4_k", 0.534)], "spread"),
    down_shexp=mix([("q6_k", 0.466), ("q4_k", 0.534)], "spread"),
    gate_exps=F("q4_k"), gate_shexp=F("q4_k"),
    up_exps=F("q4_k"), up_shexp=F("q4_k"),
)))

Q3_K_M = _register(Policy("Q3_K_M", _table7(
    output=F("q6_k"), token_embd=F("q3_k"),
    kv_a=F("q3_k"), kv_b=F("q3_k"), attn_out=F("q4_k"),
    q_a=F("q3_k"), q_b=F("q3_k"),
    down=F("q5_k"), gate=F("q3_k"), up=F("q3_k"),
    down_exps=F("q4_k"), down_shexp=F("q4_k"),
    gate_exps=F("q3_k"), gate_shexp=F("q3_k"),
    up_exps=F("q3_k"), up_shexp=F("q3_k"),
)))

DQ3_K_M = _register(Policy("DQ3_K_M", _table7(
    output=F("q6_k"), token_embd=F("q4_k"),
    kv_a=F("q6_k"), kv_b=F("q6_k"), attn_out=F("q4_k"),
    q_a=F("q4_k"), q_b=F("q4_k"),
    down=F("q6_k"), gate=F("q4_k"), up=F("q4_k"),
    down_exps=dq3_down_exps(),
    down_shexp=F("q6_k"),
    gate_exps=F("q3_k"), gate_shexp=F("q4_k"),
    up_exps=F("q3_k"), up_shexp=F("q4_k"),
)))

Q2_K_L = _register(Policy("Q2_K_L", _table7(
    output=F("q6_k"), token_embd=F("q4_k"),
    kv_a=F("q6_k"), kv_b=F("q2_k"), attn_out=F("q3_k"),
    q_a=F("q2_k"), q_b=F("q2_k"),
    down=F("q3_k"), gate=F("q2_k"), up=F("q2_k"),
    down_exps=F("q3_k"), down_shexp=F("q3_k"),
    gate_exps=F("q2_k"), gate_shexp=F("q2_k"),
    up_exps=F("q2_k"), up_shexp=F("q2_k"),
)))

UD_Q2_K_XL = _register(Policy("UD_Q2_K_XL", _table7(
    output=F("q6_k"), token_embd=F("q4_k"),
    kv_a=F("q6_k"), kv_b=F("q6_k"), attn_out=F("q4_k"),
    q_a=F("q4_k"), q_b=F("q4_k"),
    down=F("q6_k"), gate=F("q4_k"), up=F("q4_k"),
    down_exps=mix([("q3_k", 0.052), ("q2_k", 0.948)], "first"),
    down_shexp=F("q6_k"),
    gate_exps=F("q2_k"), gate_shexp=F("q4_k"),
    up_exps=F("q2_k"), up_shexp=F("q4_k"),
)))

# Fully-uniform variants evaluated for V3-0324 (Table 4).
Q4_K = _register(Policy("Q4_K", {r: F("q4_k") for r in ALL_QUANT_ROLES}
                        | {"output": F("q6_k")}))
Q3_K = _register(Policy("Q3_K", {r: F("q3_k") for r in ALL_QUANT_ROLES}
                        | {"output": F("q6_k")}))
Q8_0 = _register(Policy("Q8_0", {r: F("q8_0") for r in ALL_QUANT_ROLES}))

# Unquantized baselines (the paper's FP8 column; bf16 on TPU — DESIGN.md §3).
BF16 = _register(Policy("BF16", {}, unquantized=True))
F32 = _register(Policy("F32", {}, float_fmt="f32", unquantized=True))


def get_policy(name: str) -> Policy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; available: {sorted(POLICIES)}") from None
