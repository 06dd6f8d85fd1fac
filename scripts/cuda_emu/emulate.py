#!/usr/bin/env python3
"""Rehearse the CUDA kernels of ``src/repro_torch/csrc`` on the CPU.

    python3 scripts/cuda_emu/emulate.py attn               # GQA attention
    python3 scripts/cuda_emu/emulate.py mla                # MLA attention
    python3 scripts/cuda_emu/emulate.py prefill q2_k,q4_k  # B1 prefill form
    python3 scripts/cuda_emu/emulate.py decode q2_k,q8_0   # B1 mma decode form
    python3 scripts/cuda_emu/emulate.py experts q5_k       # B1 expert form

Copies a source with its headers into ``src/repro_torch/_build/emu/``,
rewrites it for g++ (``mma.cuh`` replaced by this directory's emulated
one, the ``fma.rn.bf16x2`` asm of ``code_pair`` and the ``bar.sync`` of
``named_sync`` made calls, ``__shared__``
arrays made per-block buffers, ``<<<...>>>`` launches made calls), builds
it with ``g++ -std=c++20`` against the stub headers in ``stub/``
(``emu_core.h``: a CUDA thread is a ``std::thread``), and loads the
library in place of the one ``kernels/build.py`` would build, so that the
wrappers' own launch code (argument types, split sizes) runs on CPU
tensors.  Each case is held against the plain version (and padded rows
against zeros, and two calls against each other, bitwise), at tiny
shapes: the indexing, the copies' alignment, ragged shapes and the
cluster merges are checked, in seconds to a minute; speed and what nvcc
accepts are not.  ``--sms`` sets the SM count that the wrappers size
their splits by (default 132).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.qtensor import quantize  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attn as pa  # noqa: E402
from repro_torch.kernels import qmatmul as qm  # noqa: E402
from repro_torch.models import paged  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "src" / "repro_torch" / "_build" / "emu"
CODE_PAIR_ASM = (r'asm\("fma\.rn\.bf16x2 %0, %1, %2, %3;\\n"\s*:\s*'
                 r'"=r"\(r\)\s*:\s*"r"\(v\), "r"\(0x3F803F80u\), '
                 r'"r"\(bias\)\);')


def emulated_library(source: str, flags: tuple = ()) -> ctypes.CDLL:
    """``csrc/<source>.cu`` rewritten for g++, built and loaded."""
    tag = "_".join([source, *(f.lstrip("-D").replace("=", "") for f in flags)])
    work = OUT / tag
    work.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    shutil.copy(HERE / "mma.cuh", work / "mma.cuh")
    s = (CSRC / f"{source}.cu").read_text()
    s = re.sub(CODE_PAIR_ASM, "r = emu_fma_bf16x2(v, 0x3F803F80u, bias);", s)
    s = s.replace('asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(n) : '
                  '"memory");', "emu_bar_sync(id, n);")
    s = re.sub(r"extern __shared__ __align__\(16\) uint8_t (\w+)\[\];",
               r"uint8_t* \1 = emu_smem();", s)
    s = re.sub(r"__shared__ (\w+) (\w+)\[(.*?)\];",
               r"\1* \2 = (\1*)emu_static_smem(sizeof(\1) * (\3));", s)
    s = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\(", r"emu_launch(\1, \2, ",
               s)
    if "asm" in re.sub(r"//.*", "", s):
        raise SystemExit(f"{source}.cu: an asm statement the emulation does "
                         "not map")
    (work / f"{source}.cu").write_text(s)
    lib = work / f"lib{tag}.so"
    cmd = ["g++", "-x", "c++", "-std=c++20", "-O1", "-fPIC", "-shared",
           "-I", str(HERE / "stub"), *flags, "-o", str(lib),
           str(work / f"{source}.cu"), "-lpthread"]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"g++ failed for {source}.cu:\n{done.stderr}")
    return ctypes.CDLL(str(lib))


def gqa_pools(rng, b, n_lp, P, hkv, d, dv, live):
    """f32 K/V pools and block tables, ``live[i]`` written tokens a lane."""
    n_pages = paged.RESERVED_PAGES + b * n_lp
    k = rng.normal(size=(n_pages, P, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, P, hkv, dv)).astype(np.float32)
    pos = np.full((n_pages, P), -1, np.int32)
    bt = np.full((b, n_lp), paged.NULL_PAGE, np.int32)
    nxt = paged.RESERVED_PAGES
    for i in range(b):
        for lp in range(-(-live[i] // P)):
            bt[i, lp] = nxt
            for o in range(P):
                if lp * P + o < live[i]:
                    pos[nxt, o] = lp * P + o
            nxt += 1
    return [torch.from_numpy(a) for a in (k, v, pos, bt)]


# mode, query dtype, B, C, H, Hkv, D, Dv, P, table width, live, window,
# softcap, padded rows of the last lane
PREFILL_CASES = [
    ("q8_0", torch.bfloat16, 2, 5, 12, 2, 128, 128, 16, 4, [40, 23], 0, 0., 2),
    ("q4_0", torch.bfloat16, 2, 5, 12, 2, 128, 128, 16, 4, [40, 23], 0, 0., 2),
    ("q8_0", torch.float32, 2, 7, 6, 2, 32, 32, 3, 6, [17, 9], 0, 0., 2),
    ("q4_0", torch.float32, 1, 40, 2, 2, 16, 16, 5, 12, [55], 0, 0., 2),
    ("q8_0", torch.bfloat16, 1, 9, 4, 1, 64, 32, 4, 10, [38], 6, 20., 2),
    ("q4_0", torch.bfloat16, 1, 3, 2, 1, 8, 8, 7, 3, [20], 0, 0., 2),
    ("q8_0", torch.bfloat16, 1, 4, 2, 1, 256, 256, 8, 4, [30], 0, 0., 2),
    ("q4_0", torch.float32, 1, 4, 3, 1, 24, 40, 3, 9, [25], 0, 0., 2),
    ("q8_0", torch.bfloat16, 1, 8, 2, 1, 128, 128, 16, 20, [300], 0, 0., 2),
    ("q8_0", torch.float32, 2, 5, 12, 2, 128, 128, 16, 4, [40, 23], 0, 0., 2),
    ("q4_0", torch.float32, 1, 4, 2, 1, 256, 256, 8, 4, [30], 9, 30., 2),
    ("q4_0", torch.bfloat16, 1, 128, 12, 2, 128, 128, 16, 64, [1000], 0, 0.,
     30),
    # the served models' head widths and groups: D = 96 at a group of 1
    # (phi3), groups of 5 and 8
    ("q4_0", torch.bfloat16, 2, 6, 4, 4, 96, 96, 16, 4, [40, 23], 0, 0., 2),
    ("q8_0", torch.float32, 2, 6, 4, 4, 96, 96, 16, 4, [40, 23], 0, 0., 2),
    ("q8_0", torch.bfloat16, 1, 20, 10, 2, 128, 128, 16, 4, [50], 0, 0., 3),
    ("q4_0", torch.float32, 1, 9, 16, 2, 128, 128, 16, 4, [50], 0, 0., 2),
]
# kv (None: bf16 pools), B, H, Hkv, D, P, table width, live, lane_pages,
# window, softcap
DECODE_CASES = [
    (kv, 3, 12, 2, 128, 16, 8, [100, 17, 1], [7, 2, 1], 0, 0.)
    for kv in (None, "q8_0", "q4_0")] + [
    (kv, 2, 4, 1, 64, 5, 12, [55, 9], None, 6, 20.)
    for kv in (None, "q8_0", "q4_0")] + [
    (kv, 2, h, hkv, d, 16, 6, [90, 33], [6, 3], 0, 0.)
    for kv in (None, "q8_0", "q4_0")
    for h, hkv, d in ((6, 6, 96), (10, 2, 128), (16, 2, 128))]


def attn(sms: int) -> bool:
    lib = emulated_library("paged_attn")
    build.library = lambda name: lib
    pa._prefill_entry.cache_clear()
    pa._decode_entry.cache_clear()
    ok = True
    for (mode, qdt, b, c, h, hkv, d, dv, P, n_lp, live, window, softcap,
         pad) in PREFILL_CASES:
        rng = np.random.default_rng(b * 7 + c + h + d + P)
        k, v, pos, bt = gqa_pools(rng, b, n_lp, P, hkv, d, dv, live)
        qpos = torch.clamp(torch.stack([torch.arange(x - c, x) for x in live]),
                           min=-1).to(torch.int32)
        qpos[-1, c - pad:] = -1
        q = torch.from_numpy(rng.normal(size=(b, c, h, d)).astype(
            np.float32)).to(qdt)
        kv = (*paged.quantize_rows(k, mode), *paged.quantize_rows(v, mode))
        kind, kq, kd, vq, vd, width = pa._quant_kv(q, kv, mode)
        kw = dict(dv=width, nj=n_lp, window=window, scale=d ** -0.5,
                  softcap=softcap)
        t0 = time.perf_counter()
        y = pa._launch_prefill(kind, q, kq, vq, kd, vd, pos, bt, qpos, **kw)
        secs = time.perf_counter() - t0
        y2 = pa._launch_prefill(kind, q, kq, vq, kd, vd, pos, bt, qpos, **kw)
        ref = pa.attn_prefill_plain(q, kv, pos, bt, qpos, window=window,
                                    softcap=softcap, scale=d ** -0.5,
                                    nj=n_lp, quant=mode)
        err = (y - ref).abs().max().item()
        good = (err < 1e-5 and torch.equal(y.view(torch.int32),
                                           y2.view(torch.int32))
                and bool((y[qpos < 0] == 0).all()))
        _, splits = pa.attn_prefill_tiles(b, c, h, hkv, nj=n_lp, page_size=P,
                                          sms=sms)
        print(f"prefill {mode} {str(qdt)[6:]} B={b} C={c} H={h}/{hkv} "
              f"D={d}/{dv} P={P} live {live} window {window} softcap "
              f"{softcap} splits {splits}: err {err:.1e} {secs:.1f}s "
              f"{'ok' if good else 'FAILED'}", flush=True)
        ok &= good
    for kv, b, h, hkv, d, P, n_lp, live, lanes, window, softcap in \
            DECODE_CASES:
        rng = np.random.default_rng(b + h + d)
        k, v, pos, bt = gqa_pools(rng, b, n_lp, P, hkv, d, d, live)
        q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
        qp = torch.tensor([x - 1 for x in live], dtype=torch.int32)
        lp = None if lanes is None else torch.tensor(lanes, dtype=torch.int32)
        if kv:
            pools = (*paged.quantize_rows(k, kv), *paged.quantize_rows(v, kv))
            kind, kq, kd, vq, vd, width = pa._quant_kv(q, pools, kv)
        else:
            pools = (k.to(torch.bfloat16), v.to(torch.bfloat16))
            kind, (kq, vq), kd, vd, width = 1, pools, None, None, d
        y = pa._launch_decode(kind, q, kq, vq, kd, vd, pos, bt, qp, lp,
                              dv=width, nj=n_lp, window=window,
                              scale=d ** -0.5, softcap=softcap)
        ref = pa.attn_decode_plain(q, pools, pos, bt, qp,
                                   pa._lane_bound(lp, b, n_lp, q.device),
                                   window=window, softcap=softcap,
                                   scale=d ** -0.5, nj=n_lp, quant=kv)
        err = (y - ref).abs().max().item()
        print(f"decode {kv or 'bf16'} B={b} H={h}/{hkv} D={d} P={P} live "
              f"{live}: err {err:.1e} {'ok' if err < 1e-5 else 'FAILED'}",
              flush=True)
        ok &= err < 1e-5
    return ok


# (latent, rope) modes (None: bf16 pools), query dtype, B, C, H, R, Dr, P,
# table width, live, padded rows of the last lane
MLA_CASES = [
    (None, torch.float32, 2, 1, 5, 32, 16, 4, 12, [40, 9], 0),
    (("q8_0", "q8_0"), torch.bfloat16, 2, 1, 20, 32, 14, 5, 9, [33, 12], 0),
    (("q4_0", "q4_0"), torch.float32, 2, 1, 5, 48, 14, 16, 4, [50, 3], 0),
    (("q8_0", "q8_0"), torch.bfloat16, 2, 9, 70, 32, 16, 4, 12, [40, 20], 2),
    (("q4_0", "q4_0"), torch.float32, 2, 9, 5, 48, 14, 5, 8, [33, 12], 2),
    (("q8_0", "q4_0"), torch.bfloat16, 1, 20, 12, 64, 16, 16, 8, [100], 3),
]


def mla(sms: int) -> bool:
    lib = emulated_library("paged_mla")
    build.library = lambda name: lib
    pa._mla_prefill_entry.cache_clear()
    pa._mla_decode_entry.cache_clear()
    ok = True
    for modes, qdt, b, c, h, r, dr, P, n_lp, live, pad in MLA_CASES:
        rng = np.random.default_rng(b + c + h + r + dr + P)
        n_pages = paged.RESERVED_PAGES + b * n_lp
        ckv = torch.from_numpy(rng.normal(size=(n_pages, P, r)).astype(
            np.float32))
        kr = torch.from_numpy(rng.normal(size=(n_pages, P, dr)).astype(
            np.float32))
        bt = torch.arange(paged.RESERVED_PAGES, n_pages,
                          dtype=torch.int32).reshape(b, n_lp)
        shape = (b, c, h) if c > 1 else (b, h)
        qe = torch.from_numpy(rng.normal(size=(*shape, r)).astype(
            np.float32)).to(qdt)
        qr = torch.from_numpy(rng.normal(size=(*shape, dr)).astype(
            np.float32)).to(qdt)
        if modes:
            pools = (*paged.quantize_rows(ckv, modes[0]),
                     *paged.quantize_rows(kr, modes[1]))
            leaves = pa._mla_leaves(qe, qr, pools, modes)
        else:
            pools = (ckv.to(torch.bfloat16), kr.to(torch.bfloat16))
            leaves = pa._mla_leaves(qe, qr, pools, None)
        kinds, cq, cd, kq, kd = leaves
        if c > 1:
            qpos = torch.clamp(torch.stack([torch.arange(x - c, x)
                                            for x in live]), min=-1).to(
                torch.int32)
            qpos[-1, c - pad:] = -1
            y = pa._mla_prefill_launch(kinds, qe, qr, cq, kq, cd, kd, bt,
                                       qpos, nj=n_lp, scale=0.1)
            ref = pa.mla_prefill_plain(qe, qr, pools, bt, qpos, scale=0.1,
                                       nj=n_lp, quant=modes)
            good0 = bool((y[qpos < 0] == 0).all())
        else:
            pos = torch.tensor([x - 1 for x in live], dtype=torch.int32)
            lp = torch.tensor([-(-x // P) for x in live], dtype=torch.int32)
            y = pa._mla_decode_launch(kinds, qe, qr, cq, kq, cd, kd, bt, pos,
                                      lp, nj=n_lp, scale=0.1)
            ref = pa.mla_decode_plain(qe, qr, pools, bt, pos, scale=0.1,
                                      nj=n_lp, quant=modes)
            good0 = True
        err = (y - ref).abs().max().item()
        good = err < 1e-5 and good0
        print(f"mla {'prefill' if c > 1 else 'decode'} {modes or 'bf16'} "
              f"{str(qdt)[6:]} B={b} C={c} H={h} R={r} Dr={dr} P={P} live "
              f"{live}: err {err:.1e} {'ok' if good else 'FAILED'}",
              flush=True)
        ok &= good
    return ok


# M, K, N, x dtype: ragged K (also with x read 16 bytes at a time: K %
# 8 == 0), N % 16 != 0, 64- and 128-row tiles
PREFILL_FORM_CASES = [(5, 700, 256, torch.bfloat16),
                      (5, 700, 256, torch.float32),
                      (77, 512, 260, torch.bfloat16),
                      (77, 512, 260, torch.float32),
                      (130, 1536, 384, torch.bfloat16),
                      (300, 512, 384, torch.bfloat16),
                      (300, 700, 388, torch.float32),
                      (77, 1664, 260, torch.bfloat16),
                      (5, 1664, 256, torch.float32)]


def prefill(formats: list[str], sms: int) -> bool:
    libs = {f"qmatmul_{fmt}": emulated_library(
        "qmatmul", (f"-DQMATMUL_FMT={build.QMATMUL_FORMATS.index(fmt)}",))
        for fmt in formats}
    build.library = lambda name: libs[name]
    qm._entry.cache_clear()
    ok = True
    for fmt in formats:
        for m, k, n, dt in PREFILL_FORM_CASES:
            rng = np.random.default_rng(m + k + n)
            qt = quantize(torch.from_numpy(rng.normal(size=(k, n)).astype(
                np.float32)), fmt)
            x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
            x[[1, m - 2]] = 0
            x = x.to(dt)
            before = qm.library_launches(fmt, "prefill")
            y = qm._launch(x, qt, 1, qm.KERNELS[fmt]).reshape(m, n)
            ran = qm.library_launches(fmt, "prefill") - before
            ref = qm.qmatmul_plain(x, qt).float()
            err = ((y.float() - ref).abs().max() / ref.abs().max()).item()
            tol = 1e-5 if dt == torch.float32 else 8e-3
            bits = torch.int32 if dt == torch.float32 else torch.int16
            good = (ran == 1 and err <= tol
                    and not y[[1, m - 2]].view(bits).any())
            print(f"prefill form {fmt} M={m} K={k} N={n} {str(dt)[6:]} "
                  f"ks={qm.prefill_ksplit(n, m, k, sms)}: rel err {err:.1e} "
                  f"{'ok' if good else 'FAILED'}", flush=True)
            ok &= good
    return ok


# M, K, N, x dtype, blocks a cluster: M = 1..4, ragged K, N % 16 != 0,
# clusters of 1..16 (the largest a non-portable size)
DECODE_FORM_CASES = [(1, 700, 256, torch.bfloat16, 1),
                     (2, 700, 260, torch.float32, 3),
                     (3, 1000, 388, torch.bfloat16, 4),
                     (4, 1000, 388, torch.float32, 2),
                     (4, 1536, 256, torch.bfloat16, 6),
                     (2, 2048, 132, torch.float32, 8),
                     (4, 4096, 128, torch.bfloat16, 16),
                     (1, 4096, 260, torch.float32, 16),
                     (4, 1664, 260, torch.bfloat16, 3),
                     (2, 1664, 128, torch.float32, 7)]


def decode(formats: list[str], sms: int) -> bool:
    """B1's decode forms (``qmatmul_mma_decode_kernel``; q4_k's
    ``qmatmul_q4k_decode_kernel``, clusters of at most 8) at each cluster
    size of DECODE_FORM_CASES, forced through the wrapper's split rule:
    one launch of it and of no other form, two calls bitwise equal, a zero
    row +0."""
    libs = {f"qmatmul_{fmt}": emulated_library(
        "qmatmul", (f"-DQMATMUL_FMT={build.QMATMUL_FORMATS.index(fmt)}",))
        for fmt in formats}
    build.library = lambda name: libs[name]
    qm._entry.cache_clear()
    rules = dict(qm.DECODE_KSPLIT)
    ok = True
    for fmt in formats:
        for m, k, n, dt, ks in DECODE_FORM_CASES:
            if fmt == "q4_k":      # its clusters are of a portable size
                ks = min(ks, qm._MAX_KSPLIT)
            qm.DECODE_KSPLIT[fmt] = lambda n_, k_, sms_, ks=ks: ks
            rng = np.random.default_rng(m + k + n + ks)
            qt = quantize(torch.from_numpy(rng.normal(size=(k, n)).astype(
                np.float32)), fmt)
            x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
            if m > 1:
                x[m - 2] = 0
            x = x.to(dt)
            before = {w: qm.library_launches(fmt, w)
                      for w in ("decode", "prefill", "experts")}
            y = qm._launch(x, qt, 1, qm.KERNELS[fmt]).reshape(m, n)
            ran = {w: qm.library_launches(fmt, w) - c
                   for w, c in before.items()}
            y2 = qm._launch(x, qt, 1, qm.KERNELS[fmt]).reshape(m, n)
            ref = qm.qmatmul_plain(x, qt).float()
            err = ((y.float() - ref).abs().max() / ref.abs().max()).item()
            tol = 1e-5 if dt == torch.float32 else 8e-3
            bits = torch.int32 if dt == torch.float32 else torch.int16
            good = (ran == {"decode": 1, "prefill": 0, "experts": 0}
                    and err <= tol and torch.equal(y.view(bits),
                                                   y2.view(bits))
                    and (m == 1 or not y[m - 2].view(bits).any()))
            print(f"decode form {fmt} M={m} K={k} N={n} {str(dt)[6:]} "
                  f"ks={ks}: rel err {err:.1e} {'ok' if good else 'FAILED'}",
                  flush=True)
            ok &= good
        qm.DECODE_KSPLIT[fmt] = rules[fmt]
    return ok


# E, C, K, N, x dtype, live experts: C = 1 (one row, x staged whole; K =
# 16640 too long to stage whole) and C = 20 (one tile) or more (40: two,
# llama4-scout's chunk), ragged K,
# N % 16 != 0 (4-byte copies), experts whose rows are all zero
EXPERT_CASES = [(4, 1, 700, 256, torch.bfloat16, [0, 2, 3]),
                (3, 1, 512, 260, torch.float32, [1]),
                (2, 1, 16640, 128, torch.bfloat16, [1]),
                (3, 20, 700, 136, torch.bfloat16, [0, 2]),
                (2, 23, 512, 256, torch.float32, [0, 1]),
                (2, 7, 1000, 132, torch.float32, [1]),
                (3, 40, 1000, 136, torch.bfloat16, [0, 2])]


def experts(formats: list[str], sms: int) -> bool:
    """B1's expert form (``qmatmul_experts_kernel``) at EXPERT_CASES: one
    launch of it and of no other form, within B1's limits of the plain
    version, the empty experts' outputs bitwise its +0, and a zero row of
    a live expert (C > 1) exactly 0."""
    libs = {f"qmatmul_{fmt}": emulated_library(
        "qmatmul", (f"-DQMATMUL_FMT={build.QMATMUL_FORMATS.index(fmt)}",))
        for fmt in formats}
    build.library = lambda name: libs[name]
    qm._entry.cache_clear()
    ok = True
    for fmt in formats:
        for e, c, k, n, dt, live in EXPERT_CASES:
            rng = np.random.default_rng(e + c + k + n)
            qt = quantize(torch.from_numpy(rng.normal(size=(e, k, n)).astype(
                np.float32)), fmt)
            x = torch.zeros((e, c, k))
            x[live] = torch.from_numpy(rng.normal(size=(len(live), c, k))
                                       .astype(np.float32))
            if c > 1:
                x[live[0], c // 2] = 0
            x = x.to(dt)
            before = {w: qm.library_launches(fmt, w)
                      for w in ("decode", "prefill", "experts")}
            y = qm._launch(x, qt, e, qm.EXPERT_KERNELS[fmt]).reshape(e, c, n)
            ran = {w: qm.library_launches(fmt, w) - b
                   for w, b in before.items()}
            ref = qm.qmatmul_plain(x, qt)
            err = ((y.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            tol = 1e-5 if dt == torch.float32 else 2 ** -8
            bits = torch.int32 if dt == torch.float32 else torch.int16
            empty = [i for i in range(e) if i not in live]
            good = (ran == {"decode": 0, "prefill": 0, "experts": 1}
                    and err <= tol
                    and torch.equal(y[empty].view(bits), ref[empty].view(bits))
                    and (c == 1 or not y[live[0], c // 2].view(bits).any()))
            print(f"expert form {fmt} E={e} C={c} K={k} N={n} {str(dt)[6:]} "
                  f"live {live}: rel err {err:.1e} "
                  f"{'ok' if good else 'FAILED'}", flush=True)
            ok &= good
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("attn", "mla", "prefill", "decode",
                                     "experts"))
    ap.add_argument("formats", nargs="?", default=None,
                    help="B1 formats of the prefill or expert form "
                         "(default: all) or of the decode form (default: "
                         "the tensor-core one's, all but q4_k)")
    ap.add_argument("--sms", type=int, default=132)
    args = ap.parse_args()
    if shutil.which("g++") is None:
        raise SystemExit("emulate: needs g++ (C++20)")
    build.stream_ptr = lambda dev: 0
    build.sm_count = lambda dev: args.sms
    every = [f for f in qm.FIELDS if args.what != "decode" or f != "q4_k"]
    formats = args.formats.split(",") if args.formats else every
    ok = (attn(args.sms) if args.what == "attn"
          else mla(args.sms) if args.what == "mla"
          else prefill(formats, args.sms) if args.what == "prefill"
          else experts(formats, args.sms) if args.what == "experts"
          else decode(formats, args.sms))
    print("all cases ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
