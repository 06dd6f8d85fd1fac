"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<source>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``_build/lib<library>-<hash>.so`` next
to this package, at first use; the hash covers the source, the headers
of ``csrc/`` (``mma.cuh``) and the flags, so a changed source rebuilds
and an unchanged one loads the library already built.
``csrc/qmatmul.cu`` is built once per weight format (``-DQMATMUL_FMT=<id>``,
one library each), so that its 64 kernels compile in six processes at
once.  Pointers and the stream cross as
``ctypes.c_void_p``, and every C entry point returns ``cudaGetLastError()``
after its launch — the wrappers raise on anything but 0 (a refused launch
never runs, and a later synchronise would not report it).

``build_all()`` compiles every library at once, one ``nvcc`` process each,
started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# B1's formats in the order of their ids in csrc/qmatmul.cu
QMATMUL_FORMATS = ("q4_k", "q6_k", "q3_k", "q5_k", "q2_k", "q8_0")
# library -> (source in csrc/, its extra nvcc flags)
LIBRARIES = {
    **{f"qmatmul_{fmt}": ("qmatmul", (f"-DQMATMUL_FMT={i}",))
       for i, fmt in enumerate(QMATMUL_FORMATS)},
    "paged_attn": ("paged_attn", ()),
    "paged_mla": ("paged_mla", ()),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or the ``PATH``."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    source, flags = LIBRARIES[name]
    # the source and the headers it may include
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS + flags).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start_build(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    source, flags = LIBRARIES[name]
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", tmp,
           str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, Path(tmp), proc


def _finish_build(name: str, job) -> str:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(csrc/{LIBRARIES[name][0]}.cu):\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{out.stem}.log").write_text(log)
    return log


def build_all() -> dict[str, float]:
    """Compile every library (in parallel); returns seconds per library
    (0.0 for one already built)."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in LIBRARIES}
    secs = {}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)
        secs[name] = 0.0 if job is None else time.perf_counter() - t0
    return secs


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` printed for one library (registers, shared
    memory, spills per kernel), or "" when it was not built here."""
    log = BUILD_DIR / f"{_lib_path(name).stem}.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    return ctypes.CDLL(str(_lib_path(name)))


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    f = getattr(library(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, which the kernels' splits are sized by."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
