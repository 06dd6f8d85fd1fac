"""The PyTorch port's weight formats, policies and import hygiene, held
against the JAX reference.

  * quantize / dequantize of all six K-quant formats are bitwise equal to
    ``repro.core`` on the sweeps of tests/test_roundtrip.py (including K
    that is not a multiple of the block and a leading expert dim);
  * the bit-packing helpers are bitwise equal;
  * ``format_map`` equals the reference path for path under Q4_K_M and
    DQ3_K_M, for qwen2-1.5b full and reduced;
  * no module of the port (nor chip_smoke.py) imports ``jax`` or ``repro``.
"""

import ast
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import apply as jax_apply
from repro.core import formats as jax_formats
from repro.core import get_policy as jax_get_policy
from repro.core import quantize as jax_quantize

from repro_torch.configs import get_config
from repro_torch.core import apply, formats, get_policy
from repro_torch.core.qtensor import quantize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(512, 48), (300, 16), (2, 256, 8), (768, 1)]
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _weights(fmt, shape):
    rng = np.random.default_rng(zlib.crc32(repr((fmt, shape)).encode()))
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("fmt", list(jax_formats.FORMATS))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_dequantize_bitwise(fmt, shape):
    w = _weights(fmt, shape)
    ref = jax_quantize(jnp.asarray(w), fmt)
    got = quantize(torch.from_numpy(w), fmt)
    assert got.shape == ref.shape
    assert sorted(got.fields) == sorted(ref.fields)
    for name, arr in ref.fields.items():
        a = np.asarray(arr)
        b = got.fields[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), (fmt, shape, name)
    assert got.num_superblocks == ref.num_superblocks
    assert got.packed_bytes() == ref.packed_bytes()
    a = np.asarray(ref.dequantize(jnp.float32))
    b = got.dequantize(torch.float32).numpy()
    assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,hi", [("nibbles", 16), ("2bit", 4),
                                     ("1bit", 2)])
def test_bitpack_bitwise(name, hi):
    per_byte = {16: 2, 4: 4, 2: 8}[hi]
    q = np.random.default_rng(7).integers(
        0, hi, (3, 32 * per_byte, 5)).astype(np.uint8)
    pack_j = getattr(jax_formats, f"pack_{name}")
    pack_t = getattr(formats, f"pack_{name}")
    unpack_t = getattr(formats, f"unpack_{name}")
    packed = pack_t(torch.from_numpy(q))
    assert packed.numpy().tobytes() == np.asarray(
        pack_j(jnp.asarray(q))).tobytes()
    assert (unpack_t(packed).numpy() == q).all()


@pytest.mark.parametrize("policy", ["Q4_K_M", "DQ3_K_M"])
@pytest.mark.parametrize("reduced", [False, True])
def test_format_map_matches_reference(policy, reduced):
    cfg, jcfg = get_config("qwen2-1.5b"), jax_get_config("qwen2-1.5b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = apply.format_map(cfg, get_policy(policy))
    ref = jax_apply.format_map(jcfg, jax_get_policy(policy))
    assert got == ref
    if policy == "DQ3_K_M":
        # the dense GQA model gets exactly the two formats B1 implements
        assert {f for f in got.values() if f in formats.FORMATS} == {
            "q4_k", "q6_k"}


def test_config_copy_matches_reference():
    for reduced in (False, True):
        cfg, jcfg = get_config("qwen2-1.5b"), jax_get_config("qwen2-1.5b")
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for field in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab_size", "padded_vocab",
                      "qkv_bias", "rope_theta", "tie_embeddings", "norm_eps"):
            assert getattr(cfg, field) == getattr(jcfg, field), field


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in files
             if "repro_torch" in p.parts}
    assert {"core/size.py", "configs/qwen2_72b.py", "configs/phi3_mini_3_8b.py",
            "configs/deepseek_r1_distill_qwen_32b.py",
            "configs/llama4_scout_17b_a16e.py"} <= names
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
