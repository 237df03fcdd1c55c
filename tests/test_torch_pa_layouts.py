"""Port parity: the plain versions of kernels B5 (wide KV view) and B6
(head-major KV cache) against the JAX Pallas kernels they replace, run in
interpret mode on the CPU.

The JAX kernels live in the layout tools ``tools/bench_pa_wide.py`` and
``tools/bench_pa_headmajor.py``, whose top level asserts a TPU and runs the
sweep. Their kernel and wrapper functions and their G/HPG/D/H globals are
taken from the sources with ``ast`` and executed without that top level;
``pallas_call`` gets ``interpret=True``. Tolerances: 1e-5 in f32 (online
against one-shot softmax, f32 sums in another order) and 2e-2 in bf16 (the
output rounding, 2^-9 relative, on outputs of order max|v|)."""

import ast
import functools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from blazr_tpu_torch.tools.bench_pa_headmajor import (
    pa_headmajor, pa_headmajor_reference, to_head_major)
from blazr_tpu_torch.tools.bench_pa_wide import pa_wide, pa_wide_reference

TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU = "cpu"


class _InterpretPallas:
    """``pl`` with ``pallas_call`` in interpret mode; everything else as is."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


def _load_tool(name: str, functions: tuple[str, ...]) -> dict:
    tree = ast.parse((TOOLS / name).read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in functions:
            keep.append(node)
        elif (isinstance(node, ast.Assign)
              and all(isinstance(t, (ast.Name, ast.Tuple)) for t in node.targets)
              and isinstance(node.value, (ast.Tuple, ast.BinOp, ast.Constant))):
            keep.append(node)                  # G, HPG, D = ...; H = G * HPG; CTX; ITERS
    ns = dict(jax=jax, jnp=jnp, np=np, pl=_InterpretPallas(), pltpu=pltpu,
              functools=functools, math=math)
    exec(compile(ast.Module(body=keep, type_ignores=[]), name, "exec"), ns)
    return ns


WIDE = _load_tool("bench_pa_wide.py", ("wide_kernel", "pa_wide"))
HEADMAJOR = _load_tool("bench_pa_headmajor.py", ("hm_kernel", "pa_headmajor"))
G, HPG, D = WIDE["G"], WIDE["HPG"], WIDE["D"]


def _inputs(seed, dtype, bs=8, nb=10, mb=4):
    """Ragged sequences: one of length 1, one ending mid-block, one full."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, G * HPG, D)).astype(np.float32)
    kf = rng.standard_normal((nb * bs + 1, G, D)).astype(np.float32)
    vf = rng.standard_normal((nb * bs + 1, G, D)).astype(np.float32)
    bt = np.array([[7, 2, 9, 0], [4, 1, 0, 0], [3, 8, 5, 6]], dtype=np.int32)[:, :mb]
    sl = np.array([1, 2 * bs + 3, mb * bs], dtype=np.int32)
    if dtype == "bf16":
        q, kf, vf = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                     for a in (q, kf, vf))
    return dict(q=q, kf=kf, vf=vf, bt=bt, sl=sl, bs=bs, nb=nb)


def _torch(a, dtype):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if dtype == "bf16" and t.is_floating_point() else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wide_plain_matches_pallas_interpret(dtype):
    s = _inputs(1, dtype)
    ref = WIDE["pa_wide"](_jax(s["q"], dtype), _jax(s["kf"], dtype), _jax(s["vf"], dtype),
                          jnp.asarray(s["bt"]), jnp.asarray(s["sl"]),
                          block_size=s["bs"], num_blocks=s["nb"])
    got = pa_wide(*(_torch(s[k], dtype) for k in ("q", "kf", "vf", "bt", "sl")),
                  block_size=s["bs"], num_blocks=s["nb"], device=CPU)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_headmajor_plain_matches_pallas_interpret(dtype):
    s = _inputs(2, dtype)
    k_hm = np.transpose(s["kf"][:-1], (1, 0, 2))
    v_hm = np.transpose(s["vf"][:-1], (1, 0, 2))
    ref = HEADMAJOR["pa_headmajor"](
        _jax(s["q"], dtype), _jax(k_hm, dtype), _jax(v_hm, dtype), jnp.asarray(s["bt"]),
        jnp.asarray(s["sl"]), block_size=s["bs"], num_blocks=s["nb"])
    kf, vf = _torch(s["kf"], dtype), _torch(s["vf"], dtype)
    got = pa_headmajor(_torch(s["q"], dtype), to_head_major(kf), to_head_major(vf),
                       _torch(s["bt"], dtype), _torch(s["sl"], dtype),
                       block_size=s["bs"], num_blocks=s["nb"], device=CPU)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=_TOL[dtype], atol=_TOL[dtype])


def test_to_head_major_drops_trash_slot():
    flat = torch.arange(5 * 2 * 3, dtype=torch.float32).reshape(5, 2, 3)
    hm = to_head_major(flat)
    assert hm.shape == (2, 4, 3) and hm.is_contiguous()
    assert torch.equal(hm[1, 2], flat[2, 1])


def test_layout_plain_versions_agree():
    """B5's and B6's plain versions are one function over two layouts."""
    s = _inputs(3, "f32")
    args = [torch.from_numpy(s[k]) for k in ("bt", "sl")]
    q, kf, vf = (torch.from_numpy(s[k]) for k in ("q", "kf", "vf"))
    a = pa_wide_reference(q, kf, vf, *args, block_size=s["bs"])
    b = pa_headmajor_reference(q, to_head_major(kf), to_head_major(vf), *args,
                               block_size=s["bs"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layout_wrappers_check_shapes():
    s = _inputs(4, "f32")
    q, kf, vf, bt, sl = (torch.from_numpy(s[k]) for k in ("q", "kf", "vf", "bt", "sl"))
    with pytest.raises(ValueError):
        pa_wide(q, kf, vf, bt, sl, block_size=s["bs"], num_blocks=s["nb"] + 1, device=CPU)
    with pytest.raises(ValueError):
        pa_headmajor(q, kf, vf, bt, sl, block_size=s["bs"], num_blocks=s["nb"],
                     device=CPU)
    with pytest.raises(ValueError):
        pa_wide(q[:, :5], kf, vf, bt, sl, block_size=s["bs"], num_blocks=s["nb"],
                device=CPU)
