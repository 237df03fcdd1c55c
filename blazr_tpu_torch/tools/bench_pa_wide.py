"""Kernel B5 (paged decode attention over the wide KV view): wrapper,
launch count, plain version, and its sweep beside kernel B2.

    python -m blazr_tpu_torch.tools.bench_pa_wide [B ...]

The kernel is ``csrc/pa_wide.cu`` (CUDA C++ for sm_90a); it replaces
``tools/bench_pa_wide.py::wide_kernel`` of the JAX repository. It computes
B2's function (``attention/paged_attention.py``) without window, softcap,
ALiBi or int8 KV, reading each KV block of the flat cache [NB*BS(+1), G, D]
as [BS, G*D] rows, with the probabilities kept in f32. ``pa_wide`` launches
the kernel for CUDA tensors and runs ``pa_wide_reference`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from ..attention.paged_attention import paged_attention_reference
from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device
from .pa_sweep import run_sweep

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("pa_wide")
    fn = lib.pa_wide_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def pa_wide_reference(q: torch.Tensor, k_flat: torch.Tensor, v_flat: torch.Tensor,
                      block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                      block_size: int) -> torch.Tensor:
    """Plain version of B5: B2's plain version with no options (a dense
    gather and a float32 softmax), the same function."""
    return paged_attention_reference(q, k_flat, v_flat, block_tables, seq_lens,
                                     block_size=block_size)


def check_layout(q, k, v, block_tables, seq_lens, num_blocks, block_size, rows_of):
    """Shared checks of B5 and B6: shapes, dtypes, contiguity. ``rows_of(k)``
    is the number of cache slots the layout holds."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("q must be [B, H_q, D] and the caches 3-D and equal in shape")
    b, h_q, d = q.shape
    if rows_of(k) < num_blocks * block_size:
        raise ValueError(f"cache has {rows_of(k)} slots < {num_blocks}x{block_size}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError("block_tables must be [B, MB] and seq_lens [B]")


def _check_card(name, q, k, v, block_tables, seq_lens):
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes bfloat16, float32 or float16 q and caches of "
                        f"q's dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] % 8:
        raise ValueError(f"{name} takes head_dim a multiple of 8, got {q.shape[2]}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if not all(t.is_contiguous() for t in (q, k, v, block_tables, seq_lens)):
        raise ValueError(f"{name} needs contiguous operands")


def pa_wide(q: torch.Tensor, k_flat: torch.Tensor, v_flat: torch.Tensor,
            block_tables: torch.Tensor, seq_lens: torch.Tensor, *, block_size: int,
            num_blocks: int, device: DeviceLike = None) -> torch.Tensor:
    """Decode attention over the flat paged cache [slots, G, D] on ``device``
    (default ``cuda``); every tensor must lie there. Output [B, H_q, D] in
    q's dtype."""
    dev = resolve_device(device)
    check_on(dev, q, k_flat, v_flat, block_tables, seq_lens)
    check_layout(q, k_flat, v_flat, block_tables, seq_lens, num_blocks, block_size,
                 lambda k: k.shape[0])
    b, h_q, d = q.shape
    g = k_flat.shape[1]
    if k_flat.shape[2] != d or h_q % g:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k_flat.shape)}")
    if dev.type == "cpu":
        return pa_wide_reference(q, k_flat, v_flat, block_tables, seq_lens,
                                 block_size=block_size)
    _check_card("B5", q, k_flat, v_flat, block_tables, seq_lens)
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _lib().pa_wide_launch(
        q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), b, h_q, g, d, block_size, num_blocks,
        block_tables.shape[1], 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"pa_wide launch failed with CUDA error {err}")
    pa_wide.launches += 1
    return out


pa_wide.launches = 0


def main(argv: Optional[Sequence[str]] = None) -> list[dict]:
    """The sweep of the JAX tool: B2 ("cur") against B5 ("wide")."""
    return run_sweep("wide", lambda s: (s["kf"], s["vf"]), pa_wide, argv)


if __name__ == "__main__":
    main()
