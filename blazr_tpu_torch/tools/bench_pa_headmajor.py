"""Kernel B6 (paged decode attention over a head-major KV cache): wrapper,
launch count, plain version, layout helper, and its sweep beside kernel B2.

    python -m blazr_tpu_torch.tools.bench_pa_headmajor [B ...]

The kernel is ``csrc/pa_headmajor.cu`` (CUDA C++ for sm_90a); it replaces
``tools/bench_pa_headmajor.py::hm_kernel`` of the JAX repository. It computes
B5's function over the cache laid out [G, NB*BS, D] (``to_head_major``), one
block per (sequence, kv head), with the probabilities kept in f32.
``pa_headmajor`` launches the kernel for CUDA tensors and runs
``pa_headmajor_reference`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from ..attention.paged_attention import paged_attention_reference
from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device
from .bench_pa_wide import _DTYPE_CODE, _check_card, check_layout
from .pa_sweep import run_sweep


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("pa_headmajor")
    fn = lib.pa_headmajor_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def to_head_major(flat: torch.Tensor) -> torch.Tensor:
    """Flat paged cache [NB*BS + 1, G, D] → head-major [G, NB*BS, D],
    without the trailing trash slot (the JAX tool's ``kf[:-1]``)."""
    return flat[:-1].transpose(0, 1).contiguous()


def pa_headmajor_reference(q: torch.Tensor, k_hm: torch.Tensor, v_hm: torch.Tensor,
                           block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                           block_size: int) -> torch.Tensor:
    """Plain version of B6: B2's plain version with no options over the
    flat view [NB*BS, G, D] of the head-major cache."""
    return paged_attention_reference(q, k_hm.transpose(0, 1), v_hm.transpose(0, 1),
                                     block_tables, seq_lens, block_size=block_size)


def pa_headmajor(q: torch.Tensor, k_hm: torch.Tensor, v_hm: torch.Tensor,
                 block_tables: torch.Tensor, seq_lens: torch.Tensor, *, block_size: int,
                 num_blocks: int, device: DeviceLike = None) -> torch.Tensor:
    """Decode attention over the head-major cache [G, slots, D] on ``device``
    (default ``cuda``); every tensor must lie there. Output [B, H_q, D] in
    q's dtype."""
    dev = resolve_device(device)
    check_on(dev, q, k_hm, v_hm, block_tables, seq_lens)
    check_layout(q, k_hm, v_hm, block_tables, seq_lens, num_blocks, block_size,
                 lambda k: k.shape[1])
    b, h_q, d = q.shape
    g = k_hm.shape[0]
    if k_hm.shape[2] != d or h_q % g:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k_hm.shape)}")
    if dev.type == "cpu":
        return pa_headmajor_reference(q, k_hm, v_hm, block_tables, seq_lens,
                                      block_size=block_size)
    _check_card("B6", q, k_hm, v_hm, block_tables, seq_lens)
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _lib().pa_headmajor_launch(
        q.data_ptr(), k_hm.data_ptr(), v_hm.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), b, h_q, g, d, block_size, num_blocks,
        block_tables.shape[1], k_hm.shape[1], 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"pa_headmajor launch failed with CUDA error {err}")
    pa_headmajor.launches += 1
    return out


pa_headmajor.launches = 0


def main(argv: Optional[Sequence[str]] = None) -> list[dict]:
    """The sweep of the JAX tool: B2 ("cur") against B6 ("headmajor")."""
    return run_sweep("headmajor",
                     lambda s: (to_head_major(s["kf"]), to_head_major(s["vf"])),
                     pa_headmajor, argv)


if __name__ == "__main__":
    main()
