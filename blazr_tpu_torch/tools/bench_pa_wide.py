"""Kernel B5 (paged decode attention over the wide KV view): wrapper,
launch count, split plan, plain version, and its sweep beside kernel B2.

    python -m blazr_tpu_torch.tools.bench_pa_wide [B ...]

The kernel is ``csrc/pa_wide.cu`` (CUDA C++ for sm_90a, on the split kernel
of ``csrc/pa_split.cuh``); it replaces ``tools/bench_pa_wide.py::wide_kernel``
of the JAX repository. It computes B2's function (``attention/
paged_attention.py``) without window, softcap, ALiBi or int8 KV, reading each
cache slot of the flat cache [NB*BS(+1), G, D] as one G*D-wide row that
serves every query head, with the probabilities kept in f32. Each sequence's
walk of table slots is split over blocks (``wide_split_plan``) and a second
kernel combines the splits. ``pa_wide`` launches the kernels for CUDA
tensors and runs ``pa_wide_reference`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from ..attention.paged_attention import paged_attention_reference
from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device
from .pa_sweep import run_sweep

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# The split plans of B5 and B6: the most blocks one wave holds (B5: one a SM
# on 132 SMs, B6: four, by their shared memory in bf16: csrc/pa_wide.cu and
# csrc/pa_headmajor.cu say how much; phase 8 of chip_smoke.py sweeps the
# split count) and the fewest bytes of K+V a split reads (B2's 128 keys x
# 256 B x 2).
WIDE_TARGET_BLOCKS = 132
MIN_SPLIT_BYTES = 64 * 1024


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("pa_wide")
    fn = lib.pa_wide_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def layout_split_plan(units: int, max_blocks: int, block_size: int, key_bytes: int,
                      target_blocks: int) -> tuple[int, int]:
    """(splits, table slots per split) for ``units`` blocks of unsplit
    work, each walking ``max_blocks`` slots of ``block_size`` keys of
    ``key_bytes`` (K+V) each: as many splits as keep the blocks within
    ``target_blocks``, none reading less than MIN_SPLIT_BYTES; short walks
    take one split. Taken from the table width, as B2's plan is: the host
    knows no seq_len."""
    max_blocks = max(1, max_blocks)            # an empty table: the kernel refuses it
    least = max(1, -(-MIN_SPLIT_BYTES // (block_size * key_bytes)))   # slots a split
    most = max(1, max_blocks // least)
    splits = max(1, min(most, target_blocks // units))
    per = -(-max_blocks // splits)
    return -(-max_blocks // per), per


@functools.lru_cache(maxsize=None)
def wide_split_plan(batch: int, num_kv_heads: int, max_blocks: int, block_size: int,
                    head_dim: int = 128, itemsize: int = 2) -> tuple[int, int]:
    """(splits, slots per split) of B5: a block covers a sequence's G kv
    heads, so a key is 2*G*D values of K+V and B blocks make one split."""
    return layout_split_plan(batch, max_blocks, block_size,
                             2 * num_kv_heads * head_dim * itemsize, WIDE_TARGET_BLOCKS)


def split_scratch(b: int, h_q: int, d: int, splits: int, dev: torch.device):
    """The f32 partials of a split launch, [B, H_q, splits, D] and
    [B, H_q, splits, 2], or (None, None) with one split."""
    if splits == 1:
        return None, None
    return (torch.empty((b, h_q, splits, d), dtype=torch.float32, device=dev),
            torch.empty((b, h_q, splits, 2), dtype=torch.float32, device=dev))


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address for ctypes, or NULL for None."""
    return None if t is None else t.data_ptr()


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
    if q.shape[2] % 8 or q.shape[2] > 256:
        raise ValueError(f"{name} takes head_dim a multiple of 8 up to 256, got {q.shape[2]}")
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
    mb = block_tables.shape[1]
    splits, per = wide_split_plan(b, g, mb, block_size, d, q.element_size())
    part_acc, part_ml = split_scratch(b, h_q, d, splits, dev)
    err = _lib().pa_wide_launch(
        q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), ptr(part_acc), ptr(part_ml), b, h_q, g, d,
        block_size, num_blocks, mb, splits, per, 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
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
