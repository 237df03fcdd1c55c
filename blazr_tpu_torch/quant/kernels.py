"""Kernels B1 (fused dequant + matmul) and B4 (its streaming decode
variant): wrappers, launch counts and plain versions.

B1 is ``csrc/qmm.cu`` and replaces
``blazr_tpu/quant/pallas/int_matmul.py::_qmm_kernel``; B4 is
``csrc/qmm_stream.cu`` (a bf16 pre-pass and a tensor-core product) and
replaces ``_qmm_stream_kernel`` (CUDA C++ for sm_90a). Their notes say what
bounds them on the H100 and how their designs answer that.

``qmm`` and ``qmm_stream`` launch their kernels for CUDA tensors and run
``qmm_reference`` / ``qmm_stream_reference`` for CPU tensors. Nothing falls
back: a CUDA tensor a kernel does not take, or a failed launch, raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device
from .qtensor import dequantize_planes

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# Fewest rows for B1's tensor-core (wgmma) variant; below it the split-K
# CUDA-core variant runs. From the row sweep of chip_smoke.py phase 8
# (PERF.md): at 4 rows the CUDA-core variant wins on all four projections,
# from 6 the wgmma one does, and 5 rows cost the CUDA-core variant what 8
# do (its 8-row tile).
TC_MIN_ROWS = 5
# Blocks B1 aims for on the H100's 132 SMs. Its tensor-core variant at
# 128-row tiles: one wave of two blocks a SM. At decode rows (its split-K
# variant, and 64-row wgmma tiles) it runs several waves of short blocks
# faster than one wave of long ones (the K-split sweep of chip_smoke.py
# phase 8, PERF.md).
_TARGET_BLOCKS = 264
_DEC_TARGET_BLOCKS = 2048
_TC64_TARGET_BLOCKS = 800
_MAX_SPLITS = 16
# B1: K rows a stage of the split-K variant streams; K rows a step of the
# tensor-core variant, the K rows it dequantizes under one scale, and the
# fewest steps one of its K splits takes.
_DEC_KST = 128
_TC_BK = 64
_TC_CHUNK = 8
_TC_MIN_STEPS = 8
# B4: rows the streaming variant takes (the JAX branch's m <= 32), the K
# rows its blocks stream per stage, and the blocks its K splits aim for
# (the split sweep of chip_smoke.py phase 8: 16 splits of o and down, 4 of
# gate+up).
STREAM_MAX_ROWS = 32
_STREAM_KST = 128
_STREAM_TARGET_BLOCKS = 896


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("qmm")
    if lib.qmm_launch.argtypes is None:
        lib.qmm_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                                   + [ctypes.c_void_p])
        lib.qmm_launch.restype = ctypes.c_int
        lib.qmm_tc_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                                      + [ctypes.c_void_p])
        lib.qmm_tc_launch.restype = ctypes.c_int
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(units: int, tiles: int, max_splits: int, target: int) -> tuple[int, int]:
    """(splits, units per split): enough splits of ``units`` K steps that
    ``tiles`` output tiles give about ``target`` blocks, at most
    ``max_splits``; the last split may be short."""
    splits = max(1, min(max_splits, _cdiv(target, tiles)))
    per = _cdiv(units, splits)
    return _cdiv(units, per), per


def _partials_cap(m: int, k: int) -> int:
    """Most splits whose f32 partials (written and read, 8*m*N*splits bytes)
    move no more bytes than the int4 weight's K*N/2."""
    return max(1, k // (16 * m))


@functools.lru_cache(maxsize=None)
def decode_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(rows per block, K splits, K rows per split) of B1's split-K CUDA-core
    variant: 128 columns a block, a split at least two 128-row stages."""
    bm = 1 if m <= 1 else 4 if m <= 4 else 8 if m <= 8 else 16
    units = _cdiv(k, _DEC_KST)
    cap = min(_MAX_SPLITS, max(1, units // 2), _partials_cap(m, k))
    splits, per = _split(units, _cdiv(m, bm) * _cdiv(n, 128), cap, _DEC_TARGET_BLOCKS)
    return bm, splits, per * _DEC_KST


@functools.lru_cache(maxsize=None)
def tc_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(rows per block, K splits, K rows per split) of B1's tensor-core
    variant: 64x128 tiles up to 64 rows, 128x128 beyond; a split takes at
    least _TC_MIN_STEPS steps of 64 K rows."""
    units = k // _TC_BK
    cap = min(_MAX_SPLITS, max(1, units // _TC_MIN_STEPS))
    if m <= 64:
        splits, per = _split(units, _cdiv(n, 128), min(cap, _partials_cap(m, k)),
                             _TC64_TARGET_BLOCKS)
        return 64, splits, per * _TC_BK
    splits, per = _split(units, _cdiv(m, 128) * _cdiv(n, 128), cap, _TARGET_BLOCKS)
    return 128, splits, per * _TC_BK


def tensor_core_path(dtype: torch.dtype, m: int, k: int, group_size: int) -> bool:
    """The wgmma variant takes bf16 or f16 rows from TC_MIN_ROWS up, K a
    multiple of 64 and a group size that 64 divides or that divides 64 and
    is a multiple of 8 (it dequantizes 8 K rows under one scale); the
    split-K CUDA-core variant takes everything else."""
    return (dtype in (torch.bfloat16, torch.float16) and m >= TC_MIN_ROWS
            and k % _TC_BK == 0 and group_size % _TC_CHUNK == 0
            and (group_size % _TC_BK == 0 or _TC_BK % group_size == 0))


def qmm_reference(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                  mins: torch.Tensor, *, bits: int, signed: bool,
                  group_size: int) -> torch.Tensor:
    """Plain version of B1: ``x [M, K] @ (q·s − m) [K, N]`` in float32,
    returned in x's dtype. f16 x is rounded to bf16 first, as
    ``_qmm_kernel`` rounds x (int_matmul.py:94)."""
    w = dequantize_planes(qweight, scales, mins, bits, signed, group_size)
    xf = x.to(torch.bfloat16) if x.dtype == torch.float16 else x
    return (xf.to(torch.float32) @ w).to(x.dtype)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(x, qweight, scales, mins, bits, group_size):
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    r = 32 // bits
    if qweight.dtype != torch.int32 or qweight.dim() != 2 or qweight.shape[0] * r != k:
        raise ValueError(f"qweight must be int32 [K/{r}, N] for K={k}, got "
                         f"{qweight.dtype} {tuple(qweight.shape)}")
    n = qweight.shape[1]
    if k % group_size or group_size % r:
        raise ValueError(f"group size {group_size} must divide K={k} and hold "
                         f"whole {bits}-bit words ({r} rows)")
    for name, t in (("scales", scales), ("mins", mins)):
        if t.dtype != torch.float32 or tuple(t.shape) != (k // group_size, n):
            raise ValueError(f"{name} must be float32 [{k // group_size}, {n}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    return m, k, n


def qmm(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
        mins: torch.Tensor, *, bits: int, signed: bool, group_size: int,
        device: DeviceLike = None) -> torch.Tensor:
    """``x [M, K] @ dequant(qweight, scales, mins) [K, N] → [M, N]`` in x's
    dtype. Runs on ``device`` (default ``cuda``); every tensor must lie
    there."""
    dev = resolve_device(device)
    check_on(dev, x, qweight, scales, mins)
    m, k, n = _check(x, qweight, scales, mins, bits, group_size)
    if dev.type == "cpu":
        return qmm_reference(x, qweight, scales, mins, bits=bits, signed=signed,
                             group_size=group_size)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"B1 takes bfloat16, float32 or float16 activations, got {x.dtype}")
    if not (x.is_contiguous() and qweight.is_contiguous()
            and scales.is_contiguous() and mins.is_contiguous()):
        raise ValueError("B1 needs contiguous operands")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    if x.data_ptr() % 16:
        x = x.clone()                      # a fresh allocation is 16-byte aligned
    code = _DTYPE_CODE[x.dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tensor_core_path(x.dtype, m, k, group_size):
        bm, splits, per = tc_plan(m, k, n)
        part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        xbf = (torch.empty((m, k), dtype=torch.bfloat16, device=dev)
               if x.dtype == torch.float16 else None)
        err = _lib().qmm_tc_launch(
            x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), mins.data_ptr(),
            _ptr(xbf), _ptr(part), y.data_ptr(), m, k, n, bits, int(signed),
            group_size, bm, splits, per, code, stream)
    else:
        bm, splits, per = decode_plan(m, k, n)
        part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        err = _lib().qmm_launch(
            x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), mins.data_ptr(),
            _ptr(part), y.data_ptr(), m, k, n, bits, int(signed), group_size, bm,
            splits, per, code, stream)
    if err:
        raise RuntimeError(f"qmm kernel launch failed with CUDA error {err} "
                           f"(M={m} K={k} N={n} bits={bits} gs={group_size})")
    qmm.launches += 1
    return y


qmm.launches = 0


# ---------------------------------------------------------------------------
# B4: streaming decode variant (tensor cores, split-K, mbarrier ring)
# ---------------------------------------------------------------------------

def _stream_lib() -> ctypes.CDLL:
    lib = cuda_build.load("qmm_stream")
    if lib.qmm_stream_launch.argtypes is None:
        lib.qmm_stream_launch.argtypes = ([ctypes.c_void_p] * 8
                                          + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.qmm_stream_launch.restype = ctypes.c_int
    return lib


def qmm_stream_reference(x: torch.Tensor, qweight: torch.Tensor,
                         scales: torch.Tensor, mins: torch.Tensor, *, bits: int,
                         group_size: int) -> torch.Tensor:
    """Plain version of B4: B1's function with x rounded to bf16 before the
    products, as ``_qmm_stream_kernel`` rounds it (int_matmul.py:215)."""
    xr = x.to(torch.bfloat16).to(torch.float32)
    return qmm_reference(xr, qweight, scales, mins, bits=bits, signed=True,
                         group_size=group_size).to(x.dtype)


@functools.lru_cache(maxsize=None)
def stream_splits(k: int, n: int, group_size: int) -> tuple[int, int]:
    """(splits, K rows per split) for B4: enough K splits that the N/128
    column tiles give about _STREAM_TARGET_BLOCKS blocks, at most
    _MAX_SPLITS; a split is a whole number of max(128, group) rows."""
    unit = max(_STREAM_KST, group_size)
    splits, per = _split(k // unit, n // 128, _MAX_SPLITS, _STREAM_TARGET_BLOCKS)
    return splits, per * unit


def qmm_stream(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               mins: torch.Tensor, *, bits: int, group_size: int,
               device: DeviceLike = None) -> torch.Tensor:
    """B1's function for signed 4/8-bit weights at decode row counts
    (m <= 32), with x rounded to bf16, through the streaming kernel. Runs on
    ``device`` (default ``cuda``); every tensor must lie there."""
    dev = resolve_device(device)
    check_on(dev, x, qweight, scales, mins)
    m, k, n = _check(x, qweight, scales, mins, bits, group_size)
    if bits not in (4, 8):
        raise ValueError(f"B4 takes signed 4- or 8-bit weights, got {bits} bits")
    if m > STREAM_MAX_ROWS:
        raise ValueError(f"B4 takes at most {STREAM_MAX_ROWS} rows, got {m}")
    if dev.type == "cpu":
        return qmm_stream_reference(x, qweight, scales, mins, bits=bits,
                                    group_size=group_size)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"B4 takes bfloat16, float32 or float16 activations, got {x.dtype}")
    unit = max(_STREAM_KST, group_size)
    if n % 128 or k % unit or unit % group_size or (group_size % 16 and group_size not in (4, 8)):
        raise ValueError(f"B4 needs N % 128 == 0, a group size of 4, 8 or a multiple "
                         f"of 16 and K a multiple of max(128, group) that the group "
                         f"divides (N={n} K={k} gs={group_size})")
    if not (x.is_contiguous() and qweight.is_contiguous()
            and scales.is_contiguous() and mins.is_contiguous()):
        raise ValueError("B4 needs contiguous operands")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    splits, per = stream_splits(k, n, group_size)
    # One f32 workspace: x rounded to bf16 [m, k] (written once per call by
    # the kernel's pre-pass and read by every block), the split partials
    # [splits, m, n] and x's group sums [m, k/gs]. k % 128 == 0 keeps each
    # part 16-byte aligned.
    xb_words, part_words = m * k // 2, splits * m * n
    ws = torch.empty((xb_words + part_words + m * (k // group_size),), dtype=torch.float32,
                     device=dev)
    xb = ws.data_ptr()
    part = xb + 4 * xb_words
    xsum = part + 4 * part_words
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _stream_lib().qmm_stream_launch(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), mins.data_ptr(),
        xb, xsum, part, y.data_ptr(), m, k, n, bits, group_size, splits, per,
        _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"qmm_stream kernel launch failed with CUDA error {err} "
                           f"(M={m} K={k} N={n} bits={bits} gs={group_size})")
    qmm_stream.launches += 1
    return y


qmm_stream.launches = 0
