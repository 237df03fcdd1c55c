"""Kernels B1 (fused dequant + matmul) and B4 (its streaming decode
variant): wrappers, launch counts and plain versions.

B1 is ``csrc/qmm.cu`` and replaces
``blazr_tpu/quant/pallas/int_matmul.py::_qmm_kernel``; B4 is
``csrc/qmm_stream.cu`` and replaces ``_qmm_stream_kernel`` (CUDA C++ for
sm_90a). Their notes say what bounds them on the H100 and how their designs
answer that.

``qmm`` and ``qmm_stream`` launch their kernels for CUDA tensors and run
``qmm_reference`` / ``qmm_stream_reference`` for CPU tensors. Nothing falls
back: a CUDA tensor a kernel does not take, or a failed launch, raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device
from .qtensor import dequantize_planes

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# Fewest rows for the tensor-core variant of B1: below 16 rows the
# CUDA-core variant is faster at every Mistral-7B projection, from 16 up
# the tensor-core one (H100 timings in PERF.md, PR 1).
TC_MIN_ROWS = 16
# B4: rows the streaming variant takes (the JAX branch's m <= 32), the K rows
# its blocks stream per stage, and the blocks it aims for on 132 SMs.
STREAM_MAX_ROWS = 32
_STREAM_KST = 128
_STREAM_TARGET_BLOCKS = 264


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("qmm")
    if lib.qmm_launch.argtypes is None:
        lib.qmm_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p])
        lib.qmm_launch.restype = ctypes.c_int
        lib.qmm_tc_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
        lib.qmm_tc_launch.restype = ctypes.c_int
    return lib


def _tensor_core_path(x: torch.Tensor, m: int, group_size: int) -> bool:
    """The WMMA variant takes bf16 rows from TC_MIN_ROWS up, groups that
    tile into 16-row steps, and 16-byte aligned x; the CUDA-core variant
    takes everything else."""
    return (x.dtype == torch.bfloat16 and m >= TC_MIN_ROWS
            and group_size % 16 == 0
            and (group_size <= 128 or group_size % 128 == 0)
            and x.data_ptr() % 16 == 0)


def qmm_reference(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                  mins: torch.Tensor, *, bits: int, signed: bool,
                  group_size: int) -> torch.Tensor:
    """Plain version of B1: ``x [M, K] @ (q·s − m) [K, N]`` in float32,
    returned in x's dtype."""
    w = dequantize_planes(qweight, scales, mins, bits, signed, group_size)
    return (x.to(torch.float32) @ w).to(x.dtype)


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
        raise TypeError(f"B1 takes bfloat16 or float32 activations, got {x.dtype}")
    if not (x.is_contiguous() and qweight.is_contiguous()
            and scales.is_contiguous() and mins.is_contiguous()):
        raise ValueError("B1 needs contiguous operands")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    lib = _lib()
    ptrs = (x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), mins.data_ptr(),
            y.data_ptr(), m, k, n, bits, int(signed), group_size)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if _tensor_core_path(x, m, group_size):
        err = lib.qmm_tc_launch(*ptrs, stream)
    else:
        err = lib.qmm_launch(*ptrs, _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"qmm kernel launch failed with CUDA error {err} "
                           f"(M={m} K={k} N={n} bits={bits} gs={group_size})")
    qmm.launches += 1
    return y


qmm.launches = 0


# ---------------------------------------------------------------------------
# B4: streaming decode variant (split-K, cp.async ring)
# ---------------------------------------------------------------------------

def _stream_lib() -> ctypes.CDLL:
    lib = cuda_build.load("qmm_stream")
    if lib.qmm_stream_launch.argtypes is None:
        lib.qmm_stream_launch.argtypes = ([ctypes.c_void_p] * 6
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


def stream_splits(k: int, n: int, group_size: int) -> tuple[int, int]:
    """(splits, K rows per split) for B4: enough K splits that the N/128
    column tiles give about _STREAM_TARGET_BLOCKS blocks; a split is a whole
    number of stages of max(128, group) rows."""
    unit = max(_STREAM_KST, group_size)
    units = k // unit
    splits = min(units, max(1, -(-_STREAM_TARGET_BLOCKS // (n // 128))))
    per = -(-units // splits) * unit
    return -(-k // per), per


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
        raise TypeError(f"B4 takes bfloat16 or float32 activations, got {x.dtype}")
    unit = max(_STREAM_KST, group_size)
    if n % 128 or k % unit or unit % group_size:
        raise ValueError(f"B4 needs N % 128 == 0 and K a multiple of "
                         f"max(128, group) that the group divides (N={n} K={k} "
                         f"gs={group_size})")
    if not (x.is_contiguous() and qweight.is_contiguous()
            and scales.is_contiguous() and mins.is_contiguous()
            and x.data_ptr() % 16 == 0):
        raise ValueError("B4 needs contiguous operands and 16-byte aligned x")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    splits, per = stream_splits(k, n, group_size)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _stream_lib().qmm_stream_launch(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), mins.data_ptr(),
        part.data_ptr(), y.data_ptr(), m, k, n, bits, group_size, splits, per,
        _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"qmm_stream kernel launch failed with CUDA error {err} "
                           f"(M={m} K={k} N={n} bits={bits} gs={group_size})")
    qmm_stream.launches += 1
    return y


qmm_stream.launches = 0
