"""Kernel B3 (int8-activation quantized matmul, W4A8 / W8A8) and its
activation quant: wrappers, launch counts, launch plan and plain versions.

The kernels are ``csrc/qmm_int8.cu`` (CUDA C++ for sm_90a, int8 tensor
cores); they replace ``blazr_tpu/quant/pallas/int_matmul.py::_qmm_int8_kernel``
behind the entry ``quant_matmul_int8mxu``, with the per-row activation quant
that the JAX package runs before its ``pallas_call`` (:391-394):

    xs = max(max|x[i]|, 1e-30) / 127,  xq = clip(round(x / xs), -127, 127)

(``torch.round`` rounds half to even, like ``jnp.round``). Then

    y[i,n] = xs[i] · Σ_g ( s[g,n] · Σ_{k∈g} xq[i,k]·q[k,n] − (Σ_{k∈g} xq[i,k]) · m[g,n] )

with exact int32 inner sums; the offset term uses the group sums of the
quantized activations. On the card the quant is one kernel
(``quantize_activations``: xq, xs and the int32 group sums in one launch,
integer-equal to ``quantize_rows`` on the CPU), and the product is one of two
kernels chosen by ``b3_plan``: ``wgmma`` above ``DEC_MAX_ROWS`` rows (for
K and groups that are multiples of 128), the swapped-operand ``mma.sync``
variant at decode rows and for every other group; a third launch sums the
K splits. The source's note says what bounds them on the H100 and how the
designs answer that. ``qmm_int8`` launches the kernels for CUDA tensors and
runs ``qmm_int8_reference`` for CPU tensors. Nothing falls back: a CUDA
tensor the kernels do not take, or a failed launch, raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device
from .kernels import _cdiv, _split
from .qtensor import unpack

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# Most rows B3's decode variant takes; above it the wgmma variant runs where
# the group fits it. From the row sweep of chip_smoke.py phase 8 (PERF.md).
DEC_MAX_ROWS = 32
# K rows per ring stage of both variants, and blocks each aims for on the
# H100's 132 SMs before K is split (phase 8's split sweep: the decode variant
# runs 8 splits fastest where the tiles give 32-48 blocks, and no split where
# they already give a wave, as gate+up's 224; the wgmma variant, one block a
# SM, about one wave: o and down at 512 rows unsplit, at 64 rows 4 splits).
_STAGE_K = 128
_SMS = 132
_TC_TARGET_BLOCKS = 128
_DEC_TARGET_BLOCKS = 256
_MAX_SPLITS = 16


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("qmm_int8")
    if lib.qmm_int8_launch.argtypes is None:
        lib.act_quant_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
        lib.act_quant_launch.restype = ctypes.c_int
        lib.qmm_int8_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                                        + [ctypes.c_void_p])
        lib.qmm_int8_launch.restype = ctypes.c_int
    return lib


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, K] float → (xq int8 [M, K], xs float32 [M, 1]): symmetric per-row
    int8 quant, the JAX package's ``int_matmul.py:391-394``."""
    x2 = x.to(torch.float32)
    absmax = x2.abs().amax(dim=1, keepdim=True)
    # A true division on every device: CUDA divides by a Python scalar as a
    # multiplication by its reciprocal, which differs in the last bit.
    xs = torch.clamp(absmax, min=1e-30) / torch.full_like(absmax, 127.0)
    xq = torch.clamp(torch.round(x2 / xs), -127, 127).to(torch.int8)
    return xq, xs


def quantize_activations_reference(x: torch.Tensor, group_size: int
                                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the quant kernel: ``quantize_rows`` plus the int32
    group sums of xq, (xq [M, K], xs [M], gsum [M, K/gs])."""
    xq, xs = quantize_rows(x)
    m, k = xq.shape
    gsum = xq.to(torch.int32).reshape(m, k // group_size, group_size).sum(dim=2,
                                                                         dtype=torch.int32)
    return xq, xs.reshape(m), gsum


def quantize_activations(x: torch.Tensor, *, group_size: int, device: DeviceLike = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3's activation quant in one launch on ``device`` (default ``cuda``):
    (xq int8 [M, K], xs float32 [M], gsum int32 [M, K/gs]), integer-equal to
    ``quantize_activations_reference``."""
    dev = resolve_device(device)
    check_on(dev, x)
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    if group_size <= 0 or group_size % 8 or k % group_size:
        raise ValueError(f"group size {group_size} must be a multiple of 8 dividing K={k}")
    if dev.type == "cpu":
        return quantize_activations_reference(x, group_size)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"B3 takes bfloat16, float32 or float16 activations, got {x.dtype}")
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    gsum = torch.empty((m, k // group_size), dtype=torch.int32, device=dev)
    if m == 0:
        return xq, xs, gsum
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.contiguous().clone()        # a fresh allocation is 16-byte aligned
    err = _lib().act_quant_launch(x.data_ptr(), xq.data_ptr(), xs.data_ptr(), gsum.data_ptr(),
                                  m, k, group_size, _DTYPE_CODE[x.dtype],
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"act_quant kernel launch failed with CUDA error {err} "
                           f"(M={m} K={k} gs={group_size})")
    quantize_activations.launches += 1
    return xq, xs, gsum


quantize_activations.launches = 0


def qmm_int8_reference(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor, mins: torch.Tensor, *, bits: int,
                       group_size: int) -> torch.Tensor:
    """Plain version of B3 in float32, returned in x's dtype. The group
    partials are integers below 2^24 (|xq|, |q| ≤ 128, groups ≤ 1024 rows),
    so their float32 sums are exact in any order."""
    xq, xs = quantize_rows(x)
    m, k = xq.shape
    q = unpack(qweight, bits, True).to(torch.float32)
    xf = xq.to(torch.float32)
    y = torch.zeros((m, q.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(k // group_size):
        sl = slice(g * group_size, (g + 1) * group_size)
        part = xf[:, sl] @ q[sl]
        y += part * scales[g] - xf[:, sl].sum(dim=1, keepdim=True) * mins[g]
    return (y * xs).to(x.dtype)


def _check(x, qweight, scales, mins, bits, group_size):
    if bits not in (4, 8):
        raise ValueError(f"B3 takes signed 4- or 8-bit weights, got {bits} bits")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    r = 32 // bits
    if qweight.dtype != torch.int32 or qweight.dim() != 2 or qweight.shape[0] * r != k:
        raise ValueError(f"qweight must be int32 [K/{r}, N] for K={k}, got "
                         f"{qweight.dtype} {tuple(qweight.shape)}")
    n = qweight.shape[1]
    if k % group_size or group_size % r or group_size > 1024:
        raise ValueError(f"group size {group_size} must divide K={k}, hold "
                         f"whole {bits}-bit words and be at most 1024")
    for name, t in (("scales", scales), ("mins", mins)):
        if t.dtype != torch.float32 or tuple(t.shape) != (k // group_size, n):
            raise ValueError(f"{name} must be float32 [{k // group_size}, {n}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    return m, k, n


def wgmma_takes(k: int, group_size: int) -> bool:
    """The wgmma variant issues a 128-row stage's products without a branch
    and folds groups at stage ends: K and the group a multiple of 128."""
    return k % _STAGE_K == 0 and group_size % _STAGE_K == 0


def mma_plan(m: int, k: int, n: int, group_size: int, bits: int) -> tuple[int, int, int]:
    """(x rows per block, K splits, K rows per split) of B3's decode variant:
    8, 16 or 32 x rows a block (tiled over M beyond 32); no split once the
    tiles fill a wave; f32 partials (written and read, 8*m*N bytes a split)
    at most the weight's bytes."""
    unit = math.lcm(group_size, _STAGE_K)
    rows = 8 if m <= 8 else 16 if m <= 16 else 32
    tiles = _cdiv(m, rows) * (n // 128)
    cap = 1 if tiles >= _SMS else min(_MAX_SPLITS, max(1, k * bits // (64 * m)))
    splits, per = _split(_cdiv(k, unit), tiles, cap, _DEC_TARGET_BLOCKS)
    return rows, splits, per * unit


def wgmma_plan(m: int, k: int, n: int, group_size: int) -> tuple[int, int, int]:
    """(rows per block, K splits, K rows per split) of B3's wgmma variant:
    64-row tiles up to 64 rows, 128 beyond; a split whole groups and at
    least 4 stages."""
    unit = group_size
    rows = 64 if m <= 64 else 128
    cap = min(_MAX_SPLITS, max(1, (k // _STAGE_K) // 4))
    splits, per = _split(_cdiv(k, unit), _cdiv(m, rows) * (n // 128), cap, _TC_TARGET_BLOCKS)
    return rows, splits, per * unit


@functools.lru_cache(maxsize=None)
def b3_plan(m: int, k: int, n: int, group_size: int, bits: int = 8
            ) -> tuple[str, int, int, int]:
    """(variant, rows per block, K splits, K rows per split) of B3:
    ``wgmma`` above DEC_MAX_ROWS rows for shapes it takes, else ``mma``, the
    swapped-operand decode variant (tiled over M). A split is a whole number
    of lcm(group, 128) K rows: a 128-row stage never holds two splits, a
    group never spans two."""
    if m > DEC_MAX_ROWS and wgmma_takes(k, group_size):
        return ("wgmma",) + wgmma_plan(m, k, n, group_size)
    return ("mma",) + mma_plan(m, k, n, group_size, bits)


def qmm_int8(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
             mins: torch.Tensor, *, bits: int, group_size: int,
             device: DeviceLike = None) -> torch.Tensor:
    """``x [M, K] @ dequant(qweight, scales, mins) [K, N] → [M, N]`` in x's
    dtype through per-row int8 activations. Signed 4/8-bit weights only.
    Runs on ``device`` (default ``cuda``); every tensor must lie there."""
    dev = resolve_device(device)
    check_on(dev, x, qweight, scales, mins)
    m, k, n = _check(x, qweight, scales, mins, bits, group_size)
    if dev.type == "cpu":
        return qmm_int8_reference(x, qweight, scales, mins, bits=bits,
                                  group_size=group_size)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"B3 takes bfloat16, float32 or float16 activations, got {x.dtype}")
    if n % 128 or k % 64 or group_size % 16:
        raise ValueError(f"B3 needs N % 128 == 0, K % 64 == 0 and a group size "
                         f"that is a multiple of 16 (N={n} K={k} gs={group_size})")
    if not (qweight.is_contiguous() and scales.is_contiguous()
            and mins.is_contiguous()):
        raise ValueError("B3 needs contiguous weight planes")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    xq, xs, gsum = quantize_activations(x, group_size=group_size, device=dev)
    variant, rows, splits, per = b3_plan(m, k, n, group_size, bits)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    err = _lib().qmm_int8_launch(
        xq.data_ptr(), xs.data_ptr(), gsum.data_ptr(), qweight.data_ptr(),
        scales.data_ptr(), mins.data_ptr(), None if part is None else part.data_ptr(),
        y.data_ptr(), m, k, n, bits, group_size, int(variant == "wgmma"), rows, splits, per, _DTYPE_CODE[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"qmm_int8 kernel launch failed with CUDA error {err} "
                           f"(M={m} K={k} N={n} bits={bits} gs={group_size})")
    qmm_int8.launches += 1
    return y


qmm_int8.launches = 0
