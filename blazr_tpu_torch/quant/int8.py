"""Kernel B3 (int8-activation quantized matmul, W4A8 / W8A8): wrapper,
launch count and plain version.

The kernel itself is ``csrc/qmm_int8.cu`` (CUDA C++ for sm_90a, int8 tensor
cores); it replaces ``blazr_tpu/quant/pallas/int_matmul.py::_qmm_int8_kernel``
behind the entry ``quant_matmul_int8mxu``. Its note says what bounds it on
the H100 and how its design answers that.

The per-row activation quant stays in plain PyTorch, as the JAX package keeps
it outside its ``pallas_call``:

    xs = max(max|x[i]|, 1e-30) / 127,  xq = clip(round(x / xs), -127, 127)

(``torch.round`` rounds half to even, like ``jnp.round``). Then

    y[i,n] = xs[i] · Σ_g ( s[g,n] · Σ_{k∈g} xq[i,k]·q[k,n] − (Σ_{k∈g} xq[i,k]) · m[g,n] )

with exact int32 inner sums; the offset term uses the group sums of the
quantized activations. ``qmm_int8`` launches the kernel for CUDA tensors and
runs ``qmm_int8_reference`` for CPU tensors. Nothing falls back: a CUDA
tensor the kernel does not take, or a failed launch, raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device
from .qtensor import unpack

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# Aim for at least two blocks per SM of the H100 (132 SMs) before the K
# loop is split across blocks; at most this many splits.
_TARGET_BLOCKS = 264
_MAX_SPLITS = 16


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("qmm_int8")
    if lib.qmm_int8_launch.argtypes is None:
        lib.qmm_int8_launch.argtypes = ([ctypes.c_void_p] * 7
                                        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
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


def _splits(m: int, k: int, n: int, group_size: int) -> tuple[int, int]:
    """(splits, K rows per split): split K across blocks when the (m, n)
    tiles alone give fewer than _TARGET_BLOCKS blocks. A split is a whole
    number of units of lcm(group, 64) rows (64: the kernel's stage depth)."""
    bm = 16 if m <= 16 else 64
    tiles = -(-m // bm) * (n // 128)
    unit = math.lcm(group_size, 64)
    units = k // unit
    splits = 1
    if tiles < _TARGET_BLOCKS:
        splits = min(units, _MAX_SPLITS, -(-_TARGET_BLOCKS // tiles))
    per = -(-units // splits) * unit
    return -(-k // per), per


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
        raise TypeError(f"B3 takes bfloat16 or float32 activations, got {x.dtype}")
    if n % 128 or k % 64 or group_size % 16:
        raise ValueError(f"B3 needs N % 128 == 0, K % 64 == 0 and a group size "
                         f"that is a multiple of 16 (N={n} K={k} gs={group_size})")
    if not (qweight.is_contiguous() and scales.is_contiguous()
            and mins.is_contiguous()):
        raise ValueError("B3 needs contiguous weight planes")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    xq, xs = quantize_rows(x)
    splits, per = _splits(m, k, n, group_size)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else y)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().qmm_int8_launch(
        xq.data_ptr(), xs.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
        mins.data_ptr(), part.data_ptr(), y.data_ptr(), m, k, n, bits,
        group_size, splits, per, _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"qmm_int8 kernel launch failed with CUDA error {err} "
                           f"(M={m} K={k} N={n} bits={bits} gs={group_size})")
    qmm_int8.launches += 1
    return y


qmm_int8.launches = 0
