"""Canonical quantized-weight representation (PyTorch).

Counterpart of ``blazr_tpu/quant/qtensor.py`` with the same layout, so the
two packages hold bit-identical weights:

    w[k, n] = q[k, n] * scales[k // gs, n] - mins[k // gs, n]

  * ``qweight``: [K*bits/32, N] 32-bit words, **K-packed**: word row ``w``
    holds logical rows ``w*r + j`` (``r = 32/bits``) in bits
    ``[bits*j, bits*j+bits)``. PyTorch has no right shift for ``uint32`` on
    the CPU, so the words are held as an ``int32`` view of the same bits and
    every shift is followed by a mask.
  * ``scales``/``mins``: float32 [K/gs, N].
  * ``perm``: optional int32 [K] activation permutation (GPTQ desc-act
    checkpoints are sorted group-contiguous at load; the gather moves to
    the activation side).

Format mapping (exact — same integers, same affine):
  AWQ INT4  → bits=4, m = s·z;  GPTQ INT4 → bits=4, m = s·(z+1).
  GGUF Q8_0 / Q8_K                    → bits=8 (signed), m = 0
  GGUF Q4_0/Q4_1/Q4_K/Q5_K/Q2_K/Q3_K  → bits∈{2,4,8}, per-sub-block affine
  GGUF Q6_K / IQ4_NL / IQ4_XS / TQ2_0 → bits=8/8/8/2
Unsigned 4-bit payloads are sign-biased at load (``_finish``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..formats.ggml_quants import (KVALUES_IQ4NL, QK_K, _blocks, _f16, _k4_scale_min,
                                   _q3k_unpack_scales)
from ..formats.gguf import GgmlType
from ..utils.device import DeviceLike, resolve_device

# AWQ nibble order: column 8w+j uses shift AWQ_SHIFTS[j]
# (reference src/loader/safetensors/awq.rs:29-32).
AWQ_SHIFTS = np.array([0, 16, 4, 20, 8, 24, 12, 28], dtype=np.uint32)


@dataclasses.dataclass
class QuantTensor:
    """Grouped-affine integer weight. Logical shape [K, N] (in, out)."""

    qweight: torch.Tensor                 # int32 view of u32 [K*bits/32, N]
    scales: torch.Tensor                  # f32 [K/gs, N]
    mins: torch.Tensor                    # f32 [K/gs, N]
    perm: Optional[torch.Tensor]          # int32 [K] or None
    bits: int
    group_size: int
    signed: bool
    in_features: int
    out_features: int
    fmt: str
    # Serve-time compute mode: route matmuls through kernel B3 (dynamic
    # per-row int8 activation quant, W4A8/W8A8). Set by mark_act_quant /
    # widen_to_int8, never by the format decoders.
    act_quant: bool = False
    # Fewest matmul rows for the B3 route: 0 = always (w4a8/w8a8);
    # _PREFILL_A8_MIN_M = prefill-shaped matmuls only (w4a8-prefill).
    act_quant_min_m: int = 0

    @property
    def device(self) -> torch.device:
        return self.qweight.device


def _pack_k(q: np.ndarray, bits: int) -> np.ndarray:
    """Pack int rows along K into uint32 words: [K, N] → [K*bits/32, N]."""
    k, n = q.shape
    r = 32 // bits
    if k % r:
        raise ValueError(f"K={k} is not a multiple of {r} rows per word")
    q = q.astype(np.uint32) & ((1 << bits) - 1)
    q = q.reshape(k // r, r, n)
    words = np.zeros((k // r, n), dtype=np.uint32)
    for j in range(r):
        words |= q[:, j, :] << np.uint32(bits * j)
    return words


def unpack_k(words: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    """Inverse of :func:`_pack_k` (numpy reference / test helper). Accepts
    uint32 words or their int32 view."""
    words = np.asarray(words).view(np.uint32)
    kw, n = words.shape
    r = 32 // bits
    out = np.empty((kw, r, n), dtype=np.int32)
    mask = (1 << bits) - 1
    for j in range(r):
        vals = (words >> np.uint32(bits * j)) & mask
        vals = vals.astype(np.int32)
        if signed:
            vals = np.where(vals >= (1 << (bits - 1)), vals - (1 << bits), vals)
        out[:, j, :] = vals
    return out.reshape(kw * r, n)


def _pack_words(q: torch.Tensor, bits: int) -> torch.Tensor:
    """:func:`_pack_k` in vectorized torch integer ops, bit for bit, on q's
    device: int rows [K, N] → the int32 view of the uint32 words
    [K*bits/32, N] (the loaders' path; ``_pack_k`` is its reference)."""
    k, n = q.shape
    r = 32 // bits
    if k % r:
        raise ValueError(f"K={k} is not a multiple of {r} rows per word")
    q = (q.to(torch.int64) & ((1 << bits) - 1)).reshape(k // r, r, n)
    words = torch.zeros((k // r, n), dtype=torch.int64, device=q.device)
    for j in range(r):
        words |= q[:, j, :] << (bits * j)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def words_to_torch(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words → the int32 tensor view the port holds."""
    arr = np.ascontiguousarray(np.asarray(words).view(np.int32))
    return torch.from_numpy(arr.copy()).to(device)


def _finish(q_int, scales: np.ndarray, mins: np.ndarray, *,
            bits: int, group_size: int, signed: bool, fmt: str,
            perm: Optional[np.ndarray] = None,
            device: DeviceLike = None, work_device: DeviceLike = None) -> QuantTensor:
    """Integer rows ``q_int`` [K, N] (numpy, or a torch tensor on
    ``work_device``) and group planes → a canonical QuantTensor on
    ``device``; the words are packed on ``work_device`` (default
    ``device``), the card when a loader loads onto it."""
    dev = resolve_device(device)
    work = dev if work_device is None else resolve_device(work_device)
    q = (q_int if isinstance(q_int, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(q_int))).to(work)
    k, n = q.shape
    if scales.shape != (k // group_size, n):
        raise ValueError(f"scales {scales.shape} do not match K={k} N={n} "
                         f"gs={group_size}")
    if bits == 4 and not signed:
        # Sign-bias the nibbles (q' = q - 8 as int4 two's complement, i.e.
        # n' = n XOR 8); the +8 offset folds into the affine:
        # w = q·s − m = (q' + 8)·s − m = q'·s − (m − 8·s).
        q = q.to(torch.uint8) ^ 8
        mins = mins - 8.0 * scales
        signed = True
    return QuantTensor(
        qweight=_pack_words(q, bits).to(dev),
        scales=torch.as_tensor(np.asarray(scales, np.float32)).to(dev),
        mins=torch.as_tensor(np.asarray(mins, np.float32)).to(dev),
        perm=None if perm is None else torch.as_tensor(
            np.asarray(perm, np.int32)).to(dev),
        bits=bits, group_size=group_size, signed=signed,
        in_features=k, out_features=n, fmt=fmt,
    )


def from_awq(qweight_u32: np.ndarray, scales: np.ndarray,
             qzeros_u32: np.ndarray, group_size: int, *,
             device: DeviceLike = None, work_device: DeviceLike = None) -> QuantTensor:
    """AWQ triplet (HF-AWQ checkpoint layout) → canonical, on ``device``.

      qweight [K, N/8] uint32 (AWQ interleaved nibbles along N)
      scales  [K/gs, N] (f16/f32)
      qzeros  [K/gs, N/8] uint32 (same interleave)

    The words are repacked on ``work_device`` (default ``device``): the
    loader passes the card, whose integer ops are the fast place for it."""
    qweight_u32 = np.asarray(qweight_u32).view(np.uint32)
    qzeros_u32 = np.asarray(qzeros_u32).view(np.uint32)
    k, n8 = qweight_u32.shape
    n = n8 * 8
    g = qzeros_u32.shape[0]
    z = np.empty((g, n), dtype=np.float32)
    for j in range(8):
        z[:, j::8] = ((qzeros_u32 >> AWQ_SHIFTS[j]) & 0xF).astype(np.float32)
    s = np.asarray(scales).astype(np.float32)
    # The nibbles unpacked on the work device: the low nibble of an
    # arithmetic shift is the word's bits [s, s+4).
    work = resolve_device(device) if work_device is None else resolve_device(work_device)
    w = torch.from_numpy(np.array(qweight_u32.view(np.int32))).to(work)
    nib = (w[:, :, None] >> torch.from_numpy(AWQ_SHIFTS.astype(np.int32)).to(work)) & 0xF
    return _finish(nib.reshape(k, n), s, s * z, bits=4, group_size=group_size, signed=False,
                   fmt="awq", device=device, work_device=work_device)


def from_gptq(qweight_u32: np.ndarray, scales: np.ndarray,
              qzeros_u32: np.ndarray, g_idx: Optional[np.ndarray],
              group_size: int, *, v2: bool = False,
              device: DeviceLike = None) -> QuantTensor:
    """GPTQ group → canonical.

      qweight [K/8, N] uint32 (sequential 4-bit, K-packed), qzeros
      [K/gs, N/8] uint32 (stored zero-1 in v1), scales [K/gs, N],
      g_idx [K] optional.

    desc-act checkpoints (non-trivial g_idx) are stable-sorted by group so
    groups are contiguous; the activation side carries the permutation.
    """
    qweight_u32 = np.asarray(qweight_u32).view(np.uint32)
    qzeros_u32 = np.asarray(qzeros_u32).view(np.uint32)
    k8, n = qweight_u32.shape
    k = k8 * 8
    q = unpack_k(qweight_u32, 4, signed=False).astype(np.uint8)   # [K, N]
    g = qzeros_u32.shape[0]
    z = np.empty((g, n), dtype=np.float32)
    for j in range(8):
        z[:, j::8] = ((qzeros_u32 >> np.uint32(4 * j)) & 0xF).astype(np.float32)
    if not v2:
        z = z + 1.0                       # classic GPTQ stores zero-1
    s = np.asarray(scales).astype(np.float32)
    perm = None
    if g_idx is not None:
        g_idx = np.asarray(g_idx, dtype=np.int64)
        if not np.array_equal(g_idx, np.arange(k) // group_size):
            perm = np.argsort(g_idx, kind="stable").astype(np.int32)
            q = q[perm]
    return _finish(q, s, s * z, bits=4, group_size=group_size, signed=False,
                   fmt="gptq", perm=perm, device=device)


# ---------------------------------------------------------------------------
# GGUF / ggml block formats (the JAX package's qtensor.py:218-398)
# ---------------------------------------------------------------------------

def _ggml_to_int_grouped(raw, gt: GgmlType, n_rows: int, k: int):
    """Extract (q_int [rows, K], scales [rows, K/gs], mins, gs, bits, signed)
    from raw ggml blocks (blocks run along K within each row)."""
    if gt == GgmlType.Q8_0:
        b = _blocks(raw, 34)
        d = _f16(b[:, :2].copy())
        q = b[:, 2:].view(np.int8)
        return (q.reshape(n_rows, k), d.reshape(n_rows, k // 32),
                np.zeros((n_rows, k // 32), np.float32), 32, 8, True)
    if gt == GgmlType.Q4_0:
        b = _blocks(raw, 18)
        d = _f16(b[:, :2].copy())
        qs = b[:, 2:]
        q = np.concatenate([qs & 0x0F, qs >> 4], axis=1)
        return (q.reshape(n_rows, k), d.reshape(n_rows, k // 32),
                (8.0 * d).reshape(n_rows, k // 32), 32, 4, False)
    if gt == GgmlType.Q4_1:
        b = _blocks(raw, 20)
        d = _f16(b[:, :2].copy())
        m = _f16(b[:, 2:4].copy())
        qs = b[:, 4:]
        q = np.concatenate([qs & 0x0F, qs >> 4], axis=1)
        return (q.reshape(n_rows, k), d.reshape(n_rows, k // 32),
                (-m).reshape(n_rows, k // 32), 32, 4, False)
    if gt == GgmlType.Q4_K:
        b = _blocks(raw, 144)
        nb = b.shape[0]
        d = _f16(b[:, :2].copy())[:, 0]
        dmin = _f16(b[:, 2:4].copy())[:, 0]
        sc, mn = _k4_scale_min(b[:, 4:16])                # [nb, 8]
        qs = b[:, 16:]
        q = np.empty((nb, QK_K), dtype=np.uint8)
        for j in range(4):
            qrow = qs[:, j * 32 : j * 32 + 32]
            q[:, j * 64 : j * 64 + 32] = qrow & 0x0F
            q[:, j * 64 + 32 : j * 64 + 64] = qrow >> 4
        scales = (d[:, None] * sc).astype(np.float32)      # per 32-elem group
        mins = (dmin[:, None] * mn).astype(np.float32)
        return (q.reshape(n_rows, k), scales.reshape(n_rows, k // 32),
                mins.reshape(n_rows, k // 32), 32, 4, False)
    if gt == GgmlType.Q5_K:
        b = _blocks(raw, 176)
        nb = b.shape[0]
        d = _f16(b[:, :2].copy())[:, 0]
        dmin = _f16(b[:, 2:4].copy())[:, 0]
        sc, mn = _k4_scale_min(b[:, 4:16])
        qh = b[:, 16:48]
        ql = b[:, 48:]
        q = np.empty((nb, QK_K), dtype=np.uint8)
        for j in range(4):
            qrow = ql[:, j * 32 : j * 32 + 32]
            u1 = 1 << (2 * j)
            u2 = 2 << (2 * j)
            q[:, j * 64 : j * 64 + 32] = (qrow & 0x0F) + np.where((qh & u1) != 0, 16, 0).astype(np.uint8)
            q[:, j * 64 + 32 : j * 64 + 64] = (qrow >> 4) + np.where((qh & u2) != 0, 16, 0).astype(np.uint8)
        scales = (d[:, None] * sc).astype(np.float32)
        mins = (dmin[:, None] * mn).astype(np.float32)
        return (q.reshape(n_rows, k), scales.reshape(n_rows, k // 32),
                mins.reshape(n_rows, k // 32), 32, 8, True)
    if gt == GgmlType.Q6_K:
        b = _blocks(raw, 210)
        nb = b.shape[0]
        ql = b[:, :128]
        qh = b[:, 128:192]
        sc6 = b[:, 192:208].view(np.int8).astype(np.float32)
        d = _f16(b[:, 208:210].copy())[:, 0]
        q = np.empty((nb, QK_K), dtype=np.int8)
        for chunk in range(2):
            qlc = ql[:, chunk * 64 : chunk * 64 + 64]
            qhc = qh[:, chunk * 32 : chunk * 32 + 32]
            base = chunk * 128
            q[:, base : base + 32] = (((qlc[:, :32] & 0x0F) | (((qhc >> 0) & 3) << 4)).astype(np.int32) - 32).astype(np.int8)
            q[:, base + 32 : base + 64] = (((qlc[:, 32:] & 0x0F) | (((qhc >> 2) & 3) << 4)).astype(np.int32) - 32).astype(np.int8)
            q[:, base + 64 : base + 96] = (((qlc[:, :32] >> 4) | (((qhc >> 4) & 3) << 4)).astype(np.int32) - 32).astype(np.int8)
            q[:, base + 96 : base + 128] = (((qlc[:, 32:] >> 4) | (((qhc >> 6) & 3) << 4)).astype(np.int32) - 32).astype(np.int8)
        scales = (d[:, None] * sc6).astype(np.float32)     # per 16-elem group
        return (q.reshape(n_rows, k), scales.reshape(n_rows, k // 16),
                np.zeros((n_rows, k // 16), np.float32), 16, 8, True)
    if gt == GgmlType.Q2_K:
        b = _blocks(raw, 84)
        nb = b.shape[0]
        sc_field = b[:, :16]
        qs = b[:, 16:80]
        d = _f16(b[:, 80:82].copy())[:, 0]
        dmin = _f16(b[:, 82:84].copy())[:, 0]
        q = np.empty((nb, QK_K), dtype=np.uint8)
        for chunk in range(2):
            qchunk = qs[:, chunk * 32 : chunk * 32 + 32]
            for j in range(4):
                q[:, chunk * 128 + j * 32 : chunk * 128 + j * 32 + 32] = (qchunk >> (2 * j)) & 3
        scales = (d[:, None] * (sc_field & 0x0F).astype(np.float32))   # per 16
        mins = (dmin[:, None] * (sc_field >> 4).astype(np.float32))
        return (q.reshape(n_rows, k), scales.reshape(n_rows, k // 16),
                mins.reshape(n_rows, k // 16), 16, 2, False)
    if gt == GgmlType.Q3_K:
        b = _blocks(raw, 110)
        nb = b.shape[0]
        hmask = b[:, :32]
        qs = b[:, 32:96]
        sc16 = _q3k_unpack_scales(np.ascontiguousarray(b[:, 96:108])).astype(np.float32)
        d = _f16(b[:, 108:110].copy())[:, 0]
        q = np.empty((nb, QK_K), dtype=np.uint8)   # values 0..7 (bias 4)
        for chunk in range(2):
            qchunk = qs[:, chunk * 32 : chunk * 32 + 32]
            for j in range(4):
                mbit = 1 << (chunk * 4 + j)
                lo = (qchunk >> (2 * j)) & 3
                hi = np.where((hmask & mbit) != 0, 4, 0).astype(np.uint8)
                q[:, chunk * 128 + j * 32 : chunk * 128 + j * 32 + 32] = lo + hi
        scales = (d[:, None] * (sc16 - 32.0))             # per 16
        mins = 4.0 * scales                                # shift bias: w = s*q' - 4s
        return (q.reshape(n_rows, k), scales.reshape(n_rows, k // 16).astype(np.float32),
                mins.reshape(n_rows, k // 16).astype(np.float32), 16, 4, False)
    if gt == GgmlType.IQ4_NL:
        b = _blocks(raw, 18)
        d = _f16(b[:, :2].copy())
        qs = b[:, 2:]
        idx = np.concatenate([qs & 0x0F, qs >> 4], axis=1)
        q = KVALUES_IQ4NL.astype(np.int8)[idx]
        return (q.reshape(n_rows, k), d.reshape(n_rows, k // 32),
                np.zeros((n_rows, k // 32), np.float32), 32, 8, True)
    if gt == GgmlType.IQ4_XS:
        b = _blocks(raw, 136)
        nb = b.shape[0]
        d = _f16(b[:, :2].copy())[:, 0]
        scales_h = b[:, 2:4].copy().view(np.uint16)[:, 0].astype(np.uint32)
        scales_l = b[:, 4:8]
        qs = b[:, 8:]
        q = np.empty((nb, QK_K), dtype=np.int8)
        scales = np.empty((nb, 8), dtype=np.float32)
        for ib in range(8):
            ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F).astype(np.uint32) | (
                ((scales_h >> (2 * ib)) & 3) << 4)
            scales[:, ib] = d * (ls.astype(np.float32) - 32.0)
            qrow = qs[:, ib * 16 : ib * 16 + 16]
            q[:, ib * 32 : ib * 32 + 16] = KVALUES_IQ4NL.astype(np.int8)[qrow & 0x0F]
            q[:, ib * 32 + 16 : ib * 32 + 32] = KVALUES_IQ4NL.astype(np.int8)[qrow >> 4]
        return (q.reshape(n_rows, k), scales.reshape(n_rows, k // 32),
                np.zeros((n_rows, k // 32), np.float32), 32, 8, True)
    if gt == GgmlType.TQ2_0:
        b = _blocks(raw, 66)
        nb = b.shape[0]
        qs = b[:, :64]
        d = _f16(b[:, 64:66].copy())[:, 0]
        q = np.empty((nb, QK_K), dtype=np.uint8)
        for j in range(0, 64, 32):
            for l in range(4):
                q[:, j * 4 + l * 32 : j * 4 + l * 32 + 32] = (qs[:, j : j + 32] >> (2 * l)) & 3
        scales = np.repeat(d[:, None], QK_K // 256, axis=1).astype(np.float32)
        return (q.reshape(n_rows, k), scales.reshape(n_rows, k // 256),
                scales.reshape(n_rows, k // 256).copy(), 256, 2, False)
    if gt == GgmlType.Q8_K:
        b = _blocks(raw, 292)
        d = b[:, :4].copy().view(np.float32)
        q = b[:, 4:260].view(np.int8)
        return (q.reshape(n_rows, k), d.reshape(n_rows, k // 256),
                np.zeros((n_rows, k // 256), np.float32), 256, 8, True)
    raise NotImplementedError(f"no canonical mapping for {gt.name}")


CANONICAL_GGML_TYPES = {
    GgmlType.Q8_0, GgmlType.Q4_0, GgmlType.Q4_1, GgmlType.Q4_K, GgmlType.Q5_K,
    GgmlType.Q6_K, GgmlType.Q2_K, GgmlType.Q3_K, GgmlType.IQ4_NL,
    GgmlType.IQ4_XS, GgmlType.TQ2_0, GgmlType.Q8_K,
}


def from_ggml(raw: bytes | memoryview, gt: GgmlType, shape: tuple[int, int], *,
              device: DeviceLike = None, work_device: DeviceLike = None) -> QuantTensor:
    """GGUF tensor blocks → canonical. ``shape`` is the GGUF logical
    [N, K] (out, in); blocks run along K within each output row. The words
    and planes are bit-exact with the JAX package's ``from_ggml``; the rows
    are transposed and packed on ``work_device`` (default ``device``)."""
    n, k = shape
    q_nk, s_nk, m_nk, gs, bits, signed = _ggml_to_int_grouped(raw, gt, n, k)
    work = resolve_device(device) if work_device is None else resolve_device(work_device)
    # Transpose to the [K, N] convention.
    q = torch.from_numpy(np.ascontiguousarray(q_nk)).to(work).t()
    return _finish(
        q, np.ascontiguousarray(s_nk.T), np.ascontiguousarray(m_nk.T),
        bits=bits, group_size=gs, signed=signed, fmt=f"ggml_{gt.name.lower()}",
        device=device, work_device=work_device,
    )


# ---------------------------------------------------------------------------
# Dequantization (the plain path the kernels are held against)
# ---------------------------------------------------------------------------

def unpack(qweight: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """K-packed int32 words [K/r, N] → int32 values [K, N] (signed payloads
    de-biased). Shift then mask, so the arithmetic right shift of the int32
    view never leaks sign bits."""
    r = 32 // bits
    kw, n = qweight.shape
    shifts = torch.arange(r, dtype=torch.int32, device=qweight.device) * bits
    vals = (qweight[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    if signed:
        half = 1 << (bits - 1)
        vals = torch.where(vals >= half, vals - (1 << bits), vals)
    return vals.reshape(kw * r, n)


def dequantize_planes(qweight: torch.Tensor, scales: torch.Tensor,
                      mins: torch.Tensor, bits: int, signed: bool,
                      group_size: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense [K, N] weight ``q·s − m`` in float32, cast to ``dtype``."""
    q = unpack(qweight, bits, signed).to(torch.float32)
    s = scales.to(torch.float32).repeat_interleave(group_size, dim=0)
    m = mins.to(torch.float32).repeat_interleave(group_size, dim=0)
    return (q * s - m).to(dtype)


def dequantize(qt: QuantTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense [K, N] weight in the *sorted* (physical) row order."""
    return dequantize_planes(qt.qweight, qt.scales, qt.mins, qt.bits,
                             qt.signed, qt.group_size, dtype)


def dequantize_np(qt: QuantTensor) -> np.ndarray:
    """Host-side numpy dequant to f32 [K, N] (test helper)."""
    q = unpack_k(qt.qweight.cpu().numpy(), qt.bits, qt.signed).astype(np.float32)
    s = np.repeat(qt.scales.cpu().numpy().astype(np.float32), qt.group_size, 0)
    m = np.repeat(qt.mins.cpu().numpy().astype(np.float32), qt.group_size, 0)
    return q * s - m


# ---------------------------------------------------------------------------
# Stacked expert weights (MoE): a QuantTensor with a leading [E] axis
# ---------------------------------------------------------------------------

def stack_quant(qts: list[QuantTensor]) -> QuantTensor:
    """Stack per-expert QuantTensors into one whose planes carry a leading
    expert axis: qweight [E, K*bits/32, N], scales and mins [E, K/gs, N].
    The logical per-expert shape stays (in_features, out_features);
    :func:`expert_slice` takes an expert back out."""
    first = qts[0]
    for q in qts[1:]:
        if (q.in_features, q.out_features, q.bits, q.group_size, q.signed) != (
                first.in_features, first.out_features, first.bits, first.group_size,
                first.signed):
            raise ValueError("expert weights of one projection differ in shape or format")
    if any(q.perm is not None for q in qts):
        raise ValueError("desc-act (perm) expert weights cannot be stacked")
    return dataclasses.replace(
        first, qweight=torch.stack([q.qweight for q in qts]),
        scales=torch.stack([q.scales for q in qts]),
        mins=torch.stack([q.mins for q in qts]), perm=None)


def is_stacked(qt) -> bool:
    return isinstance(qt, QuantTensor) and qt.qweight.dim() == 3


def expert_slice(w, e: int):
    """Expert ``e`` of a stacked expert weight, dense [E, K, N] or a stacked
    QuantTensor: views, no copy."""
    if isinstance(w, QuantTensor):
        return dataclasses.replace(w, qweight=w.qweight[e], scales=w.scales[e],
                                   mins=w.mins[e], perm=None)
    return w[e]


def _dequantize_host_into(qweight: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor,
                          bits: int, signed: bool, group_size: int,
                          out: torch.Tensor) -> None:
    """``dequantize_planes``'s values written into the f32 [K, N] ``out``,
    on the CPU in column blocks: each block's integer temporary is reused
    and stays in cache, and nothing else is allocated (a Mixtral
    projection several times faster than the whole-tensor form)."""
    r = 32 // bits
    kw, n = qweight.shape
    rows = out.view(kw, r, n)
    groups = out.view(-1, group_size, n)
    width = max(256, (1 << 20) // kw)          # ~4 MB of int32 a block
    tmp = torch.empty((kw, min(width, n)), dtype=torch.int32)
    for c0 in range(0, n, width):
        c1 = min(n, c0 + width)
        w, t = qweight[:, c0:c1], tmp[:, :c1 - c0]
        for j in range(r):
            if signed:          # the field to the top, then an arithmetic shift down
                torch.bitwise_left_shift(w, 32 - bits * (j + 1), out=t)
                t.bitwise_right_shift_(32 - bits)
            else:
                torch.bitwise_right_shift(w, bits * j, out=t)
                t.bitwise_and_((1 << bits) - 1)
            rows[:, j, c0:c1] = t
        groups[:, :, c0:c1].mul_(scales[:, None, c0:c1]).sub_(mins[:, None, c0:c1])


def dequantize_stack_np(qt: QuantTensor, experts: Optional[list[int]] = None,
                        out: Optional[torch.Tensor] = None) -> np.ndarray:
    """Host-side dequant of a stacked expert QuantTensor → f32 [E, K, N], or
    of the ``experts`` given only → [len(experts), K, N] (the MoE offload's
    host term), written into ``out`` when given (an f32 CPU tensor of that
    shape). ``dequantize_np``'s values, computed by torch on the CPU in
    column blocks (``_dequantize_host_into``)."""
    ids = list(range(qt.qweight.shape[0]) if experts is None else experts)
    if out is None:
        out = torch.empty((len(ids), qt.in_features, qt.out_features), dtype=torch.float32)
    for i, e in enumerate(ids):
        _dequantize_host_into(qt.qweight[e].cpu(), qt.scales[e].cpu().float(),
                              qt.mins[e].cpu().float(), qt.bits, qt.signed, qt.group_size,
                              out[i])
    return out.numpy()


def widen_to_int8(qt: QuantTensor) -> QuantTensor:
    """4-bit → 8-bit storage for W8A8: the same integers, scales and mins,
    repacked 4 int8 values per K-packed word (twice the weight bytes), and
    tagged for kernel B3. An 8-bit signed tensor is only tagged."""
    if qt.bits == 8 and qt.signed:
        return qt if qt.act_quant else dataclasses.replace(qt, act_quant=True)
    if qt.bits != 4 or not qt.signed:
        raise NotImplementedError(
            f"widen_to_int8: only signed 4-bit payloads (got bits={qt.bits} "
            f"signed={qt.signed})")
    q = unpack(qt.qweight, 4, True).reshape(
        qt.in_features // 4, 4, qt.out_features)           # int32 values
    # Bytes 0-2 as unsigned fields; byte 3 signed, so the word is the int32
    # view of the u32 word with no overflow.
    lo = q[:, :3] & 0xFF
    words = lo[:, 0] + (lo[:, 1] << 8) + (lo[:, 2] << 16) + q[:, 3] * (1 << 24)
    return dataclasses.replace(qt, qweight=words.contiguous(), bits=8,
                               act_quant=True)


# Row count from which a matmul counts as prefill-shaped under
# ``w4a8-prefill`` (the JAX package's threshold, qtensor.py:465).
_PREFILL_A8_MIN_M = 256


def mark_act_quant(qt: QuantTensor, min_m: int = 0) -> QuantTensor:
    """Tag a signed 4/8-bit tensor for kernel B3 without widening it (W4A8).
    ``min_m`` restricts the route to matmuls with at least that many rows."""
    if qt.act_quant and qt.act_quant_min_m == min_m:
        return qt
    if not qt.signed or qt.bits not in (4, 8):
        raise NotImplementedError(
            f"act-quant compute: only signed 4/8-bit payloads (got "
            f"bits={qt.bits} signed={qt.signed})")
    return dataclasses.replace(qt, act_quant=True, act_quant_min_m=min_m)


def _tag(leaf: QuantTensor, mode: str) -> QuantTensor:
    # Unsigned and 2-bit leaves pass through, and so do stacked experts, as
    # in the JAX package (qtensor.py:505-511): they stay on B1.
    if not leaf.signed or leaf.bits not in (4, 8) or is_stacked(leaf):
        return leaf
    if mode == "w8a8":
        return widen_to_int8(leaf)
    if mode == "w4a8-prefill":
        return mark_act_quant(leaf, min_m=_PREFILL_A8_MIN_M)
    return mark_act_quant(leaf)


def quant_leaves(params):
    """Every QuantTensor of a param tree of dicts, lists and tuples."""
    if isinstance(params, QuantTensor):
        yield params
    elif isinstance(params, dict):
        for v in params.values():
            yield from quant_leaves(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from quant_leaves(v)


def apply_quant_compute(params, mode: Optional[str], *, inplace: bool = False):
    """Apply an ``inference.quant_compute`` mode to a param tree of dicts
    and lists.

    ``w4a8`` tags signed 4/8-bit QuantTensors for kernel B3; ``w8a8`` also
    widens 4-bit storage to int8; ``w4a8-prefill`` tags them with
    ``min_m=256`` so only prefill-shaped matmuls take B3. Unsigned and
    2-bit leaves and stacked expert weights pass through untouched. ``auto`` is ``w4a16`` on every
    device (the JAX package resolves it to ``w4a8-prefill`` on a TPU only,
    from TPU timings; ROADMAP §C), so it, ``w4a16`` and None return the
    tree as it is.

    The tree is rebuilt; with ``inplace=True`` the leaves are replaced in
    the given dicts and lists instead, one at a time, so a widened weight's
    4-bit copy is freed as soon as it is replaced."""
    if mode in (None, "auto", "w4a16"):
        return params
    if mode not in ("w4a8", "w8a8", "w4a8-prefill"):
        raise ValueError(f"unknown quant_compute mode {mode!r}")

    def walk(node):
        if isinstance(node, QuantTensor):
            return _tag(node, mode)
        if isinstance(node, dict):
            if not inplace:
                return {k: walk(v) for k, v in node.items()}
            for k in list(node):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            if not inplace:
                return [walk(v) for v in node]
            for i, v in enumerate(node):
                node[i] = walk(v)
            return node
        if isinstance(node, tuple):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
