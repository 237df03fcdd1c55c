"""GGML block-quant codecs: numpy dequantization and quantization.

Copy of ``blazr_tpu/formats/ggml_quants.py`` (the port imports nothing of
the JAX package): the load-time dequant path of GGUF checkpoints, the plain
reference the canonical ``QuantTensor`` is held against, and the encoders
that ``convert`` and the synthetic checkpoints use. Layouts follow the
public ggml block definitions (block sizes in
``blazr_tpu_torch.formats.gguf.GGML_BLOCK_INFO``). Every dequant function
takes raw little-endian block bytes and returns float32. Without
``ml_dtypes`` (absent where the port runs), BF16 widens by a 16-bit shift,
which is exact.
"""

from __future__ import annotations

import numpy as np

from .gguf import GGML_BLOCK_INFO, GgmlType

QK_K = 256

def _f16(a: np.ndarray) -> np.ndarray:
    return a.view(np.float16).astype(np.float32)


# IQ4 non-linear codebook (public kvalues_iq4nl table from ggml).
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32,
)


# ---------------------------------------------------------------------------
# Dequantization
# ---------------------------------------------------------------------------

def _blocks(raw: bytes | memoryview, block_bytes: int) -> np.ndarray:
    buf = np.frombuffer(raw, dtype=np.uint8)
    assert buf.size % block_bytes == 0, (buf.size, block_bytes)
    return buf.reshape(-1, block_bytes)


def dequant_q8_0(raw) -> np.ndarray:
    b = _blocks(raw, 34)
    d = _f16(b[:, :2].copy())[:, 0]
    q = b[:, 2:].view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)


def dequant_q8_1(raw) -> np.ndarray:
    b = _blocks(raw, 36)
    d = _f16(b[:, :2].copy())[:, 0]
    q = b[:, 4:].view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)


def dequant_q4_0(raw) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:]
    lo = (qs & 0x0F).astype(np.float32) - 8.0
    hi = (qs >> 4).astype(np.float32) - 8.0
    out = np.concatenate([lo, hi], axis=1)  # elem j ← low nibble, j+16 ← high
    return (out * d[:, None]).reshape(-1)


def dequant_q4_1(raw) -> np.ndarray:
    b = _blocks(raw, 20)
    d = _f16(b[:, :2].copy())[:, 0]
    m = _f16(b[:, 2:4].copy())[:, 0]
    qs = b[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1)
    return (out * d[:, None] + m[:, None]).reshape(-1)


def dequant_q5_0(raw) -> np.ndarray:
    b = _blocks(raw, 22)
    d = _f16(b[:, :2].copy())[:, 0]
    qh = b[:, 2:6].copy().view(np.uint32)[:, 0]
    qs = b[:, 6:]
    bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    lo = (qs & 0x0F).astype(np.int32) | (bits[:, :16] << 4).astype(np.int32)
    hi = (qs >> 4).astype(np.int32) | (bits[:, 16:] << 4).astype(np.int32)
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0
    return (out * d[:, None]).reshape(-1)


def dequant_q5_1(raw) -> np.ndarray:
    b = _blocks(raw, 24)
    d = _f16(b[:, :2].copy())[:, 0]
    m = _f16(b[:, 2:4].copy())[:, 0]
    qh = b[:, 4:8].copy().view(np.uint32)[:, 0]
    qs = b[:, 8:]
    bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    lo = (qs & 0x0F).astype(np.int32) | (bits[:, :16] << 4).astype(np.int32)
    hi = (qs >> 4).astype(np.int32) | (bits[:, 16:] << 4).astype(np.int32)
    out = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (out * d[:, None] + m[:, None]).reshape(-1)


def dequant_q2_k(raw) -> np.ndarray:
    b = _blocks(raw, 84)
    scales = b[:, :16]                       # 16 × (scale | min<<4)
    qs = b[:, 16:80]                         # 64 bytes of 2-bit values
    d = _f16(b[:, 80:82].copy())[:, 0]
    dmin = _f16(b[:, 82:84].copy())[:, 0]

    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    # element e: chunk = e//128, j = (e%128)//32, l = e%32
    # q byte = qs[chunk*32 + l], shift 2*j; scale idx = chunk*8 + 2*j + (l>=16)
    for chunk in range(2):
        qchunk = qs[:, chunk * 32 : chunk * 32 + 32]
        for j in range(4):
            q = ((qchunk >> (2 * j)) & 3).astype(np.float32)   # [nb, 32]
            for half in range(2):
                sc = scales[:, chunk * 8 + 2 * j + half]
                dl = d * (sc & 0x0F).astype(np.float32)
                ml = dmin * (sc >> 4).astype(np.float32)
                sl = slice(half * 16, half * 16 + 16)
                out[:, chunk * 128 + j * 32 + half * 16 : chunk * 128 + j * 32 + half * 16 + 16] = (
                    q[:, sl] * dl[:, None] - ml[:, None]
                )
    return out.reshape(-1)


def _q3k_unpack_scales(scales12: np.ndarray) -> np.ndarray:
    """Unpack q3_K's 12-byte scale field into 16 signed 6-bit scales."""
    a = scales12[:, :4].copy().view(np.uint32)[:, 0]
    bb = scales12[:, 4:8].copy().view(np.uint32)[:, 0]
    c = scales12[:, 8:12].copy().view(np.uint32)[:, 0]
    kmask1 = np.uint32(0x03030303)
    kmask2 = np.uint32(0x0F0F0F0F)
    aux0 = (a & kmask2) | (((c >> np.uint32(0)) & kmask1) << np.uint32(4))
    aux1 = (bb & kmask2) | (((c >> np.uint32(2)) & kmask1) << np.uint32(4))
    aux2 = ((a >> np.uint32(4)) & kmask2) | (((c >> np.uint32(4)) & kmask1) << np.uint32(4))
    aux3 = ((bb >> np.uint32(4)) & kmask2) | (((c >> np.uint32(6)) & kmask1) << np.uint32(4))
    packed = np.stack([aux0, aux1, aux2, aux3], axis=1)  # [nb, 4] u32
    return packed.view(np.uint8).reshape(-1, 16).view(np.int8).astype(np.int32)


def dequant_q3_k(raw) -> np.ndarray:
    b = _blocks(raw, 110)
    hmask = b[:, :32]
    qs = b[:, 32:96]
    scales = _q3k_unpack_scales(np.ascontiguousarray(b[:, 96:108]))  # [nb,16]
    d = _f16(b[:, 108:110].copy())[:, 0]

    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    for chunk in range(2):
        qchunk = qs[:, chunk * 32 : chunk * 32 + 32]
        for j in range(4):
            mbit = 1 << (chunk * 4 + j)
            q = ((qchunk >> (2 * j)) & 3).astype(np.int32)
            hi = np.where((hmask & mbit) != 0, 0, 4)
            val = (q - hi).astype(np.float32)
            for half in range(2):
                sc = scales[:, chunk * 8 + 2 * j + half]
                dl = d * (sc - 32).astype(np.float32)
                sl = slice(half * 16, half * 16 + 16)
                base = chunk * 128 + j * 32 + half * 16
                out[:, base : base + 16] = val[:, sl] * dl[:, None]
    return out.reshape(-1)


def _k4_scale_min(scales12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the q4_K/q5_K 12-byte scale field → 8 (scale, min) pairs."""
    q = scales12.astype(np.uint8)
    sc = np.empty((q.shape[0], 8), dtype=np.float32)
    mn = np.empty((q.shape[0], 8), dtype=np.float32)
    for j in range(8):
        if j < 4:
            sc[:, j] = (q[:, j] & 63).astype(np.float32)
            mn[:, j] = (q[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((q[:, j + 4] & 0x0F) | ((q[:, j - 4] >> 6) << 4)).astype(np.float32)
            mn[:, j] = ((q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def dequant_q4_k(raw) -> np.ndarray:
    b = _blocks(raw, 144)
    d = _f16(b[:, :2].copy())[:, 0]
    dmin = _f16(b[:, 2:4].copy())[:, 0]
    sc, mn = _k4_scale_min(b[:, 4:16])
    qs = b[:, 16:]                            # 128 bytes

    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    for j in range(4):                        # 64-elem super-rows
        qrow = qs[:, j * 32 : j * 32 + 32]
        lo = (qrow & 0x0F).astype(np.float32)
        hi = (qrow >> 4).astype(np.float32)
        d1 = d * sc[:, 2 * j]
        m1 = dmin * mn[:, 2 * j]
        d2 = d * sc[:, 2 * j + 1]
        m2 = dmin * mn[:, 2 * j + 1]
        out[:, j * 64 : j * 64 + 32] = lo * d1[:, None] - m1[:, None]
        out[:, j * 64 + 32 : j * 64 + 64] = hi * d2[:, None] - m2[:, None]
    return out.reshape(-1)


def dequant_q5_k(raw) -> np.ndarray:
    b = _blocks(raw, 176)
    d = _f16(b[:, :2].copy())[:, 0]
    dmin = _f16(b[:, 2:4].copy())[:, 0]
    sc, mn = _k4_scale_min(b[:, 4:16])
    qh = b[:, 16:48]
    ql = b[:, 48:]

    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    for j in range(4):
        qrow = ql[:, j * 32 : j * 32 + 32]
        u1 = 1 << (2 * j)
        u2 = 2 << (2 * j)
        lo = (qrow & 0x0F).astype(np.float32) + np.where((qh & u1) != 0, 16.0, 0.0)
        hi = (qrow >> 4).astype(np.float32) + np.where((qh & u2) != 0, 16.0, 0.0)
        d1 = d * sc[:, 2 * j]
        m1 = dmin * mn[:, 2 * j]
        d2 = d * sc[:, 2 * j + 1]
        m2 = dmin * mn[:, 2 * j + 1]
        out[:, j * 64 : j * 64 + 32] = lo * d1[:, None] - m1[:, None]
        out[:, j * 64 + 32 : j * 64 + 64] = hi * d2[:, None] - m2[:, None]
    return out.reshape(-1)


def dequant_q6_k(raw) -> np.ndarray:
    b = _blocks(raw, 210)
    ql = b[:, :128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210].copy())[:, 0]

    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    for chunk in range(2):
        qlc = ql[:, chunk * 64 : chunk * 64 + 64]
        qhc = qh[:, chunk * 32 : chunk * 32 + 32]
        scc = scales[:, chunk * 8 : chunk * 8 + 8]
        q1 = ((qlc[:, :32] & 0x0F) | (((qhc >> 0) & 3) << 4)).astype(np.int32) - 32
        q2 = ((qlc[:, 32:] & 0x0F) | (((qhc >> 2) & 3) << 4)).astype(np.int32) - 32
        q3 = ((qlc[:, :32] >> 4) | (((qhc >> 4) & 3) << 4)).astype(np.int32) - 32
        q4 = ((qlc[:, 32:] >> 4) | (((qhc >> 6) & 3) << 4)).astype(np.int32) - 32
        for idx, q in enumerate([q1, q2, q3, q4]):
            # sub-block scale index: is = l//16 + idx*2 → sc columns {idx*2, idx*2+1}
            s = np.repeat(scc[:, [idx * 2, idx * 2 + 1]], 16, axis=1)  # [nb,32]
            out[:, chunk * 128 + idx * 32 : chunk * 128 + idx * 32 + 32] = (
                q.astype(np.float32) * s * d[:, None]
            )
    return out.reshape(-1)


def dequant_q8_k(raw) -> np.ndarray:
    b = _blocks(raw, 292)
    d = b[:, :4].copy().view(np.float32)[:, 0]
    q = b[:, 4:260].view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)


def dequant_iq4_nl(raw) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:]
    lo = KVALUES_IQ4NL[qs & 0x0F]
    hi = KVALUES_IQ4NL[qs >> 4]
    out = np.concatenate([lo, hi], axis=1)
    return (out * d[:, None]).reshape(-1)


def dequant_iq4_xs(raw) -> np.ndarray:
    b = _blocks(raw, 136)
    d = _f16(b[:, :2].copy())[:, 0]
    scales_h = b[:, 2:4].copy().view(np.uint16)[:, 0].astype(np.uint32)
    scales_l = b[:, 4:8]
    qs = b[:, 8:]

    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    for ib in range(8):                      # 8 sub-blocks of 32
        ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F).astype(np.uint32) | (
            ((scales_h >> (2 * ib)) & 3) << 4
        )
        dl = d * (ls.astype(np.float32) - 32.0)
        qrow = qs[:, ib * 16 : ib * 16 + 16]
        lo = KVALUES_IQ4NL[qrow & 0x0F]
        hi = KVALUES_IQ4NL[qrow >> 4]
        out[:, ib * 32 : ib * 32 + 16] = lo * dl[:, None]
        out[:, ib * 32 + 16 : ib * 32 + 32] = hi * dl[:, None]
    return out.reshape(-1)


def dequant_tq2_0(raw) -> np.ndarray:
    b = _blocks(raw, 66)
    qs = b[:, :64]
    d = _f16(b[:, 64:66].copy())[:, 0]
    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    for j in range(0, 64, 32):
        for l in range(4):
            q = ((qs[:, j : j + 32] >> (2 * l)) & 3).astype(np.float32) - 1.0
            base = j * 4 + l * 32
            out[:, base : base + 32] = q * d[:, None]
    return out.reshape(-1)


def dequant_tq1_0(raw) -> np.ndarray:
    b = _blocks(raw, 54)
    qs = b[:, :48].astype(np.uint16)
    qh = b[:, 48:52].astype(np.uint16)
    d = _f16(b[:, 52:54].copy())[:, 0]
    pow3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)
    nb = b.shape[0]
    out = np.empty((nb, QK_K), dtype=np.float32)
    y = 0
    # First 32-byte group → 160 elems
    for n in range(5):
        q = ((qs[:, :32] * pow3[n]) & 0xFF) * 3 >> 8
        out[:, y : y + 32] = q.astype(np.float32) - 1.0
        y += 32
    # Next 16-byte group → 80 elems
    for n in range(5):
        q = ((qs[:, 32:48] * pow3[n]) & 0xFF) * 3 >> 8
        out[:, y : y + 16] = q.astype(np.float32) - 1.0
        y += 16
    # qh → 16 elems
    for n in range(4):
        q = ((qh * pow3[n]) & 0xFF) * 3 >> 8
        out[:, y : y + 4] = q.astype(np.float32) - 1.0
        y += 4
    assert y == QK_K
    return (out * d[:, None]).reshape(-1)


from .iq_quants import IQ_DEQUANT_FNS, IQ_QUANT_FNS  # noqa: E402

_DEQUANT_FNS = {
    GgmlType.Q8_0: dequant_q8_0,
    GgmlType.Q8_1: dequant_q8_1,
    GgmlType.Q4_0: dequant_q4_0,
    GgmlType.Q4_1: dequant_q4_1,
    GgmlType.Q5_0: dequant_q5_0,
    GgmlType.Q5_1: dequant_q5_1,
    GgmlType.Q2_K: dequant_q2_k,
    GgmlType.Q3_K: dequant_q3_k,
    GgmlType.Q4_K: dequant_q4_k,
    GgmlType.Q5_K: dequant_q5_k,
    GgmlType.Q6_K: dequant_q6_k,
    GgmlType.Q8_K: dequant_q8_k,
    GgmlType.IQ4_NL: dequant_iq4_nl,
    GgmlType.IQ4_XS: dequant_iq4_xs,
    GgmlType.TQ1_0: dequant_tq1_0,
    GgmlType.TQ2_0: dequant_tq2_0,
    **IQ_DEQUANT_FNS,
}


def supported_quant_types() -> list[GgmlType]:
    plain = [GgmlType.F32, GgmlType.F16, GgmlType.BF16, GgmlType.F64,
             GgmlType.I8, GgmlType.I16, GgmlType.I32, GgmlType.I64]
    return plain + sorted(_DEQUANT_FNS.keys())


def dequantize_ggml(raw: bytes | memoryview, gt: GgmlType,
                    shape: tuple[int, ...]) -> np.ndarray:
    """Dequantize raw GGUF tensor bytes to a float32 (or native int) array."""
    if gt == GgmlType.F32:
        return np.frombuffer(raw, dtype=np.float32).reshape(shape).copy()
    if gt == GgmlType.F16:
        return np.frombuffer(raw, dtype=np.float16).astype(np.float32).reshape(shape)
    if gt == GgmlType.BF16:
        u = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
        return u.view(np.float32).reshape(shape)
    if gt == GgmlType.F64:
        return np.frombuffer(raw, dtype=np.float64).astype(np.float32).reshape(shape)
    if gt in (GgmlType.I8, GgmlType.I16, GgmlType.I32, GgmlType.I64):
        dt = {GgmlType.I8: np.int8, GgmlType.I16: np.int16,
              GgmlType.I32: np.int32, GgmlType.I64: np.int64}[gt]
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    fn = _DEQUANT_FNS.get(gt)
    if fn is None:
        raise NotImplementedError(
            f"GGML type {gt.name} not supported; "
            f"supported: {[t.name for t in supported_quant_types()]}"
        )
    return fn(raw).reshape(shape)


# ---------------------------------------------------------------------------
# Quantization (the encoders of fixtures and `convert`)
# ---------------------------------------------------------------------------

def _to_f16_bytes(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float16).view(np.uint8)


def quant_q8_0(x: np.ndarray) -> bytes:
    x = x.reshape(-1, 32).astype(np.float32)
    amax = np.max(np.abs(x), axis=1)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]), -127, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def quant_q4_0(x: np.ndarray) -> bytes:
    x = x.reshape(-1, 32).astype(np.float32)
    imax = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), imax]
    d = maxv / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def quant_q4_1(x: np.ndarray) -> bytes:
    x = x.reshape(-1, 32).astype(np.float32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv[:, None]), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 20), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _to_f16_bytes(mn).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def quant_q4_k(x: np.ndarray) -> bytes:
    """Simple (non-search) Q4_K encoder: per-32 sub-block min/max affine with
    6-bit super-scales. Valid for roundtrip/golden tests and conversion."""
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    smin = np.minimum(sub.min(axis=2), 0.0)       # ensure min <= 0 so -m works
    smax = sub.max(axis=2)
    scale = (smax - smin) / 15.0                  # per sub-block scale
    neg_min = -smin                               # stored min is subtracted
    d = scale.max(axis=1) / 63.0
    dmin = neg_min.max(axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1.0, dmin), 0.0)
    ls = np.clip(np.round(scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    lm = np.clip(np.round(neg_min * inv_m[:, None]), 0, 63).astype(np.uint8)
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    eff_scale = d16[:, None] * ls
    eff_min = dmin16[:, None] * lm
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1.0, eff_scale), 0.0)
    q = np.clip(np.round((sub + eff_min[:, :, None]) * inv_s[:, :, None]), 0, 15).astype(np.uint8)

    out = np.zeros((nb, 144), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _to_f16_bytes(dmin).reshape(-1, 2)
    # Pack 6-bit scales: j<4 plain; j>=4 split across bytes.
    sc_field = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(4):
        sc_field[:, j] = ls[:, j] & 63
        sc_field[:, j + 4] = lm[:, j] & 63
    for j in range(4, 8):
        sc_field[:, j - 4] |= (ls[:, j] >> 4) << 6
        sc_field[:, j] |= (lm[:, j] >> 4) << 6
        sc_field[:, j + 4] = (ls[:, j] & 0x0F) | ((lm[:, j] & 0x0F) << 4)
    out[:, 4:16] = sc_field
    # qs: per 64-elem pair: 32 bytes; low nibble = sub 2j, high = sub 2j+1.
    for j in range(4):
        out[:, 16 + j * 32 : 16 + j * 32 + 32] = q[:, 2 * j] | (q[:, 2 * j + 1] << 4)
    return out.tobytes()


def quant_q6_k(x: np.ndarray) -> bytes:
    """Simple Q6_K encoder: symmetric 6-bit per 16-elem sub-block with int8
    sub-scales and f16 super-scale."""
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    amax = np.max(np.abs(sub), axis=2)
    sub_scale = amax / 31.0
    d = sub_scale.max(axis=1) / 127.0
    d = np.where(d == 0, 1e-12, d)
    ls = np.clip(np.round(sub_scale / d[:, None]), -128, 127).astype(np.int8)
    d16 = d.astype(np.float16).astype(np.float32)
    eff = d16[:, None] * ls.astype(np.float32)
    inv = np.where(eff != 0, 1.0 / np.where(eff == 0, 1.0, eff), 0.0)
    q = np.clip(np.round(sub * inv[:, :, None]), -32, 31).astype(np.int32) + 32  # [nb,16,16]
    q = q.reshape(nb, QK_K).astype(np.uint8)

    out = np.zeros((nb, 210), dtype=np.uint8)
    ql = np.zeros((nb, 128), dtype=np.uint8)
    qh = np.zeros((nb, 64), dtype=np.uint8)
    for chunk in range(2):
        base = chunk * 128
        q1 = q[:, base : base + 32]
        q2 = q[:, base + 32 : base + 64]
        q3 = q[:, base + 64 : base + 96]
        q4 = q[:, base + 96 : base + 128]
        ql[:, chunk * 64 : chunk * 64 + 32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        ql[:, chunk * 64 + 32 : chunk * 64 + 64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
        qh[:, chunk * 32 : chunk * 32 + 32] = (
            (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
        )
    out[:, :128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = ls.view(np.uint8)
    out[:, 208:210] = _to_f16_bytes(d).reshape(-1, 2)
    return out.tobytes()


def quant_q5_k(x: np.ndarray) -> bytes:
    """Simple Q5_K encoder mirroring quant_q4_k with a 5th bit plane."""
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    smin = np.minimum(sub.min(axis=2), 0.0)
    smax = sub.max(axis=2)
    scale = (smax - smin) / 31.0
    neg_min = -smin
    d = scale.max(axis=1) / 63.0
    dmin = neg_min.max(axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1.0, dmin), 0.0)
    ls = np.clip(np.round(scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    lm = np.clip(np.round(neg_min * inv_m[:, None]), 0, 63).astype(np.uint8)
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    eff_scale = d16[:, None] * ls
    eff_min = dmin16[:, None] * lm
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1.0, eff_scale), 0.0)
    q = np.clip(np.round((sub + eff_min[:, :, None]) * inv_s[:, :, None]), 0, 31).astype(np.uint8)

    out = np.zeros((nb, 176), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _to_f16_bytes(dmin).reshape(-1, 2)
    sc_field = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(4):
        sc_field[:, j] = ls[:, j] & 63
        sc_field[:, j + 4] = lm[:, j] & 63
    for j in range(4, 8):
        sc_field[:, j - 4] |= (ls[:, j] >> 4) << 6
        sc_field[:, j] |= (lm[:, j] >> 4) << 6
        sc_field[:, j + 4] = (ls[:, j] & 0x0F) | ((lm[:, j] & 0x0F) << 4)
    out[:, 4:16] = sc_field
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for j in range(4):
        lo5 = q[:, 2 * j]
        hi5 = q[:, 2 * j + 1]
        out[:, 48 + j * 32 : 48 + j * 32 + 32] = (lo5 & 0x0F) | ((hi5 & 0x0F) << 4)
        qh |= ((lo5 >> 4) << (2 * j)) | ((hi5 >> 4) << (2 * j + 1))
    out[:, 16:48] = qh
    return out.tobytes()


def quant_q2_k(x: np.ndarray) -> bytes:
    """Simple Q2_K encoder: per-16 sub-block affine with 4-bit scale/min."""
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    smin = np.minimum(sub.min(axis=2), 0.0)
    smax = sub.max(axis=2)
    scale = (smax - smin) / 3.0
    neg_min = -smin
    d = scale.max(axis=1) / 15.0
    dmin = neg_min.max(axis=1) / 15.0
    d = np.where(d == 0, 1e-12, d)
    dmin = np.where(dmin == 0, 1e-12, dmin)
    ls = np.clip(np.round(scale / d[:, None]), 0, 15).astype(np.uint8)
    lm = np.clip(np.round(neg_min / dmin[:, None]), 0, 15).astype(np.uint8)
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    eff_scale = d16[:, None] * ls
    eff_min = dmin16[:, None] * lm
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1.0, eff_scale), 0.0)
    q = np.clip(np.round((sub + eff_min[:, :, None]) * inv_s[:, :, None]), 0, 3).astype(np.uint8)
    q = q.reshape(nb, QK_K)

    out = np.zeros((nb, 84), dtype=np.uint8)
    out[:, :16] = ls | (lm << 4)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    for chunk in range(2):
        for j in range(4):
            vals = q[:, chunk * 128 + j * 32 : chunk * 128 + j * 32 + 32]
            qs[:, chunk * 32 : chunk * 32 + 32] |= vals << (2 * j)
    out[:, 16:80] = qs
    out[:, 80:82] = _to_f16_bytes(d).reshape(-1, 2)
    out[:, 82:84] = _to_f16_bytes(dmin).reshape(-1, 2)
    return out.tobytes()


_QUANT_FNS = {
    GgmlType.Q8_0: quant_q8_0,
    GgmlType.Q4_0: quant_q4_0,
    GgmlType.Q4_1: quant_q4_1,
    GgmlType.Q2_K: quant_q2_k,
    GgmlType.Q4_K: quant_q4_k,
    GgmlType.Q5_K: quant_q5_k,
    GgmlType.Q6_K: quant_q6_k,
    **IQ_QUANT_FNS,
}


def quantize_ggml(x: np.ndarray, gt: GgmlType) -> bytes:
    """Quantize a float array to raw GGUF block bytes."""
    if gt == GgmlType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).tobytes()
    if gt == GgmlType.F16:
        return np.ascontiguousarray(x, dtype=np.float16).tobytes()
    fn = _QUANT_FNS.get(gt)
    if fn is None:
        raise NotImplementedError(f"No encoder for {gt.name}")
    _, epb = GGML_BLOCK_INFO[gt]
    if x.size % epb != 0:
        raise ValueError(f"size {x.size} not a multiple of {epb} for {gt.name}")
    return fn(np.asarray(x))
