"""Grid-codebook IQ quant codecs: IQ1_S/M, IQ2_XXS/XS/S, IQ3_XXS/S.

Copy of ``blazr_tpu/formats/iq_quants.py`` (the port imports nothing of the
JAX package). Bitstream layouts follow the public ggml block definitions
(block sizes in ``gguf.GGML_BLOCK_INFO``): per-block f16 super-scales,
packed 4-bit / 3-bit sub-scales, 7-bit parity-sign indices (IQ2_XXS /
IQ2_XS / IQ3_XXS) or explicit sign bytes (IQ2_S / IQ3_S), and 8- to 11-bit
codebook indices.

Codebooks: the official ggml grid tables are hand-curated lattice subsets
published only as constants inside ggml. The active grids come, in order,
from the ``.npz`` that ``BLAZR_TPU_IQ_GRIDS`` names (keys iq2xxs_grid,
iq2xs_grid, iq2s_grid, iq3xxs_grid, iq3s_grid, iq1s_grid), from package
data (``formats/data/iq_grids.npz``), or from deterministic synthetic
codebooks of the same cardinality, alphabet and parity constraints (the
JAX package's, so both packages hold the same tables). They are read at
first use, and again when the variable names another file.

Files that hold grid-coded tensors carry the fingerprint of the grids that
encoded them (``IQ_GRIDS_META_KEY``). ``check_grid_stamp`` refuses a file
whose stamp differs from the active grids' fingerprint, whatever the grids'
source, and an unstamped file (an external llama.cpp file) unless the
active grids are the official tables. The JAX package's check is one-way:
it accepts any stamp when its grids are canonical (ROADMAP §C).
"""

from __future__ import annotations

import functools
import hashlib
import os
from pathlib import Path
from typing import Optional

import numpy as np

from .gguf import GgmlType

QK_K = 256

IQ1S_DELTA = 0.125
IQ1M_DELTA = 0.0625

# Value alphabets (ggml conventions: IQ2 grid bytes encode magnitudes
# {8, 25, 43} ~ {1, 3, 5} * 8.5; IQ3 grid bytes are 8 magnitude levels;
# IQ1 grids hold {-1, 0, 1} stored as {0, 1, 2}).
_IQ2_ALPHABET = np.array([8, 25, 43], dtype=np.uint8)
_IQ3_ALPHABET = np.array([4, 12, 20, 28, 36, 44, 52, 62], dtype=np.uint8)


def _f16(a: np.ndarray) -> np.ndarray:
    return a.view(np.float16).astype(np.float32)


def _to_f16_bytes(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, dtype=np.float16).view(np.uint8)


def _blocks(raw: bytes | memoryview, block_bytes: int) -> np.ndarray:
    buf = np.frombuffer(raw, dtype=np.uint8)
    assert buf.size % block_bytes == 0, (buf.size, block_bytes)
    return buf.reshape(-1, block_bytes)


# ---------------------------------------------------------------------------
# Sign tables (fully derivable from the public spec)
# ---------------------------------------------------------------------------

def _make_ksigns() -> np.ndarray:
    """ksigns_iq2xs[128]: 7 explicit sign bits + 1 even-parity bit
    (bit j set → element j negative)."""
    i = np.arange(128, dtype=np.uint16)
    pop = np.array([bin(v).count("1") & 1 for v in range(128)], dtype=np.uint16)
    return (i | (pop << 7)).astype(np.uint8)


KSIGNS = _make_ksigns()
# [128, 8] float signs (+1/-1) for vectorized dequant
_SIGNS_F = 1.0 - 2.0 * (
    (KSIGNS[:, None].astype(np.uint16) >> np.arange(8)[None, :]) & 1
).astype(np.float32)
# [256, 8] for explicit 8-bit sign bytes (IQ2_S / IQ3_S)
_SIGNS8_F = 1.0 - 2.0 * (
    (np.arange(256, dtype=np.uint16)[:, None] >> np.arange(8)[None, :]) & 1
).astype(np.float32)


# ---------------------------------------------------------------------------
# Codebook generation (deterministic synthetic grids)
# ---------------------------------------------------------------------------

def _gen_grid(n: int, width: int, alphabet: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic codebook: always includes the uniform low/high vectors
    and a spread of distinct random lattice-alphabet points."""
    rng = np.random.default_rng(seed)
    seen: set[bytes] = set()
    rows = []
    # Seed with structured entries: constant vectors and single-step ramps.
    for v in alphabet:
        row = np.full(width, v, dtype=np.uint8)
        rows.append(row)
        seen.add(row.tobytes())       # random draws must not duplicate them
    while len(rows) < n:
        r = alphabet[rng.integers(0, len(alphabet), width)].astype(np.uint8)
        k = r.tobytes()
        if k not in seen:
            seen.add(k)
            rows.append(r)
    return np.stack(rows[:n])


_PACKAGE_GRIDS = Path(__file__).parent / "data" / "iq_grids.npz"
_GRID_KEYS = ("iq2xxs_grid", "iq2xs_grid", "iq2s_grid", "iq3xxs_grid",
              "iq3s_grid", "iq1s_grid")


class IqGrids:
    """The active codebook tables and where they came from: ``"env"`` or
    ``"package"`` (the official ggml tables) or ``"synthetic"``."""

    def __init__(self, source: str, tables: dict[str, np.ndarray]):
        self.source = source
        self.tables = tables
        # IQ1 grids hold {-1, 0, 1} stored as {0, 1, 2}
        self.iq1s = tables["iq1s_grid"].astype(np.float32) - 1.0
        h = hashlib.sha256()
        for k in sorted(tables):
            h.update(k.encode())
            h.update(np.ascontiguousarray(tables[k]).tobytes())
        self.fingerprint = h.hexdigest()[:16]

    @property
    def canonical(self) -> bool:
        return self.source != "synthetic"


def _read_npz(path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


@functools.lru_cache(maxsize=4)
def _load_grids(env_path: Optional[str]) -> IqGrids:
    if env_path and os.path.exists(env_path):
        return IqGrids("env", _read_npz(env_path))
    if _PACKAGE_GRIDS.exists():
        return IqGrids("package", _read_npz(_PACKAGE_GRIDS))
    return IqGrids("synthetic", {
        "iq2xxs_grid": _gen_grid(256, 8, _IQ2_ALPHABET, seed=0x12),
        "iq2xs_grid": _gen_grid(512, 8, _IQ2_ALPHABET, seed=0x13),
        "iq2s_grid": _gen_grid(1024, 8, _IQ2_ALPHABET, seed=0x14),
        "iq3xxs_grid": _gen_grid(256, 4, _IQ3_ALPHABET, seed=0x15),
        "iq3s_grid": _gen_grid(512, 4, _IQ3_ALPHABET, seed=0x16),
        "iq1s_grid": _gen_grid(2048, 8, np.array([0, 1, 2], dtype=np.uint8),
                               seed=0x17),
    })


def active_grids() -> IqGrids:
    """The grids of ``BLAZR_TPU_IQ_GRIDS``, else package data, else synthetic."""
    return _load_grids(os.environ.get("BLAZR_TPU_IQ_GRIDS"))


def _grid(name: str) -> np.ndarray:
    return active_grids().tables[name]


# GGUF metadata key the writer stamps into files that hold grid-coded IQ
# tensors: the fingerprint of the grids that encoded them.
IQ_GRIDS_META_KEY = "blazr_tpu.iq_grids"


def grids_fingerprint() -> str:
    """Short stable hash of the active codebook tables (the JAX package's)."""
    return active_grids().fingerprint


def grids_are_canonical() -> bool:
    """True when the active grids are the official ggml tables (loaded from
    ``BLAZR_TPU_IQ_GRIDS`` or package data)."""
    return active_grids().canonical


def check_grid_stamp(file_stamp, context: str) -> None:
    """Refuse to decode a file's grid-coded IQ tensors with other grids
    than the ones that encoded them: a stamp must equal the active grids'
    fingerprint; an unstamped file decodes only with the official tables."""
    grids = active_grids()
    if file_stamp == grids.fingerprint or (file_stamp is None and grids.canonical):
        return
    if file_stamp is None:
        why = ("it carries no grid stamp (an external file) and only synthetic "
               "IQ codebooks are active (the official ggml tables are not "
               "bundled)")
    else:
        why = (f"it was encoded with grids of fingerprint {file_stamp}, and the "
               f"active {grids.source} grids have fingerprint {grids.fingerprint}")
    raise RuntimeError(
        f"{context} contains grid-codebook IQ tensors that cannot be decoded: "
        f"{why}. Decoding would give wrong weights. Point BLAZR_TPU_IQ_GRIDS "
        f"at an .npz with the grids that encoded the file.")


# ===========================================================================
# Dequantization
# ===========================================================================

def dequant_iq2_xxs(raw) -> np.ndarray:
    """block: f16 d + uint16 qs[32]. Per 32-elem group: 4 grid bytes +
    u32 of 4×7-bit sign indices and a 4-bit scale."""
    b = _blocks(raw, 66)
    nb = b.shape[0]
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4)    # [nb, grp, 4]
    gidx = qs[:, :, :2].copy().view(np.uint8).reshape(nb, 8, 4)  # 4 grid idx
    aux32 = (qs[:, :, 2].astype(np.uint32)
             | (qs[:, :, 3].astype(np.uint32) << 16))            # [nb, grp]
    ls = (aux32 >> 28).astype(np.float32)
    db = d[:, None] * 0.25 * (0.5 + ls)                          # [nb, grp]
    sidx = (aux32[:, :, None] >> (7 * np.arange(4))[None, None, :]) & 127
    vals = _grid("iq2xxs_grid")[gidx].astype(np.float32)                  # [nb,grp,4,8]
    signs = _SIGNS_F[sidx]                                       # [nb,grp,4,8]
    out = db[:, :, None, None] * vals * signs
    return out.reshape(-1)


def dequant_iq2_xs(raw) -> np.ndarray:
    """block: f16 d + uint16 qs[32] (9-bit grid idx + 7-bit sign idx) +
    uint8 scales[8] (two 4-bit sub-scales per 32-group)."""
    b = _blocks(raw, 74)
    nb = b.shape[0]
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4)
    scales = b[:, 66:74]                                         # [nb, 8]
    lo = (scales & 0x0F).astype(np.float32)
    hi = (scales >> 4).astype(np.float32)
    # first two 8-groups use the low nibble, last two the high nibble
    ls = np.stack([lo, lo, hi, hi], axis=2)                      # [nb, grp, 4]
    db = d[:, None, None] * 0.25 * (0.5 + ls)
    vals = _grid("iq2xs_grid")[qs & 511].astype(np.float32)               # [nb,grp,4,8]
    signs = _SIGNS_F[qs >> 9]
    out = db[:, :, :, None] * vals * signs
    return out.reshape(-1)


def dequant_iq2_s(raw) -> np.ndarray:
    """block: f16 d + uint8 qs[64] (32 grid-low bytes then 32 sign bytes) +
    uint8 qh[8] (2 high idx bits per 8-group) + uint8 scales[8]."""
    b = _blocks(raw, 82)
    nb = b.shape[0]
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:34].reshape(nb, 8, 4)                            # grid low bits
    sign_bytes = b[:, 34:66].reshape(nb, 8, 4)
    qh = b[:, 66:74]                                             # [nb, 8]
    scales = b[:, 74:82]
    lo = (scales & 0x0F).astype(np.float32)
    hi = (scales >> 4).astype(np.float32)
    ls = np.stack([lo, lo, hi, hi], axis=2)
    db = d[:, None, None] * 0.25 * (0.5 + ls)
    high = ((qh[:, :, None].astype(np.uint16)
             << (8 - 2 * np.arange(4))[None, None, :]) & 0x300)
    idx = qs.astype(np.uint16) | high
    vals = _grid("iq2s_grid")[idx].astype(np.float32)
    signs = _SIGNS8_F[sign_bytes]
    out = db[:, :, :, None] * vals * signs
    return out.reshape(-1)


def dequant_iq3_xxs(raw) -> np.ndarray:
    """block: f16 d + uint8 qs[64] (64 grid idx, 4 elems each) +
    uint8 sas[32] (per 32-group u32: 4×7-bit signs + 4-bit scale)."""
    b = _blocks(raw, 98)
    nb = b.shape[0]
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:66].reshape(nb, 8, 8)                            # 8 idx / group
    aux32 = b[:, 66:98].copy().view(np.uint32).reshape(nb, 8)    # [nb, grp]
    ls = (aux32 >> 28).astype(np.float32)
    db = d[:, None] * 0.5 * (0.5 + ls)
    # sign index l covers 8 elems = 2 consecutive grid entries
    sidx = (aux32[:, :, None] >> (7 * np.arange(4))[None, None, :]) & 127
    signs = _SIGNS_F[sidx]                                       # [nb,grp,4,8]
    vals = _grid("iq3xxs_grid")[qs].astype(np.float32).reshape(nb, 8, 4, 8)
    out = db[:, :, None, None] * vals * signs
    return out.reshape(-1)


def dequant_iq3_s(raw) -> np.ndarray:
    """block: f16 d + uint8 qs[64] + qh[8] (high idx bit per entry) +
    signs[32] (explicit) + scales[4] (4-bit per 64 elems)."""
    b = _blocks(raw, 110)
    nb = b.shape[0]
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:66].reshape(nb, 8, 8)
    qh = b[:, 66:74]                                             # [nb, 8]
    sign_bytes = b[:, 74:106].reshape(nb, 8, 4)
    scales = b[:, 106:110]                                       # [nb, 4]
    lo = (scales & 0x0F).astype(np.float32)
    hi = (scales >> 4).astype(np.float32)
    ls = np.stack([lo, hi], axis=2).reshape(nb, 8)               # per 32-group
    db = d[:, None] * (1.0 + 2.0 * ls)
    high = ((qh[:, :, None].astype(np.uint16) << (8 - np.arange(8))[None, None, :])
            & 0x100)
    idx = qs.astype(np.uint16) | high
    vals = _grid("iq3s_grid")[idx].astype(np.float32).reshape(nb, 8, 4, 8)
    signs = _SIGNS8_F[sign_bytes]
    out = db[:, :, None, None] * vals * signs
    return out.reshape(-1)


def dequant_iq1_s(raw) -> np.ndarray:
    """block: f16 d + uint8 qs[32] + uint16 qh[8]: per 32-group an 11-bit
    grid index per 8 elems (3 high bits from qh), 3-bit scale, delta sign."""
    b = _blocks(raw, 50)
    nb = b.shape[0]
    d = _f16(b[:, :2].copy())[:, 0]
    qs = b[:, 2:34].reshape(nb, 8, 4)
    qh = b[:, 34:50].copy().view(np.uint16)                      # [nb, 8]
    ls = ((qh >> 12) & 7).astype(np.float32)
    dl = d[:, None] * (2.0 * ls + 1.0)                           # [nb, grp]
    delta = np.where(qh & 0x8000, -IQ1S_DELTA, IQ1S_DELTA).astype(np.float32)
    high = ((qh[:, :, None].astype(np.uint32)
             >> (3 * np.arange(4))[None, None, :]) & 7) << 8
    idx = qs.astype(np.uint32) | high
    vals = active_grids().iq1s[idx]                                        # [nb,grp,4,8]
    out = dl[:, :, None, None] * (vals + delta[:, :, None, None])
    return out.reshape(-1)


def dequant_iq1_m(raw) -> np.ndarray:
    """block: uint8 qs[32] + uint8 qh[16] (nibble per 8 elems: 3 high idx
    bits + delta sign) + uint8 scales[8] (u16[4]: 4×3-bit sub-scales +
    4 bits each of the packed f16 super-scale)."""
    b = _blocks(raw, 56)
    nb = b.shape[0]
    qs = b[:, 0:32].reshape(nb, 8, 4)
    qh_b = b[:, 32:48].reshape(nb, 16)
    sc = b[:, 48:56].copy().view(np.uint16)                      # [nb, 4]
    d_bits = ((sc[:, 0] >> 12)
              | ((sc[:, 1] >> 12) << 4)
              | ((sc[:, 2] >> 12) << 8)
              | ((sc[:, 3] >> 12) << 12)).astype(np.uint16)
    d = d_bits.view(np.float16).astype(np.float32)               # [nb]
    # 16 sub-scales (one per 16 elems): 3-bit fields, 4 per u16
    ib16 = np.arange(16)
    ls = ((sc[:, ib16 // 4] >> (3 * (ib16 % 4))[None, :]) & 7).astype(np.float32)
    dl = d[:, None] * (2.0 * ls + 1.0)                           # [nb, 16]
    # qh nibbles: one per 8 elems (32 of them)
    nib = np.empty((nb, 32), dtype=np.uint16)
    nib[:, 0::2] = qh_b & 0x0F
    nib[:, 1::2] = qh_b >> 4
    idx = qs.reshape(nb, 32).astype(np.uint32) | ((nib & 7).astype(np.uint32) << 8)
    delta = np.where(nib & 8, -IQ1M_DELTA, IQ1M_DELTA).astype(np.float32)
    vals = active_grids().iq1s[idx]                                        # [nb, 32, 8]
    out = (vals + delta[:, :, None]) * dl.repeat(2, axis=1)[:, :, None]
    return out.reshape(-1)


# ===========================================================================
# Quantization (nearest-codebook search; fixtures and `convert`)
# ===========================================================================

def _nearest(grid_f: np.ndarray, target: np.ndarray) -> np.ndarray:
    """argmin_j ||grid[j] - target_i|| for each row of target.
    grid_f: [G, W]; target: [N, W] → [N] indices."""
    # ||g - t||^2 = ||g||^2 - 2 g·t + const
    g2 = (grid_f * grid_f).sum(axis=1)                           # [G]
    scores = g2[None, :] - 2.0 * target @ grid_f.T               # [N, G]
    return np.argmin(scores, axis=1)


def _parity_signs(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Even-parity sign encoding: returns (7-bit sign index, ±1 signs [N,8]).
    Where the natural pattern has odd parity, the smallest-|t| element's
    sign flips (the information-minimal correction)."""
    neg = (t < 0)
    parity = neg.sum(axis=1) & 1
    fix_rows = np.nonzero(parity)[0]
    if fix_rows.size:
        flip_col = np.abs(t[fix_rows]).argmin(axis=1)
        neg[fix_rows, flip_col] ^= True
    bits = (neg.astype(np.uint16) << np.arange(8)[None, :]).sum(axis=1)
    signs = 1.0 - 2.0 * neg.astype(np.float32)
    return (bits & 127).astype(np.uint32), signs


def _scale_fit(groups_max: np.ndarray, unit: float, levels: int,
               bias: float) -> tuple[np.ndarray, np.ndarray]:
    """Choose super-scale d and per-group integer sub-scales ls such that
    db = d * unit * (bias + ls) tracks group magnitudes."""
    top = groups_max.max(axis=1) / (unit * (bias + levels))
    # f16-safe clamp: tiny magnitudes underflow f16 to 0 (NaN divides
    # downstream, garbage scale bits) and huge ones overflow to inf;
    # all-zero blocks get a positive d with ls=0.
    d = np.clip(top, 6.2e-5, 6.0e4)
    d16 = d.astype(np.float16).astype(np.float32)
    ls = np.clip(np.round(groups_max / (d16[:, None] * unit) - bias),
                 0, levels).astype(np.uint32)
    return d16, ls


def quant_iq2_xxs(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    grid_f = _grid("iq2xxs_grid").astype(np.float32)
    g32 = x.reshape(nb, 8, 32)
    gmax = np.abs(g32).max(axis=2)                               # [nb, 8]
    d, ls = _scale_fit(gmax / grid_f.max(), 0.25, 15, 0.5)
    db = d[:, None] * 0.25 * (0.5 + ls)                          # [nb, 8]
    out = np.zeros((nb, 66), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    qs = np.zeros((nb, 8, 4), dtype=np.uint16)
    t8 = x.reshape(nb, 8, 4, 8)
    for g in range(8):
        t = t8[:, g].reshape(-1, 8) / np.maximum(db[:, g], 1e-8).repeat(4)[:, None]
        sbits, signs = _parity_signs(t)
        gi = _nearest(grid_f, t * signs).reshape(nb, 4).astype(np.uint16)
        sbits = sbits.reshape(nb, 4)
        aux32 = (sbits[:, 0] | (sbits[:, 1] << 7) | (sbits[:, 2] << 14)
                 | (sbits[:, 3] << 21) | (ls[:, g] << 28)).astype(np.uint32)
        qs[:, g, 0] = gi[:, 0] | (gi[:, 1] << 8)
        qs[:, g, 1] = gi[:, 2] | (gi[:, 3] << 8)
        qs[:, g, 2] = aux32 & 0xFFFF
        qs[:, g, 3] = aux32 >> 16
    out[:, 2:66] = qs.reshape(nb, -1).view(np.uint8)
    return out.tobytes()


def quant_iq2_xs(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    grid_f = _grid("iq2xs_grid").astype(np.float32)
    g32 = x.reshape(nb, 8, 32)
    gmax = np.abs(g32).max(axis=2)
    d, ls = _scale_fit(gmax / grid_f.max(), 0.25, 15, 0.5)
    db = d[:, None] * 0.25 * (0.5 + ls)
    out = np.zeros((nb, 74), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    qs = np.zeros((nb, 8, 4), dtype=np.uint16)
    t8 = x.reshape(nb, 8, 4, 8)
    for g in range(8):
        # sub-groups 0,1 share ls (low nibble); keep one ls per 32 here
        t = t8[:, g].reshape(-1, 8) / np.maximum(db[:, g], 1e-8).repeat(4)[:, None]
        sbits, signs = _parity_signs(t)
        gi = _nearest(grid_f, t * signs).astype(np.uint16)
        qs[:, g] = (gi | (sbits.astype(np.uint16) << 9)).reshape(nb, 4)
    out[:, 2:66] = qs.reshape(nb, -1).view(np.uint8)
    out[:, 66:74] = (ls | (ls << 4)).astype(np.uint8)            # both nibbles
    return out.tobytes()


def quant_iq2_s(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    grid_f = _grid("iq2s_grid").astype(np.float32)
    g32 = x.reshape(nb, 8, 32)
    gmax = np.abs(g32).max(axis=2)
    d, ls = _scale_fit(gmax / grid_f.max(), 0.25, 15, 0.5)
    db = d[:, None] * 0.25 * (0.5 + ls)
    out = np.zeros((nb, 82), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    t8 = x.reshape(nb, 8, 4, 8)
    for g in range(8):
        t = t8[:, g].reshape(-1, 8) / np.maximum(db[:, g], 1e-8).repeat(4)[:, None]
        neg = (t < 0)
        sbytes = (neg.astype(np.uint16) << np.arange(8)[None, :]).sum(axis=1)
        signs = 1.0 - 2.0 * neg.astype(np.float32)
        gi = _nearest(grid_f, t * signs)
        gi = gi.reshape(nb, 4)
        out[:, 2 + 4 * g: 2 + 4 * g + 4] = (gi & 0xFF).astype(np.uint8)
        hb = (gi >> 8).astype(np.uint8)                          # 2 bits each
        out[:, 66 + g] = (hb[:, 0] | (hb[:, 1] << 2) | (hb[:, 2] << 4)
                          | (hb[:, 3] << 6))
        out[:, 34 + 4 * g: 34 + 4 * g + 4] = \
            sbytes.reshape(nb, 4).astype(np.uint8)
    out[:, 74:82] = (ls | (ls << 4)).astype(np.uint8)
    return out.tobytes()


def quant_iq3_xxs(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    grid_f = _grid("iq3xxs_grid").astype(np.float32)
    g32 = x.reshape(nb, 8, 32)
    gmax = np.abs(g32).max(axis=2)
    d, ls = _scale_fit(gmax / grid_f.max(), 0.5, 15, 0.5)
    db = d[:, None] * 0.5 * (0.5 + ls)
    out = np.zeros((nb, 98), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    aux = np.zeros((nb, 8), dtype=np.uint32)
    t8 = x.reshape(nb, 8, 4, 8)
    for g in range(8):
        t = t8[:, g].reshape(-1, 8) / np.maximum(db[:, g], 1e-8).repeat(4)[:, None]
        sbits, signs = _parity_signs(t)
        ta = (t * signs).reshape(-1, 2, 4)                       # 2 entries/8
        gi = _nearest(grid_f, ta.reshape(-1, 4)).reshape(nb, 4, 2)
        for l in range(4):
            out[:, 2 + 8 * g + 2 * l] = gi[:, l, 0]
            out[:, 2 + 8 * g + 2 * l + 1] = gi[:, l, 1]
        sb = sbits.reshape(nb, 4).astype(np.uint32)
        aux[:, g] = (sb[:, 0] | (sb[:, 1] << 7) | (sb[:, 2] << 14)
                     | (sb[:, 3] << 21) | (ls[:, g] << 28))
    out[:, 66:98] = aux.view(np.uint8)
    return out.tobytes()


def quant_iq3_s(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    grid_f = _grid("iq3s_grid").astype(np.float32)
    g32 = x.reshape(nb, 8, 32)
    gmax = np.abs(g32).max(axis=2)
    top = gmax.max(axis=1) / (grid_f.max() * (1 + 2 * 15))
    d = np.clip(top, 6.2e-5, 6.0e4).astype(np.float16).astype(np.float32)
    ls = np.clip(np.round((gmax / (d[:, None] * grid_f.max()) - 1) / 2),
                 0, 15).astype(np.uint8)
    db = d[:, None] * (1.0 + 2.0 * ls.astype(np.float32))
    out = np.zeros((nb, 110), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    t8 = x.reshape(nb, 8, 4, 8)
    for g in range(8):
        t = t8[:, g].reshape(-1, 8) / np.maximum(db[:, g], 1e-8).repeat(4)[:, None]
        neg = (t < 0)
        sbytes = (neg.astype(np.uint16) << np.arange(8)[None, :]).sum(axis=1)
        signs = 1.0 - 2.0 * neg.astype(np.float32)
        ta = (t * signs).reshape(-1, 2, 4)
        gi = _nearest(grid_f, ta.reshape(-1, 4)).reshape(nb, 8)  # 8 idx/group
        out[:, 2 + 8 * g: 2 + 8 * g + 8] = (gi & 0xFF).astype(np.uint8)
        hb = ((gi >> 8) & 1).astype(np.uint8)
        out[:, 66 + g] = (hb << np.arange(8)[None, :]).sum(axis=1).astype(np.uint8)
        out[:, 74 + 4 * g: 74 + 4 * g + 4] = \
            sbytes.reshape(nb, 4).astype(np.uint8)
    out[:, 106:110] = (ls[:, 0::2] | (ls[:, 1::2] << 4))
    return out.tobytes()


def quant_iq1_s(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    g32 = x.reshape(nb, 8, 32)
    gmax = np.abs(g32).max(axis=2)
    top = gmax.max(axis=1) / (2 * 7 + 1)
    d = np.clip(top, 6.2e-5, 6.0e4).astype(np.float16).astype(np.float32)
    ls = np.clip(np.round((gmax / d[:, None] - 1) / 2), 0, 7).astype(np.uint16)
    dl = d[:, None] * (2.0 * ls.astype(np.float32) + 1.0)
    out = np.zeros((nb, 50), dtype=np.uint8)
    out[:, :2] = _to_f16_bytes(d).reshape(-1, 2)
    qh = np.zeros((nb, 8), dtype=np.uint16)
    t8 = x.reshape(nb, 8, 4, 8)
    for g in range(8):
        t = t8[:, g].reshape(-1, 8) / np.maximum(dl[:, g], 1e-8).repeat(4)[:, None]
        delta_sign = (t.reshape(nb, 32).mean(axis=1) < 0)
        delta = np.where(delta_sign, -IQ1S_DELTA, IQ1S_DELTA)
        gi = _nearest(active_grids().iq1s, t - delta.repeat(4)[:, None]).reshape(nb, 4)
        out[:, 2 + 4 * g: 2 + 4 * g + 4] = (gi & 0xFF).astype(np.uint8)
        hi = (gi >> 8).astype(np.uint16)                         # 3 bits each
        qh[:, g] = (hi[:, 0] | (hi[:, 1] << 3) | (hi[:, 2] << 6)
                    | (hi[:, 3] << 9) | (ls[:, g] << 12)
                    | (delta_sign.astype(np.uint16) << 15))
    out[:, 34:50] = qh.view(np.uint8)
    return out.tobytes()


def quant_iq1_m(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = x.shape[0]
    g16 = x.reshape(nb, 16, 16)
    gmax = np.abs(g16).max(axis=2)                               # [nb, 16]
    top = gmax.max(axis=1) / (2 * 7 + 1)
    d = np.where(top > 0, top, 1e-8).astype(np.float16)
    d_bits = d.view(np.uint16)
    d = d.astype(np.float32)
    ls = np.clip(np.round((gmax / d[:, None] - 1) / 2), 0, 7).astype(np.uint16)
    dl = d[:, None] * (2.0 * ls.astype(np.float32) + 1.0)        # [nb, 16]
    out = np.zeros((nb, 56), dtype=np.uint8)
    qh = np.zeros((nb, 32), dtype=np.uint8)                      # nibbles
    t8 = x.reshape(nb, 32, 8)
    dl8 = dl.repeat(2, axis=1)                                   # per 8 elems
    for j in range(32):
        t = t8[:, j] / np.maximum(dl8[:, j], 1e-8)[:, None]
        delta_sign = (t.mean(axis=1) < 0)
        delta = np.where(delta_sign, -IQ1M_DELTA, IQ1M_DELTA)
        gi = _nearest(active_grids().iq1s, t - delta[:, None])
        out[:, j] = (gi & 0xFF).astype(np.uint8)
        qh[:, j] = ((gi >> 8) & 7).astype(np.uint8) \
            | (delta_sign.astype(np.uint8) << 3)
    out[:, 32:48] = qh[:, 0::2] | (qh[:, 1::2] << 4)
    sc = np.zeros((nb, 4), dtype=np.uint16)
    for ib16 in range(16):
        sc[:, ib16 // 4] |= (ls[:, ib16] & 7) << (3 * (ib16 % 4))
    sc[:, 0] |= (d_bits & 0x000F) << 12
    sc[:, 1] |= (d_bits & 0x00F0) << 8
    sc[:, 2] |= (d_bits & 0x0F00) << 4
    sc[:, 3] |= (d_bits & 0xF000)
    out[:, 48:56] = sc.view(np.uint8)
    return out.tobytes()


IQ_DEQUANT_FNS = {
    GgmlType.IQ2_XXS: dequant_iq2_xxs,
    GgmlType.IQ2_XS: dequant_iq2_xs,
    GgmlType.IQ2_S: dequant_iq2_s,
    GgmlType.IQ3_XXS: dequant_iq3_xxs,
    GgmlType.IQ3_S: dequant_iq3_s,
    GgmlType.IQ1_S: dequant_iq1_s,
    GgmlType.IQ1_M: dequant_iq1_m,
}

IQ_QUANT_FNS = {
    GgmlType.IQ2_XXS: quant_iq2_xxs,
    GgmlType.IQ2_XS: quant_iq2_xs,
    GgmlType.IQ2_S: quant_iq2_s,
    GgmlType.IQ3_XXS: quant_iq3_xxs,
    GgmlType.IQ3_S: quant_iq3_s,
    GgmlType.IQ1_S: quant_iq1_s,
    GgmlType.IQ1_M: quant_iq1_m,
}

# GGML types whose decode depends on the curated codebook grids (IQ4_NL /
# IQ4_XS use the fully-public kvalues table and are NOT gated).
IQ_GRID_TYPES = frozenset(IQ_DEQUANT_FNS)
