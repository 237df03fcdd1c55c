"""GGUF file reader and writer, written against the public GGUF spec.

Copy of ``blazr_tpu/formats/gguf.py`` (the port imports nothing of the JAX
package): parse the header, the metadata KV store and the tensor table,
memory-map tensor data, and expose the typed metadata getters that
``loader/gguf_config.py`` reads. ``write_gguf`` writes the same bytes as
the JAX writer, streamed to the file instead of built in memory (a
full-width file is gigabytes).

GGUF layout (v2/v3, little-endian):
    magic "GGUF" | u32 version | u64 n_tensors | u64 n_kv
    n_kv × (string key | u32 type | value)
    n_tensors × (string name | u32 n_dims | u64 dims[n_dims] | u32 ggml_type | u64 offset)
    padding to `general.alignment` (default 32)
    tensor data (each tensor at its aligned `offset` from data start)
"""

from __future__ import annotations

import enum
import mmap
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np


class GgmlType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35


# (block_size_bytes, elements_per_block) per ggml type.
GGML_BLOCK_INFO: dict[GgmlType, tuple[int, int]] = {
    GgmlType.F32: (4, 1),
    GgmlType.F16: (2, 1),
    GgmlType.BF16: (2, 1),
    GgmlType.F64: (8, 1),
    GgmlType.I8: (1, 1),
    GgmlType.I16: (2, 1),
    GgmlType.I32: (4, 1),
    GgmlType.I64: (8, 1),
    GgmlType.Q4_0: (18, 32),
    GgmlType.Q4_1: (20, 32),
    GgmlType.Q5_0: (22, 32),
    GgmlType.Q5_1: (24, 32),
    GgmlType.Q8_0: (34, 32),
    GgmlType.Q8_1: (36, 32),
    GgmlType.Q2_K: (84, 256),
    GgmlType.Q3_K: (110, 256),
    GgmlType.Q4_K: (144, 256),
    GgmlType.Q5_K: (176, 256),
    GgmlType.Q6_K: (210, 256),
    GgmlType.Q8_K: (292, 256),
    GgmlType.IQ2_XXS: (66, 256),
    GgmlType.IQ2_XS: (74, 256),
    GgmlType.IQ3_XXS: (98, 256),
    GgmlType.IQ1_S: (50, 256),
    GgmlType.IQ1_M: (56, 256),
    GgmlType.IQ4_NL: (18, 32),
    GgmlType.IQ3_S: (110, 256),
    GgmlType.IQ2_S: (82, 256),
    GgmlType.IQ4_XS: (136, 256),
    GgmlType.TQ1_0: (54, 256),
    GgmlType.TQ2_0: (66, 256),
}


class _GgufValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    _GgufValueType.UINT8: ("<B", 1),
    _GgufValueType.INT8: ("<b", 1),
    _GgufValueType.UINT16: ("<H", 2),
    _GgufValueType.INT16: ("<h", 2),
    _GgufValueType.UINT32: ("<I", 4),
    _GgufValueType.INT32: ("<i", 4),
    _GgufValueType.FLOAT32: ("<f", 4),
    _GgufValueType.BOOL: ("<?", 1),
    _GgufValueType.UINT64: ("<Q", 8),
    _GgufValueType.INT64: ("<q", 8),
    _GgufValueType.FLOAT64: ("<d", 8),
}

GGUF_MAGIC = 0x46554747  # "GGUF"


class GgufTensorInfo:
    __slots__ = ("name", "shape", "ggml_type", "offset")

    def __init__(self, name: str, shape: tuple[int, ...], ggml_type: GgmlType, offset: int):
        self.name = name
        # GGUF stores dims innermost-first; `shape` here is row-major
        # (numpy order), i.e. reversed GGUF dims.
        self.shape = shape
        self.ggml_type = ggml_type
        self.offset = offset

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def size_bytes(self) -> int:
        bs, epb = GGML_BLOCK_INFO[self.ggml_type]
        assert self.num_elements % epb == 0, (self.name, self.shape, self.ggml_type)
        return self.num_elements // epb * bs

    def __repr__(self) -> str:  # pragma: no cover
        return f"GgufTensorInfo({self.name!r}, {self.shape}, {self.ggml_type.name})"


class GgufMetadata:
    """Typed access over the metadata KV store."""

    def __init__(self, kv: dict[str, Any]):
        self.kv = kv

    def get(self, key: str, default: Any = None) -> Any:
        return self.kv.get(key, default)

    def architecture(self) -> Optional[str]:
        return self.kv.get("general.architecture")

    def _arch_key(self, suffix: str) -> str:
        return f"{self.architecture() or 'llama'}.{suffix}"

    def embedding_length(self) -> Optional[int]:
        return self.get_u32(self._arch_key("embedding_length"))

    def block_count(self) -> Optional[int]:
        return self.get_u32(self._arch_key("block_count"))

    def context_length(self) -> Optional[int]:
        return self.get_u32(self._arch_key("context_length"))

    def get_u32(self, key: str) -> Optional[int]:
        v = self.kv.get(key)
        return int(v) if isinstance(v, (int, np.integer)) else None

    def get_f32(self, key: str) -> Optional[float]:
        v = self.kv.get(key)
        return float(v) if isinstance(v, (int, float, np.floating, np.integer)) else None

    def get_str(self, key: str) -> Optional[str]:
        v = self.kv.get(key)
        return v if isinstance(v, str) else None

    def get_array(self, key: str) -> Optional[list]:
        v = self.kv.get(key)
        return v if isinstance(v, list) else None


class Gguf:
    """Parsed GGUF file with mmap'd tensor data."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._parse()

    @classmethod
    def open(cls, path: str | Path) -> "Gguf":
        return cls(path)

    # ---- parsing ---------------------------------------------------------
    def _parse(self) -> None:
        mm = self._mm
        pos = 0

        def read(fmt: str, size: int):
            nonlocal pos
            vals = struct.unpack_from(fmt, mm, pos)
            pos += size
            return vals[0]

        def read_string() -> str:
            nonlocal pos
            n = read("<Q", 8)
            s = mm[pos : pos + n].decode("utf-8", errors="replace")
            pos += n
            return s

        def read_value(vt: _GgufValueType):
            nonlocal pos
            if vt == _GgufValueType.STRING:
                return read_string()
            if vt == _GgufValueType.ARRAY:
                elem_t = _GgufValueType(read("<I", 4))
                count = read("<Q", 8)
                if elem_t in _SCALAR_FMT and elem_t != _GgufValueType.BOOL:
                    fmt, sz = _SCALAR_FMT[elem_t]
                    arr = np.frombuffer(mm, dtype=np.dtype(fmt[1:]).newbyteorder("<"),
                                        count=count, offset=pos)
                    pos += sz * count
                    return arr.tolist()
                return [read_value(elem_t) for _ in range(count)]
            fmt, sz = _SCALAR_FMT[vt]
            return read(fmt, sz)

        magic = read("<I", 4)
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        self.version = read("<I", 4)
        if self.version < 2:
            raise ValueError(f"GGUF v{self.version} unsupported (need >= 2)")
        n_tensors = read("<Q", 8)
        n_kv = read("<Q", 8)

        kv: dict[str, Any] = {}
        for _ in range(n_kv):
            key = read_string()
            vt = _GgufValueType(read("<I", 4))
            kv[key] = read_value(vt)
        self._metadata = GgufMetadata(kv)

        self._tensors: dict[str, GgufTensorInfo] = {}
        order: list[str] = []
        for _ in range(n_tensors):
            name = read_string()
            n_dims = read("<I", 4)
            dims = [read("<Q", 8) for _ in range(n_dims)]
            ggml_type = GgmlType(read("<I", 4))
            offset = read("<Q", 8)
            # GGUF dims are innermost-first; reverse to row-major.
            shape = tuple(reversed(dims)) if dims else (1,)
            self._tensors[name] = GgufTensorInfo(name, shape, ggml_type, offset)
            order.append(name)
        self._tensor_order = order

        alignment = self._metadata.get_u32("general.alignment") or 32
        self.alignment = alignment
        self.data_start = (pos + alignment - 1) // alignment * alignment

    # ---- introspection ---------------------------------------------------
    def metadata(self) -> GgufMetadata:
        return self._metadata

    def tensor_names(self) -> list[str]:
        return list(self._tensor_order)

    def tensor_info(self, name: str) -> GgufTensorInfo:
        return self._tensors[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tensors

    # ---- data ------------------------------------------------------------
    def tensor_bytes(self, name: str) -> memoryview:
        info = self._tensors[name]
        start = self.data_start + info.offset
        return memoryview(self._mm)[start : start + info.size_bytes]

    def load_numpy(self, name: str) -> np.ndarray:
        """Dequantize/parse one tensor into a float32 (or int) numpy array."""
        from .ggml_quants import dequantize_ggml

        info = self._tensors[name]
        return dequantize_ggml(self.tensor_bytes(name), info.ggml_type, info.shape)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # Zero-copy views of the mmap are still alive; reclaimed on GC.
            pass
        self._file.close()

    def __enter__(self) -> "Gguf":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# GGUF writer: the convert CLI, tests and checkpoint synthesis.
# ---------------------------------------------------------------------------

def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(v: Any) -> tuple[int, bytes]:
    """Infer GGUF value type and pack. Returns (type_id, payload)."""
    if isinstance(v, bool):
        return int(_GgufValueType.BOOL), struct.pack("<?", v)
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if iv < 0:
            return int(_GgufValueType.INT64), struct.pack("<q", iv)
        if iv <= 0xFFFFFFFF:
            return int(_GgufValueType.UINT32), struct.pack("<I", iv)
        return int(_GgufValueType.UINT64), struct.pack("<Q", iv)
    if isinstance(v, (float, np.floating)):
        return int(_GgufValueType.FLOAT32), struct.pack("<f", float(v))
    if isinstance(v, str):
        return int(_GgufValueType.STRING), _pack_string(v)
    if isinstance(v, (list, tuple, np.ndarray)):
        items = list(v)
        if not items:
            return int(_GgufValueType.ARRAY), struct.pack("<IQ", int(_GgufValueType.UINT32), 0)
        # Promote the WHOLE array to one common element type up front —
        # repacking with the first element's type crashed on mixed arrays
        # (negative after non-negative, int-then-float, bool-first).
        if any(isinstance(x, (float, np.floating)) for x in items):
            et = int(_GgufValueType.FLOAT32)
            packed = [struct.pack("<f", float(x)) for x in items]
        elif all(isinstance(x, (bool, np.bool_)) for x in items):
            et = int(_GgufValueType.BOOL)
            packed = [struct.pack("<?", bool(x)) for x in items]
        elif all(isinstance(x, (bool, int, np.integer)) for x in items):
            ints = [int(x) for x in items]
            if any(x < 0 for x in ints):
                et = int(_GgufValueType.INT64)
                packed = [struct.pack("<q", x) for x in ints]
            elif any(x > 0xFFFFFFFF for x in ints):
                et = int(_GgufValueType.UINT64)
                packed = [struct.pack("<Q", x) for x in ints]
            else:
                et = int(_GgufValueType.UINT32)
                packed = [struct.pack("<I", x) for x in ints]
        else:
            et, _ = _pack_value(items[0])
            packed = []
            for item in items:
                it, ib = _pack_value(item)
                if it != et:
                    raise TypeError(
                        f"mixed GGUF array element types {it} vs {et}")
                packed.append(ib)
        payload = struct.pack("<IQ", et, len(items)) + b"".join(packed)
        return int(_GgufValueType.ARRAY), payload
    raise TypeError(f"Cannot encode GGUF value of type {type(v)}")


def _iq_grid_types():
    from .iq_quants import IQ_GRID_TYPES   # lazy: iq_quants imports gguf

    return IQ_GRID_TYPES


def _tensor_raw(data, gt: GgmlType) -> bytes | memoryview:
    if isinstance(data, np.ndarray):
        dt = {GgmlType.F32: np.float32, GgmlType.F16: np.float16,
              GgmlType.I32: np.int32}.get(gt)
        if dt is None:
            raise ValueError(f"Pass raw bytes for quantized type {gt.name}")
        return memoryview(np.ascontiguousarray(data, dtype=dt)).cast("B")
    return data


def write_gguf(path: str | Path, metadata: dict[str, Any],
               tensors: dict[str, tuple[np.ndarray | bytes, GgmlType, tuple[int, ...]]],
               alignment: int = 32) -> None:
    """Write a GGUF v3 file.

    ``tensors`` maps name → (raw_block_bytes_or_float_array, ggml_type, shape).
    Float arrays are accepted directly for F32/F16/I32; quantized types take
    raw block bytes (``ggml_quants.quantize_ggml``).
    """
    # A non-default alignment must be stamped into the metadata: readers
    # default to 32 and would misplace every tensor.
    if alignment != 32 and "general.alignment" not in metadata:
        metadata = {**metadata, "general.alignment": alignment}
    # Grid-coded IQ tensors: stamp the fingerprint of the grids that
    # encoded them (iq_quants.check_grid_stamp reads it back).
    if any(gt in _iq_grid_types() for _, gt, _ in tensors.values()):
        from .iq_quants import IQ_GRIDS_META_KEY, grids_fingerprint

        if IQ_GRIDS_META_KEY not in metadata:
            metadata = {**metadata, IQ_GRIDS_META_KEY: grids_fingerprint()}
    head = bytearray()
    head += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(tensors), len(metadata))
    for k, v in metadata.items():
        head += _pack_string(k)
        t, payload = _pack_value(v)
        head += struct.pack("<I", t) + payload

    offset = 0
    raws = []
    for name, (data, gt, shape) in tensors.items():
        raw = _tensor_raw(data, gt)
        aligned = (offset + alignment - 1) // alignment * alignment
        head += _pack_string(name)
        dims = list(reversed(shape))  # row-major → GGUF innermost-first
        head += struct.pack("<I", len(dims))
        for d in dims:
            head += struct.pack("<Q", d)
        head += struct.pack("<IQ", int(gt), aligned)
        raws.append((aligned, raw))
        offset = aligned + len(raw)

    data_start = (len(head) + alignment - 1) // alignment * alignment
    head += b"\x00" * (data_start - len(head))
    with open(path, "wb") as f:
        f.write(head)
        pos = 0
        for toff, raw in raws:
            f.write(b"\x00" * (toff - pos))
            f.write(raw)
            pos = toff + len(raw)
