"""SafeTensors reader and writer, written against the public format spec.

Counterpart of ``blazr_tpu/formats/safetensors.py``: open single-file or
sharded checkpoints, list tensors, query shapes/dtypes, and read tensor
data zero-copy via mmap. Without ``ml_dtypes``, 16-bit brain floats (and
the fp8 types) are read as their raw unsigned integers in numpy and
reinterpreted as ``torch.bfloat16`` (``torch.float8_*``) by ``load_torch``.

Format: ``[u64 little-endian header_len][JSON header][raw data]`` where the
JSON maps tensor name → {"dtype", "shape", "data_offsets": [begin, end]}
(offsets relative to the end of the header). A ``__metadata__`` key holds
string metadata.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

_ST_DTYPES: dict[str, np.dtype] = {
    "F64": np.dtype(np.float64),
    "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "I64": np.dtype(np.int64),
    "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "U16": np.dtype(np.uint16),
    "U32": np.dtype(np.uint32),
    "U64": np.dtype(np.uint64),
    "BOOL": np.dtype(np.bool_),
}
# Types numpy lacks: raw bits in numpy, the real type in torch.
_RAW_BITS: dict[str, tuple[np.dtype, torch.dtype]] = {
    "BF16": (np.dtype(np.uint16), torch.bfloat16),
    "F8_E4M3": (np.dtype(np.uint8), torch.float8_e4m3fn),
    "F8_E5M2": (np.dtype(np.uint8), torch.float8_e5m2),
}
_SIGNED_VIEW = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.int8}


class TensorInfo:
    """Shape/dtype/size description of one stored tensor."""

    __slots__ = ("name", "dtype_str", "shape", "data_offsets", "shard")

    def __init__(self, name: str, dtype_str: str, shape: list[int],
                 data_offsets: tuple[int, int], shard: Path):
        self.name = name
        self.dtype_str = dtype_str
        self.shape = tuple(shape)
        self.data_offsets = data_offsets
        self.shard = shard

    @property
    def numpy_dtype(self) -> np.dtype:
        """The numpy dtype; the raw unsigned bits for BF16 and the fp8 types."""
        if self.dtype_str in _RAW_BITS:
            return _RAW_BITS[self.dtype_str][0]
        try:
            return _ST_DTYPES[self.dtype_str]
        except KeyError:
            raise ValueError(f"Unsupported safetensors dtype {self.dtype_str!r}") from None

    @property
    def size_bytes(self) -> int:
        return self.data_offsets[1] - self.data_offsets[0]

    def __repr__(self) -> str:  # pragma: no cover
        return f"TensorInfo({self.name!r}, {self.dtype_str}, {self.shape})"


class _ShardFile:
    """One mmap'd .safetensors file."""

    def __init__(self, path: Path):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        (header_len,) = struct.unpack_from("<Q", self._mm, 0)
        if header_len > len(self._mm) - 8:
            raise ValueError(f"{path}: corrupt safetensors header length {header_len}")
        header = json.loads(self._mm[8 : 8 + header_len].decode("utf-8"))
        self.metadata: dict[str, str] = header.pop("__metadata__", {})
        self.data_start = 8 + header_len
        self.tensors: dict[str, TensorInfo] = {}
        for name, ent in header.items():
            self.tensors[name] = TensorInfo(
                name, ent["dtype"], ent["shape"],
                (ent["data_offsets"][0], ent["data_offsets"][1]), path,
            )

    def read_bytes(self, info: TensorInfo) -> memoryview:
        b, e = info.data_offsets
        return memoryview(self._mm)[self.data_start + b : self.data_start + e]

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # Zero-copy numpy views of the mmap are still alive; the map is
            # reclaimed when they are garbage-collected.
            pass
        self._file.close()


class SafeTensorsReader:
    """Unified single-file / sharded safetensors reader.

    ``path`` may be a ``.safetensors`` file, a sharded
    ``model.safetensors.index.json``, or a directory containing either.
    """

    def __init__(self, path: str | Path):
        path = Path(path)
        self._shards: dict[Path, _ShardFile] = {}
        self._index: dict[str, Path] = {}
        self.metadata: dict[str, str] = {}

        files = self._resolve_files(path)
        if not files:
            raise FileNotFoundError(f"No safetensors files found at {path}")
        for f in files:
            shard = _ShardFile(f)
            self._shards[f] = shard
            self.metadata.update(shard.metadata)
            for name in shard.tensors:
                self._index[name] = f

    @staticmethod
    def _resolve_files(path: Path) -> list[Path]:
        if path.is_file():
            if path.suffix == ".json":  # index file
                with open(path) as f:
                    index = json.load(f)
                base = path.parent
                return sorted({base / v for v in index["weight_map"].values()})
            return [path]
        if path.is_dir():
            idx = path / "model.safetensors.index.json"
            if idx.exists():
                return SafeTensorsReader._resolve_files(idx)
            single = path / "model.safetensors"
            if single.exists():
                return [single]
            return sorted(path.glob("*.safetensors"))
        return []

    # ---- introspection (mirrors boostr SafeTensorsLoader surface) --------
    def tensor_names(self) -> list[str]:
        return sorted(self._index.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def tensor_info(self, name: str) -> TensorInfo:
        try:
            shard_path = self._index[name]
        except KeyError:
            raise KeyError(f"Tensor {name!r} not found") from None
        return self._shards[shard_path].tensors[name]

    @property
    def is_sharded(self) -> bool:
        return len(self._shards) > 1

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def total_size(self) -> int:
        return sum(
            info.size_bytes for s in self._shards.values() for info in s.tensors.values()
        )

    # ---- data access -----------------------------------------------------
    def read_tensor_bytes(self, name: str) -> memoryview:
        """Zero-copy view of the raw little-endian tensor bytes."""
        info = self.tensor_info(name)
        return self._shards[info.shard].read_bytes(info)

    def load_numpy(self, name: str, dtype: Optional[np.dtype] = None) -> np.ndarray:
        """Load a tensor as a numpy array (zero-copy view when possible).

        ``dtype`` reinterprets the raw bytes (e.g. read int32-packed AWQ
        qweight as uint32), matching the reference's Storage::from_bytes
        reinterpretation (src/loader/safetensors/awq.rs:190-196).
        """
        info = self.tensor_info(name)
        raw = self.read_tensor_bytes(name)
        np_dtype = dtype if dtype is not None else info.numpy_dtype
        arr = np.frombuffer(raw, dtype=np_dtype)
        if dtype is None:
            arr = arr.reshape(info.shape)
        else:
            # Reinterpretation keeps element count consistent with byte size.
            n = info.size_bytes // np.dtype(np_dtype).itemsize
            arr = arr.reshape(self._reinterp_shape(info.shape, n))
        return arr

    @staticmethod
    def _reinterp_shape(shape: tuple[int, ...], total: int) -> tuple[int, ...]:
        if not shape:
            return (total,)
        lead = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        if lead and total % lead == 0:
            return (*shape[:-1], total // lead)
        return (total,)

    def load_torch(self, name: str) -> torch.Tensor:
        """Load a tensor as a CPU torch tensor of its stored type (a copy;
        BF16 and fp8 are reinterpreted from their raw bits)."""
        info = self.tensor_info(name)
        arr = np.array(self.load_numpy(name))
        if info.dtype_str in _RAW_BITS:
            raw, tdt = _RAW_BITS[info.dtype_str]
            return torch.from_numpy(arr.view(_SIGNED_VIEW[raw])).view(tdt)
        return torch.from_numpy(arr)

    def items(self) -> Iterator[tuple[str, TensorInfo]]:
        for name in self.tensor_names():
            yield name, self.tensor_info(name)

    def close(self) -> None:
        for s in self._shards.values():
            s.close()

    def __enter__(self) -> "SafeTensorsReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_TORCH_TO_ST = {torch.bfloat16: "BF16", torch.float8_e4m3fn: "F8_E4M3",
                torch.float8_e5m2: "F8_E5M2"}


def write_safetensors(path: str | Path, tensors: dict,
                      metadata: Optional[dict[str, str]] = None) -> None:
    """Write a single safetensors file from numpy arrays or torch tensors
    (torch ``bfloat16`` and fp8 tensors are stored as BF16 / F8_*)."""
    _NP_TO_ST = {v: k for k, v in _ST_DTYPES.items()}
    header: dict = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    payload: list[bytes] = []
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            t = arr.detach().cpu().contiguous()
            dt = _TORCH_TO_ST.get(t.dtype)
            if dt is not None:
                arr = t.view(torch.int16 if t.element_size() == 2 else torch.int8).numpy()
            else:
                arr = t.numpy()
                dt = _NP_TO_ST.get(arr.dtype)
        else:
            arr = np.ascontiguousarray(arr)
            dt = _NP_TO_ST.get(arr.dtype)
        arr = np.ascontiguousarray(arr)
        if dt is None:
            raise ValueError(f"Unsupported dtype {arr.dtype} for tensor {name!r}")
        nbytes = arr.nbytes
        header[name] = {
            "dtype": dt,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        payload.append(arr.tobytes())
        offset += nbytes
    header_bytes = json.dumps(header).encode("utf-8")
    # Pad header to 8-byte alignment like the canonical writer.
    pad = (8 - len(header_bytes) % 8) % 8
    header_bytes += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for chunk in payload:
            f.write(chunk)
