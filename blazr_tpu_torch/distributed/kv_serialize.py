"""KV-cache and tensor wire serialization.

The port's own copy of ``blazr_tpu/distributed/kv_serialize.py``: a
hand-rolled little-endian format (not pickle: payloads cross the network),
used by the disaggregated prefill→decode KV transfer and the swarm's
activations:

    [u32 n_arrays] then per array:
    [u8 dtype_code][u8 ndim][u64 dims...][u64 nbytes][raw bytes]

The dtype codes are the JAX package's (f32 0, f16 1, i32 2, i64 3, u32 4,
u8 5, bool 6, bf16 7), so equal arrays give equal bytes. The port adds int8
(8): an int8 KV cache's values, which the JAX serializer refuses. Arrays go
in as numpy arrays or torch tensors and come out as CPU torch tensors
(numpy has no bfloat16 without ml_dtypes, which the port does not use).
"""

from __future__ import annotations

import struct
from typing import Sequence, Union

import numpy as np
import torch

_NAMES = ("float32", "float16", "int32", "int64", "uint32", "uint8", "bool", "bfloat16",
          "int8")
_TORCH = {"float32": torch.float32, "float16": torch.float16, "int32": torch.int32,
          "int64": torch.int64, "uint32": torch.uint32, "uint8": torch.uint8,
          "bool": torch.bool, "bfloat16": torch.bfloat16, "int8": torch.int8}
_CODE = {name: i for i, name in enumerate(_NAMES)}

MAX_KV_TRANSFER_BYTES = 2 << 30   # reference cap 2 GiB (disaggregated.rs:93)

Array = Union[np.ndarray, torch.Tensor]


def _raw(a: Array) -> tuple[str, tuple[int, ...], bytes]:
    """(dtype name, shape, little-endian bytes) of an array or tensor."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name not in _CODE:
            raise TypeError(f"unsupported dtype {t.dtype}")
        return name, tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(a)
    if a.dtype.name not in _CODE:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return a.dtype.name, a.shape, a.tobytes()


def serialize_arrays(arrays: Sequence[Array], max_bytes: int = MAX_KV_TRANSFER_BYTES) -> bytes:
    out = bytearray(struct.pack("<I", len(arrays)))
    total = 0
    for a in arrays:
        name, shape, raw = _raw(a)
        total += len(raw)
        if total > max_bytes:
            raise ValueError(
                f"KV transfer exceeds cap: {total} > {max_bytes} bytes")
        out += struct.pack("<BB", _CODE[name], len(shape))
        out += struct.pack(f"<{len(shape)}Q", *shape)
        out += struct.pack("<Q", len(raw))
        out += raw
    return bytes(out)


def deserialize_arrays(data: bytes) -> list[torch.Tensor]:
    (n,) = struct.unpack_from("<I", data, 0)
    pos = 4
    out = []
    for _ in range(n):
        code, ndim = struct.unpack_from("<BB", data, pos)
        pos += 2
        shape = struct.unpack_from(f"<{ndim}Q", data, pos)
        pos += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        raw = bytearray(data[pos:pos + nbytes])
        pos += nbytes
        t = torch.frombuffer(raw, dtype=torch.uint8) if nbytes else torch.empty(0, dtype=torch.uint8)
        out.append(t.view(_TORCH[_NAMES[code]]).reshape(shape))
    return out


def serialize_kv_cache(cache) -> bytes:
    """A contiguous ``KVCache`` → bytes (reference serialize_kv_cache):
    k, v and the int32 lengths, then the scale planes of a quantized cache
    (3 arrays: a float cache; 5: a quantized one)."""
    arrays = [cache.k, cache.v, cache.length.to(torch.int32)]
    if cache.k_scale is not None:
        arrays += [cache.k_scale, cache.v_scale]
    return serialize_arrays(arrays)


def deserialize_kv_cache(data: bytes, device=None):
    """bytes → a ``KVCache`` on ``device`` (default the CPU); a uint8 cache
    is int4 KV (two values a byte), an int8 one int8 KV."""
    from ..kvcache.contiguous import KVCache

    arrays = [a.to(device) if device is not None else a for a in deserialize_arrays(data)]
    k, v, length = arrays[:3]
    cache = KVCache(k=k, v=v, length=length.to(torch.int32))
    if len(arrays) == 5:
        cache.k_scale, cache.v_scale = arrays[3], arrays[4]
        cache.qmax = 7.0 if k.dtype == torch.uint8 else 127.0
    return cache
