r"""ctypes binding of the C++ BPE core (``native/bpe.cpp``).

Counterpart of ``blazr_tpu/native/bpe_binding.py``. ``NativeBpe`` holds a
rank table in the library: ``encode_pieces`` merges pre-tokenized pieces in
one call, and ``encode_text`` pre-tokenizes and merges in one call for the
GPT-2 pattern (mode 0) and the cl100k/llama3 pattern (mode 1), the two the
C++ scanner replicates.

The scanner reads each code point's class from a table: 0 other, 1 letter,
2 number, 3 whitespace. The JAX package builds it with the ``regex``
package, which the card's machine lacks; here it comes from ``unicodedata``'s
general categories (L*, N*) and the Unicode White_Space list, the classes
``bpe.compile_pattern`` gives ``\p{L}``, ``\p{N}`` and ``\s``, so the native
and the Python paths agree. The table is cached in ``native/_build/``,
keyed by ``unicodedata``'s Unicode version, written atomically. A failed
build or load raises (``native.load_library``): nothing falls back to
Python.
"""

from __future__ import annotations

import ctypes
import os
import struct
import unicodedata
from typing import Optional

import numpy as np

from .. import native

_u32p = ctypes.POINTER(ctypes.c_uint32)
_cats: Optional[np.ndarray] = None


def unicode_class_table() -> np.ndarray:
    """[0x110000] uint8: 1 letter, 2 number, 3 whitespace, 0 other."""
    global _cats
    if _cats is not None:
        return _cats
    path = native.BUILD_DIR / f"unicode_classes-{unicodedata.unidata_version}.npy"
    if path.exists():
        t = np.load(path)
        if t.shape == (0x110000,) and t.dtype == np.uint8:
            _cats = t
            return t
    from .bpe import _CATS, WHITE_SPACE, _categories

    cat = np.frombuffer(_categories(), dtype=np.uint8)
    lut = np.zeros(len(_CATS), dtype=np.uint8)
    lut[[i for i, c in enumerate(_CATS) if c[0] == "L"]] = 1
    lut[[i for i, c in enumerate(_CATS) if c[0] == "N"]] = 2
    t = lut[cat]
    for a, b in WHITE_SPACE:
        t[a:b + 1] = 3
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
    np.save(tmp, t)
    os.replace(tmp, path)
    _cats = t
    return t


class NativeBpe:
    """One rank table in the C++ core."""

    def __init__(self, ranks: dict[bytes, int]):
        lib = self._lib = native.load_library("bpe")
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.bpe_encode_batch.restype = ctypes.c_int64
        lib.bpe_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, _u32p, ctypes.c_uint64]
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_cats_new.restype = ctypes.c_void_p
        lib.bpe_cats_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.bpe_cats_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode_text.restype = ctypes.c_int64
        lib.bpe_encode_text.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_int32, _u32p, ctypes.c_uint64]
        self._handle = None
        self._cats = None
        blob = bytearray(struct.pack("<I", len(ranks)))
        for tok, tid in ranks.items():
            if len(tok) <= 0xFFFF:
                blob += struct.pack("<H", len(tok)) + tok + struct.pack("<I", tid)
        self._handle = lib.bpe_new(bytes(blob), len(blob))
        if not self._handle:
            raise RuntimeError("bpe_new failed")

    def enable_pretokenizer(self) -> None:
        """Load the code-point class table, so that ``encode_text`` covers
        pre-tokenization too."""
        if self._cats is None:
            table = unicode_class_table().tobytes()
            self._cats = self._lib.bpe_cats_new(table, len(table))
            if not self._cats:
                raise RuntimeError("bpe_cats_new failed")

    def encode_pieces(self, pieces: list[bytes]) -> list[int]:
        """Merge each pre-tokenized piece; one call for all of them."""
        text = b"".join(pieces)
        offsets = np.zeros(len(pieces) + 1, dtype=np.uint64)
        np.cumsum([len(p) for p in pieces], out=offsets[1:])
        cap = max(16, len(text) + 4 * len(pieces))
        out = (ctypes.c_uint32 * cap)()
        n = self._lib.bpe_encode_batch(
            self._handle, text, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(pieces), out, cap)
        if n < 0:
            raise RuntimeError("bpe output overflow")
        return list(out[:n])

    def encode_text(self, text: bytes, mode: int) -> list[int]:
        """Pre-tokenize and merge ``text``: mode 0 the GPT-2 pattern, 1 the
        cl100k/llama3 pattern."""
        cap = max(16, len(text) + 8)
        out = (ctypes.c_uint32 * cap)()
        n = self._lib.bpe_encode_text(self._handle, self._cats, text, len(text), mode,
                                      out, cap)
        if n < 0:
            raise RuntimeError("bpe output overflow")
        return list(out[:n])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_free(self._handle)
        if getattr(self, "_cats", None):
            self._lib.bpe_cats_free(self._cats)
