"""Native (C++) host libraries of the port, built with g++ on first use.

``pda.cpp`` is the port's copy of ``blazr_tpu/native/pda.cpp``: the exact
pushdown automaton of the grammar tier (``engine/grammar_pda.py``).
``jpeg.cpp`` is the port's baseline JPEG decoder (``utils/preprocess.py``;
the JAX package decodes images with Pillow). ``bpe.cpp`` is the port's copy
of ``blazr_tpu/native/bpe.cpp``: the BPE merge core and pre-tokenizer of
``tokenizer/bpe.py`` (``tokenizer/bpe_native.py``). Each is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` into
``native/_build/lib<name>-<hash>.so`` (the hash covers the source and the
flags; the directory is listed in ``.gitignore``) and loaded with
``ctypes``. A build or load that fails raises: nothing falls back to a
Python path. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """``native/<name>.cpp`` compiled (once; a cached build is reused)."""
    out = lib_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: native/{name}.cpp cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)                 # atomic: concurrent builders agree
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
