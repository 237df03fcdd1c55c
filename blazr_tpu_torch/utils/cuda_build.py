"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``csrc/_build/lib<name>-<hash>.so`` (the hash covers
the source, every ``csrc/`` header it includes with ``#include "..."``, and
the flags, so an edited source or header is rebuilt). The build
directory is listed in ``.gitignore``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly or
    through another header, in a fixed order."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> tuple[Path, subprocess.Popen | None, Path]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if out.exists():
        return out, None, tmp
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish_build(name: str, out: Path, proc, tmp: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)                 # atomic: concurrent builders agree
    return log


def build_all(names: list[str]) -> dict[str, str]:
    """Compile every named source in parallel (one nvcc each, all started
    together) and return each build's compiler log ('' when cached)."""
    started = {n: _start_build(n) for n in names}
    return {n: _finish_build(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, proc, tmp = _start_build(name)
            _finish_build(name, out, proc, tmp)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib
