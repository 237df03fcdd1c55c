"""Embedding wire encodings (float list / base64).

Counterpart of ``blazr_tpu/server/encoding.py``, the reference encoding
module (src/server/encoding.rs); the server only encodes.
"""

from __future__ import annotations

import base64

import numpy as np


def encode_embedding(vec: np.ndarray, fmt: str = "float"):
    if fmt == "float":
        return [float(x) for x in vec]
    if fmt == "base64":
        return base64.b64encode(np.asarray(vec, dtype=np.float32).tobytes()).decode("ascii")
    raise ValueError(f"unknown encoding_format {fmt!r}")

