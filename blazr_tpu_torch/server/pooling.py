"""Embedding pooling strategies.

Copy of ``blazr_tpu/server/pooling.py``, the reference pooling module
(src/server/pooling.rs): mean / cls / last / none pooling with optional L2
normalization.
"""

from __future__ import annotations

import numpy as np


def pool(embeddings: np.ndarray, strategy: str = "mean",
         normalize: bool = True) -> np.ndarray:
    """[T, H] token embeddings → pooled vector (or matrix for 'none')."""
    if embeddings.ndim != 2:
        raise ValueError(f"expected [T, H], got {embeddings.shape}")
    if strategy == "mean":
        out = embeddings.mean(axis=0)
    elif strategy == "cls":
        out = embeddings[0]
    elif strategy == "last":
        out = embeddings[-1]
    elif strategy == "none":
        out = embeddings
    else:
        raise ValueError(f"unknown pooling strategy {strategy!r}")
    if normalize:
        if out.ndim == 1:
            n = np.linalg.norm(out)
            out = out / n if n > 0 else out
        else:
            n = np.linalg.norm(out, axis=-1, keepdims=True)
            out = np.where(n > 0, out / np.maximum(n, 1e-12), out)
    return out
