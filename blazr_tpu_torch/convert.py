"""Carry the JAX package's param tree over to the port.

``params_from_jax`` takes a ``blazr_tpu`` param tree whose arrays were
turned into numpy arrays by the caller (``QuantTensor`` fields included;
tests do this with ``np.asarray`` on the JAX side) and builds the port's
params from it, so that both packages compute with bit-identical weights.
Nothing of JAX is imported: a quantized leaf is recognised by its fields.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .quant.qtensor import QuantTensor, words_to_torch
from .utils.device import DeviceLike, resolve_device

_QT_FIELDS = ("qweight", "scales", "mins", "perm", "bits", "group_size",
              "signed", "in_features", "out_features", "fmt")


def _tensor(a, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    t = t.to(device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def _is_quant(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in _QT_FIELDS)


def params_from_jax(tree: Any, *, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a (numpy-leaved) JAX param tree: dicts, lists and
    QuantTensor-like leaves. Float arrays keep their dtype unless ``dtype``
    is given; QuantTensor planes stay int32 words and float32 scales."""
    dev = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=dev, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device=dev, dtype=dtype) for v in tree)
    if _is_quant(tree):                       # 2-D, or a stacked [E] expert weight
        return QuantTensor(
            qweight=words_to_torch(np.asarray(tree.qweight), dev),
            scales=_tensor(tree.scales, dev, torch.float32),
            mins=_tensor(tree.mins, dev, torch.float32),
            perm=None if tree.perm is None else _tensor(
                np.asarray(tree.perm, np.int32), dev, None),
            bits=int(tree.bits), group_size=int(tree.group_size),
            signed=bool(tree.signed), in_features=int(tree.in_features),
            out_features=int(tree.out_features), fmt=str(tree.fmt),
            act_quant=bool(getattr(tree, "act_quant", False)),
            act_quant_min_m=int(getattr(tree, "act_quant_min_m", 0)))
    return _tensor(tree, dev, dtype)
