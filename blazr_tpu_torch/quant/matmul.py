"""Quantized matmul dispatch.

Counterpart of ``blazr_tpu/quant/matmul.py::quant_matmul``: the GPTQ
desc-act permutation is gathered on the activation side, then kernel B1
(``kernels.qmm``) computes the product. The JAX package falls back to a
dequantize-and-dot for shapes its Pallas tiles cannot cover; B1 masks its
own ragged edges, so there is no fallback to take.
"""

from __future__ import annotations

import torch

from .kernels import qmm
from .qtensor import QuantTensor


def quant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x [..., K] @ W_logical [K, N] → [..., N]`` on the device ``qt``
    lives on."""
    if qt.perm is not None:
        x = x.index_select(-1, qt.perm)
    lead = x.shape[:-1]
    y = qmm(x.reshape(-1, qt.in_features).contiguous(), qt.qweight, qt.scales,
            qt.mins, bits=qt.bits, signed=qt.signed, group_size=qt.group_size,
            device=qt.device)
    return y.reshape(*lead, qt.out_features)
