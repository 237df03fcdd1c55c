"""Quantized matmul dispatch.

Counterpart of ``blazr_tpu/quant/matmul.py::quant_matmul``, routed in the JAX
package's order (:55-96):

  1. the GPTQ desc-act permutation is gathered on the activation side;
  2. a tensor tagged for int8 activations (``act_quant``) with at least
     ``act_quant_min_m`` rows goes to kernel B3 (``int8.qmm_int8``);
  3. with ``BLAZR_TPU_STREAM_KERNEL=1``, a decode-shaped matmul (m <= 32) on
     signed 4/8-bit weights goes to kernel B4 (``kernels.qmm_stream``);
  4. everything else goes to kernel B1 (``kernels.qmm``).

B3 and B4 take only the geometries the JAX package tiles: the acceptance
predicate of ``_choose_tiles`` (int_matmul.py:428-451) is written out in
``tile_k``, so a shape the JAX package would not tile goes to B1 in both
packages. This is the JAX dispatch rule, not a fallback: no kernel error is
caught and retried on another path. The route does not depend on the
platform: B3 is taken wherever a tensor is tagged (the plain version on the
CPU), and the knob is read on every call, never latched. The JAX stream
branch also checks a TPU scratch-memory budget (:483-488); it describes the
TPU's 100 MB VMEM and is left out (ROADMAP §C).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .int8 import qmm_int8
from .kernels import STREAM_MAX_ROWS, qmm, qmm_stream
from .qtensor import QuantTensor


def tile_k(k: int, n: int, bits: int, group_size: int) -> Optional[int]:
    """The K tile ``bk`` the JAX package's ``_choose_tiles`` would pick, or
    None where it tiles nothing: the first of 512, 256, 128 that divides K
    and is a multiple of the group size (and of the rows per word), with N a
    multiple of 128."""
    r = 32 // bits
    if n % 128:
        return None
    for bk in (512, 256, 128):
        if k % bk == 0 and bk % r == 0 and bk % group_size == 0:
            return bk
    return None


def quant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x [..., K] @ W_logical [K, N] → [..., N]`` on the device ``qt``
    lives on."""
    if qt.perm is not None:
        x = x.index_select(-1, qt.perm)
    lead = x.shape[:-1]
    k, n = qt.in_features, qt.out_features
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    bk = tile_k(k, n, qt.bits, qt.group_size)
    kw = dict(bits=qt.bits, group_size=qt.group_size, device=qt.device)
    if qt.act_quant and m >= qt.act_quant_min_m and bk is not None:
        y = qmm_int8(x2, qt.qweight, qt.scales, qt.mins, **kw)
    elif (os.environ.get("BLAZR_TPU_STREAM_KERNEL") == "1"     # read per call
          and m <= STREAM_MAX_ROWS and qt.signed
          and qt.bits in (4, 8) and bk is not None and k // bk >= 2):
        y = qmm_stream(x2, qt.qweight, qt.scales, qt.mins, **kw)
    else:
        y = qmm(x2, qt.qweight, qt.scales, qt.mins, signed=qt.signed, **kw)
    return y.reshape(*lead, n)
