"""Layered recurrent state of Mamba2 models.

Counterpart of ``blazr_tpu/kvcache/ssm_state.py`` (``SSMState`` :21,
``init_ssm_state`` :38) with the same layout, both f32:

    conv: [L, B, conv_dim, conv_kernel - 1]   the causal conv's rolling window
    ssm:  [L, B, num_heads, head_dim, state_size]

O(1) in the sequence length. Unlike the JAX pytree, the forwards write the
tensors IN PLACE, so a captured decode graph holds them. A Mamba3 mixer's
conv buffer (JAX :45-55) is (x|B|C) widened by the MIMO rank, with one
column for the previous token's post-activation (x|B), after the conv
window when ``use_conv`` is on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config.model_config import UniversalConfig
from ..utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class SSMState:
    conv: torch.Tensor      # [L, B, conv_dim, conv_kernel - 1] f32
    ssm: torch.Tensor       # [L, B, num_heads, head_dim, state_size] f32
    length: torch.Tensor    # [B] int32 tokens absorbed so far

    @property
    def num_layers(self) -> int:
        return self.conv.shape[0]

    def reset_(self) -> "SSMState":
        """Zero every row in place (a new sequence starts from zero state)."""
        self.conv.zero_()
        self.ssm.zero_()
        self.length.zero_()
        return self


def init_ssm_state(cfg: UniversalConfig, batch: int,
                   num_layers: Optional[int] = None,
                   device: DeviceLike = None) -> SSMState:
    ssm = cfg.ssm
    assert ssm is not None
    dev = resolve_device(device)
    conv_dim = ssm.inner_size + 2 * ssm.n_groups * ssm.state_size
    cols = ssm.conv_kernel - 1
    if ssm.variant == "mamba3":
        from ..models.mamba2 import _m3, _m3_widths

        _, x_w, b_w, c_w = _m3_widths(ssm)
        conv_dim = x_w + b_w + c_w
        cols = (ssm.conv_kernel - 1 if _m3(ssm)["conv"] else 0) + 1
    layers = num_layers if num_layers is not None else cfg.num_layers
    return SSMState(
        conv=torch.zeros((layers, batch, conv_dim, cols),
                         dtype=torch.float32, device=dev),
        ssm=torch.zeros((layers, batch, ssm.num_heads, ssm.head_dim, ssm.state_size),
                        dtype=torch.float32, device=dev),
        length=torch.zeros((batch,), dtype=torch.int32, device=dev))
