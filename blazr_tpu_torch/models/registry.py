"""Model handle.

Counterpart of ``blazr_tpu/models/registry.py::Model`` (:266): the config,
the params and their dtype. Checkpoint loading comes in a later slice
(ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config.model_config import UniversalConfig


@dataclasses.dataclass
class Model:
    cfg: UniversalConfig
    params: dict[str, Any]
    dtype: torch.dtype

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @property
    def vocab_size(self) -> int:
        return self.cfg.vocab_size
