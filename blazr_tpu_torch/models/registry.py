"""Model handle.

Counterpart of ``blazr_tpu/models/registry.py::Model`` (:266): the config,
the params, their dtype and the contiguous-cache forward (``llama.forward``
unless another is given), with the introspection and cache helpers the
single-stream ``Executor`` and ``utils.ppl`` use. Checkpoint loading comes
in a later slice (ROADMAP queue A item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..config.model_config import UniversalConfig
from ..kvcache.contiguous import KVCache, init_kv_cache


@dataclasses.dataclass
class Model:
    cfg: UniversalConfig
    params: dict[str, Any]
    dtype: torch.dtype
    # forward_fn(params, cfg, tokens, cache, positions, seq_lens) →
    # (logits [B, T, V] float32, cache); None = llama.forward.
    forward_fn: Optional[Callable[..., tuple[torch.Tensor, Any]]] = None

    def __post_init__(self) -> None:
        if self.forward_fn is None:
            from .llama import forward

            self.forward_fn = forward

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    @property
    def vocab_size(self) -> int:
        return self.cfg.vocab_size

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.attention.kv_heads() if self.cfg.attention else 0

    @property
    def head_dim(self) -> int:
        if self.cfg.attention is None:
            return 0
        return self.cfg.attention.resolved_head_dim(self.cfg.hidden_size)

    @property
    def needs_ssm_state(self) -> bool:
        return self.cfg.needs_ssm_state

    @property
    def needs_kv_cache(self) -> bool:
        return self.cfg.needs_kv_cache

    def init_cache(self, batch: int, capacity: int, kv_quant: bool = False,
                   kv_dtype: str = "int8") -> KVCache:
        """Contiguous KV cache on the params' device (int8 or int4 values
        with scales when ``kv_quant``). Recurrent-state and MLA caches come
        with their families (ROADMAP queue A item 11)."""
        if self.needs_ssm_state or self.cfg.attention is None or self.cfg.attention.is_mla:
            raise NotImplementedError(
                f"{self.cfg.model_type!r} caches are not ported yet "
                "(ROADMAP queue A item 11)")
        return init_kv_cache(self.num_layers, batch, capacity, self.num_kv_heads,
                             self.head_dim, dtype=self.dtype, quantized=kv_quant,
                             kv_dtype=kv_dtype, device=self.device)

    def forward(self, tokens: torch.Tensor, cache: Any, positions: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None):
        return self.forward_fn(self.params, self.cfg, tokens, cache, positions,
                               seq_lens)
