"""Model registry: UniversalConfig + VarMap → Model handle.

Counterpart of ``blazr_tpu/models/registry.py``: ``ParamBuilder`` (:45),
``build_llama_layer_params`` (:66), ``build_llama_params`` (:245),
``build_model`` (:342) and the ``Model`` handle (:266): the config, the
params on the device in the model's dtype, and the contiguous-cache forward
(``llama.forward`` unless another is given), with the introspection and
cache helpers the ``Executor``, the ``BatchEngine`` and ``utils.ppl`` use.
``build_model`` serves the llama and mistral families; the others raise
(ROADMAP queue A item 11).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Optional

import torch

from ..config.model_config import UniversalConfig
from ..kvcache.contiguous import KVCache, init_kv_cache
from ..quant.qtensor import QuantTensor
from ..utils.device import DeviceLike, resolve_device

if TYPE_CHECKING:  # avoids the loader <-> models import cycle
    from ..loader.varmap import VarMap

# Families whose checkpoints build_model serves (the llama layout).
SERVED_FAMILIES = ("llama", "mistral")


def _place(w, dtype: torch.dtype, device: torch.device, transpose: bool = False):
    """VarMap weight → device tensor. Dense [out, in] transposes to
    [in, out]; QuantTensors are already canonical [in, out] and only move."""
    if w is None:
        return None
    if isinstance(w, QuantTensor):
        return dataclasses.replace(
            w, qweight=w.qweight.to(device), scales=w.scales.to(device),
            mins=w.mins.to(device), perm=None if w.perm is None else w.perm.to(device))
    t = w.t() if transpose and w.dim() == 2 else w
    return t.to(device=device, dtype=dtype).contiguous()


class ParamBuilder:
    """Helper around VarMap with fallback names and device placement."""

    def __init__(self, vm: "VarMap", dtype: torch.dtype, device: torch.device):
        self.vm = vm
        self.dtype = dtype
        self.device = device

    def get(self, *names: str, transpose: bool = False, required: bool = True,
            dtype: Optional[torch.dtype] = None):
        for n in names:
            if n in self.vm:
                return _place(self.vm.take(n), dtype or self.dtype, self.device,
                              transpose)
        if required:
            raise KeyError(f"Missing tensor (tried {names})")
        return None


def build_llama_layer_params(pb: ParamBuilder, i: int, cfg: UniversalConfig) -> dict:
    """One decoder layer of the llama layout (HF names): separate or fused
    q/k/v, gated MLP, optional biases and q/k norms."""
    p = f"model.layers.{i}."
    out: dict[str, Any] = {
        "input_norm": pb.get(p + "input_layernorm.weight"),
        "post_norm": pb.get(p + "post_attention_layernorm.weight"),
        "o": pb.get(p + "self_attn.o_proj.weight", p + "self_attn.dense.weight",
                    transpose=True),
    }
    qkv = pb.get(p + "self_attn.qkv_proj.weight", transpose=True, required=False)
    if qkv is not None:
        out["qkv"] = qkv
    else:
        out["q"] = pb.get(p + "self_attn.q_proj.weight", transpose=True)
        out["k"] = pb.get(p + "self_attn.k_proj.weight", transpose=True)
        out["v"] = pb.get(p + "self_attn.v_proj.weight", transpose=True)
    gu = pb.get(p + "mlp.gate_up_proj.weight", transpose=True, required=False)
    if gu is not None:
        out["gateup"] = gu
        out["down"] = pb.get(p + "mlp.down_proj.weight", transpose=True)
    else:
        out["gate"] = pb.get(p + "mlp.gate_proj.weight", transpose=True)
        out["up"] = pb.get(p + "mlp.up_proj.weight", transpose=True)
        out["down"] = pb.get(p + "mlp.down_proj.weight", transpose=True)
    for side in ("q", "k", "v", "o"):
        b = pb.get(p + f"self_attn.{side}_proj.bias", required=False)
        if b is not None:
            out[f"{side}_bias"] = b
    qn = pb.get(p + "self_attn.q_norm.weight", required=False)
    if qn is not None:
        out["q_norm"] = qn
        out["k_norm"] = pb.get(p + "self_attn.k_norm.weight")
    return out


def build_llama_params(cfg: UniversalConfig, vm: "VarMap", dtype: torch.dtype,
                       device: torch.device) -> dict:
    pb = ParamBuilder(vm, dtype, device)
    params: dict[str, Any] = {
        "embed": pb.get("model.embed_tokens.weight", "embed_tokens.weight"),
        "final_norm": pb.get("model.norm.weight"),
        "layers": [build_llama_layer_params(pb, i, cfg) for i in range(cfg.num_layers)],
    }
    params["lm_head"] = pb.get("lm_head.weight", transpose=True, required=False)
    if params["lm_head"] is None and not cfg.tie_word_embeddings:
        cfg.tie_word_embeddings = True
    return params


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
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

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


def build_model(cfg: UniversalConfig, vm: "VarMap", dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Model:
    """Resolve the architecture, build the params on ``device`` (default
    ``cuda``) and return the Model handle."""
    dev = resolve_device(device)
    if (cfg.model_type not in SERVED_FAMILIES or cfg.ssm is not None or cfg.moe is not None
            or cfg.hybrid_layers or cfg.attention is None or cfg.attention.is_mla):
        raise NotImplementedError(
            f"model family {cfg.model_type!r} is not served by blazr_tpu_torch yet "
            f"(it serves {', '.join(SERVED_FAMILIES)}; ROADMAP queue A item 11)")
    return Model(cfg, build_llama_params(cfg, vm, dtype, dev), dtype)
