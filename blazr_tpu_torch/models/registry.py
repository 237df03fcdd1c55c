"""Model registry: UniversalConfig + VarMap → Model handle.

Counterpart of ``blazr_tpu/models/registry.py``: ``ParamBuilder`` (:45),
``build_llama_layer_params`` (:66), ``_split_falcon_qkv`` (:136),
``build_falcon_params`` (:152), ``build_llama_params`` (:245),
``build_model`` (:342) and the ``Model`` handle (:266): the config, the
params on the device in the model's dtype, and the contiguous-cache forward,
with the introspection and cache helpers the ``Executor``, the
``BatchEngine`` and ``utils.ppl`` use.

Every family kind (``resolve_paged_kind``, JAX ``paged_multi.py:54``) has
one row of ``FAMILY_KINDS``: its builder (JAX ``build_model`` :342-358),
its contiguous forward and cache (``Model.init_cache``, :315-334), and its
paged step and engine cache (``make_paged_forward``, ``init_engine_cache``:
JAX ``paged_multi.py:410-447``). Mamba2 models (every layer a Mamba2 mixer)
take ``mamba2``, Mamba2/attention hybrids ``hybrid``, MLA models ``mla``,
the rest (``SERVED_FAMILIES``) the llama builders.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Optional

import torch

from ..config.model_config import LAYER_MAMBA2, UniversalConfig
from ..kvcache.contiguous import init_kv_cache
from ..kvcache.paged import init_paged_cache
from ..kvcache.ssm_state import init_ssm_state
from ..quant.qtensor import QuantTensor
from ..utils.device import DeviceLike, resolve_device
from . import hybrid, llama, mamba2, mla, paged_multi
from .llama import SERVED_FAMILIES, check_config  # noqa: F401 (re-exported)
from .llama_paged import forward_paged
from .moe import build_moe_params, is_moe_layer

if TYPE_CHECKING:  # avoids the loader <-> models import cycle
    from ..loader.varmap import VarMap


def _place(w, dtype: torch.dtype, device: torch.device, transpose: bool = False):
    """VarMap weight → device tensor. Dense [out, in] (or a stacked [E, out,
    in]) transposes to [in, out]; QuantTensors are already canonical [in,
    out] and only move."""
    if w is None:
        return None
    if isinstance(w, QuantTensor):
        return dataclasses.replace(
            w, qweight=w.qweight.to(device), scales=w.scales.to(device),
            mins=w.mins.to(device), perm=None if w.perm is None else w.perm.to(device))
    t = w.transpose(-2, -1) if transpose and w.dim() >= 2 else w
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
    q/k/v (Phi-3's ``qkv_proj``), a gated, fused gate+up or plain
    (Starcoder2's ``c_fc``/``c_proj``) MLP, or an MoE FFN where the layer's
    weights have one (``moe.is_moe_layer``, JAX registry :83-92), biases,
    q/k norms, LayerNorm biases and Gemma2's sandwich norms."""
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
    if is_moe_layer(pb.vm, p, cfg):
        out["moe"] = build_moe_params(pb, p, cfg)
    elif p + "mlp.c_fc.weight" in pb.vm:    # starcoder2 plain MLP
        out["fc"] = pb.get(p + "mlp.c_fc.weight", transpose=True)
        out["fc_bias"] = pb.get(p + "mlp.c_fc.bias", required=False)
        out["down"] = pb.get(p + "mlp.c_proj.weight", transpose=True)
        out["down_bias"] = pb.get(p + "mlp.c_proj.bias", required=False)
    elif p + "mlp.gate_up_proj.weight" in pb.vm:
        out["gateup"] = pb.get(p + "mlp.gate_up_proj.weight", transpose=True)
        out["down"] = pb.get(p + "mlp.down_proj.weight", transpose=True)
    else:
        out["gate"] = pb.get(p + "mlp.gate_proj.weight", transpose=True)
        out["up"] = pb.get(p + "mlp.up_proj.weight", transpose=True)
        out["down"] = pb.get(p + "mlp.down_proj.weight", transpose=True)
    for side in ("q", "k", "v", "o"):
        b = pb.get(p + f"self_attn.{side}_proj.bias", required=False)
        if b is not None:
            out[f"{side}_bias"] = b
    for key, name in (("input_norm_bias", "input_layernorm.bias"),
                      ("post_norm_bias", "post_attention_layernorm.bias")):
        b = pb.get(p + name, required=False)
        if b is not None:
            out[key] = b
    qn = pb.get(p + "self_attn.q_norm.weight", required=False)
    if qn is not None:
        out["q_norm"] = qn
        out["k_norm"] = pb.get(p + "self_attn.k_norm.weight")
    pre_ffw = pb.get(p + "pre_feedforward_layernorm.weight", required=False)
    if pre_ffw is not None:
        # Gemma2 names its post-attention sandwich norm
        # post_attention_layernorm; pre_feedforward takes the post_norm slot.
        out["post_attn_norm"] = out["post_norm"]
        out["post_norm"] = pre_ffw
        out["post_ffw_norm"] = pb.get(p + "post_feedforward_layernorm.weight",
                                      required=False)
    return out


def _split_falcon_qkv(fused: torch.Tensor, n_heads: int, n_kv: int,
                      head_dim: int) -> tuple[torch.Tensor, ...]:
    """De-interleave HF falcon's fused query_key_value into contiguous
    q/k/v (HF ``FalconAttention._split_heads``): grouped [n_kv, q_per + 2,
    hd] is per-head interleaved [n, 3, hd] when n_kv == n_heads and
    contiguous q|k|v when n_kv == 1 (multi_query)."""
    q_per = n_heads // n_kv
    rest = fused.shape[1:]                   # (hidden,) for W, () for bias
    g = fused.reshape(n_kv, q_per + 2, head_dim, *rest)
    q = g[:, :q_per].reshape(n_heads * head_dim, *rest)
    k = g[:, -2].reshape(n_kv * head_dim, *rest)
    v = g[:, -1].reshape(n_kv * head_dim, *rest)
    return q, k, v


def build_falcon_params(cfg: UniversalConfig, vm: "VarMap", dtype: torch.dtype,
                        device: torch.device) -> dict:
    """Falcon: the fused MQA/GQA query_key_value de-interleaved at load,
    LayerNorm, a plain GELU MLP, parallel residual blocks. Takes HF names
    (``transformer.h.{i}.``) and the llama-style names GGUF conversion gives
    (``model.layers.{i}.``). A quantized fused query_key_value cannot be
    de-interleaved and is refused, as the JAX loader refuses it."""
    att = cfg.attention
    head_dim = att.resolved_head_dim(cfg.hidden_size)
    n_heads, n_kv = att.num_heads, att.kv_heads()
    pb = ParamBuilder(vm, dtype, device)

    def first(*names, required=True):
        for n in names:
            if n in vm:
                return n
        if required:
            raise KeyError(f"Missing tensor (tried {names})")
        return None

    def place(t, transpose=False):
        return _place(t, dtype, device, transpose)

    layers = []
    for i in range(cfg.num_layers):
        hf = f"transformer.h.{i}."
        gg = f"model.layers.{i}."
        # Old architecture: one input_layernorm (post_attention_layernorm
        # when sequential); new architecture: ln_attn and ln_mlp.
        out: dict[str, Any] = {
            "input_norm": pb.get(hf + "ln_attn.weight", hf + "input_layernorm.weight",
                                 gg + "input_layernorm.weight"),
            "input_norm_bias": pb.get(hf + "ln_attn.bias", hf + "input_layernorm.bias",
                                      gg + "input_layernorm.bias", required=False),
        }
        pn = first(hf + "ln_mlp.weight", hf + "post_attention_layernorm.weight",
                   gg + "pre_feedforward_layernorm.weight",
                   gg + "post_attention_layernorm.weight", required=False)
        if pn is not None:
            out["post_norm"] = pb.get(pn)
            out["post_norm_bias"] = pb.get(pn[: -len(".weight")] + ".bias",
                                           required=False)
        qkv_name = first(hf + "self_attention.query_key_value.weight",
                         gg + "self_attn.query_key_value.weight")
        fused = vm.take(qkv_name)
        if isinstance(fused, QuantTensor):
            raise ValueError(
                "quantized falcon checkpoints must store q/k/v unfused "
                "(a fused query_key_value QuantTensor cannot be de-interleaved)")
        q, k, v = _split_falcon_qkv(fused, n_heads, n_kv, head_dim)
        out["q"], out["k"], out["v"] = (place(q, True), place(k, True), place(v, True))
        bias_name = qkv_name[: -len(".weight")] + ".bias"
        if bias_name in vm:
            qb, kb, vb = _split_falcon_qkv(vm.take(bias_name), n_heads, n_kv, head_dim)
            out["q_bias"], out["k_bias"], out["v_bias"] = place(qb), place(kb), place(vb)
        out["o"] = pb.get(hf + "self_attention.dense.weight",
                          gg + "self_attn.o_proj.weight", transpose=True)
        out["o_bias"] = pb.get(hf + "self_attention.dense.bias",
                               gg + "self_attn.o_proj.bias", required=False)
        out["fc"] = pb.get(hf + "mlp.dense_h_to_4h.weight", gg + "mlp.up_proj.weight",
                           transpose=True)
        out["fc_bias"] = pb.get(hf + "mlp.dense_h_to_4h.bias", gg + "mlp.up_proj.bias",
                                required=False)
        out["down"] = pb.get(hf + "mlp.dense_4h_to_h.weight",
                             gg + "mlp.down_proj.weight", transpose=True)
        out["down_bias"] = pb.get(hf + "mlp.dense_4h_to_h.bias",
                                  gg + "mlp.down_proj.bias", required=False)
        layers.append(out)
    params: dict[str, Any] = {
        "embed": pb.get("transformer.word_embeddings.weight", "model.embed_tokens.weight"),
        "final_norm": pb.get("transformer.ln_f.weight", "model.norm.weight"),
        "layers": layers,
    }
    fnb = pb.get("transformer.ln_f.bias", "model.norm.bias", required=False)
    if fnb is not None:
        params["final_norm_bias"] = fnb
    params["lm_head"] = pb.get("lm_head.weight", transpose=True, required=False)
    if params["lm_head"] is None and not cfg.tie_word_embeddings:
        cfg.tie_word_embeddings = True
    return params


def build_llama_params(cfg: UniversalConfig, vm: "VarMap", dtype: torch.dtype,
                       device: torch.device) -> dict:
    pb = ParamBuilder(vm, dtype, device)
    params: dict[str, Any] = {
        "embed": pb.get("model.embed_tokens.weight", "embed_tokens.weight"),
        "final_norm": pb.get("model.norm.weight"),
        "layers": [build_llama_layer_params(pb, i, cfg) for i in range(cfg.num_layers)],
    }
    fnb = pb.get("model.norm.bias", required=False)
    if fnb is not None:
        params["final_norm_bias"] = fnb
    params["lm_head"] = pb.get("lm_head.weight", transpose=True, required=False)
    if params["lm_head"] is None and not cfg.tie_word_embeddings:
        cfg.tie_word_embeddings = True
    return params


def resolve_paged_kind(cfg: UniversalConfig) -> str:
    """'llama' | 'mla' | 'mamba2' | 'hybrid': the family's row of
    ``FAMILY_KINDS``."""
    types = set(cfg.layer_types())
    if types == {LAYER_MAMBA2}:
        return "mamba2"
    if LAYER_MAMBA2 in types:
        return "hybrid"
    if cfg.attention is not None and cfg.attention.is_mla:
        return "mla"
    return "llama"


@dataclasses.dataclass(frozen=True)
class FamilyKind:
    """What one family kind runs.

    build(cfg, vm, dtype, device) -> params
    forward(params, cfg, tokens, cache, positions, seq_lens) -> (logits, cache)
    init_cache(cfg, batch, capacity, dtype, kv_quant, kv_dtype, device)
    paged_forward(params, cfg, tokens, cache, positions, slots, block_tables,
                  seq_lens, state_rows=None, last_idx=None) -> (logits, cache)
    init_engine_cache(cfg, num_blocks, block_size, max_batch, dtype,
                      quantized, device)
    state_rows: the engine cache holds a pool of state rows.
    """

    build: Callable[..., dict]
    forward: Callable[..., tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]
    paged_forward: Callable[..., tuple[torch.Tensor, Any]]
    init_engine_cache: Callable[..., Any]
    state_rows: bool = False


def _build_llama(cfg, vm, dtype, device) -> dict:
    build = build_falcon_params if cfg.model_type == "falcon" else build_llama_params
    return build(cfg, vm, dtype, device)


def _llama_paged(params, cfg, tokens, cache, positions, slots, block_tables, seq_lens,
                 state_rows=None, last_idx=None):
    return forward_paged(params, cfg, tokens, cache, positions, slots, block_tables,
                         seq_lens, last_idx=last_idx, device=tokens.device)


def _head_dim(cfg: UniversalConfig) -> int:
    return cfg.attention.resolved_head_dim(cfg.hidden_size)


FAMILY_KINDS = {
    "llama": FamilyKind(
        _build_llama, llama.forward,
        lambda cfg, b, cap, dtype, kv_quant, kv_dtype, dev: init_kv_cache(
            cfg.num_layers, b, cap, cfg.attention.kv_heads(), _head_dim(cfg), dtype=dtype,
            quantized=kv_quant, kv_dtype=kv_dtype, device=dev),
        _llama_paged,
        lambda cfg, nb, bs, max_batch, dtype, quantized, dev: init_paged_cache(
            cfg.num_layers, nb, bs, cfg.attention.kv_heads(), _head_dim(cfg), dtype=dtype,
            quantized=quantized, device=dev)),
    "mla": FamilyKind(
        mla.build_mla_params, mla.forward,
        lambda cfg, b, cap, dtype, kv_quant, kv_dtype, dev: mla.init_mla_cache(
            cfg, b, cap, dtype=dtype, quantized=kv_quant, device=dev),
        paged_multi.mla_forward_paged,
        lambda cfg, nb, bs, max_batch, dtype, quantized, dev: paged_multi.init_paged_mla_cache(
            cfg, nb, bs, dtype=dtype, quantized=quantized, device=dev)),
    "mamba2": FamilyKind(
        mamba2.build_mamba2_params, mamba2.forward,
        lambda cfg, b, cap, dtype, kv_quant, kv_dtype, dev: init_ssm_state(cfg, b, device=dev),
        paged_multi.mamba2_forward_slots,
        lambda cfg, nb, bs, max_batch, dtype, quantized, dev: paged_multi.init_ssm_slots(
            cfg, max_batch, device=dev),
        state_rows=True),
    "hybrid": FamilyKind(
        hybrid.build_hybrid_params, hybrid.forward,
        lambda cfg, b, cap, dtype, kv_quant, kv_dtype, dev: hybrid.init_hybrid_state(
            cfg, b, cap, dtype=dtype, device=dev),
        paged_multi.hybrid_forward_paged, paged_multi.init_hybrid_paged_state,
        state_rows=True),
}


def make_paged_forward(cfg: UniversalConfig):
    """The engine's step for the model's family (``FamilyKind.paged_forward``)."""
    check_config(cfg)
    return FAMILY_KINDS[resolve_paged_kind(cfg)].paged_forward


def init_engine_cache(cfg: UniversalConfig, num_blocks: int, block_size: int,
                      max_batch: int, dtype: torch.dtype = torch.bfloat16,
                      quantized: bool = False, device: DeviceLike = None) -> tuple[Any, bool]:
    """(cache, needs_state_rows) for the model's family."""
    check_config(cfg)
    kind = FAMILY_KINDS[resolve_paged_kind(cfg)]
    return kind.init_engine_cache(cfg, num_blocks, block_size, max_batch, dtype, quantized,
                                  device), kind.state_rows


@dataclasses.dataclass
class Model:
    cfg: UniversalConfig
    params: dict[str, Any]
    dtype: torch.dtype
    # forward_fn(params, cfg, tokens, cache, positions, seq_lens) →
    # (logits [B, T, V] float32, cache); None = the family's
    # (``FamilyKind.forward``).
    forward_fn: Optional[Callable[..., tuple[torch.Tensor, Any]]] = None

    def __post_init__(self) -> None:
        if self.forward_fn is None:
            self.forward_fn = FAMILY_KINDS[resolve_paged_kind(self.cfg)].forward

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
                   kv_dtype: str = "int8") -> Any:
        """The family's contiguous cache on the params' device: the SSM
        state (Mamba2), KV and SSM state (hybrid), the latent cache (MLA;
        int8 latents when ``kv_quant``), else the KV cache (int8 or int4
        values with scales when ``kv_quant``)."""
        check_config(self.cfg)
        return FAMILY_KINDS[resolve_paged_kind(self.cfg)].init_cache(
            self.cfg, batch, capacity, self.dtype, kv_quant, kv_dtype, self.device)

    def forward(self, tokens: torch.Tensor, cache: Any, positions: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None):
        return self.forward_fn(self.params, self.cfg, tokens, cache, positions,
                               seq_lens)


def build_model(cfg: UniversalConfig, vm: "VarMap", dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Model:
    """Resolve the architecture, build the params on ``device`` (default
    ``cuda``) and return the Model handle."""
    dev = resolve_device(device)
    check_config(cfg)
    return Model(cfg, FAMILY_KINDS[resolve_paged_kind(cfg)].build(cfg, vm, dtype, dev), dtype)
