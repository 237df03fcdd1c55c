"""DeepSeek MLA (multi-head latent attention) decoder with its MoE FFN.

Counterpart of ``blazr_tpu/models/mla.py`` (``MLACache`` :43,
``init_mla_cache`` :70, ``mla_attention_block`` :90, ``forward`` :186,
``build_mla_params`` :234). The cache holds the compressed latent (c_kv
[kv_lora] and the shared k_rope [d_rope] a token, bf16 or int8 with a
per-token absmax scale) and attention runs in absorbed form, f32:

    score[t, s] = (W_kbᵏᵀ q_nope[t]) · c[s] + q_rope[t] · k_rope[s]
    out[t]      = W_kbᵛᵀ (Σ_s p[t, s] c[s])

with DeepSeek's interleaved rope on the decoupled dims. Every projection
(q or q_a/q_b, kv_a, o, the experts, the shared experts, the dense MLP) goes
through ``layers.linear`` (kernel B1 when quantized); the absorbed einsums
and the latent writes are XLA in the JAX package, no Pallas kernel, so they
stay plain PyTorch. Layers with experts take ``models/moe.py``, the others
the dense MLP.

Two corrections to the reference (ROADMAP §C):
  * ``kv_b_proj`` is dequantized to f32 at load (a QuantTensor cannot be
    reshaped into the absorbed halves; the JAX builder fails on one);
  * under YaRN rope scaling the scores scale by (d_nope + d_rope)^-0.5 ·
    mscale², mscale = 0.1·mscale_all_dim·ln(factor) + 1, as DeepSeek's
    own code and transformers' ``DeepseekV3Attention`` do; the JAX package
    leaves the mscale out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..config.model_config import AttentionConfig, UniversalConfig
from ..kvcache.paged import quantize_tokens
from ..quant.qtensor import QuantTensor, dequantize
from ..utils.device import DeviceLike, resolve_device
from . import llama
from .layers import (apply_rope, apply_rope_interleaved, linear, rms_norm, rope_cos_sin,
                     rope_frequencies)
from .moe import is_moe_layer


@dataclasses.dataclass
class MLACache:
    """Contiguous latent cache: latent [L, B, S+1, kv_lora], k_rope [L, B,
    S+1, d_rope] (+1: the trash position padded prefill writes), per-token
    scales [L, B, S+1] f32 in the int8 mode. Written in place."""

    latent: torch.Tensor
    k_rope: torch.Tensor
    length: torch.Tensor                       # [B] int32
    latent_scale: Optional[torch.Tensor] = None
    k_rope_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.latent_scale is not None

    @property
    def capacity(self) -> int:
        return self.latent.shape[2] - 1

    @property
    def trash_position(self) -> int:
        return self.latent.shape[2] - 1


def init_mla_cache(cfg: UniversalConfig, batch: int, capacity: int,
                   dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
                   device: DeviceLike = None) -> MLACache:
    dev = resolve_device(device)
    att = cfg.attention
    shape_c = (cfg.num_layers, batch, capacity + 1, att.kv_latent_dim)
    shape_r = (cfg.num_layers, batch, capacity + 1, att.d_rope)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if quantized:
        return MLACache(
            latent=torch.zeros(shape_c, dtype=torch.int8, device=dev),
            k_rope=torch.zeros(shape_r, dtype=torch.int8, device=dev), length=length,
            latent_scale=torch.zeros(shape_c[:3], dtype=torch.float32, device=dev),
            k_rope_scale=torch.zeros(shape_r[:3], dtype=torch.float32, device=dev))
    return MLACache(latent=torch.zeros(shape_c, dtype=dtype, device=dev),
                    k_rope=torch.zeros(shape_r, dtype=dtype, device=dev), length=length)


def d_nope(att: AttentionConfig) -> int:
    """qk_nope_head_dim; a GGUF file gives the whole key width instead."""
    return att.d_nope if att.d_nope is not None else att.head_dim - att.d_rope


def softmax_scale(att: AttentionConfig) -> float:
    """(d_nope + d_rope)^-0.5, times mscale² under YaRN with
    ``mscale_all_dim`` (transformers' ``DeepseekV3Attention``)."""
    scale = (d_nope(att) + att.d_rope) ** -0.5
    sc = att.rope_scaling
    if sc is not None and sc.rope_type == "yarn" and sc.mscale_all_dim and sc.factor > 1:
        m = 0.1 * sc.mscale_all_dim * math.log(sc.factor) + 1.0
        scale *= m * m
    return scale


def rope(cfg: UniversalConfig, positions: torch.Tensor):
    """cos/sin of the decoupled rope dims at ``positions``."""
    att = cfg.attention
    inv_freq = rope_frequencies(att, 2 * (att.d_rope // 2), positions.device)
    return rope_cos_sin(positions, inv_freq)


def project(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor, cos, sin):
    """(q_nope [B, T, H, d_nope], q_rope [B, T, H, d_rope] roped, c [B, T,
    kv_lora] normed, k_rope [B, T, d_rope] roped) from x [B, T, hidden]."""
    att = cfg.attention
    b, t, _ = x.shape
    dn, dr, r = d_nope(att), att.d_rope, att.kv_latent_dim
    if p.get("q_a") is not None:
        q = linear(rms_norm(linear(x, p["q_a"]), p["q_a_norm"], cfg.rms_norm_eps), p["q_b"])
    else:
        q = linear(x, p["q"])
    q = q.reshape(b, t, att.num_heads, dn + dr)
    rope_fn = apply_rope_interleaved if att.rope_interleave else apply_rope
    ckv = linear(x, p["kv_a"])
    c = rms_norm(ckv[..., :r], p["kv_a_norm"], cfg.rms_norm_eps)
    k_rope = rope_fn(ckv[..., r:][:, :, None, :], cos, sin)[:, :, 0, :]
    return q[..., :dn], rope_fn(q[..., dn:], cos, sin), c, k_rope


def absorbed_attention(p: dict[str, Any], cfg: UniversalConfig, q_nope, q_rope,
                       c_all, kr_all, c_scale, r_scale, mask, out_dtype) -> torch.Tensor:
    """Attention of q [B, T, H, ·] over the latent c_all [B, S, r] and
    kr_all [B, S, d_rope] (int8 values with their scales [B, S], or float)
    under ``mask`` [B, T, S], in f32; the output projection's input [B, T,
    H·v_dim] in ``out_dtype``."""
    att = cfg.attention
    b, t, h, _ = q_nope.shape
    c_all = c_all.to(torch.float32)
    kr_all = kr_all.to(torch.float32)
    q_eff = torch.einsum("bthd,rhd->bthr", q_nope.to(torch.float32),
                         p["kv_b_k"].to(torch.float32))
    sc_c = torch.einsum("bthr,bsr->bhts", q_eff, c_all)
    sc_r = torch.einsum("bthd,bsd->bhts", q_rope.to(torch.float32), kr_all)
    if c_scale is not None:
        sc_c = sc_c * c_scale[:, None, None, :]
        sc_r = sc_r * r_scale[:, None, None, :]
    scores = (sc_c + sc_r) * softmax_scale(att)
    scores = torch.where(mask[:, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    if c_scale is not None:
        probs = probs * c_scale[:, None, None, :]
    out_latent = torch.einsum("bhts,bsr->bthr", probs, c_all)
    out = torch.einsum("bthr,rhv->bthv", out_latent, p["kv_b_v"].to(torch.float32))
    return out.reshape(b, t, h * att.v_head_dim).to(out_dtype)


def mla_attention_block(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor,
                        cache: MLACache, layer: int, positions: torch.Tensor,
                        kv_len: torch.Tensor, cos, sin) -> torch.Tensor:
    """One MLA attention block over the contiguous latent cache, written in
    place at ``positions`` [B, T]; ``kv_len`` [B] is the valid length after
    the write."""
    q_nope, q_rope, c, k_rope = project(p, cfg, x, cos, sin)
    b = x.shape[0]
    rows = torch.arange(b, device=positions.device)[:, None].expand_as(positions)
    pos = positions.to(torch.long)
    if cache.quantized:
        cq, cs = quantize_tokens(c)
        rq, rs = quantize_tokens(k_rope)
        cache.latent[layer][rows, pos] = cq
        cache.k_rope[layer][rows, pos] = rq
        cache.latent_scale[layer][rows, pos] = cs
        cache.k_rope_scale[layer][rows, pos] = rs
    else:
        cache.latent[layer][rows, pos] = c.to(cache.latent.dtype)
        cache.k_rope[layer][rows, pos] = k_rope.to(cache.k_rope.dtype)
    s = cache.latent.shape[2]
    kv_pos = torch.arange(s, dtype=torch.int32, device=x.device)
    mask = ((kv_pos[None, :] < kv_len[:, None])[:, None, :]
            & (kv_pos[None, None, :] <= positions[:, :, None]))
    out = absorbed_attention(
        p, cfg, q_nope, q_rope, cache.latent[layer], cache.k_rope[layer],
        cache.latent_scale[layer] if cache.quantized else None,
        cache.k_rope_scale[layer] if cache.quantized else None, mask, x.dtype)
    return linear(out, p["o"])


def decoder_layer(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor,
                  attn) -> torch.Tensor:
    """One DeepSeek layer around ``attn(h)``: pre-norm attention, then the
    MoE FFN or the dense MLP (``llama.mlp``)."""
    x = x + attn(rms_norm(x, p["input_norm"], cfg.rms_norm_eps))
    return x + llama.mlp(p, cfg, rms_norm(x, p["post_norm"], cfg.rms_norm_eps))


def forward(params: dict[str, Any], cfg: UniversalConfig, tokens: torch.Tensor,
            cache: MLACache, positions: torch.Tensor,
            seq_lens: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, MLACache]:
    """Logits [B, T, V] f32 and the cache (written in place); prefill pads
    point at the cache's trash position and ``seq_lens`` holds the true
    lengths, as in ``llama.forward``."""
    x = llama.forward_embed(params, cfg, tokens)
    cos, sin = rope(cfg, positions)
    new_len = (seq_lens.to(torch.int32) if seq_lens is not None
               else (positions.amax(dim=-1) + 1).to(torch.int32))
    kv_len = torch.maximum(cache.length, new_len)
    for i, p in enumerate(params["layers"]):
        x = decoder_layer(p, cfg, x, lambda h: mla_attention_block(
            p, cfg, h, cache, i, positions, kv_len, cos, sin))
    cache.length.copy_(kv_len)
    return llama.forward_head(params, cfg, x), cache


def split_kv_b(kv_b, att: AttentionConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """HF ``kv_b_proj`` [H·(d_nope + v_dim), kv_lora] (dense, or a
    QuantTensor dequantized here to f32) → (W_kbᵏ [r, H, d_nope], W_kbᵛ [r,
    H, v_dim]), f32."""
    if isinstance(kv_b, QuantTensor):
        w = dequantize(kv_b)                        # [in, out], rows in the sorted order
        if kv_b.perm is not None:                   # GPTQ desc-act: x[:, perm] @ w
            w = torch.empty_like(w).index_copy_(0, kv_b.perm.to(torch.long), w)
        kv_b = w.t()
    dn = d_nope(att)
    w = kv_b.to(torch.float32).reshape(att.num_heads, dn + att.v_head_dim,
                                       att.kv_latent_dim)
    return (w[:, :dn, :].permute(2, 0, 1).contiguous(),
            w[:, dn:, :].permute(2, 0, 1).contiguous())


def build_mla_params(cfg: UniversalConfig, vm, dtype: torch.dtype,
                     device: torch.device) -> dict:
    """HF DeepseekV2/V3 names. A layer is MoE by its weights (the first
    ``first_k_dense_replace`` layers have a dense MLP)."""
    from .moe import build_moe_params
    from .registry import ParamBuilder

    pb = ParamBuilder(vm, dtype, device)
    att = cfg.attention
    layers = []
    for i in range(cfg.num_layers):
        pfx = f"model.layers.{i}."
        p: dict[str, Any] = {
            "input_norm": pb.get(pfx + "input_layernorm.weight"),
            "post_norm": pb.get(pfx + "post_attention_layernorm.weight"),
            "kv_a": pb.get(pfx + "self_attn.kv_a_proj_with_mqa.weight", transpose=True),
            "kv_a_norm": pb.get(pfx + "self_attn.kv_a_layernorm.weight"),
            "o": pb.get(pfx + "self_attn.o_proj.weight", transpose=True),
        }
        if pfx + "self_attn.q_a_proj.weight" in vm:
            p["q_a"] = pb.get(pfx + "self_attn.q_a_proj.weight", transpose=True)
            p["q_a_norm"] = pb.get(pfx + "self_attn.q_a_layernorm.weight")
            p["q_b"] = pb.get(pfx + "self_attn.q_b_proj.weight", transpose=True)
        else:
            p["q"] = pb.get(pfx + "self_attn.q_proj.weight", transpose=True)
        kv_b = vm.take(pfx + "self_attn.kv_b_proj.weight")
        p["kv_b_k"], p["kv_b_v"] = (w.to(device) for w in split_kv_b(kv_b, att))
        if is_moe_layer(vm, pfx, cfg):
            p["moe"] = build_moe_params(pb, pfx, cfg)
        else:
            p["gate"] = pb.get(pfx + "mlp.gate_proj.weight", transpose=True)
            p["up"] = pb.get(pfx + "mlp.up_proj.weight", transpose=True)
            p["down"] = pb.get(pfx + "mlp.down_proj.weight", transpose=True)
        layers.append(p)
    params = {
        "embed": pb.get("model.embed_tokens.weight"),
        "final_norm": pb.get("model.norm.weight"),
        "layers": layers,
        "lm_head": pb.get("lm_head.weight", transpose=True, required=False),
    }
    if params["lm_head"] is None and not cfg.tie_word_embeddings:
        cfg.tie_word_embeddings = True
    return params
