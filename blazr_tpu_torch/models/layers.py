"""Core building blocks as plain functions on tensors.

Counterpart of ``blazr_tpu/models/layers.py``. Linear weights are stored
[in_features, out_features] so the forward is ``x @ w``; quantized weights
are ``quant.qtensor.QuantTensor`` and go through kernel B1. ``attend`` is
XLA einsums in the JAX package, not a Pallas kernel, so it stays plain
PyTorch here (prefill attention).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..config.model_config import AttentionConfig, RopeScaling
from ..quant.matmul import quant_matmul
from ..quant.qtensor import QuantTensor


def linear(x: torch.Tensor, w: Any, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain [K, N] tensor or a QuantTensor."""
    if isinstance(w, QuantTensor):
        y = quant_matmul(x, w)
    else:
        y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32. ``offset=1.0`` gives Gemma's (1+w) form."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (weight.to(torch.float32) + offset)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """Full (mean-centred) LayerNorm in f32: the starcoder2/falcon family."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def rope_frequencies(cfg: AttentionConfig, head_dim: int,
                     device: torch.device) -> torch.Tensor:
    """Per-dimension inverse frequencies with scaling applied
    (linear / llama3 / yarn / dynamic)."""
    half = head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    sc: Optional[RopeScaling] = cfg.rope_scaling
    if sc is None:
        return inv_freq
    if sc.rope_type in ("linear", "dynamic"):
        return inv_freq / sc.factor
    if sc.rope_type == "llama3":
        low_wavelen = sc.original_max_position_embeddings / sc.low_freq_factor
        high_wavelen = sc.original_max_position_embeddings / sc.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / sc.factor
        smooth = (sc.original_max_position_embeddings / wavelen
                  - sc.low_freq_factor) / (sc.high_freq_factor - sc.low_freq_factor)
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
        out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
        mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        return torch.where(mid, smoothed, out)
    if sc.rope_type == "yarn":
        def find_dim(num_rot: float) -> float:
            return (head_dim * math.log(sc.original_max_position_embeddings /
                                        (num_rot * 2 * math.pi))) / (
                2 * math.log(cfg.rope_theta))

        low = max(math.floor(find_dim(sc.beta_fast)), 0)
        high = min(math.ceil(find_dim(sc.beta_slow)), half - 1)
        rng = torch.arange(half, dtype=torch.float32, device=device)
        mask = 1.0 - torch.clamp((rng - low) / max(high - low, 1), 0.0, 1.0)
        return inv_freq / sc.factor * (1 - mask) + inv_freq * mask
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 mscale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions ``[...]`` → ``[..., half]``."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles) * mscale, torch.sin(angles) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate half-dims (HF "rotate_half"): x [..., S, H, D]; cos/sin
    [..., S, half]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :].to(x.dtype)
    sin = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent (even, odd) pairs: DeepSeek's decoupled rope dims."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos = cos[..., None, :].to(x.dtype)
    sin = sin[..., None, :].to(x.dtype)
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


@functools.lru_cache(maxsize=None)
def device_scalar(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d constant built once per (value, dtype, device) and shared: a
    forward that needs it makes no host-to-device copy, which a captured
    CUDA graph could not hold. Read-only."""
    return torch.tensor(value, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def alibi_slopes(n_heads: int, device: torch.device) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.; HF falcon / ggml formula), built
    once per (heads, device) and shared, as ``device_scalar``. Read-only."""
    p = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(p) - 3)))
    slopes = [base ** (i + 1) for i in range(p)]
    if p < n_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * p) - 3)))
        slopes += [extra ** (2 * i + 1) for i in range(n_heads - p)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_positions: torch.Tensor, kv_len: torch.Tensor,
           sliding_window: Optional[int] = None,
           logit_softcap: Optional[float] = None,
           scale: Optional[float] = None,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None,
           alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked attention over a fixed-length cache with grouped GQA.

    q [B, T, H, D]; k/v [B, S, H_kv, D]; q_positions [B, T]; kv_len [B];
    k/v_scale [B, S, H_kv] (int8 KV); alibi [H]. Compute in q's dtype with
    f32 sums; invalid and non-causal keys get -1e30 before the softmax.
    """
    b, t, h, d = q.shape
    s = k.shape[1]
    g = k.shape[2]
    n_rep = h // g
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    cdt = q.dtype
    qg = (q * scale).to(cdt).reshape(b, t, g, n_rep, d)
    # Operands in the compute dtype, sums in f32: the products of two
    # compute-dtype values are exact in f32, so f32 einsums match the JAX
    # dots with preferred_element_type=float32.
    logits = torch.einsum("btgrd,bsgd->bgrts", qg.to(torch.float32),
                          k.to(cdt).to(torch.float32))
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    kv_pos = torch.arange(s, dtype=torch.int32, device=q.device)
    if alibi is not None:
        rel = (kv_pos[None, None, :] - q_positions[:, :, None]).to(torch.float32)
        logits = logits + (alibi.reshape(g, n_rep)[None, :, :, None, None]
                           * rel[:, None, None, :, :])
    valid = kv_pos[None, :] < kv_len[:, None]                           # [B, S]
    causal = kv_pos[None, None, :] <= q_positions[:, :, None]           # [B, T, S]
    mask = valid[:, None, :] & causal
    if sliding_window is not None:
        mask = mask & (kv_pos[None, None, :] > q_positions[:, :, None] - sliding_window)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bgrts,bsgd->btgrd", probs, v.to(torch.float32))
    else:
        out = torch.einsum("bgrts,bsgd->btgrd", probs.to(cdt).to(torch.float32),
                           v.to(cdt).to(torch.float32))
    return out.reshape(b, t, h, d).to(q.dtype)


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """An MLP activation by name: the plain MLP's ``hidden_act``, or the
    gate's ``gelu`` (tanh approximation, Gemma) or ``silu``."""
    if act in ("gelu", "gelu_tanh", "gelu_pytorch_tanh"):
        return F.gelu(h, approximate="tanh")
    if act == "gelu_exact":
        return F.gelu(h)
    if act == "relu":
        return F.relu(h)
    return F.silu(h)


def plain_mlp(x: torch.Tensor, fc: Any, fc_b: Optional[torch.Tensor], down: Any,
              down_b: Optional[torch.Tensor], act: str = "gelu_tanh") -> torch.Tensor:
    """Non-gated two-layer MLP (starcoder2 c_fc → act → c_proj; falcon)."""
    return linear(activation(linear(x, fc, fc_b), act), down, down_b)
