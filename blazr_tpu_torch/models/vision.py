"""Vision encoder (CLIP-style ViT) and the multimodal projector.

Counterpart of ``blazr_tpu/models/vision.py`` (``encode_images`` :46-80):
patch embedding (the conv as an unfold and a matmul), CLS, position
embeddings, the pre-norm, pre-norm transformer blocks, then the 2-layer
GELU projector into the LLM's embedding space. Weights and arithmetic are
f32, as the JAX builder makes them (``loader/vision.py:125``); the matmuls
are ``torch.matmul``: the JAX package computes them in XLA, outside any
Pallas kernel.

Two repairs over the JAX tower follow transformers' CLIP and LLaVA, where
the config names them (``VisionConfig``; ROADMAP §C): the encoder MLP's
activation (``hidden_act``: CLIP's ``quick_gelu``, x·σ(1.702x); the JAX
package applies exact GELU everywhere) and the features the projector
reads (``feature_layer``: LLaVA takes ``hidden_states[-2]``, the output of
the second-to-last block with no post-norm; the JAX package runs every
block and the post-norm). CLS is dropped, as both do. The defaults are
the JAX package's tower.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..config.model_config import VisionConfig


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b)."""
    y = torch.matmul(x, w)
    return y if b is None else y + b


def act(x: torch.Tensor, name: str) -> torch.Tensor:
    """The encoder MLP's activation by its HF name."""
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise NotImplementedError(f"vision hidden_act {name!r}")


def _attention(p: dict[str, Any], x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, h = x.shape
    d = h // num_heads
    q = _linear(x, p["q"], p.get("q_bias")).reshape(b, t, num_heads, d)
    k = _linear(x, p["k"], p.get("k_bias")).reshape(b, t, num_heads, d)
    v = _linear(x, p["v"], p.get("v_bias")).reshape(b, t, num_heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * (1.0 / d ** 0.5), k)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, h)
    return _linear(out, p["o"], p.get("o_bias"))


def _blocks_to_run(vcfg: VisionConfig) -> int:
    """How many encoder blocks feed the projector: all of them by default,
    else as many as ``hidden_states[feature_layer]`` holds (index 0 is the
    pre-normed embeddings, index k the output of block k)."""
    n = vcfg.num_layers
    if vcfg.feature_layer is None:
        return n
    idx = vcfg.feature_layer + n + 1 if vcfg.feature_layer < 0 else vcfg.feature_layer
    if not 0 <= idx <= n:
        raise ValueError(f"vision_feature_layer {vcfg.feature_layer} outside "
                         f"0..{n} hidden states")
    return idx


@torch.no_grad()
def encode_images(params: dict[str, Any], vcfg: VisionConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] pixels → [N, patches, proj_dim] LLM-space embeddings
    (CLS dropped), f32, on the params' device."""
    n, c, hh, ww = pixels.shape
    ps = vcfg.patch_size
    patches = pixels.to(torch.float32).reshape(n, c, hh // ps, ps, ww // ps, ps)
    patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(n, (hh // ps) * (ww // ps), c * ps * ps)
    x = torch.matmul(patches, params["patch_embed"])
    cls = params.get("cls_token")
    if cls is not None:
        x = torch.cat([cls.expand(n, 1, x.shape[-1]), x], dim=1)
    x = x + params["pos_embed"][: x.shape[1]][None]
    if params.get("pre_norm") is not None:
        x = layer_norm(x, params["pre_norm"], params.get("pre_norm_bias"))
    for p in params["layers"][:_blocks_to_run(vcfg)]:
        h = layer_norm(x, p["norm1"], p.get("norm1_bias"))
        x = x + _attention(p, h, vcfg.num_heads)
        h = layer_norm(x, p["norm2"], p.get("norm2_bias"))
        h = act(_linear(h, p["fc1"], p.get("fc1_bias")), vcfg.hidden_act)
        x = x + _linear(h, p["fc2"], p.get("fc2_bias"))
    if vcfg.feature_layer is None and params.get("post_norm") is not None:
        x = layer_norm(x, params["post_norm"], params.get("post_norm_bias"))
    if cls is not None:
        x = x[:, 1:]
    h = F.gelu(_linear(x, params["proj_fc1"], params.get("proj_fc1_bias")))
    return _linear(h, params["proj_fc2"], params.get("proj_fc2_bias"))


def vision_flops(vcfg: VisionConfig, n_images: int = 1) -> float:
    """Multiply-adds × 2 of ``encode_images`` over ``n_images``: the patch
    embedding, each block's projections, scores and MLP, the projector."""
    h, i, ps = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_size
    p = (vcfg.image_size // ps) ** 2
    t = p + 1
    block = 2 * t * (4 * h * h + 2 * h * i) + 4 * t * t * h
    proj = 2 * p * (h * vcfg.projection_dim + vcfg.projection_dim ** 2)
    return n_images * (2 * p * 3 * ps * ps * h + _blocks_to_run(vcfg) * block + proj)
