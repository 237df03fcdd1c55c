"""Architecture detection from tensor names, and config inference from
tensor shapes.

Copy of ``blazr_tpu/formats/detect_arch.py``: given the tensor names of a
checkpoint (and their shapes), infer the architecture family (llama-style
attention, DeepSeek MLA+MoE, Mamba2, hybrid) and the core dimensions
(hidden, vocab, intermediate, heads, layers). The last link of the config
chain, for a checkpoint with neither ``config.json`` nor GGUF metadata.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..config.model_config import (
    LAYER_ATTENTION,
    LAYER_MAMBA2,
    AttentionConfig,
    MoeConfig,
    SsmConfig,
    UniversalConfig,
)

_LAYER_RE = re.compile(r"(?:model\.)?layers\.(\d+)\.")
_BLK_RE = re.compile(r"blk\.(\d+)\.")


@dataclass
class DetectedConfig:
    """Result of tensor-name sniffing."""

    model_type: str = "llama"
    num_layers: int = 0
    layer_types: list[str] = field(default_factory=list)
    has_mla: bool = False
    has_moe: bool = False
    has_ssm: bool = False
    is_quantized_awq: bool = False
    is_quantized_gptq: bool = False
    tie_word_embeddings: bool = False


def detect_architecture_from_names(names: list[str]) -> DetectedConfig:
    """Classify per-layer types from tensor names.

    Marker tensors (HF naming):
      * MLA:    ``kv_a_proj_with_mqa`` / ``q_a_proj`` / ``kv_b_proj``
      * MoE:    ``mlp.experts.N.`` / ``mlp.gate.weight`` (router) /
                ``block_sparse_moe``
      * Mamba2: ``mixer.in_proj`` / ``A_log`` / ``mixer.dt_bias`` / ``conv1d``
      * attention: ``self_attn.q_proj`` etc.
    """
    det = DetectedConfig()
    name_set = set(names)

    per_layer: dict[int, set[str]] = {}
    for n in names:
        m = _LAYER_RE.search(n) or _BLK_RE.search(n)
        if m:
            per_layer.setdefault(int(m.group(1)), set()).add(n)

    det.num_layers = (max(per_layer) + 1) if per_layer else 0
    det.is_quantized_awq = any(n.endswith(".qweight") for n in names) and not any(
        n.endswith(".g_idx") for n in names
    )
    det.is_quantized_gptq = any(n.endswith(".g_idx") for n in names)
    det.tie_word_embeddings = not any(
        n in ("lm_head.weight", "lm_head.qweight", "output.weight") for n in names
    ) and any("embed" in n for n in names)

    def layer_has(i: int, pat: str) -> bool:
        return any(pat in n for n in per_layer.get(i, ()))

    layer_types: list[str] = []
    for i in range(det.num_layers):
        is_mamba = (
            layer_has(i, "mixer.in_proj")
            or layer_has(i, "A_log")
            or layer_has(i, "mixer.dt_bias")
            or layer_has(i, "ssm_")
        )
        is_mla = (
            layer_has(i, "kv_a_proj_with_mqa")
            or layer_has(i, "kv_b_proj")
            or layer_has(i, "attn_kv_a_mqa")
        )
        is_moe = (
            layer_has(i, "mlp.experts.")
            or layer_has(i, "block_sparse_moe")
            or layer_has(i, "ffn_gate_exps")
            or layer_has(i, "mlp.gate.weight")
        )
        if is_mamba and not is_mla:
            layer_types.append(LAYER_MAMBA2)
        elif is_mla and is_moe:
            layer_types.append("mla_moe")
        elif is_mla:
            layer_types.append("mla")
        else:
            layer_types.append(LAYER_ATTENTION)
        det.has_mla |= is_mla
        det.has_moe |= is_moe
        det.has_ssm |= is_mamba

    det.layer_types = layer_types
    if det.has_ssm and any(t == LAYER_ATTENTION or t.startswith("mla") for t in layer_types):
        det.model_type = "hybrid"
    elif det.has_ssm:
        det.model_type = "mamba2"
    elif det.has_mla:
        det.model_type = "deepseek"
    elif any("mistral" in n for n in name_set):  # rarely in names; fallback llama
        det.model_type = "mistral"
    else:
        det.model_type = "llama"
    return det


def infer_config_from_shapes(
    names: list[str],
    shape_of: Callable[[str], tuple[int, ...]],
    detected: Optional[DetectedConfig] = None,
) -> UniversalConfig:
    """Infer hidden/vocab/intermediate/head dims from tensor shapes.

    ``shape_of`` maps tensor name → logical [out, in] / embedding shape.
    Works for both plain and AWQ/GPTQ checkpoints (caller passes logical
    shapes for quantized tensors).
    """
    detected = detected or detect_architecture_from_names(names)
    name_set = set(names)

    def find(*candidates: str) -> Optional[str]:
        for c in candidates:
            if c in name_set:
                return c
        return None

    hidden = vocab = None
    embed = find("model.embed_tokens.weight", "embed_tokens.weight",
                 "token_embd.weight", "transformer.wte.weight", "backbone.embeddings.weight",
                 "backbone.embedding.weight")
    if embed:
        vs, hs = shape_of(embed)
        vocab, hidden = int(vs), int(hs)

    inter = None
    gate = find("model.layers.0.mlp.gate_proj.weight", "layers.0.mlp.gate_proj.weight",
                "blk.0.ffn_gate.weight")
    if gate:
        inter = int(shape_of(gate)[0])

    num_heads = None
    num_kv_heads = None
    head_dim = None
    q = find("model.layers.0.self_attn.q_proj.weight", "layers.0.self_attn.q_proj.weight",
             "blk.0.attn_q.weight")
    k = find("model.layers.0.self_attn.k_proj.weight", "layers.0.self_attn.k_proj.weight",
             "blk.0.attn_k.weight")
    if q is not None and hidden:
        q_out = int(shape_of(q)[0])
        # Common head_dim guesses; prefer exact divisibility with 128 first.
        for hd in (128, 64, 96, 80, 256):
            if q_out % hd == 0 and (k is None or int(shape_of(k)[0]) % hd == 0):
                head_dim = hd
                break
        head_dim = head_dim or 128
        num_heads = q_out // head_dim
        if k is not None:
            num_kv_heads = int(shape_of(k)[0]) // head_dim

    attention = None
    if not (detected.has_ssm and not any(
            t == LAYER_ATTENTION or t.startswith("mla") for t in detected.layer_types)):
        attention = AttentionConfig(
            num_heads=num_heads or 32,
            num_kv_heads=num_kv_heads,
            head_dim=head_dim,
        )

    ssm = SsmConfig() if detected.has_ssm else None
    moe = None
    if detected.has_moe:
        expert_ids = set()
        for n in names:
            m = re.search(r"experts\.(\d+)\.", n)
            if m:
                expert_ids.add(int(m.group(1)))
        moe = MoeConfig(num_experts=(max(expert_ids) + 1) if expert_ids else 8)
        e0 = find("model.layers.0.mlp.experts.0.gate_proj.weight")
        if e0 is None:
            for n in names:
                if re.search(r"experts\.0\.gate_proj\.weight$", n):
                    e0 = n
                    break
        if e0:
            moe.intermediate_size = int(shape_of(e0)[0])

    hybrid_layers = None
    if detected.model_type == "hybrid":
        hybrid_layers = detected.layer_types

    return UniversalConfig(
        model_type=detected.model_type,
        vocab_size=vocab or 32000,
        hidden_size=hidden or 4096,
        num_layers=detected.num_layers or 32,
        intermediate_size=inter,
        attention=attention,
        ssm=ssm,
        moe=moe,
        hybrid_layers=hybrid_layers,
        tie_word_embeddings=detected.tie_word_embeddings,
    )
