"""Tensor-name mapping: GGUF convention ↔ HF convention.

Copy of ``blazr_tpu/formats/names.py``. The in-memory naming is HF's; every
loader normalizes to it before ``models/registry.py`` takes the weights.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

# Non-layer (global) tensors.
_GLOBAL_GGUF_TO_HF = {
    "token_embd.weight": "model.embed_tokens.weight",
    "output_norm.weight": "model.norm.weight",
    "output_norm.bias": "model.norm.bias",
    "output.weight": "lm_head.weight",
    "output.bias": "lm_head.bias",
    "rope_freqs.weight": "rope_freqs.weight",
}

# Per-layer suffix mapping: gguf suffix → hf suffix.
_LAYER_GGUF_TO_HF = {
    # attention
    "attn_norm": "input_layernorm",
    "attn_norm_2": "pre_feedforward_layernorm",
    "attn_qkv": "self_attn.query_key_value",   # falcon fused MQA/GQA
    "attn_q": "self_attn.q_proj",
    "attn_k": "self_attn.k_proj",
    "attn_v": "self_attn.v_proj",
    "attn_output": "self_attn.o_proj",
    "attn_q_norm": "self_attn.q_norm",
    "attn_k_norm": "self_attn.k_norm",
    # MLP
    "ffn_norm": "post_attention_layernorm",
    "ffn_gate": "mlp.gate_proj",
    "ffn_up": "mlp.up_proj",
    "ffn_down": "mlp.down_proj",
    # MoE
    "ffn_gate_inp": "mlp.gate",
    "ffn_gate_exps": "mlp.experts.gate_proj",   # stacked [E, ...]
    "ffn_up_exps": "mlp.experts.up_proj",
    "ffn_down_exps": "mlp.experts.down_proj",
    "ffn_gate_shexp": "mlp.shared_experts.gate_proj",
    "ffn_up_shexp": "mlp.shared_experts.up_proj",
    "ffn_down_shexp": "mlp.shared_experts.down_proj",
    "exp_probs_b": "mlp.gate.e_score_correction_bias",
    # DeepSeek MLA
    "attn_q_a": "self_attn.q_a_proj",
    "attn_q_b": "self_attn.q_b_proj",
    "attn_kv_a_mqa": "self_attn.kv_a_proj_with_mqa",
    "attn_kv_b": "self_attn.kv_b_proj",
    "attn_k_b": "self_attn.k_b_proj",
    "attn_v_b": "self_attn.v_b_proj",
    "attn_q_a_norm": "self_attn.q_a_layernorm",
    "attn_kv_a_norm": "self_attn.kv_a_layernorm",
    # Mamba2 SSM
    "ssm_in": "mixer.in_proj",
    "ssm_conv1d": "mixer.conv1d",
    "ssm_x": "mixer.x_proj",
    "ssm_dt": "mixer.dt_proj",
    "ssm_a": "mixer.A_log",
    "ssm_d": "mixer.D",
    "ssm_norm": "mixer.norm",
    "ssm_out": "mixer.out_proj",
}

_HF_TO_LAYER_GGUF = {v: k for k, v in _LAYER_GGUF_TO_HF.items()}
_HF_TO_GLOBAL_GGUF = {v: k for k, v in _GLOBAL_GGUF_TO_HF.items()}

_BLK_RE = re.compile(r"^blk\.(\d+)\.(.+?)(\.(weight|bias))?$")
_HF_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+?)(\.(weight|bias))?$")


def gguf_to_hf_name(name: str) -> str:
    """Map one GGUF tensor name to the HF convention (identity if unknown)."""
    if name in _GLOBAL_GGUF_TO_HF:
        return _GLOBAL_GGUF_TO_HF[name]
    m = _BLK_RE.match(name)
    if not m:
        return name
    idx, mid, _, leaf = m.group(1), m.group(2), m.group(3), m.group(4)
    hf_mid = _LAYER_GGUF_TO_HF.get(mid)
    if hf_mid is None:
        return name
    leaf = leaf or "weight"
    return f"model.layers.{idx}.{hf_mid}.{leaf}"


def hf_to_gguf_name(name: str) -> str:
    """Inverse mapping (used by the convert CLI)."""
    if name in _HF_TO_GLOBAL_GGUF:
        return _HF_TO_GLOBAL_GGUF[name]
    m = _HF_LAYER_RE.match(name)
    if not m:
        return name
    idx, mid, _, leaf = m.group(1), m.group(2), m.group(3), m.group(4)
    g_mid = _HF_TO_LAYER_GGUF.get(mid)
    if g_mid is None:
        return name
    leaf = leaf or "weight"
    return f"blk.{idx}.{g_mid}.{leaf}"


# ---------------------------------------------------------------------------
# llama.cpp's Q/K row order
# ---------------------------------------------------------------------------

# llama.cpp's convert_hf_to_gguf.py permutes the rows of attn_q and attn_k
# for its `llama` architecture (Llama, Mistral and Mixtral files) so that
# its adjacent-pair rope applies. The models here rotate halves (HF
# rotate_half), so the loader undoes the permutation and `convert` applies
# it, both on this one predicate. The JAX package does neither (ROADMAP §C).
QK_PERMUTED_ARCHS = frozenset({"llama"})


def qk_permuted(arch: Optional[str]) -> bool:
    """Whether a GGUF file of architecture ``arch`` holds permuted Q/K rows."""
    return (arch or "llama") in QK_PERMUTED_ARCHS


def qk_row_order(n_rows: int, n_head: int, to_gguf: bool) -> np.ndarray:
    """Row indices of llama.cpp's Q/K permutation over ``n_head`` heads:
    ``w[order]`` permutes HF rows into GGUF order (``to_gguf``) or back
    (transformers' ``LlamaTensorProcessor._reverse_permute_weights``)."""
    half = n_rows // n_head // 2
    rows = np.arange(n_rows)
    if to_gguf:
        return rows.reshape(n_head, 2, half).swapaxes(1, 2).reshape(-1)
    return rows.reshape(n_head, half, 2).swapaxes(1, 2).reshape(-1)


_QK_NAME_RE = re.compile(r"^blk\.\d+\.attn_(q|k)\.(weight|bias)$")


def qk_heads_of(gguf_name: str, heads: dict[str, int]) -> Optional[int]:
    """The heads to permute tensor ``gguf_name`` over (``heads`` maps "q"
    and "k" to theirs), or None if its rows keep their order."""
    m = _QK_NAME_RE.match(gguf_name)
    return heads.get(m.group(1)) if m else None


def qk_rows(data, shape: tuple[int, ...], n_head: int, to_gguf: bool) -> np.ndarray:
    """Permute the rows of a Q/K tensor of logical ``shape`` ([out, in] or
    [out]), given as a float array or as raw ggml bytes (a row's blocks run
    along ``in``, so a quantized row moves whole)."""
    rows = np.asarray(data) if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    rows = rows.reshape(shape[0], -1)
    out = np.ascontiguousarray(rows[qk_row_order(shape[0], n_head, to_gguf)])
    return out if not isinstance(data, np.ndarray) else out.reshape(data.shape)
