"""Model configuration dataclasses.

A copy of the dataclasses of ``blazr_tpu/config/model_config.py`` (the port
imports nothing of the JAX package). The HF ``config.json`` conversion
comes with checkpoint loading, in a later slice.

``UniversalConfig`` is the single model-architecture description every
subsystem consumes: loaders fill it from checkpoint metadata (HF
config.json, GGUF metadata, or tensor-name sniffing), the model registry
builds forward functions from it, and the engine sizes KV caches from it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional


@dataclass
class RopeScaling:
    """RoPE scaling description (HF ``rope_scaling`` field).

    Supports the linear / dynamic-NTK / llama3 / yarn families.
    """

    rope_type: str = "linear"
    factor: float = 1.0
    # llama3-style frequency-band scaling
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RopeScaling":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        # HF uses "type" or "rope_type"
        rt = d.get("rope_type", d.get("type", "linear"))
        kwargs["rope_type"] = rt
        return cls(**kwargs)


@dataclass
class AttentionConfig:
    """Attention sub-config (reference AttentionConfig, SURVEY §2.9).

    ``kv_latent_dim``/``q_latent_dim``/``d_rope`` being set marks DeepSeek
    MLA latent-KV attention (reference: src/loader/gguf.rs:188-196).
    """

    num_heads: int = 32
    num_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    # DeepSeek MLA
    kv_latent_dim: Optional[int] = None      # kv_lora_rank
    q_latent_dim: Optional[int] = None       # q_lora_rank
    d_rope: Optional[int] = None             # decoupled RoPE dims (qk_rope_head_dim)
    d_nope: Optional[int] = None             # qk_nope_head_dim (MLA)
    v_head_dim: Optional[int] = None         # MLA value head dim
    sliding_window: Optional[int] = None
    use_alibi: bool = False
    # qkv bias (Qwen2-style)
    qkv_bias: bool = False
    # MLA decoupled-RoPE pairing convention (HF deepseek rope_interleave)
    rope_interleave: bool = True

    def kv_heads(self) -> int:
        return self.num_kv_heads if self.num_kv_heads is not None else self.num_heads

    def resolved_head_dim(self, hidden_size: int) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return hidden_size // self.num_heads

    @property
    def is_mla(self) -> bool:
        return self.kv_latent_dim is not None


@dataclass
class SsmConfig:
    """Mamba2 state-space sub-config (reference SsmConfig, SURVEY §2.9;
    GGUF key mapping reference: src/loader/gguf.rs:219-265)."""

    variant: str = "mamba2"
    num_heads: int = 32
    head_dim: int = 64
    state_size: int = 64        # N (SSM state dim per head)
    chunk_size: int = 256       # chunked-scan block length
    n_groups: int = 1           # B/C groups
    conv_kernel: int = 4
    expand: int = 2
    complex_rope: Optional[bool] = None   # mamba3
    mimo_rank: Optional[int] = None
    use_conv: Optional[bool] = None

    @property
    def inner_size(self) -> int:
        return self.num_heads * self.head_dim


@dataclass
class MoeConfig:
    """Mixture-of-experts sub-config (reference MoeConfig, SURVEY §2.9;
    GGUF mapping reference: src/loader/gguf.rs:271-286)."""

    num_experts: int = 8
    experts_per_tok: int = 2
    shared_expert: Optional[int] = None          # number of shared experts (DeepSeek)
    intermediate_size: Optional[int] = None      # per-expert FFN dim
    load_balance_alpha: float = 0.01
    z_loss_alpha: float = 1e-3
    # DeepSeek extensions
    num_dense_layers: int = 0                    # first_k_dense_replace
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"                # softmax | sigmoid (v3)
    n_group: int = 1                             # group-limited routing (v3)
    topk_group: int = 1
    # Serve-time flag (set by the executor, never by checkpoints): route
    # MoE forwards through the expert-parallel all-to-all path when the
    # serving mesh has an ``ep`` axis.
    use_ep: bool = False
    # Opt-in host-side counting of EP capacity drops (parallel/ep.py
    # DROPPED_TOKENS, surfaced as /metrics moe_ep_tokens_dropped_total).
    ep_count_drops: bool = False


@dataclass
class VisionConfig:
    """Vision-encoder sub-config (multimodal; reference UniversalConfig.vision)."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    intermediate_size: int = 4096
    projection_dim: int = 4096


@dataclass
class AudioConfig:
    """Audio-encoder sub-config (reference UniversalConfig.audio)."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    n_mels: int = 80
    sample_rate: int = 16000


# Layer-type markers for hybrid models (reference boostr LayerType re-export,
# src/model/detect.rs:6).
LAYER_ATTENTION = "attention"
LAYER_MAMBA2 = "mamba2"
LAYER_MLA = "mla"
LAYER_MLA_MOE = "mla_moe"


@dataclass
class UniversalConfig:
    """The universal model-architecture description.

    Counterpart of boostr's ``UniversalConfig`` (SURVEY §2.9).
    """

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    max_seq_len: int = 4096
    intermediate_size: Optional[int] = None
    rms_norm_eps: float = 1e-5
    attention: Optional[AttentionConfig] = None
    ssm: Optional[SsmConfig] = None
    moe: Optional[MoeConfig] = None
    # Per-layer type list for hybrid models (e.g. Mamba2 + attention mixes).
    hybrid_layers: Optional[list[str]] = None
    tie_word_embeddings: bool = False
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    # Gemma-style final logit softcap / embedding scaling
    final_logit_softcapping: Optional[float] = None
    attn_logit_softcapping: Optional[float] = None
    scale_embeddings: bool = False
    # starcoder2/falcon family: full LayerNorm + non-gated MLP
    norm_type: str = "rmsnorm"            # rmsnorm | layernorm
    mlp_type: str = "gated"               # gated (SwiGLU/GeGLU) | plain
    hidden_act: str = "silu"
    # Falcon parallel blocks: attention + MLP read the same normed input
    # and share one residual add (HF parallel_attn / new_decoder_architecture).
    parallel_residual: bool = False

    # ---- derived helpers -------------------------------------------------
    def resolved_intermediate_size(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        return 4 * self.hidden_size

    def layer_types(self) -> list[str]:
        """Resolve per-layer types for hybrid models.

        Pure attention unless ``ssm``/``moe``/``hybrid_layers`` say otherwise.
        """
        if self.hybrid_layers is not None:
            return list(self.hybrid_layers)
        if self.ssm is not None and self.attention is None:
            return [LAYER_MAMBA2] * self.num_layers
        if self.attention is not None and self.attention.is_mla:
            if self.moe is not None:
                dense = self.moe.num_dense_layers
                return [LAYER_MLA] * dense + [LAYER_MLA_MOE] * (self.num_layers - dense)
            return [LAYER_MLA] * self.num_layers
        return [LAYER_ATTENTION] * self.num_layers

    @property
    def needs_ssm_state(self) -> bool:
        return any(t == LAYER_MAMBA2 for t in self.layer_types())

    @property
    def needs_kv_cache(self) -> bool:
        return any(t != LAYER_MAMBA2 for t in self.layer_types())

    # ---- serde -----------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return _asdict_not_none(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "UniversalConfig":
        d = dict(d)
        if (att := d.get("attention")) is not None and isinstance(att, dict):
            if isinstance(att.get("rope_scaling"), dict):
                att = dict(att)
                att["rope_scaling"] = RopeScaling.from_dict(att["rope_scaling"])
            d["attention"] = _dataclass_from_dict(AttentionConfig, att)
        if isinstance(d.get("ssm"), dict):
            d["ssm"] = _dataclass_from_dict(SsmConfig, d["ssm"])
        if isinstance(d.get("moe"), dict):
            d["moe"] = _dataclass_from_dict(MoeConfig, d["moe"])
        if isinstance(d.get("vision"), dict):
            d["vision"] = _dataclass_from_dict(VisionConfig, d["vision"])
        if isinstance(d.get("audio"), dict):
            d["audio"] = _dataclass_from_dict(AudioConfig, d["audio"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json_file(cls, path: str | Path) -> "UniversalConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _dataclass_from_dict(cls, d):
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


def _asdict_not_none(obj) -> dict[str, Any]:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            v = _asdict_not_none(v)
        out[f.name] = v
    return out
