"""GGUF metadata → UniversalConfig.

Copy of ``blazr_tpu/loader/gguf_config.py``: the architecture string's
family, MLA by ``kv_lora_rank``, the SSM keys, MoE by ``expert_count``,
the attention geometry and the RoPE base.
"""

from __future__ import annotations

from ..config.model_config import (
    AttentionConfig,
    MoeConfig,
    SsmConfig,
    UniversalConfig,
)
from ..formats.gguf import GgufMetadata
from ..formats.names import qk_permuted

# GGUF arch string → model_type.
_ARCH_MAP = {
    "llama": "llama", "llama2": "llama", "llama3": "llama",
    "mistral": "mistral",
    "deepseek": "deepseek", "deepseek2": "deepseek",
    "mamba": "mamba2", "mamba2": "mamba2", "mamba3": "mamba3",
    "falcon": "falcon",
    "qwen2": "qwen2", "qwen3": "qwen3",
    "phi3": "phi3",
    "gemma": "gemma", "gemma2": "gemma2",
    "starcoder2": "starcoder2",
}


def universal_from_gguf_metadata(md: GgufMetadata) -> UniversalConfig:
    arch = md.architecture() or "llama"
    model_type = _ARCH_MAP.get(arch, "llama")
    is_ssm = model_type in ("mamba2", "mamba3")

    vocab_size = md.get_u32("general.vocab_size")
    if vocab_size is None:
        tokens = md.get_array("tokenizer.ggml.tokens")
        vocab_size = len(tokens) if tokens else (
            128256 if model_type == "llama" else 32000
        )

    hidden_size = md.embedding_length()
    if hidden_size is None:
        raise ValueError(f"GGUF missing {arch}.embedding_length")
    num_layers = md.block_count()
    if num_layers is None:
        raise ValueError(f"GGUF missing {arch}.block_count")
    max_seq_len = md.context_length() or 4096

    intermediate = md.get_u32(f"{arch}.feed_forward_length")
    rms_norm_eps = (md.get_f32(f"{arch}.attention.layer_norm_rms_epsilon")
                    or md.get_f32(f"{arch}.attention.layer_norm_epsilon")
                    or 1e-5)

    attention = None
    if not is_ssm:
        num_heads = md.get_u32(f"{arch}.attention.head_count") or 32
        head_dim = md.get_u32(f"{arch}.attention.key_length") or (
            hidden_size // num_heads if num_heads else None
        )
        attention = AttentionConfig(
            num_heads=num_heads,
            num_kv_heads=md.get_u32(f"{arch}.attention.head_count_kv"),
            head_dim=head_dim,
            rope_theta=md.get_f32(f"{arch}.rope.freq_base") or 10000.0,
            kv_latent_dim=md.get_u32(f"{arch}.attention.kv_lora_rank"),
            q_latent_dim=md.get_u32(f"{arch}.attention.q_lora_rank"),
            d_rope=md.get_u32(f"{arch}.rope.dimension_count")
            if md.get_u32(f"{arch}.attention.kv_lora_rank") is not None else None,
            use_alibi=(model_type == "falcon"
                       and bool(md.get_u32(f"{arch}.attention.use_alibi"))),
        )
        if attention.is_mla:
            attention.v_head_dim = md.get_u32(f"{arch}.attention.value_length")

    ssm = None
    if is_ssm:
        state_size = md.get_u32(f"{arch}.ssm.state_size") or 64
        conv_kernel = md.get_u32(f"{arch}.ssm.conv_kernel") or 4
        inner = md.get_u32(f"{arch}.ssm.inner_size") or hidden_size * 2
        head_dim = md.get_u32(f"{arch}.ssm.head_dim") or 64
        ssm = SsmConfig(
            variant=model_type,
            num_heads=inner // head_dim,
            head_dim=head_dim,
            state_size=state_size,
            chunk_size=256,
            n_groups=md.get_u32(f"{arch}.ssm.group_count") or 1,
            conv_kernel=conv_kernel,
            expand=(inner // hidden_size) if hidden_size else 2,
            complex_rope=True if model_type == "mamba3" else None,
        )

    moe = None
    n_exp = md.get_u32(f"{arch}.expert_count")
    if n_exp:
        moe = MoeConfig(
            num_experts=n_exp,
            experts_per_tok=md.get_u32(f"{arch}.expert_used_count") or 2,
            shared_expert=md.get_u32(f"{arch}.expert_shared_count"),
            intermediate_size=md.get_u32(f"{arch}.expert_feed_forward_length"),
        )

    return UniversalConfig(
        model_type=model_type,
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        num_layers=num_layers,
        max_seq_len=max_seq_len,
        intermediate_size=intermediate,
        rms_norm_eps=rms_norm_eps,
        attention=attention,
        ssm=ssm,
        moe=moe,
        # Falcon family: LayerNorm + non-gated exact-GELU MLP + parallel
        # residual blocks (both released falcon arches are parallel).
        norm_type="layernorm" if model_type in ("falcon", "starcoder2")
        else "rmsnorm",
        mlp_type="plain" if model_type in ("falcon", "starcoder2")
        else "gated",
        hidden_act=("gelu_exact" if model_type == "falcon"
                    else "gelu_tanh" if model_type == "starcoder2"
                    else "silu"),
        parallel_residual=model_type == "falcon",
    )


def gguf_qk_heads(md: GgufMetadata) -> dict[str, int]:
    """Heads of each Q/K projection whose rows a file of this architecture
    holds in llama.cpp's permuted order ({"q": n_head, "k": n_kv_head}), or
    {} where they keep HF's order (``formats.names.qk_permuted``)."""
    arch = md.architecture() or "llama"
    if not qk_permuted(arch):
        return {}
    n_head = md.get_u32(f"{arch}.attention.head_count")
    if n_head is None:
        raise ValueError(f"GGUF file of architecture {arch!r} holds permuted Q/K rows "
                         f"and no {arch}.attention.head_count to undo them with")
    return {"q": n_head, "k": md.get_u32(f"{arch}.attention.head_count_kv") or n_head}
