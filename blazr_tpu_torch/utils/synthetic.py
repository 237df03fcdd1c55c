"""Synthetic params, checkpoints and tokenizers (no checkpoint is downloaded).

Counterpart of ``blazr_tpu/utils/synthetic.py``: the same configs and the
same weight distributions, built on the device from a seeded
``torch.Generator``. The draws differ from ``jax.random``'s; tests that
compare the two packages convert the JAX params with ``convert.py``.

Beyond the JAX module: one config per dense family and per MoE family at
the published width of a public checkpoint (``FAMILY_CONFIGS``,
``MOE_CONFIGS``), the family extras and the MoE layers in
``synth_llama_params``, ``write_hf_checkpoint``, which writes a family's
HF tensor layout (AWQ-INT4 or plain) with its ``config.json``, and
``write_gguf_checkpoint``, which writes a llama-layout GGUF file in
llama.cpp's Q4_K_M mix (or one ggml type) with an embedded SentencePiece
tokenizer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.model_config import (AttentionConfig, MoeConfig, RopeScaling, SsmConfig,
                                   UniversalConfig)
from ..quant.qtensor import QuantTensor, stack_quant
from .device import DeviceLike, resolve_device


def mistral_7b_config() -> UniversalConfig:
    """Mistral-7B-v0.1 geometry (public config, sliding_window 4096)."""
    return UniversalConfig(
        model_type="mistral", vocab_size=32000, hidden_size=4096, num_layers=32,
        max_seq_len=4096, intermediate_size=14336, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  rope_theta=10000.0, sliding_window=4096),
    )


def mistral_7b_instruct_v02_config() -> UniversalConfig:
    """mistralai/Mistral-7B-Instruct-v0.2 config.json: Mistral-7B's widths,
    rope_theta 1e6, no sliding window, a 32768-token context."""
    return UniversalConfig(
        model_type="mistral", vocab_size=32000, hidden_size=4096, num_layers=32,
        max_seq_len=32768, intermediate_size=14336, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  rope_theta=1000000.0),
    )


def llama_3_2_1b_config() -> UniversalConfig:
    """Llama-3.2-1B geometry (public config)."""
    return UniversalConfig(
        model_type="llama", vocab_size=128256, hidden_size=2048, num_layers=16,
        max_seq_len=8192, intermediate_size=8192, rms_norm_eps=1e-5,
        attention=AttentionConfig(
            num_heads=32, num_kv_heads=8, head_dim=64, rope_theta=500000.0,
            rope_scaling=RopeScaling(rope_type="llama3", factor=32.0),
        ),
        tie_word_embeddings=True,
    )


def qwen2_7b_config() -> UniversalConfig:
    """Qwen/Qwen2.5-7B-Instruct config.json: qkv biases, 7:1 GQA (its
    sliding_window 131072 is off by use_sliding_window; the loader reads it,
    as the JAX one does, and it never binds below 131072 tokens)."""
    return UniversalConfig(
        model_type="qwen2", vocab_size=152064, hidden_size=3584, num_layers=28,
        max_seq_len=32768, intermediate_size=18944, rms_norm_eps=1e-6,
        attention=AttentionConfig(num_heads=28, num_kv_heads=4, head_dim=128,
                                  rope_theta=1000000.0, sliding_window=131072,
                                  qkv_bias=True))


def qwen3_8b_config() -> UniversalConfig:
    """Qwen/Qwen3-8B config.json: per-head QK norm."""
    return UniversalConfig(
        model_type="qwen3", vocab_size=151936, hidden_size=4096, num_layers=36,
        max_seq_len=40960, intermediate_size=12288, rms_norm_eps=1e-6,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  rope_theta=1000000.0))


def phi3_mini_config() -> UniversalConfig:
    """microsoft/Phi-3-mini-4k-instruct config.json: fused qkv and gate+up,
    head_dim 96, no GQA, sliding_window 2047."""
    return UniversalConfig(
        model_type="phi3", vocab_size=32064, hidden_size=3072, num_layers=32,
        max_seq_len=4096, intermediate_size=8192, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=96,
                                  rope_theta=10000.0, sliding_window=2047))


def gemma_7b_config() -> UniversalConfig:
    """google/gemma-7b config.json: GeGLU, (1 + w) norms, scaled and tied
    embeddings, head_dim 256."""
    return UniversalConfig(
        model_type="gemma", vocab_size=256000, hidden_size=3072, num_layers=28,
        max_seq_len=8192, intermediate_size=24576, rms_norm_eps=1e-6,
        attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=256,
                                  rope_theta=10000.0),
        tie_word_embeddings=True, scale_embeddings=True)


def gemma2_9b_config() -> UniversalConfig:
    """google/gemma-2-9b config.json: sandwich norms, attention and final
    softcaps 50 / 30, a 4096-token window on the even layers,
    query_pre_attn_scalar 256."""
    return UniversalConfig(
        model_type="gemma2", vocab_size=256000, hidden_size=3584, num_layers=42,
        max_seq_len=8192, intermediate_size=14336, rms_norm_eps=1e-6,
        attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                                  rope_theta=10000.0, sliding_window=4096,
                                  window_layers=[i % 2 == 0 for i in range(42)],
                                  query_pre_attn_scalar=256),
        tie_word_embeddings=True, scale_embeddings=True,
        final_logit_softcapping=30.0, attn_logit_softcapping=50.0)


def starcoder2_7b_config() -> UniversalConfig:
    """bigcode/starcoder2-7b config.json: LayerNorm with biases, a plain
    GELU MLP, biases everywhere, a 4096-token window, tied embeddings (its
    config sets no tie_word_embeddings; HF's default ties)."""
    return UniversalConfig(
        model_type="starcoder2", vocab_size=49152, hidden_size=4608, num_layers=32,
        max_seq_len=16384, intermediate_size=18432, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=36, num_kv_heads=4, head_dim=128,
                                  rope_theta=1000000.0, sliding_window=4096,
                                  qkv_bias=True),
        tie_word_embeddings=True, norm_type="layernorm", mlp_type="plain",
        hidden_act="gelu_tanh")


def falcon_7b_config() -> UniversalConfig:
    """tiiuae/falcon-7b config.json: fused multi-query qkv (71 heads on one
    kv head of 64), parallel attention and MLP on one LayerNorm, no biases,
    rope; hidden 4544, not a multiple of 128."""
    return UniversalConfig(
        model_type="falcon", vocab_size=65024, hidden_size=4544, num_layers=32,
        max_seq_len=2048, intermediate_size=18176, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=71, num_kv_heads=1, head_dim=64,
                                  rope_theta=10000.0),
        tie_word_embeddings=True, norm_type="layernorm", mlp_type="plain",
        hidden_act="gelu_exact", parallel_residual=True)


# The dense families at the published width of one public checkpoint each.
FAMILY_CONFIGS = {"qwen2": qwen2_7b_config, "qwen3": qwen3_8b_config,
                  "phi3": phi3_mini_config, "gemma": gemma_7b_config,
                  "gemma2": gemma2_9b_config, "starcoder2": starcoder2_7b_config,
                  "falcon": falcon_7b_config}


def mixtral_8x7b_config() -> UniversalConfig:
    """mistralai/Mixtral-8x7B-v0.1 config.json: Mistral-7B's attention (no
    window), 8 experts of 14336, top-2, the top-2 weights renormalized."""
    return UniversalConfig(
        model_type="mixtral", vocab_size=32000, hidden_size=4096, num_layers=32,
        max_seq_len=32768, intermediate_size=14336, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  rope_theta=1000000.0),
        moe=MoeConfig(num_experts=8, experts_per_tok=2, intermediate_size=14336,
                      norm_topk_prob=True))


def qwen3_30b_a3b_config() -> UniversalConfig:
    """Qwen/Qwen3-30B-A3B config.json: Qwen3's QK norm, head_dim 128 over a
    2048 hidden, 128 experts of 768, top-8 with norm_topk_prob, every layer
    sparse (decoder_sparse_step 1, no mlp_only_layers)."""
    return UniversalConfig(
        model_type="qwen3_moe", vocab_size=151936, hidden_size=2048, num_layers=48,
        max_seq_len=40960, intermediate_size=6144, rms_norm_eps=1e-6,
        attention=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=128,
                                  rope_theta=1000000.0),
        moe=MoeConfig(num_experts=128, experts_per_tok=8, intermediate_size=768,
                      norm_topk_prob=True))


def qwen1_5_moe_a2_7b_config() -> UniversalConfig:
    """Qwen/Qwen1.5-MoE-A2.7B config.json: qkv biases, 60 experts of 1408,
    top-4 without renormalizing, one shared expert of 5632 behind a sigmoid
    gate (its use_sliding_window is off)."""
    return UniversalConfig(
        model_type="qwen2_moe", vocab_size=151936, hidden_size=2048, num_layers=24,
        max_seq_len=8192, intermediate_size=5632, rms_norm_eps=1e-6,
        attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                                  rope_theta=1000000.0, qkv_bias=True),
        moe=MoeConfig(num_experts=60, experts_per_tok=4, intermediate_size=1408,
                      shared_expert_intermediate_size=5632, norm_topk_prob=False))


# The MoE families at the published width of one public checkpoint each.
MOE_CONFIGS = {"mixtral": mixtral_8x7b_config, "qwen3_moe": qwen3_30b_a3b_config,
               "qwen2_moe": qwen1_5_moe_a2_7b_config}


def deepseek_v2_lite_config() -> UniversalConfig:
    """deepseek-ai/DeepSeek-V2-Lite config.json: MLA (kv_lora_rank 512, no
    q_lora_rank, 128 nope + 64 rope dims, v 128) under YaRN (factor 40),
    64 routed experts of 1408, top-6 by softmax without renormalizing, 2
    shared experts, layer 0 dense (10944)."""
    return UniversalConfig(
        model_type="deepseek", vocab_size=102400, hidden_size=2048, num_layers=27,
        max_seq_len=163840, intermediate_size=10944, rms_norm_eps=1e-6,
        attention=AttentionConfig(
            num_heads=16, num_kv_heads=16, rope_theta=10000.0,
            rope_scaling=RopeScaling(rope_type="yarn", factor=40.0,
                                     original_max_position_embeddings=4096,
                                     beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                                     mscale_all_dim=0.707),
            kv_latent_dim=512, d_rope=64, d_nope=128, v_head_dim=128),
        moe=MoeConfig(num_experts=64, experts_per_tok=6, shared_expert=2,
                      intermediate_size=1408, num_dense_layers=1,
                      routed_scaling_factor=1.0, norm_topk_prob=False))


def mamba_codestral_7b_config() -> UniversalConfig:
    """mistralai/Mamba-Codestral-7B-v0.1 config.json (Mamba2ForCausalLM):
    64 layers of 128 heads x 64, state 128, 8 groups, expand 2, conv 4."""
    return UniversalConfig(
        model_type="mamba2", vocab_size=32768, hidden_size=4096, num_layers=64,
        max_seq_len=4096, rms_norm_eps=1e-5, attention=None,
        ssm=SsmConfig(num_heads=128, head_dim=64, state_size=128, chunk_size=256,
                      n_groups=8, conv_kernel=4, expand=2))


def bamba_9b_config() -> UniversalConfig:
    """ibm-ai-platform/Bamba-9B's widths in the hybrid layout the JAX package
    reads (``layer_types``, ``mixer.*``, ``mlp.*``): 32 layers, attention
    (32 query heads, 8 kv heads of 128) at layers 9, 18 and 27, Mamba2
    (128 heads x 64, state 128, 1 group) elsewhere, an MLP of 14336 on
    every layer."""
    types = ["attention" if i in (9, 18, 27) else "mamba2" for i in range(32)]
    return UniversalConfig(
        model_type="bamba", vocab_size=128256, hidden_size=4096, num_layers=32,
        max_seq_len=4096, intermediate_size=14336, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, rope_theta=10000.0),
        ssm=SsmConfig(num_heads=128, head_dim=64, state_size=128, n_groups=1,
                      conv_kernel=4, expand=2),
        hybrid_layers=types)


# The MLA, Mamba2 and hybrid families at the published width of one public
# checkpoint each.
RECURRENT_CONFIGS = {"deepseek": deepseek_v2_lite_config,
                     "mamba2": mamba_codestral_7b_config, "bamba": bamba_9b_config}


def tiny_recurrent_config(family: str) -> UniversalConfig:
    """``RECURRENT_CONFIGS[family]`` cut to hidden 64 for the CPU tests:
    DeepSeek with 4 heads (latent 32, 16 nope + 16 rope dims, v 16), layer
    0 dense and layer 1 with 4 experts of 32 (top-2) and one shared expert,
    no rope scaling; Mamba2 with 2 layers of 8 heads x 16, state 16, 2
    groups; the hybrid with 3 layers (Mamba2, attention of 4 heads of 16 on
    2 kv heads, Mamba2) and the same mixer."""
    import dataclasses

    cfg = RECURRENT_CONFIGS[family]()
    cfg = dataclasses.replace(cfg, vocab_size=256, hidden_size=64,
                              num_layers=3 if family == "bamba" else 2, max_seq_len=512,
                              intermediate_size=96)
    if family == "deepseek":
        cfg.attention = dataclasses.replace(
            cfg.attention, num_heads=4, num_kv_heads=4, kv_latent_dim=32, d_rope=16,
            d_nope=16, v_head_dim=16, rope_scaling=None)
        cfg.moe = dataclasses.replace(cfg.moe, num_experts=4, experts_per_tok=2,
                                      intermediate_size=32, shared_expert=1)
        return cfg
    cfg.ssm = dataclasses.replace(cfg.ssm, num_heads=8, head_dim=16, state_size=16,
                                  n_groups=2)
    if family == "bamba":
        cfg.attention = dataclasses.replace(cfg.attention, num_heads=4, num_kv_heads=2,
                                            head_dim=16)
        cfg.hybrid_layers = ["mamba2", "attention", "mamba2"]
    return cfg


def tiny_llama_config(vocab: int = 256) -> UniversalConfig:
    return UniversalConfig(
        model_type="llama", vocab_size=vocab, hidden_size=64, num_layers=2,
        max_seq_len=512, intermediate_size=128,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    )


def _rand_awq_qt(gen: torch.Generator, k: int, n: int, group_size: int,
                 device: torch.device) -> QuantTensor:
    """Random AWQ-style canonical QuantTensor (signed 4-bit payload, as the
    loaders produce after sign biasing), drawn on ``device``."""
    qweight = torch.randint(-2 ** 31, 2 ** 31 - 1, (k * 4 // 32, n),
                            dtype=torch.int32, device=device, generator=gen)
    scales = torch.rand((k // group_size, n), device=device, generator=gen) * 0.01 + 0.001
    zeros = torch.randint(0, 16, (k // group_size, n), device=device,
                          generator=gen).to(torch.float32)
    return QuantTensor(qweight=qweight, scales=scales, mins=scales * zeros,
                       perm=None, bits=4, group_size=group_size, signed=True,
                       in_features=k, out_features=n, fmt="awq")


def _rand_dense(gen: torch.Generator, k: int, n: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    return (torch.randn((k, n), device=device, generator=gen) * 0.02).to(dtype)


def synth_llama_params(cfg: UniversalConfig, quant: str = "awq",
                       dtype: torch.dtype = torch.bfloat16, group_size: int = 128,
                       seed: int = 0, fuse: bool = True,
                       device: DeviceLike = None) -> dict:
    """Random params of a dense family matching ``cfg`` ('awq' or 'dense')
    on ``device`` (default ``cuda``). ``fuse=True`` emits fused qkv / gateup
    projections (the serving layout). Norm weights are ones (zeros where the
    family scales by 1 + w); the family's extras follow ``cfg``: qkv biases
    (``qkv_bias``), QK norms (qwen3), Gemma2's sandwich norms, the plain
    MLP and LayerNorm biases (starcoder2, falcon), and where ``cfg.moe`` is
    set an MoE FFN on every layer in place of the MLP (router, stacked
    experts, Qwen2-MoE's gated shared expert)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    att = cfg.attention
    h = cfg.hidden_size
    hd = att.resolved_head_dim(h)
    q_out = att.num_heads * hd
    kv_out = att.kv_heads() * hd
    inter = cfg.resolved_intermediate_size()

    def lin(k_dim, n_dim):
        if quant == "awq":
            return _rand_awq_qt(gen, k_dim, n_dim, group_size, dev)
        return _rand_dense(gen, k_dim, n_dim, dtype, dev)

    def norm_w(n):
        fill = 0.0 if cfg.model_type in ("gemma", "gemma2") else 1.0
        return torch.full((n,), fill, dtype=dtype, device=dev)

    def bias(n):
        return (torch.randn((n,), device=dev, generator=gen) * 0.02).to(dtype)

    def moe_ffn():
        moe = cfg.moe
        mi = moe.intermediate_size

        def stack(k_dim, n_dim):
            ws = [lin(k_dim, n_dim) for _ in range(moe.num_experts)]
            return stack_quant(ws) if quant == "awq" else torch.stack(ws)

        p = {"router": _rand_dense(gen, h, moe.num_experts, dtype, dev),
             "correction_bias": None, "experts_gate": stack(h, mi),
             "experts_up": stack(h, mi), "experts_down": stack(mi, h)}
        if moe.shared_expert_intermediate_size:
            si = moe.shared_expert_intermediate_size
            p.update(shared_gate=lin(h, si), shared_up=lin(h, si), shared_down=lin(si, h),
                     shared_expert_gate=_rand_dense(gen, h, 1, dtype, dev))
        return p

    layer_norm = cfg.norm_type == "layernorm"
    layers = []
    for _ in range(cfg.num_layers):
        layer = {"input_norm": norm_w(h), "post_norm": norm_w(h), "o": lin(q_out, h)}
        if cfg.moe is None:
            layer["down"] = lin(inter, h)
        if fuse:
            layer["qkv"] = lin(h, q_out + 2 * kv_out)
        else:
            layer.update({"q": lin(h, q_out), "k": lin(h, kv_out), "v": lin(h, kv_out)})
        if att.qkv_bias:
            if fuse:
                layer["qkv_bias"] = bias(q_out + 2 * kv_out)
            else:
                layer.update({"q_bias": bias(q_out), "k_bias": bias(kv_out),
                              "v_bias": bias(kv_out)})
        if cfg.moe is not None:
            layer["moe"] = moe_ffn()
        elif cfg.mlp_type == "plain":
            layer["fc"] = lin(h, inter)
            if att.qkv_bias:                    # starcoder2: biases everywhere
                layer.update({"fc_bias": bias(inter), "down_bias": bias(h),
                              "o_bias": bias(h)})
        elif fuse:
            layer["gateup"] = lin(h, 2 * inter)
        else:
            layer.update({"gate": lin(h, inter), "up": lin(h, inter)})
        if layer_norm:
            layer.update({"input_norm_bias": bias(h), "post_norm_bias": bias(h)})
        if cfg.model_type in ("qwen3", "qwen3_moe"):
            layer.update({"q_norm": norm_w(hd), "k_norm": norm_w(hd)})
        if cfg.model_type == "gemma2":
            layer.update({"post_attn_norm": norm_w(h), "post_ffw_norm": norm_w(h)})
        layers.append(layer)
    params = {
        "embed": _rand_dense(gen, cfg.vocab_size, h, dtype, dev),
        "final_norm": norm_w(h),
        "layers": layers,
        "lm_head": None if cfg.tie_word_embeddings
        else _rand_dense(gen, h, cfg.vocab_size, dtype, dev),
    }
    if layer_norm:
        params["final_norm_bias"] = bias(h)
    return params


def synth_recurrent_params(cfg: UniversalConfig, quant: str = "awq",
                           dtype: torch.dtype = torch.bfloat16, group_size: int = 128,
                           seed: int = 0, device: DeviceLike = None) -> dict:
    """Random params of a DeepSeek (MLA), Mamba2 or hybrid ``cfg`` in the
    layout their builders give (``models/mla.py``, ``mamba2.py``,
    ``hybrid.py``), on ``device`` (default ``cuda``): projections AWQ-INT4
    ('awq') or dense, the absorbed ``kv_b`` halves in f32, a Mamba2 mixer's
    A_log, D and dt_bias as ``write_hf_checkpoint`` draws them, norm
    weights ones."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h = cfg.hidden_size
    inter = cfg.resolved_intermediate_size()
    f32 = torch.float32

    def lin(k_dim, n_dim):
        if quant == "awq":
            return _rand_awq_qt(gen, k_dim, n_dim, group_size, dev)
        return _rand_dense(gen, k_dim, n_dim, dtype, dev)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    def uniform(n, lo, hi):
        return torch.rand((n,), device=dev, generator=gen) * (hi - lo) + lo

    def mixer():
        ssm = cfg.ssm
        di, nh = ssm.inner_size, ssm.num_heads
        conv_dim = di + 2 * ssm.n_groups * ssm.state_size
        dt = torch.exp(uniform(nh, np.log(1e-3), np.log(1e-1)))
        return {"input_norm": ones(h), "in_proj": lin(h, conv_dim + di + nh),
                "conv_w": (torch.rand((conv_dim, ssm.conv_kernel), device=dev,
                                      generator=gen) - 0.5).to(dtype),
                "conv_b": (torch.randn((conv_dim,), device=dev, generator=gen)
                           * 0.02).to(dtype),
                "A_log": torch.log(uniform(nh, 1.0, 16.0)), "D": torch.ones(nh, device=dev),
                "dt_bias": dt + torch.log(-torch.expm1(-dt)), "norm": ones(di),
                "out_proj": lin(di, h)}

    def mlp(width):
        return {"post_norm": ones(h), "gate": lin(h, width), "up": lin(h, width),
                "down": lin(width, h)}

    layers = []
    for i, t in enumerate(cfg.layer_types()):
        if cfg.model_type == "deepseek":
            att, moe = cfg.attention, cfg.moe
            dn, dr, v, r, nh = (att.d_nope, att.d_rope, att.v_head_dim, att.kv_latent_dim,
                                att.num_heads)
            p = {"input_norm": ones(h), "post_norm": ones(h), "kv_a": lin(h, r + dr),
                 "kv_a_norm": ones(r), "o": lin(nh * v, h), "q": lin(h, nh * (dn + dr)),
                 "kv_b_k": torch.randn((r, nh, dn), device=dev, generator=gen,
                                       dtype=f32) * 0.02,
                 "kv_b_v": torch.randn((r, nh, v), device=dev, generator=gen,
                                       dtype=f32) * 0.02}
            if i < moe.num_dense_layers:
                p.update(mlp(inter))
            else:
                mi = moe.intermediate_size
                p["moe"] = {
                    "router": _rand_dense(gen, h, moe.num_experts, dtype, dev),
                    "correction_bias": None,
                    **{key: stack_quant([lin(k, n) for _ in range(moe.num_experts)])
                       if quant == "awq" else
                       torch.stack([lin(k, n) for _ in range(moe.num_experts)])
                       for key, k, n in (("experts_gate", h, mi), ("experts_up", h, mi),
                                         ("experts_down", mi, h))}}
                if moe.shared_expert:
                    si = mi * moe.shared_expert
                    p["moe"].update(shared_gate=lin(h, si), shared_up=lin(h, si),
                                    shared_down=lin(si, h))
        elif t == "mamba2":
            p = mixer()
            if cfg.model_type != "mamba2":
                p.update(mlp(inter))
        else:
            att = cfg.attention
            hd = att.resolved_head_dim(h)
            p = {"input_norm": ones(h), "q": lin(h, att.num_heads * hd),
                 "k": lin(h, att.kv_heads() * hd), "v": lin(h, att.kv_heads() * hd),
                 "o": lin(att.num_heads * hd, h), **mlp(inter)}
        layers.append(p)
    return {"embed": _rand_dense(gen, cfg.vocab_size, h, dtype, dev), "final_norm": ones(h),
            "layers": layers,
            "lm_head": None if cfg.tie_word_embeddings
            else _rand_dense(gen, h, cfg.vocab_size, dtype, dev)}


# ---------------------------------------------------------------------------
# Checkpoints and tokenizers on disk (the normal entry point's inputs)
# ---------------------------------------------------------------------------

_HF_ARCH = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
            "qwen2": "Qwen2ForCausalLM", "qwen3": "Qwen3ForCausalLM",
            "phi3": "Phi3ForCausalLM", "gemma": "GemmaForCausalLM",
            "gemma2": "Gemma2ForCausalLM", "starcoder2": "Starcoder2ForCausalLM",
            "falcon": "FalconForCausalLM", "mixtral": "MixtralForCausalLM",
            "qwen2_moe": "Qwen2MoeForCausalLM", "qwen3_moe": "Qwen3MoeForCausalLM"}


def _falcon_new_arch(cfg: UniversalConfig) -> bool:
    """Falcon's new decoder architecture (grouped kv heads, ln_attn and
    ln_mlp); the old one is multi-query or one kv head per head."""
    n_kv = cfg.attention.kv_heads()
    return 1 < n_kv < cfg.attention.num_heads


def _recurrent_hf_config(cfg: UniversalConfig) -> dict:
    """config.json of a DeepSeek (DeepseekV2's keys), Mamba2 (Mamba2's) or
    hybrid (the JAX package's hybrid layout) ``cfg``."""
    fam = cfg.model_type
    out = {"model_type": fam, "hidden_size": cfg.hidden_size,
           "num_hidden_layers": cfg.num_layers, "vocab_size": cfg.vocab_size,
           "tie_word_embeddings": cfg.tie_word_embeddings}
    if fam == "mamba2":
        ssm = cfg.ssm
        out.update(architectures=["Mamba2ForCausalLM"], num_heads=ssm.num_heads,
                   head_dim=ssm.head_dim, state_size=ssm.state_size,
                   n_groups=ssm.n_groups, expand=ssm.expand, conv_kernel=ssm.conv_kernel,
                   chunk_size=ssm.chunk_size, layer_norm_epsilon=cfg.rms_norm_eps,
                   rms_norm=True, use_conv_bias=True, use_bias=False,
                   residual_in_fp32=True)
        return out
    att = cfg.attention
    out.update(num_attention_heads=att.num_heads, num_key_value_heads=att.kv_heads(),
               intermediate_size=cfg.resolved_intermediate_size(),
               max_position_embeddings=cfg.max_seq_len, rms_norm_eps=cfg.rms_norm_eps,
               rope_theta=att.rope_theta)
    if fam == "deepseek":
        moe = cfg.moe
        sc = att.rope_scaling
        out.update(
            architectures=["DeepseekV2ForCausalLM"], model_type="deepseek_v2",
            kv_lora_rank=att.kv_latent_dim, q_lora_rank=att.q_latent_dim,
            qk_nope_head_dim=att.d_nope, qk_rope_head_dim=att.d_rope,
            v_head_dim=att.v_head_dim, n_routed_experts=moe.num_experts,
            num_experts_per_tok=moe.experts_per_tok, n_shared_experts=moe.shared_expert,
            moe_intermediate_size=moe.intermediate_size,
            first_k_dense_replace=moe.num_dense_layers, moe_layer_freq=1,
            norm_topk_prob=moe.norm_topk_prob,
            routed_scaling_factor=moe.routed_scaling_factor,
            scoring_func=moe.scoring_func, topk_method="greedy", n_group=moe.n_group,
            topk_group=moe.topk_group,
            rope_scaling=None if sc is None else {
                "type": sc.rope_type, "factor": sc.factor,
                "original_max_position_embeddings": sc.original_max_position_embeddings,
                "beta_fast": sc.beta_fast, "beta_slow": sc.beta_slow,
                "mscale": sc.mscale, "mscale_all_dim": sc.mscale_all_dim})
        return out
    ssm = cfg.ssm
    out.update(architectures=["HybridForCausalLM"],
               layer_types=["mamba" if t == "mamba2" else "attention"
                            for t in cfg.layer_types()],
               num_heads=ssm.num_heads, state_size=ssm.state_size,
               n_groups=ssm.n_groups, expand=ssm.expand, conv_kernel=ssm.conv_kernel)
    # One "head_dim" key serves both mixers in this layout: give it where they
    # share it, else leave it out (attention then takes hidden / heads and
    # the mixer its default of 64).
    hd = att.resolved_head_dim(cfg.hidden_size)
    if ssm.head_dim == hd:
        out["head_dim"] = hd
    elif not (att.head_dim in (None, cfg.hidden_size // att.num_heads)
              and ssm.head_dim == 64):
        raise ValueError("this hybrid layout cannot give attention and the mixer "
                         "different head widths")
    return out


def hf_config(cfg: UniversalConfig) -> dict:
    """The HF ``config.json`` fields of a family's ``cfg``."""
    if cfg.model_type in RECURRENT_CONFIGS:
        return _recurrent_hf_config(cfg)
    att = cfg.attention
    out = {
        "architectures": [_HF_ARCH[cfg.model_type]],
        "model_type": cfg.model_type, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.resolved_intermediate_size(),
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": att.num_heads,
        "num_key_value_heads": att.kv_heads(),
        "head_dim": att.resolved_head_dim(cfg.hidden_size),
        "vocab_size": cfg.vocab_size, "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": att.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings,
    }
    if att.sliding_window is not None:
        out["sliding_window"] = att.sliding_window
    if cfg.model_type in ("gemma", "gemma2"):
        out["hidden_activation"] = "gelu_pytorch_tanh"
    if cfg.model_type == "gemma2":
        out.update(attn_logit_softcapping=cfg.attn_logit_softcapping,
                   final_logit_softcapping=cfg.final_logit_softcapping,
                   query_pre_attn_scalar=att.query_pre_attn_scalar
                   or att.resolved_head_dim(cfg.hidden_size))
        if att.window_layers is not None:
            out["layer_types"] = ["sliding_attention" if w else "full_attention"
                                  for w in att.window_layers]
    if cfg.model_type == "starcoder2":
        out.update(norm_epsilon=cfg.rms_norm_eps, use_bias=True,
                   hidden_act="gelu_pytorch_tanh")
    moe = cfg.moe
    if moe is not None and cfg.model_type == "mixtral":      # one FFN width
        out.update(num_local_experts=moe.num_experts,
                   num_experts_per_tok=moe.experts_per_tok,
                   intermediate_size=moe.intermediate_size)
    elif moe is not None:
        out.update(num_experts=moe.num_experts, num_experts_per_tok=moe.experts_per_tok,
                   moe_intermediate_size=moe.intermediate_size,
                   norm_topk_prob=moe.norm_topk_prob, decoder_sparse_step=1,
                   mlp_only_layers=[])
        if moe.shared_expert_intermediate_size:
            out["shared_expert_intermediate_size"] = moe.shared_expert_intermediate_size
    if cfg.model_type == "falcon":
        new_arch = _falcon_new_arch(cfg)
        out.update(layer_norm_epsilon=cfg.rms_norm_eps, alibi=att.use_alibi,
                   bias=att.qkv_bias, parallel_attn=cfg.parallel_residual,
                   new_decoder_architecture=new_arch,
                   multi_query=att.kv_heads() == 1)
        if new_arch:
            out["num_kv_heads"] = att.kv_heads()
    return out


def _half_bits(rng, n: int, exp: int) -> np.ndarray:
    """``n`` random f16 values of magnitude in [2^exp, 2^(exp+2)) with a
    random sign, from raw generator bytes (a full-width embedding is 10^9
    values; a normal draw would take minutes)."""
    raw = np.frombuffer(rng.bytes(2 * n), np.uint16)
    # sign and mantissa random; exponent exp or exp + 1 by one random bit
    bits = (raw & np.uint16(0x83FF)) + (raw & np.uint16(0x0400)) + np.uint16((exp + 15) << 10)
    return bits.view(np.float16)


def write_hf_checkpoint(path, cfg: UniversalConfig, quant: str = "awq",
                        group_size: int = 128, seed: int = 0,
                        dtype: str = "float16", weight_exp: int = -7,
                        keep_plain: tuple[str, ...] = ()) -> None:
    """Write a random checkpoint of the family ``cfg.model_type`` in that
    family's HF tensor layout to the directory ``path``, with its
    ``config.json``:

    * llama, mistral, qwen2 (q/k/v biases), qwen3 (q/k norms), gemma,
      gemma2 (sandwich norms): split q/k/v/o and gate/up/down;
    * phi3: fused ``qkv_proj`` and ``gate_up_proj``;
    * starcoder2: ``c_fc``/``c_proj``, biases on every projection and norm;
    * falcon: ``transformer.h.{i}`` names, the fused ``query_key_value`` in
      HF's grouped layout (multi-query, per-head or the new architecture's
      groups), ``dense_h_to_4h``/``dense_4h_to_h``, biases with
      ``qkv_bias``, ``ln_attn``/``ln_mlp`` in the new architecture;
    * mixtral, qwen2_moe (qkv biases, the gated shared expert), qwen3_moe
      (q/k norms): per-expert projections under the family's names with an
      unquantized router (``moe_layer`` below);
    * deepseek: DeepseekV2's MLA names (``mla_attention``), a dense MLP on
      the first ``first_k_dense_replace`` layers, experts and shared experts
      on the rest (``deepseek_ffn``);
    * mamba2: HF Mamba2's ``backbone.*`` names (``mamba_mixer``);
    * bamba: the hybrid layout the JAX package reads: ``mixer.*`` or
      ``self_attn.*`` by ``layer_types``, and an ``mlp.*`` on every layer.

    ``quant="awq"``: every projection as AutoAWQ's packed ``qweight`` /
    ``qzeros`` (uint32, eight interleaved nibbles along N) and f16
    ``scales`` in [0.001, 0.011], the rest f16 (the loaders refuse a
    quantized falcon ``query_key_value``). ``quant="plain"``: every tensor
    in ``dtype`` ("float16", "bfloat16" or "float32"); under AWQ the
    projections whose names end with one of ``keep_plain`` stay plain too.
    Dense weights have a
    magnitude in [2^weight_exp, 2^(weight_exp+2)) and a random sign; norm
    weights are 1 + 0.1 N(0,1) (0.1 N(0,1) where the family scales by
    1 + w), biases 0.02 N(0,1)."""
    import json
    from pathlib import Path

    from ..formats.safetensors import write_safetensors

    if quant not in ("awq", "plain"):
        raise ValueError(f"quant must be 'awq' or 'plain', not {quant!r}")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    att = cfg.attention
    fam = cfg.model_type
    h = cfg.hidden_size
    hd = att.resolved_head_dim(h) if att is not None else 0
    n_q, n_kv = (att.num_heads * hd, att.kv_heads() * hd) if att is not None else (0, 0)
    inter = cfg.resolved_intermediate_size()
    falcon = fam == "falcon"
    float_dt = "float16" if quant == "awq" else dtype

    def cast(a: np.ndarray):
        if float_dt == "bfloat16":
            return torch.from_numpy(a).to(torch.bfloat16)
        return a.astype(np.float16 if float_dt == "float16" else np.float32)

    def dense(*shape):
        return cast(_half_bits(rng, int(np.prod(shape)), weight_exp).reshape(shape))

    def normal(n, std, mean=0.0):
        return cast(mean + std * rng.standard_normal(n, dtype=np.float32))

    def words(*shape):
        return np.frombuffer(rng.bytes(4 * int(np.prod(shape))), np.uint32).reshape(shape)

    tensors: dict = {}

    def linear(name, k, n, bias=False):
        """HF [out, in] weight (or AWQ's [in, out/8] planes) of ``name``."""
        if quant == "awq" and not name.endswith(keep_plain):
            tensors[name + ".qweight"] = words(k, n // 8)
            tensors[name + ".qzeros"] = words(k // group_size, n // 8)
            tensors[name + ".scales"] = (rng.random((k // group_size, n), np.float32)
                                         * 0.01 + 0.001).astype(np.float16)
        else:
            tensors[name + ".weight"] = dense(n, k)
        if bias:
            tensors[name + ".bias"] = normal(n, 0.02)

    offset = fam in ("gemma", "gemma2")

    def norm(name, with_bias=False):
        tensors[name + ".weight"] = normal(h, 0.1, 0.0 if offset else 1.0)
        if with_bias:
            tensors[name + ".bias"] = normal(h, 0.02)

    def moe_layer(p):
        """Mixtral's block_sparse_moe.experts.N.w1/w3/w2, or Qwen-MoE's
        mlp.experts.N.gate/up/down_proj with Qwen2-MoE's gated shared
        expert; the router (and the shared expert's gate) unquantized, as
        AutoAWQ leaves them."""
        moe = cfg.moe
        mi = moe.intermediate_size
        mixtral = fam == "mixtral"
        base = p + ("block_sparse_moe." if mixtral else "mlp.")
        tensors[base + "gate.weight"] = dense(moe.num_experts, h)
        parts = ("w1", "w3", "w2") if mixtral else ("gate_proj", "up_proj", "down_proj")
        for e in range(moe.num_experts):
            ex = base + f"experts.{e}."
            linear(ex + parts[0], h, mi)
            linear(ex + parts[1], h, mi)
            linear(ex + parts[2], mi, h)
        if moe.shared_expert_intermediate_size:
            si = moe.shared_expert_intermediate_size
            linear(p + "mlp.shared_expert.gate_proj", h, si)
            linear(p + "mlp.shared_expert.up_proj", h, si)
            linear(p + "mlp.shared_expert.down_proj", si, h)
            tensors[p + "mlp.shared_expert_gate.weight"] = dense(1, h)

    def mamba_mixer(p):
        """HF Mamba2's ``mixer.*``: in_proj and out_proj (quantized under
        AWQ), the depthwise conv [C, 1, k] with its bias, and f32 A_log, D
        and dt_bias drawn as HF initializes them (A in [1, 16], dt in
        [0.001, 0.1])."""
        ssm = cfg.ssm
        di, nh = ssm.inner_size, ssm.num_heads
        conv_dim = di + 2 * ssm.n_groups * ssm.state_size
        linear(p + "mixer.in_proj", h, conv_dim + di + nh)
        tensors[p + "mixer.conv1d.weight"] = cast(
            (rng.random((conv_dim, 1, ssm.conv_kernel), np.float32) - 0.5))
        tensors[p + "mixer.conv1d.bias"] = normal(conv_dim, 0.02)
        tensors[p + "mixer.A_log"] = np.log(rng.uniform(1, 16, nh)).astype(np.float32)
        tensors[p + "mixer.D"] = np.ones(nh, np.float32)
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), nh))
        tensors[p + "mixer.dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        tensors[p + "mixer.norm.weight"] = normal(di, 0.1, 1.0)
        linear(p + "mixer.out_proj", di, h)

    def mla_attention(p):
        """DeepSeek's ``self_attn.*``: q (or q_a/q_b with its norm),
        kv_a_proj_with_mqa, the kv_a norm, kv_b_proj (quantized under AWQ
        unless ``keep_plain`` names it) and o_proj."""
        dn, dr, v, r = att.d_nope, att.d_rope, att.v_head_dim, att.kv_latent_dim
        nh = att.num_heads
        if att.q_latent_dim:
            linear(p + "self_attn.q_a_proj", h, att.q_latent_dim)
            tensors[p + "self_attn.q_a_layernorm.weight"] = normal(att.q_latent_dim, 0.1, 1.0)
            linear(p + "self_attn.q_b_proj", att.q_latent_dim, nh * (dn + dr))
        else:
            linear(p + "self_attn.q_proj", h, nh * (dn + dr))
        linear(p + "self_attn.kv_a_proj_with_mqa", h, r + dr)
        tensors[p + "self_attn.kv_a_layernorm.weight"] = normal(r, 0.1, 1.0)
        linear(p + "self_attn.kv_b_proj", r, nh * (dn + v))
        linear(p + "self_attn.o_proj", nh * v, h)

    def deepseek_ffn(p, i):
        """Layer i's dense MLP (the first ``first_k_dense_replace``) or its
        experts with an unquantized router and the shared experts."""
        moe = cfg.moe
        if i < moe.num_dense_layers:
            linear(p + "mlp.gate_proj", h, inter)
            linear(p + "mlp.up_proj", h, inter)
            linear(p + "mlp.down_proj", inter, h)
            return
        mi = moe.intermediate_size
        tensors[p + "mlp.gate.weight"] = dense(moe.num_experts, h)
        for e in range(moe.num_experts):
            linear(p + f"mlp.experts.{e}.gate_proj", h, mi)
            linear(p + f"mlp.experts.{e}.up_proj", h, mi)
            linear(p + f"mlp.experts.{e}.down_proj", mi, h)
        if moe.shared_expert:
            si = mi * moe.shared_expert
            linear(p + "mlp.shared_experts.gate_proj", h, si)
            linear(p + "mlp.shared_experts.up_proj", h, si)
            linear(p + "mlp.shared_experts.down_proj", si, h)

    ln = cfg.norm_type == "layernorm"
    if fam == "mamba2":
        tensors["backbone.embeddings.weight"] = dense(cfg.vocab_size, h)
        norm("backbone.norm_f")
    elif falcon:
        tensors["transformer.word_embeddings.weight"] = dense(cfg.vocab_size, h)
        norm("transformer.ln_f", True)
    else:
        tensors["model.embed_tokens.weight"] = dense(cfg.vocab_size, h)
        norm("model.norm", ln)
    if not cfg.tie_word_embeddings:
        tensors["lm_head.weight"] = dense(cfg.vocab_size, h)
    types = cfg.layer_types()
    for i in range(cfg.num_layers):
        if fam == "mamba2":
            norm(f"backbone.layers.{i}.norm")
            mamba_mixer(f"backbone.layers.{i}.")
            continue
        if fam in ("deepseek", "bamba"):
            p = f"model.layers.{i}."
            norm(p + "input_layernorm")
            norm(p + "post_attention_layernorm")
            if fam == "deepseek":
                mla_attention(p)
                deepseek_ffn(p, i)
                continue
            if types[i] == "mamba2":
                mamba_mixer(p)
            else:
                linear(p + "self_attn.q_proj", h, n_q)
                linear(p + "self_attn.k_proj", h, n_kv)
                linear(p + "self_attn.v_proj", h, n_kv)
                linear(p + "self_attn.o_proj", n_q, h)
            linear(p + "mlp.gate_proj", h, inter)
            linear(p + "mlp.up_proj", h, inter)
            linear(p + "mlp.down_proj", inter, h)
            continue
        if falcon:
            p = f"transformer.h.{i}."
            bias = att.qkv_bias
            if _falcon_new_arch(cfg):
                norm(p + "ln_attn", True)
                norm(p + "ln_mlp", True)
            else:
                norm(p + "input_layernorm", True)
                if not cfg.parallel_residual:
                    norm(p + "post_attention_layernorm", True)
            linear(p + "self_attention.query_key_value", h, n_q + 2 * n_kv, bias)
            linear(p + "self_attention.dense", n_q, h, bias)
            linear(p + "mlp.dense_h_to_4h", h, inter, bias)
            linear(p + "mlp.dense_4h_to_h", inter, h, bias)
            continue
        p = f"model.layers.{i}."
        norm(p + "input_layernorm", ln)
        norm(p + "post_attention_layernorm", ln)
        bias = fam == "starcoder2"
        if fam == "phi3":
            linear(p + "self_attn.qkv_proj", h, n_q + 2 * n_kv)
        else:
            qkv_bias = bias or att.qkv_bias
            linear(p + "self_attn.q_proj", h, n_q, qkv_bias)
            linear(p + "self_attn.k_proj", h, n_kv, qkv_bias)
            linear(p + "self_attn.v_proj", h, n_kv, qkv_bias)
        linear(p + "self_attn.o_proj", n_q, h, bias)
        if fam in ("qwen3", "qwen3_moe"):
            tensors[p + "self_attn.q_norm.weight"] = normal(hd, 0.1, 1.0)
            tensors[p + "self_attn.k_norm.weight"] = normal(hd, 0.1, 1.0)
        if fam == "gemma2":
            norm(p + "pre_feedforward_layernorm")
            norm(p + "post_feedforward_layernorm")
        if cfg.moe is not None:
            moe_layer(p)
        elif cfg.mlp_type == "plain":
            linear(p + "mlp.c_fc", h, inter, bias)
            linear(p + "mlp.c_proj", inter, h, bias)
        elif fam == "phi3":
            linear(p + "mlp.gate_up_proj", h, 2 * inter)
            linear(p + "mlp.down_proj", inter, h)
        else:
            linear(p + "mlp.gate_proj", h, inter)
            linear(p + "mlp.up_proj", h, inter)
            linear(p + "mlp.down_proj", inter, h)
    write_safetensors(path / "model.safetensors", tensors)
    config = hf_config(cfg)
    config["torch_dtype"] = float_dt
    if quant == "awq":
        config["quantization_config"] = {"quant_method": "awq", "bits": 4,
                                         "group_size": group_size, "zero_point": True,
                                         "version": "gemm"}
    (path / "config.json").write_text(json.dumps(config, indent=1))


# Qwen2's pre-tokenizer split (its tokenizer.json's Split regex).
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def write_bpe_tokenizer_json(path, vocab_size: int, seed: int = 0,
                             eos_token: str = "</s>", style: str = "gpt2") -> list[bytes]:
    """Write a byte-level BPE ``tokenizer.json`` (+ ``tokenizer_config.json``)
    whose vocab covers ids 0 .. vocab_size-1: the 256 byte tokens, merged
    tokens of lower-case letters and spaces up to vocab_size - 1, and the
    special EOS token last. Each merge joins two earlier tokens, so a token's
    id is its merge rank. ``style="qwen"`` writes Qwen2's pre-tokenizer (its
    Split regex, then ByteLevel without its own regex) in place of GPT-2's
    ByteLevel. Returns the merged tokens' bytes."""
    import json
    from pathlib import Path

    import numpy as np

    from ..tokenizer.bpe import gpt2_byte_encoder

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    enc = gpt2_byte_encoder()
    alphabet = [bytes([c]) for c in b"abcdefghijklmnopqrstuvwxyz "]
    pieces = list(alphabet)
    seen = set(pieces)
    merged: list[bytes] = []
    merges: list[str] = []
    want = vocab_size - 1 - 256
    while len(merged) < want:
        for ia, ib in rng.integers(0, len(pieces), (4096, 2)):
            a, b = pieces[ia], pieces[ib]
            if len(merged) == want or len(a) + len(b) > 12 or a + b in seen:
                continue
            seen.add(a + b)
            pieces.append(a + b)
            merged.append(a + b)
            merges.append("".join(enc[x] for x in a) + " " + "".join(enc[x] for x in b))

    def unicode(bs: bytes) -> str:
        return "".join(enc[x] for x in bs)

    vocab = {enc[b]: b for b in range(256)}
    for i, tok in enumerate(merged):
        vocab[unicode(tok)] = 256 + i
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                  "use_regex": True}
    data = {
        "version": "1.0",
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "pre_tokenizer": byte_level if style == "gpt2" else {
            "type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": QWEN_SPLIT},
                 "behavior": "Isolated", "invert": False},
                dict(byte_level, use_regex=False)]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                    "trim_offsets": True, "use_regex": True},
        "added_tokens": [{"id": vocab_size - 1, "content": eos_token, "special": True}],
    }
    (path / "tokenizer.json").write_text(json.dumps(data))
    (path / "tokenizer_config.json").write_text(json.dumps({"eos_token": eos_token}))
    return merged


def write_metaspace_tokenizer_json(path, vocab_size: int, seed: int = 0) -> list[bytes]:
    """Write a Gemma-style ``tokenizer.json`` (+ ``tokenizer_config.json``):
    a BPE model with ``byte_fallback``, spaces normalized to U+2581 ("▁"),
    no pre-tokenizer, ``<pad>``/``<eos>``/``<bos>``/``<unk>`` at ids 0-3,
    the 256 ``<0xXX>`` byte tokens at 4-259, then "▁" and the lower-case
    letters, then merged tokens of those up to ``vocab_size``. Each merge
    joins two earlier tokens, so a token's id is its merge rank. Returns the
    merged tokens' bytes (spaces as b" ")."""
    import json
    from pathlib import Path

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    specials = ["<pad>", "<eos>", "<bos>", "<unk>"]
    vocab = {t: i for i, t in enumerate(specials)}
    vocab.update({f"<0x{b:02X}>": 4 + b for b in range(256)})
    pieces = ["▁"] + list("abcdefghijklmnopqrstuvwxyz")
    for piece in pieces:
        vocab[piece] = len(vocab)
    seen = set(pieces)
    merges: list[str] = []
    while len(vocab) < vocab_size:
        for ia, ib in rng.integers(0, len(pieces), (4096, 2)):
            a, b = pieces[ia], pieces[ib]
            if len(vocab) == vocab_size or len(a) + len(b) > 12 or a + b in seen:
                continue
            seen.add(a + b)
            pieces.append(a + b)
            vocab[a + b] = len(vocab)
            merges.append(f"{a} {b}")
    data = {
        "version": "1.0",
        "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
        "pre_tokenizer": None,
        "model": {"type": "BPE", "vocab": vocab, "merges": merges, "byte_fallback": True,
                  "unk_token": "<unk>", "fuse_unk": True},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]},
        "added_tokens": [{"id": i, "content": t, "special": True}
                         for i, t in enumerate(specials)],
    }
    (path / "tokenizer.json").write_text(json.dumps(data, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<bos>", "eos_token": "<eos>"}))
    return [p.replace("▁", " ").encode() for p in pieces[27:]]


# ---------------------------------------------------------------------------
# GGUF checkpoints (llama.cpp's layout, the port's own encoders and writer)
# ---------------------------------------------------------------------------

# ggml file types (llama.cpp's LLAMA_FTYPE_*): general.file_type.
_FILE_TYPES = {"F32": 0, "F16": 1, "Q4_0": 2, "Q4_1": 3, "Q8_0": 7, "Q2_K": 10,
               "Q3_K": 11, "Q4_K": 14, "Q5_K": 16, "Q6_K": 18, "Q4_K_M": 15}


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp's ``use_more_bits``: the layers whose attn_v and ffn_down a
    Q4_K_M file keeps in Q6_K (integer division throughout)."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def q4_k_m_types(num_layers: int) -> dict[str, str]:
    """The ggml type of each tensor kind of a llama-layout Q4_K_M file:
    Q4_K everywhere, the output head Q6_K, and attn_v and ffn_down in Q6_K
    on the layers ``use_more_bits`` picks ("blk.{i}.attn_v" keys)."""
    types = {"token_embd": "Q4_K", "output": "Q6_K"}
    for i in range(num_layers):
        more = use_more_bits(i, num_layers)
        for kind in ("attn_q", "attn_k", "attn_output", "ffn_gate", "ffn_up",
                     "ffn_gate_exps", "ffn_up_exps"):
            types[f"blk.{i}.{kind}"] = "Q4_K"
        for kind in ("attn_v", "ffn_down", "ffn_down_exps"):
            types[f"blk.{i}.{kind}"] = "Q6_K" if more else "Q4_K"
    return types


def spm_vocab(vocab_size: int, seed: int = 0) -> tuple[list[str], list[float], list[int]]:
    """A SentencePiece (GGUF ``llama``) vocab of ``vocab_size`` tokens:
    <unk>, <s>, </s>, the 256 byte-fallback tokens <0xXX>, the single
    characters of printable ASCII and ``▁``, then pieces that each join two
    earlier pieces (so every piece is reachable by merges), scored in
    decreasing order. Returns (tokens, scores, token types)."""
    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    chars = ["▁"] + [chr(c) for c in range(0x21, 0x7F)]
    pieces = list(chars)
    seen = set(pieces)
    letters = [c for c in chars if c.isalpha() or c == "▁"]
    while len(tokens) + len(pieces) < vocab_size:
        # join a word start (or a letter) with a letter run; short pieces first
        pool = pieces[-2000:] if len(pieces) > 2000 and rng.random() < 0.5 else pieces
        a = pool[int(rng.integers(len(pool)))]
        b = letters[int(rng.integers(len(letters)))] if rng.random() < 0.6 else \
            pool[int(rng.integers(len(pool)))]
        piece = a + b
        if len(piece) > 12 or piece in seen or "▁" in piece[1:]:
            continue
        seen.add(piece)
        pieces.append(piece)
    tokens += pieces[:vocab_size - len(tokens)]
    types += [1] * (vocab_size - len(types))
    scores = [0.0] * 259 + [-float(i) for i in range(vocab_size - 259)]
    return tokens, scores, types


def write_gguf_checkpoint(path, cfg: UniversalConfig, quant: str = "Q4_K_M",
                          seed: int = 0, llama_cpp_qk: bool = True) -> dict[str, str]:
    """Write a random llama-layout GGUF file of ``cfg`` (dense, or MoE with
    llama.cpp's pre-stacked ``ffn_{gate,up,down}_exps``) to ``path`` with
    an embedded SentencePiece tokenizer of ``cfg.vocab_size`` tokens, the
    way llama.cpp writes a Llama, Mistral or Mixtral file: architecture
    ``llama``, and attn_q/attn_k rows in its permuted order (HF order with
    ``llama_cpp_qk=False``). ``quant="Q4_K_M"`` is llama.cpp's mix
    (``q4_k_m_types``; token_embd Q4_K, output Q6_K); another ggml type name
    applies to every linear weight and the embedding. Norms are F32. Weights
    have a magnitude in [2^-7, 2^-5) and a random sign, norm weights are
    1 + 0.1 N(0,1), the router N(0,1) × 2^-7.
    Returns each tensor's ggml type name. The weights are drawn in order
    from ``seed`` and encoded by a pool of threads (numpy's encoders release
    the interpreter lock), so the bytes do not depend on the pool."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ..formats.ggml_quants import quantize_ggml
    from ..formats.gguf import GgmlType, write_gguf
    from ..formats.names import qk_row_order

    if cfg.model_type not in ("llama", "mistral", "mixtral"):
        raise ValueError(f"llama-layout GGUF only (got {cfg.model_type!r})")
    rng = np.random.default_rng(seed)
    att = cfg.attention
    h, n_layers = cfg.hidden_size, cfg.num_layers
    hd = att.resolved_head_dim(h)
    n_q, n_kv = att.num_heads * hd, att.kv_heads() * hd
    inter = cfg.resolved_intermediate_size()
    mix = q4_k_m_types(n_layers) if quant.upper() == "Q4_K_M" else None
    tensors: dict = {}
    kinds: dict[str, str] = {}
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))

    def weight(name: str, kind: str, *shape, n_head: int = 0):
        w = _half_bits(rng, int(np.prod(shape)), -7).reshape(shape)
        if n_head and llama_cpp_qk:
            w = w[qk_row_order(shape[0], n_head, to_gguf=True)]
        gt = mix[kind] if mix is not None else quant.upper()
        tensors[name] = (pool.submit(quantize_ggml, w.astype(np.float32), GgmlType[gt]),
                         GgmlType[gt], shape)
        kinds[name] = gt

    def norm(name: str):
        tensors[name] = ((1.0 + 0.1 * rng.standard_normal(h, dtype=np.float32)),
                         GgmlType.F32, (h,))
        kinds[name] = "F32"

    weight("token_embd.weight", "token_embd", cfg.vocab_size, h)
    norm("output_norm.weight")
    if not cfg.tie_word_embeddings:
        weight("output.weight", "output", cfg.vocab_size, h)
    for i in range(n_layers):
        b = f"blk.{i}."
        norm(b + "attn_norm.weight")
        weight(b + "attn_q.weight", b + "attn_q", n_q, h, n_head=att.num_heads)
        weight(b + "attn_k.weight", b + "attn_k", n_kv, h, n_head=att.kv_heads())
        weight(b + "attn_v.weight", b + "attn_v", n_kv, h)
        weight(b + "attn_output.weight", b + "attn_output", h, n_q)
        norm(b + "ffn_norm.weight")
        if cfg.moe is not None:
            e, mi = cfg.moe.num_experts, cfg.moe.intermediate_size
            router = rng.standard_normal((e, h), dtype=np.float32) * 2.0 ** -7
            tensors[b + "ffn_gate_inp.weight"] = (router, GgmlType.F32, (e, h))
            kinds[b + "ffn_gate_inp.weight"] = "F32"
            weight(b + "ffn_gate_exps.weight", b + "ffn_gate_exps", e, mi, h)
            weight(b + "ffn_up_exps.weight", b + "ffn_up_exps", e, mi, h)
            weight(b + "ffn_down_exps.weight", b + "ffn_down_exps", e, h, mi)
        else:
            weight(b + "ffn_gate.weight", b + "ffn_gate", inter, h)
            weight(b + "ffn_up.weight", b + "ffn_up", inter, h)
            weight(b + "ffn_down.weight", b + "ffn_down", h, inter)

    tokens, scores, types = spm_vocab(cfg.vocab_size, seed)
    a = "llama"
    meta = {
        "general.architecture": a,
        "general.name": f"synthetic {cfg.model_type} {quant}",
        "general.file_type": _FILE_TYPES.get(quant.upper(), 0),
        f"{a}.context_length": cfg.max_seq_len,
        f"{a}.embedding_length": h,
        f"{a}.block_count": n_layers,
        f"{a}.feed_forward_length": inter,
        f"{a}.attention.head_count": att.num_heads,
        f"{a}.attention.head_count_kv": att.kv_heads(),
        f"{a}.rope.freq_base": float(att.rope_theta),
        f"{a}.rope.dimension_count": hd,
        f"{a}.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": scores,
        "tokenizer.ggml.token_type": types,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.add_bos_token": True,
    }
    if cfg.moe is not None:
        meta[f"{a}.expert_count"] = cfg.moe.num_experts
        meta[f"{a}.expert_used_count"] = cfg.moe.experts_per_tok
    with pool:
        tensors = {name: (data.result() if hasattr(data, "result") else data, gt, shape)
                   for name, (data, gt, shape) in tensors.items()}
    write_gguf(path, meta, tensors)
    return kinds


def write_gguf_recurrent(path, cfg: UniversalConfig, quant: str = "Q8_0", seed: int = 0,
                         keep_f32: tuple[str, ...] = ("attn_kv_b",)) -> None:
    """Write a random GGUF file of a DeepSeek (architecture ``deepseek2``) or
    Mamba2 (``mamba2``) ``cfg``: the weights of ``write_hf_checkpoint``'s
    plain f32 checkpoint of the same seed under their GGUF names, the
    experts pre-stacked as llama.cpp's ``ffn_{gate,up,down}_exps``, every
    2-D projection whose rows are a whole number of ``quant`` blocks in
    that ggml type except those whose names end with one of ``keep_f32``
    (the JAX loader reads ``attn_kv_b`` dense only), the rest F32; and the
    metadata keys ``loader/gguf_config.py`` reads. No tokenizer."""
    import tempfile

    from ..formats.ggml_quants import quantize_ggml
    from ..formats.gguf import GGML_BLOCK_INFO, GgmlType, write_gguf
    from ..formats.names import hf_to_gguf_name
    from ..formats.safetensors import SafeTensorsReader

    fam = cfg.model_type
    if fam not in ("deepseek", "mamba2"):
        raise ValueError(f"deepseek or mamba2 only (got {fam!r})")
    qt = GgmlType[quant.upper()]
    per_block = GGML_BLOCK_INFO[qt][1]
    with tempfile.TemporaryDirectory() as tmp:
        write_hf_checkpoint(tmp, cfg, quant="plain", dtype="float32", seed=seed)
        with SafeTensorsReader(f"{tmp}/model.safetensors") as r:
            raw = {n: np.array(r.load_numpy(n), dtype=np.float32) for n in r.tensor_names()}
    if fam == "mamba2":                 # the loader reads model.layers.* too
        raw = {n.replace("backbone.layers.", "model.layers.")
               .replace("backbone.embeddings.", "model.embed_tokens.")
               .replace("backbone.norm_f.", "model.norm."): v for n, v in raw.items()}
    if cfg.moe is not None:
        for i in range(cfg.num_layers):
            base = f"model.layers.{i}.mlp.experts."
            for part, key in (("gate_proj", "ffn_gate_exps"), ("up_proj", "ffn_up_exps"),
                              ("down_proj", "ffn_down_exps")):
                names = [f"{base}{e}.{part}.weight" for e in range(cfg.moe.num_experts)]
                if names[0] in raw:
                    raw[f"blk.{i}.{key}.weight"] = np.stack([raw.pop(n) for n in names])
    tensors = {}
    for name, w in raw.items():
        gname = hf_to_gguf_name(name)
        leaf = gname.rsplit(".", 1)[0]
        quantize = (w.ndim in (2, 3) and w.shape[-1] % per_block == 0
                    and not any(k in gname for k in ("token_embd", "norm", "ffn_gate_inp",
                                                     "conv1d"))
                    and not leaf.endswith(keep_f32))
        tensors[gname] = ((quantize_ggml(w.reshape(-1, w.shape[-1]), qt), qt, w.shape)
                          if quantize else (w, GgmlType.F32, w.shape))
    a = "deepseek2" if fam == "deepseek" else "mamba2"
    meta = {"general.architecture": a, "general.name": f"synthetic {fam} {quant}",
            "general.vocab_size": cfg.vocab_size, f"{a}.context_length": cfg.max_seq_len,
            f"{a}.embedding_length": cfg.hidden_size, f"{a}.block_count": cfg.num_layers,
            f"{a}.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps)}
    if fam == "mamba2":
        ssm = cfg.ssm
        meta.update({f"{a}.ssm.inner_size": ssm.inner_size,
                     f"{a}.ssm.state_size": ssm.state_size,
                     f"{a}.ssm.group_count": ssm.n_groups, f"{a}.ssm.head_dim": ssm.head_dim,
                     f"{a}.ssm.conv_kernel": ssm.conv_kernel})
    else:
        att, moe = cfg.attention, cfg.moe
        meta.update({
            f"{a}.feed_forward_length": cfg.resolved_intermediate_size(),
            f"{a}.attention.head_count": att.num_heads,
            f"{a}.attention.head_count_kv": att.kv_heads(),
            f"{a}.attention.key_length": att.d_nope + att.d_rope,
            f"{a}.attention.value_length": att.v_head_dim,
            f"{a}.attention.kv_lora_rank": att.kv_latent_dim,
            f"{a}.rope.dimension_count": att.d_rope,
            f"{a}.rope.freq_base": float(att.rope_theta),
            f"{a}.expert_count": moe.num_experts,
            f"{a}.expert_used_count": moe.experts_per_tok,
            f"{a}.expert_shared_count": moe.shared_expert or 0,
            f"{a}.expert_feed_forward_length": moe.intermediate_size,
            f"{a}.leading_dense_block_count": moe.num_dense_layers})
        if att.q_latent_dim:
            meta[f"{a}.attention.q_lora_rank"] = att.q_latent_dim
    write_gguf(path, meta, tensors)
