"""Synthetic llama-family params (no checkpoint exists in this environment).

Counterpart of ``blazr_tpu/utils/synthetic.py``: the same configs and the
same weight distributions, built on the device from a seeded
``torch.Generator``. The draws differ from ``jax.random``'s; tests that
compare the two packages convert the JAX params with ``convert.py``.
"""

from __future__ import annotations

import torch

from ..config.model_config import AttentionConfig, RopeScaling, UniversalConfig
from ..quant.qtensor import QuantTensor
from .device import DeviceLike, resolve_device


def mistral_7b_config() -> UniversalConfig:
    """Mistral-7B-v0.1 geometry (public config, sliding_window 4096)."""
    return UniversalConfig(
        model_type="mistral", vocab_size=32000, hidden_size=4096, num_layers=32,
        max_seq_len=4096, intermediate_size=14336, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  rope_theta=10000.0, sliding_window=4096),
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
    """Random llama-family params matching ``cfg`` ('awq' or 'dense') on
    ``device`` (default ``cuda``). ``fuse=True`` emits fused qkv / gateup
    projections (the serving layout)."""
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

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "input_norm": torch.ones((h,), dtype=dtype, device=dev),
            "post_norm": torch.ones((h,), dtype=dtype, device=dev),
            "o": lin(q_out, h),
            "down": lin(inter, h),
        }
        if fuse:
            layer["qkv"] = lin(h, q_out + 2 * kv_out)
            layer["gateup"] = lin(h, 2 * inter)
        else:
            layer.update({"q": lin(h, q_out), "k": lin(h, kv_out),
                          "v": lin(h, kv_out), "gate": lin(h, inter),
                          "up": lin(h, inter)})
        layers.append(layer)
    return {
        "embed": _rand_dense(gen, cfg.vocab_size, h, dtype, dev),
        "final_norm": torch.ones((h,), dtype=dtype, device=dev),
        "layers": layers,
        "lm_head": None if cfg.tie_word_embeddings
        else _rand_dense(gen, h, cfg.vocab_size, dtype, dev),
    }
