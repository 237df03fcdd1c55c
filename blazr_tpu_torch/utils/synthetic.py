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


# ---------------------------------------------------------------------------
# Checkpoints and tokenizers on disk (the normal entry point's inputs)
# ---------------------------------------------------------------------------

def hf_config(cfg: UniversalConfig) -> dict:
    """The HF ``config.json`` fields of a llama-family ``cfg``."""
    att = cfg.attention
    out = {
        "architectures": ["MistralForCausalLM" if cfg.model_type == "mistral"
                          else "LlamaForCausalLM"],
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
    return out


def write_awq_checkpoint(path, cfg: UniversalConfig, group_size: int = 128,
                         seed: int = 0) -> None:
    """Write a random AWQ-INT4 checkpoint of ``cfg`` to the directory
    ``path``: AutoAWQ's own packed ``qweight``/``qzeros`` (uint32, eight
    interleaved nibbles along N) and f16 ``scales`` for every projection,
    f16 embeddings, norms and head, and a ``config.json`` with its
    ``quantization_config``. The weight distribution is that of
    ``synth_llama_params`` (scales in [0.001, 0.011], zeros in [0, 16))."""
    import json
    from pathlib import Path

    import numpy as np

    from ..formats.safetensors import write_safetensors

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    att = cfg.attention
    h = cfg.hidden_size
    hd = att.resolved_head_dim(h)
    inter = cfg.resolved_intermediate_size()

    def words(shape):
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)

    def dense(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02).astype(np.float16)

    tensors = {"model.embed_tokens.weight": dense(cfg.vocab_size, h),
               "model.norm.weight": np.ones(h, np.float16)}
    if not cfg.tie_word_embeddings:
        tensors["lm_head.weight"] = dense(cfg.vocab_size, h)
    projections = {"self_attn.q_proj": (h, att.num_heads * hd),
                   "self_attn.k_proj": (h, att.kv_heads() * hd),
                   "self_attn.v_proj": (h, att.kv_heads() * hd),
                   "self_attn.o_proj": (att.num_heads * hd, h),
                   "mlp.gate_proj": (h, inter), "mlp.up_proj": (h, inter),
                   "mlp.down_proj": (inter, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = np.ones(h, np.float16)
        tensors[p + "post_attention_layernorm.weight"] = np.ones(h, np.float16)
        for name, (k, n) in projections.items():
            tensors[f"{p}{name}.qweight"] = words((k, n // 8))
            tensors[f"{p}{name}.qzeros"] = words((k // group_size, n // 8))
            tensors[f"{p}{name}.scales"] = (rng.random((k // group_size, n), np.float32)
                                            * 0.01 + 0.001).astype(np.float16)
    write_safetensors(path / "model.safetensors", tensors)
    config = hf_config(cfg)
    config["torch_dtype"] = "float16"
    config["quantization_config"] = {"quant_method": "awq", "bits": 4,
                                     "group_size": group_size, "zero_point": True,
                                     "version": "gemm"}
    (path / "config.json").write_text(json.dumps(config, indent=1))


def write_bpe_tokenizer_json(path, vocab_size: int, seed: int = 0,
                             eos_token: str = "</s>") -> list[bytes]:
    """Write a byte-level BPE ``tokenizer.json`` (+ ``tokenizer_config.json``)
    whose vocab covers ids 0 .. vocab_size-1: the 256 byte tokens, merged
    tokens of lower-case letters and spaces up to vocab_size - 1, and the
    special EOS token last. Each merge joins two earlier tokens, so a token's
    id is its merge rank. Returns the merged tokens' bytes."""
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
    data = {
        "version": "1.0",
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                    "trim_offsets": True, "use_regex": True},
        "added_tokens": [{"id": vocab_size - 1, "content": eos_token, "special": True}],
    }
    (path / "tokenizer.json").write_text(json.dumps(data))
    (path / "tokenizer_config.json").write_text(json.dumps({"eos_token": eos_token}))
    return merged
