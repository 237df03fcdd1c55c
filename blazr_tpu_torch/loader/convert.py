"""Checkpoint conversion: safetensors ↔ GGUF, with an optional ggml
quantization on the way out.

Counterpart of ``blazr_tpu/loader/convert.py``, with one deviation: the
rows of ``attn_q`` and ``attn_k`` go out in llama.cpp's permuted order for
the architectures whose llama.cpp files hold them so, and come back in HF
order, on the predicate the loader uses (``formats.names.qk_permuted``;
ROADMAP §C). Every other byte of a GGUF it writes equals the JAX
converter's.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ..formats.detect import ModelFormat, detect_model_source
from ..formats.ggml_quants import dequantize_ggml, quantize_ggml
from ..formats.gguf import GGML_BLOCK_INFO, GgmlType, Gguf, write_gguf
from ..formats.names import gguf_to_hf_name, hf_to_gguf_name, qk_heads_of, qk_permuted, qk_rows
from ..formats.safetensors import SafeTensorsReader, write_safetensors
from .gguf_config import gguf_qk_heads

logger = logging.getLogger(__name__)


def convert_checkpoint(src: str | Path, dst: str | Path,
                       quant: Optional[str] = None) -> None:
    src_info = detect_model_source(src)
    dst = Path(dst)
    if dst.suffix == ".gguf":
        if src_info.format == ModelFormat.GGUF:
            raise ValueError("GGUF → GGUF requantization not yet supported")
        _st_to_gguf(src_info, dst, quant)
    elif dst.suffix == ".safetensors" or dst.is_dir() or not dst.suffix:
        if src_info.format != ModelFormat.GGUF:
            raise ValueError("safetensors → safetensors copy not needed")
        _gguf_to_st(src_info, dst)
    else:
        raise ValueError(f"unknown destination format: {dst}")


def _tokenizer_metadata(tok_json: Path) -> dict:
    """The gpt2-style ``tokenizer.ggml.*`` arrays of a ``tokenizer.json``."""
    from ..tokenizer.bpe import gpt2_byte_encoder
    from ..tokenizer.hf_tokenizer import load_hf_tokenizer

    tok = load_hf_tokenizer(tok_json)
    enc = gpt2_byte_encoder()
    id_to_tok = {tid: "".join(enc[b] for b in raw) for raw, tid in tok.ranks.items()}
    for s, tid in tok.special_tokens.items():
        id_to_tok[tid] = s
    n = max(id_to_tok) + 1
    meta = {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": [id_to_tok.get(i, f"<unused{i}>") for i in range(n)],
        "tokenizer.ggml.token_type": [3 if i in tok.special_tokens.values() else 1
                                      for i in range(n)],
    }
    # gpt2-model tokenizers need merges for llama.cpp interop (the rank-based
    # loader here does without them).
    merges = (json.loads(tok_json.read_text()).get("model") or {}).get("merges")
    if merges:
        meta["tokenizer.ggml.merges"] = [m if isinstance(m, str) else " ".join(m)
                                         for m in merges]
    if tok.bos_token_id is not None:
        meta["tokenizer.ggml.bos_token_id"] = tok.bos_token_id
    if tok.eos_token_id is not None:
        meta["tokenizer.ggml.eos_token_id"] = tok.eos_token_id
    return meta


def _st_to_gguf(src_info, dst: Path, quant: Optional[str]) -> None:
    from .api import resolve_config

    qt = GgmlType[quant.upper()] if quant else GgmlType.F32
    if src_info.config_path is None:
        raise ValueError(
            "safetensors → GGUF conversion needs a config.json next to "
            "the weights (architecture metadata cannot be inferred)")
    cfg = resolve_config(src_info).model
    att = cfg.attention
    # HF model_type names match llama.cpp's arch strings for the served
    # families; stamping every file 'llama' would rebuild the wrong topology.
    arch = cfg.model_type or "llama"
    meta = {
        "general.architecture": arch,
        "general.name": dst.stem,
        "general.vocab_size": cfg.vocab_size,
        f"{arch}.embedding_length": cfg.hidden_size,
        f"{arch}.block_count": cfg.num_layers,
        f"{arch}.context_length": cfg.max_seq_len,
        f"{arch}.feed_forward_length": cfg.resolved_intermediate_size(),
        f"{arch}.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
    }
    heads = {}
    if att is not None:
        meta[f"{arch}.attention.head_count"] = att.num_heads
        meta[f"{arch}.attention.head_count_kv"] = att.kv_heads()
        meta[f"{arch}.rope.freq_base"] = att.rope_theta
        if qk_permuted(arch):
            heads = {"q": att.num_heads, "k": att.kv_heads()}

    tok_json = src_info.model_dir / "tokenizer.json"
    if tok_json.exists():
        try:
            meta.update(_tokenizer_metadata(tok_json))
        except (ValueError, KeyError):
            logger.warning("could not embed tokenizer", exc_info=True)

    _, elems_per_block = GGML_BLOCK_INFO[qt]
    tensors = {}
    skipped = 0
    with SafeTensorsReader(src_info.path) as r:
        for name in r.tensor_names():
            arr = r.load_torch(name).float().numpy()
            gname = hf_to_gguf_name(name)
            n_head = qk_heads_of(gname, heads)
            if n_head:
                arr = qk_rows(arr, arr.shape, n_head, to_gguf=True)
            # Eligibility uses the target type's block size (32 for
            # Q8_0/Q4_0/Q4_1/IQ4_NL, 256 for the K and IQ families).
            if (arr.ndim == 2 and "embed" not in name and "norm" not in name
                    and qt != GgmlType.F32
                    and arr.shape[1] % max(elems_per_block, 1) == 0):
                tensors[gname] = (quantize_ggml(arr, qt), qt, arr.shape)
            else:
                if qt != GgmlType.F32 and arr.ndim == 2:
                    skipped += 1
                tensors[gname] = (arr, GgmlType.F32, arr.shape)
    if skipped:
        logger.warning("%d 2-D tensors kept F32 (embed/norm or inner dim "
                       "not divisible by the %s block size)", skipped, qt.name)
    write_gguf(dst, meta, tensors)
    logger.info("wrote %s (%d tensors, quant=%s)", dst, len(tensors), qt.name)


def _gguf_to_st(src_info, dst: Path) -> None:
    # 'out.safetensors' is a file destination (config.json lands next to
    # it); anything else is a directory.
    if dst.suffix == ".safetensors":
        dst.parent.mkdir(parents=True, exist_ok=True)
        st_path, cfg_path = dst, dst.parent / "config.json"
    else:
        dst.mkdir(parents=True, exist_ok=True)
        st_path, cfg_path = dst / "model.safetensors", dst / "config.json"
    tensors = {}
    with Gguf.open(src_info.path) as g:
        md = g.metadata()
        heads = gguf_qk_heads(md)
        for name in g.tensor_names():
            info = g.tensor_info(name)
            raw = g.tensor_bytes(name)
            n_head = qk_heads_of(name, heads)
            if n_head:
                raw = qk_rows(raw, info.shape, n_head, to_gguf=False)
            tensors[gguf_to_hf_name(name)] = dequantize_ggml(
                raw, info.ggml_type, info.shape).astype(np.float32)
        arch = md.architecture()
        cfg = {
            "model_type": arch or "llama",
            "hidden_size": md.embedding_length(),
            "num_hidden_layers": md.block_count(),
            "max_position_embeddings": md.context_length() or 4096,
            "vocab_size": md.get_u32("general.vocab_size") or 32000,
            "num_attention_heads": md.get_u32(f"{arch}.attention.head_count") or 32,
            "num_key_value_heads": md.get_u32(f"{arch}.attention.head_count_kv"),
            "intermediate_size": md.get_u32(f"{arch}.feed_forward_length"),
            "rope_theta": md.get_f32(f"{arch}.rope.freq_base") or 10000.0,
        }
    write_safetensors(st_path, tensors)
    cfg_path.write_text(json.dumps({k: v for k, v in cfg.items() if v is not None},
                                   indent=2))
    logger.info("wrote %s (%d tensors)", st_path, len(tensors))
