"""HF ``tokenizer.json`` loader.

Counterpart of ``blazr_tpu/tokenizer/hf_tokenizer.py``: parses HuggingFace
fast-tokenizer files (BPE model) into
:class:`~blazr_tpu_torch.tokenizer.bpe.BpeTokenizer`, converting the GPT-2
byte-alphabet vocab back to raw bytes. Covers the Llama-3 / Qwen / Mistral /
GPT-2 style checkpoints.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from .bpe import (
    PATTERN_CL100K,
    PATTERN_GPT2,
    BpeTokenizer,
    gpt2_unicode_to_bytes,
)


def load_hf_tokenizer(path: str | Path) -> BpeTokenizer:
    """Load tokenizer.json (or a model dir containing it)."""
    path = Path(path)
    if path.is_dir():
        tok_path = path / "tokenizer.json"
    else:
        tok_path = path
    data = json.loads(tok_path.read_text())

    model = data.get("model", {})
    if model.get("type") not in ("BPE", None):
        raise ValueError(f"Unsupported tokenizer model type {model.get('type')!r}")

    vocab: dict[str, int] = model.get("vocab", {})
    byte_level = _is_byte_level(data)

    ranks: dict[bytes, int] = {}
    for tok, tid in vocab.items():
        raw = gpt2_unicode_to_bytes(tok) if byte_level else tok.replace("▁", " ").encode()
        ranks[raw] = tid

    special: dict[str, int] = {}
    bos_id = eos_id = None
    for added in data.get("added_tokens", []):
        if added.get("special"):
            special[added["content"]] = added["id"]
    # bos/eos from config next to tokenizer.json if present
    cfg_path = tok_path.parent / "tokenizer_config.json"
    if cfg_path.exists():
        cfg = json.loads(cfg_path.read_text())
        bos_id = _resolve_token_id(cfg.get("bos_token"), vocab, special)
        eos_id = _resolve_token_id(cfg.get("eos_token"), vocab, special)
    if eos_id is None:
        for cand in ("</s>", "<|end_of_text|>", "<|endoftext|>", "<|im_end|>", "<eos>"):
            if cand in special:
                eos_id = special[cand]
                break
    if bos_id is None:
        for cand in ("<s>", "<|begin_of_text|>", "<bos>"):
            if cand in special:
                bos_id = special[cand]
                break

    pattern = _extract_pattern(data) or (PATTERN_GPT2 if byte_level else PATTERN_CL100K)
    return BpeTokenizer(ranks, pattern=pattern, special_tokens=special,
                        bos_token_id=bos_id, eos_token_id=eos_id)


def _is_byte_level(data: dict) -> bool:
    def scan(node) -> bool:
        if isinstance(node, dict):
            if node.get("type") == "ByteLevel":
                return True
            return any(scan(v) for v in node.values())
        if isinstance(node, list):
            return any(scan(v) for v in node)
        return False

    return scan(data.get("pre_tokenizer")) or scan(data.get("decoder"))


def _extract_pattern(data: dict) -> Optional[str]:
    """Pull the Split-pretokenizer regex when present (Llama-3 style)."""
    pre = data.get("pre_tokenizer") or {}
    nodes = pre.get("pretokenizers", [pre]) if pre else []
    for node in nodes:
        if node.get("type") == "Split":
            pat = node.get("pattern", {})
            if isinstance(pat, dict) and "Regex" in pat:
                return pat["Regex"]
    return None


def _resolve_token_id(tok, vocab: dict[str, int], special: dict[str, int]):
    if tok is None:
        return None
    if isinstance(tok, dict):
        tok = tok.get("content")
    if tok in special:
        return special[tok]
    return vocab.get(tok)
