"""Tokenizer subsystem.

Counterpart of ``blazr_tpu/tokenizer/__init__.py``. Resolution order for a
checkpoint (the JAX package's :50-93): the tokenizer embedded in a given
GGUF file, then the dir's ``tokenizer.json`` (HF fast-tokenizer BPE), then
the tokenizer embedded in a sibling ``*.gguf``, then a pretrained vocab
picked by the model's vocab size (``tokenizer/pretrained.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

from ..formats.gguf import Gguf
from .bpe import BpeTokenizer
from .byte_tok import ByteTokenizer
from .gguf_tokenizer import SentencePieceBpeTokenizer, tokenizer_from_gguf
from .hf_tokenizer import load_hf_tokenizer


AnyTokenizer = Union[BpeTokenizer, SentencePieceBpeTokenizer]


# Vocab size → pretrained vocab name: the first name whose limit the size
# does not pass. The JAX package has no deepseek_v3 band and resolves
# 128400 < v <= 129000 to qwen2 or llama3 (ROADMAP §C).
VOCAB_SIZE_THRESHOLDS = [
    (32100, "mistral"),
    (50300, "gpt2"),
    (100352, "cl100k_base"),
    (128400, "llama3"),
    (129000, "deepseek_v3"),
    (152128, "qwen2"),
    (200100, "o200k_base"),
]


def vocab_name_for_size(vocab_size: int) -> str:
    for limit, name in VOCAB_SIZE_THRESHOLDS:
        if vocab_size <= limit:
            return name
    return "o200k_base"


def load_tokenizer(model_dir: str | Path,
                   gguf_path: Optional[str | Path] = None) -> AnyTokenizer:
    """The best tokenizer for a checkpoint, in the order above."""
    model_dir = Path(model_dir)
    if gguf_path is not None:
        with Gguf.open(gguf_path) as g:
            try:
                return tokenizer_from_gguf(g)
            except ValueError:
                pass            # no embedded tokenizer → try tokenizer.json
    tok_json = model_dir / "tokenizer.json"
    if tok_json.exists():
        return load_hf_tokenizer(tok_json)
    ggufs = sorted(model_dir.glob("*.gguf"))
    if ggufs:
        with Gguf.open(ggufs[0]) as g:
            return tokenizer_from_gguf(g)
    from .pretrained import available_vocabs, load_pretrained

    vocab_size = _config_vocab_size(model_dir)
    if vocab_size is not None:
        try:
            return load_pretrained(vocab_name_for_size(vocab_size))
        except FileNotFoundError:
            pass
    raise FileNotFoundError(
        f"No tokenizer found for {model_dir}: expected one of "
        f"'{tok_json}' (HF fast-tokenizer JSON), a '*.gguf' file with an "
        f"embedded tokenizer (tokenizer.ggml.* metadata), an explicit gguf_path "
        f"argument, or a pretrained vocab table matching the model's vocab size "
        f"(available: {available_vocabs() or 'none'}; pretrained.write_vocab "
        f"writes one). Fallback: copy the model's tokenizer.json next to the "
        f"weights.")


def _config_vocab_size(model_dir: Path) -> Optional[int]:
    """vocab_size from a checkpoint-local config.json, if any."""
    cfg = model_dir / "config.json"
    if not cfg.exists():
        return None
    try:
        v = json.loads(cfg.read_text()).get("vocab_size")
        return int(v) if v else None
    except (ValueError, OSError):
        return None


__all__ = ["AnyTokenizer", "BpeTokenizer", "ByteTokenizer", "SentencePieceBpeTokenizer",
           "load_hf_tokenizer", "load_tokenizer", "tokenizer_from_gguf",
           "vocab_name_for_size"]
