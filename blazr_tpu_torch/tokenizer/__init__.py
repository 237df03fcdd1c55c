"""Tokenizer subsystem.

Counterpart of ``blazr_tpu/tokenizer/__init__.py``: a model dir's
``tokenizer.json`` (HF fast-tokenizer BPE). GGUF-embedded tokenizers and the
pretrained vocab tier raise (ROADMAP queue A item 8).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from .bpe import BpeTokenizer
from .byte_tok import ByteTokenizer
from .hf_tokenizer import load_hf_tokenizer


def load_tokenizer(model_dir: str | Path,
                   gguf_path: Optional[str | Path] = None) -> BpeTokenizer:
    """The tokenizer of a checkpoint dir: its ``tokenizer.json``."""
    model_dir = Path(model_dir)
    tok_json = model_dir / "tokenizer.json"
    if gguf_path is None and tok_json.exists():
        return load_hf_tokenizer(tok_json)
    if gguf_path is not None or any(model_dir.glob("*.gguf")):
        raise NotImplementedError(
            "GGUF-embedded tokenizers are not ported to blazr_tpu_torch yet "
            "(ROADMAP queue A item 8)")
    raise FileNotFoundError(
        f"No tokenizer found for {model_dir}: expected "
        f"'{tok_json}' (HF fast-tokenizer JSON). The pretrained vocab tier "
        "is not ported to blazr_tpu_torch yet (ROADMAP queue A item 8).")


__all__ = ["BpeTokenizer", "ByteTokenizer", "load_hf_tokenizer", "load_tokenizer"]
