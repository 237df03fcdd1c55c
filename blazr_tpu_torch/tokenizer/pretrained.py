"""Pretrained vocab tier.

Copy of ``blazr_tpu/tokenizer/pretrained.py``: so that a bare checkpoint
(no ``tokenizer.json``, no GGUF metadata) still tokenizes, a vocab is
picked by the model's vocab size (``tokenizer.vocab_name_for_size``) and
read from a rank table in package data, ``tokenizer/vocab_data/``, in the
``.tiktoken`` format (base64(token) <space> rank per line; optionally
gzipped) with a JSON sidecar holding the pre-tokenization pattern, special
tokens and bos/eos ids. ``BLAZR_TPU_VOCAB_DIR`` names another directory.
The repository ships no table: ``write_vocab`` writes one.
"""

from __future__ import annotations

import base64
import gzip
import json
import os
from pathlib import Path
from typing import Optional

from .bpe import PATTERN_CL100K, PATTERN_GPT2, PATTERN_O200K, BpeTokenizer

VOCAB_DATA_DIR = Path(__file__).parent / "vocab_data"

# The vocab names the size thresholds can give.
KNOWN_VOCABS = ("mistral", "gpt2", "cl100k_base", "llama3", "qwen2",
                "o200k_base", "deepseek_v3")

_PATTERNS = {
    "gpt2": PATTERN_GPT2,
    "cl100k": PATTERN_CL100K,
    "o200k": PATTERN_O200K,
}


def data_dir() -> Path:
    """Active vocab-data directory (``BLAZR_TPU_VOCAB_DIR`` overrides the
    package data)."""
    override = os.environ.get("BLAZR_TPU_VOCAB_DIR")
    return Path(override) if override else VOCAB_DATA_DIR


def available_vocabs() -> list[str]:
    d = data_dir()
    if not d.is_dir():
        return []
    out = set()
    for p in d.iterdir():
        name = p.name
        for suf in (".tiktoken.gz", ".tiktoken"):
            if name.endswith(suf):
                out.add(name[: -len(suf)])
    return sorted(out)


def _read_ranks(path: Path) -> dict[bytes, int]:
    raw = path.read_bytes()
    if path.name.endswith(".gz"):
        raw = gzip.decompress(raw)
    ranks: dict[bytes, int] = {}
    for line in raw.splitlines():
        if not line.strip():
            continue
        tok_b64, rank = line.split()
        ranks[base64.b64decode(tok_b64)] = int(rank)
    return ranks


def load_pretrained(name: str,
                    directory: Optional[Path] = None) -> BpeTokenizer:
    """Load a baked pretrained vocab table by name.

    Raises FileNotFoundError when the table is not present."""
    d = Path(directory) if directory else data_dir()
    table = None
    for suf in (".tiktoken.gz", ".tiktoken"):
        p = d / f"{name}{suf}"
        if p.exists():
            table = p
            break
    if table is None:
        raise FileNotFoundError(
            f"pretrained vocab {name!r} is not baked (looked in {d}; "
            f"available: {available_vocabs() or 'none'}). Write the table "
            f"with write_vocab, or set BLAZR_TPU_VOCAB_DIR to a directory "
            f"that holds it."
        )
    ranks = _read_ranks(table)

    meta_path = d / f"{name}.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    pattern = _PATTERNS.get(meta.get("pattern", "cl100k"), PATTERN_CL100K)
    return BpeTokenizer(
        ranks,
        pattern=pattern,
        special_tokens=meta.get("special_tokens") or {},
        bos_token_id=meta.get("bos_token_id"),
        eos_token_id=meta.get("eos_token_id"),
    )


def write_vocab(name: str, ranks: dict[bytes, int], *,
                pattern: str = "cl100k",
                special_tokens: Optional[dict[str, int]] = None,
                bos_token_id: Optional[int] = None,
                eos_token_id: Optional[int] = None,
                directory: Optional[Path] = None) -> Path:
    """Serialize a rank table (and its sidecar) into the vocab-data dir."""
    d = Path(directory) if directory else data_dir()
    d.mkdir(parents=True, exist_ok=True)
    lines = b"\n".join(
        base64.b64encode(tok) + b" " + str(rank).encode()
        for tok, rank in sorted(ranks.items(), key=lambda kv: kv[1]))
    out = d / f"{name}.tiktoken.gz"
    out.write_bytes(gzip.compress(lines + b"\n"))
    sidecar = {"pattern": pattern}
    if special_tokens:
        sidecar["special_tokens"] = special_tokens
    if bos_token_id is not None:
        sidecar["bos_token_id"] = bos_token_id
    if eos_token_id is not None:
        sidecar["eos_token_id"] = eos_token_id
    (d / f"{name}.json").write_text(json.dumps(sidecar))
    return out
