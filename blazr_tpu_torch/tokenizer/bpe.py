r"""Byte-level BPE engine.

Counterpart of ``blazr_tpu/tokenizer/bpe.py``: byte-pair encoding over a
rank table with regex pre-tokenization (tiktoken-style), special-token
handling, and exact decode. Encoding runs the C++ core (``native/bpe.cpp``,
the port's copy of ``blazr_tpu/native/bpe.cpp``, through
``tokenizer/bpe_native.py``), as the JAX tokenizer does (its :64-79): for
the GPT-2 and cl100k/llama3 patterns the core pre-tokenizes and merges in
one call, for the others it merges the pieces the Python pattern cuts. The
Python merge loop stays as the plain version (``native=False``), which the
tests hold the core to; a core that does not build or load raises.

The pre-tokenization patterns use Unicode property classes (``\p{L}``,
``\p{N}``, ...) that the standard library's ``re`` lacks. ``compile_pattern``
rewrites each ``\p{..}`` / ``\P{..}`` and each ``\s`` / ``\S`` into an explicit
character class built from ``unicodedata`` (Python's Unicode tables) and the
Unicode ``White_Space`` list, and compiles the result with ``re``, which has
the possessive quantifiers and atomic groups the patterns use (Python 3.11+).
Where ``unicodedata``'s Unicode version differs from another regex engine's
tables, the classes follow ``unicodedata``.
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata
from typing import Iterable, Optional

# Pre-tokenization patterns (public tiktoken/llama patterns).
PATTERN_CL100K = (
    r"'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"
)
PATTERN_O200K = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?|"
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?|"
    r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
PATTERN_GPT2 = (
    r"'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)
# Llama 3 uses the cl100k pattern with minor changes; identical in practice.
PATTERN_LLAMA3 = PATTERN_CL100K


# Unicode White_Space (PropList.txt; unchanged since Unicode 6.3): what the
# JAX package's regex engine takes for \s.
WHITE_SPACE = ([(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000)])


@functools.lru_cache(maxsize=1)
def _categories() -> bytes:
    """Index of each codepoint's general category in ``_CATS``, as bytes."""
    index = {c: i for i, c in enumerate(_CATS)}
    return bytes(index[unicodedata.category(chr(cp))]
                 for cp in range(sys.maxunicode + 1))


_CATS = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc",
         "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Zl",
         "Zp", "Cc", "Cf", "Cs", "Co", "Cn")


def _ranges_to_class(ranges: list[tuple[int, int]]) -> str:
    def esc(cp: int) -> str:
        return f"\\U{cp:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges)


@functools.lru_cache(maxsize=None)
def property_ranges(name: str) -> str:
    r"""The body of a character class for ``\p{name}`` (a general category
    such as ``Lu`` or a major class such as ``L``), from ``unicodedata``."""
    wanted = {i for i, c in enumerate(_CATS) if c == name or c[0] == name}
    if not wanted:
        raise ValueError(f"unsupported Unicode property \\p{{{name}}}")
    cats = _categories()
    ranges: list[tuple[int, int]] = []
    start = None
    for cp, c in enumerate(cats):
        if c in wanted:
            if start is None:
                start = cp
        elif start is not None:
            ranges.append((start, cp - 1))
            start = None
    if start is not None:
        ranges.append((start, len(cats) - 1))
    return _ranges_to_class(ranges)


def translate_pattern(pattern: str) -> str:
    r"""Rewrite ``\p{..}``, ``\P{..}``, ``\s`` and ``\S`` into explicit
    classes that ``re`` compiles with the same meaning. ``\P{..}`` inside a
    bracketed class has no such rewrite and raises."""
    ws = _ranges_to_class(WHITE_SPACE)
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i + 3)
                body = property_ranges(pattern[i + 3:end])
                if in_class:
                    if nxt == "P":
                        raise ValueError(f"\\P{{..}} inside a class: {pattern!r}")
                    out.append(body)
                else:
                    out.append(("[" if nxt == "p" else "[^") + body + "]")
                i = end + 1
                continue
            if nxt in "sS":
                if in_class:
                    if nxt == "S":
                        raise ValueError(f"\\S inside a class: {pattern!r}")
                    out.append(ws)
                else:
                    out.append(("[" if nxt == "s" else "[^") + ws + "]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":      # a leading ] is a literal
                out.append("\\]")
                i += 1
            continue
        if ch == "]" and in_class:
            in_class = False
        out.append(ch)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=32)
def compile_pattern(pattern: str) -> "re.Pattern[str]":
    """A pre-tokenization pattern compiled with the standard library."""
    return re.compile(translate_pattern(pattern))


class BpeTokenizer:
    """Rank-table byte-level BPE (tiktoken-compatible semantics)."""

    def __init__(
        self,
        ranks: dict[bytes, int],
        pattern: str = PATTERN_CL100K,
        special_tokens: Optional[dict[str, int]] = None,
        bos_token_id: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        native: bool = True,
    ):
        self.ranks = ranks
        self._pattern_str = pattern
        self.pattern = compile_pattern(pattern)
        self.special_tokens = special_tokens or {}
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self._decoder: dict[int, bytes] = {v: k for k, v in ranks.items()}
        for tok, tid in self.special_tokens.items():
            self._decoder[tid] = tok.encode("utf-8")
        if self.special_tokens:
            self._special_re = re.compile(
                "|".join(re.escape(t) for t in
                         sorted(self.special_tokens, key=len, reverse=True))
            )
        else:
            self._special_re = None
        self._n_vocab = max(self._decoder) + 1 if self._decoder else 0
        self._native = None
        self._native_mode = None     # 0 the GPT-2 pattern, 1 the cl100k family
        if native:
            from .bpe_native import NativeBpe

            self._native = NativeBpe(ranks)
            self._native_mode = {PATTERN_GPT2: 0, PATTERN_CL100K: 1}.get(pattern)
            if self._native_mode is not None:
                self._native.enable_pretokenizer()

    # -- introspection -----------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self._n_vocab

    def special_token_id(self, token: str) -> Optional[int]:
        return self.special_tokens.get(token)

    def token_bytes(self, token_id: int) -> bytes:
        return self._decoder.get(token_id, b"")

    def vocab_bytes(self) -> list[bytes]:
        """[V] list of token byte strings (grammar masking input): a
        byte-level token's raw bytes, not its display string."""
        return [self._decoder.get(i, b"") for i in range(self._n_vocab)]

    # -- encode ------------------------------------------------------------
    def _bpe_merge(self, piece: bytes) -> list[int]:
        if len(piece) == 1:
            rank = self.ranks.get(piece)
            return [rank] if rank is not None else []
        rank = self.ranks.get(piece)
        if rank is not None:
            return [rank]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_idx = i
            if best_rank is None:
                break
            parts[best_idx : best_idx + 2] = [parts[best_idx] + parts[best_idx + 1]]
        out = []
        for p in parts:
            r = self.ranks.get(p)
            if r is None:
                # byte fallback: split into single bytes
                for b in p:
                    rb = self.ranks.get(bytes([b]))
                    if rb is not None:
                        out.append(rb)
            else:
                out.append(r)
        return out

    def encode_ordinary(self, text: str) -> list[int]:
        """Encode without special-token recognition."""
        if self._native is not None:
            if self._native_mode is not None:
                return self._native.encode_text(text.encode("utf-8"), self._native_mode)
            pieces = [m.group().encode("utf-8") for m in self.pattern.finditer(text)]
            return self._native.encode_pieces(pieces) if pieces else []
        ids: list[int] = []
        for m in self.pattern.finditer(text):
            ids.extend(self._bpe_merge(m.group().encode("utf-8")))
        return ids

    def encode(self, text: str, add_bos: bool = False,
               allowed_special: bool = True) -> list[int]:
        """Encode with special tokens recognized inline
        (splintr encode_with_special)."""
        ids: list[int] = []
        if add_bos and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        if self._special_re is None or not allowed_special:
            ids.extend(self.encode_ordinary(text))
            return ids
        pos = 0
        for m in self._special_re.finditer(text):
            ids.extend(self.encode_ordinary(text[pos : m.start()]))
            ids.append(self.special_tokens[m.group()])
            pos = m.end()
        ids.extend(self.encode_ordinary(text[pos:]))
        return ids

    # -- decode ------------------------------------------------------------
    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self._decoder.get(i, b"") for i in ids)

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def is_eos(self, token_id: int) -> bool:
        return self.eos_token_id is not None and token_id == self.eos_token_id


# ---------------------------------------------------------------------------
# GPT-2 byte↔unicode table (HF tokenizer.json BPE vocabs use this alphabet)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def gpt2_byte_encoder() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def gpt2_byte_decoder() -> dict[str, int]:
    return {c: b for b, c in gpt2_byte_encoder().items()}


def gpt2_unicode_to_bytes(s: str) -> bytes:
    dec = gpt2_byte_decoder()
    return bytes(dec[c] for c in s if c in dec)
