"""GGUF-embedded tokenizers.

Counterpart of ``blazr_tpu/tokenizer/gguf_tokenizer.py``: a tokenizer from
the ``tokenizer.ggml.*`` metadata arrays of a GGUF file. Two families:

  * ``llama``  — SentencePiece-style BPE: merge the adjacent pair with the
    highest score repeatedly; ``▁`` marks spaces; byte-fallback tokens
    ``<0xXX>``.
  * ``gpt2``   — byte-level BPE with an explicit merges list.

The SentencePiece merges are the JAX loop's, taken from a heap instead of
a rescan of every pair (the same ids; O(n log n) where the JAX loop is
quadratic in a prompt's length).
"""

from __future__ import annotations

import heapq
from typing import Optional

from ..formats.gguf import Gguf, GgufMetadata
from .bpe import PATTERN_GPT2, BpeTokenizer, gpt2_unicode_to_bytes

# tokenizer.ggml.token_type values (public gguf spec)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6


class SentencePieceBpeTokenizer:
    """Score-based SentencePiece BPE (the GGUF 'llama' tokenizer model)."""

    def __init__(self, tokens: list[str], scores: list[float],
                 token_types: Optional[list[int]],
                 bos_token_id: Optional[int], eos_token_id: Optional[int],
                 add_bos: bool = True):
        self.tokens = tokens
        self.scores = scores
        self.token_types = token_types or [TOKEN_TYPE_NORMAL] * len(tokens)
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.add_bos = add_bos
        self.index = {t: i for i, t in enumerate(tokens)}
        self.byte_tokens: dict[int, int] = {}
        for i, (t, tt) in enumerate(zip(tokens, self.token_types)):
            if tt == TOKEN_TYPE_BYTE and t.startswith("<0x") and t.endswith(">"):
                self.byte_tokens[int(t[3:-1], 16)] = i

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- encode ------------------------------------------------------------
    def encode(self, text: str, add_bos: Optional[bool] = None) -> list[int]:
        ids: list[int] = []
        if (self.add_bos if add_bos is None else add_bos) and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        # SentencePiece treats input as one sequence with ▁ for spaces and a
        # leading space prepended.
        piece_text = "▁" + text.replace(" ", "▁")
        symbols = list(piece_text)

        for sym in self._merge(symbols):
            i = self.index.get(sym)
            if i is not None:
                ids.append(i)
            else:
                # byte fallback
                for b in sym.encode("utf-8"):
                    bt = self.byte_tokens.get(b)
                    if bt is not None:
                        ids.append(bt)
        return ids

    def _merge(self, symbols: list[str]) -> list[str]:
        """The JAX loop's merges: while some adjacent pair joins into a
        piece of the vocab, join the pair whose piece scores highest, the
        leftmost of equal scores. A heap of (−score, start) over a linked
        list takes each step in O(log n) where the JAX loop rescans every
        pair (O(n²) a prompt); stale entries are skipped when popped."""
        n = len(symbols)
        syms = list(symbols)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        heap: list = []

        def push(i: int) -> None:
            j = nxt[i]
            if j != -1:
                tid = self.index.get(syms[i] + syms[j])
                if tid is not None:
                    heapq.heappush(heap, (-self.scores[tid], i, syms[i], syms[j]))

        for i in range(n - 1):
            push(i)
        alive = [True] * n
        while heap:
            _, i, a, b = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j == -1 or syms[i] != a or syms[j] != b:
                continue
            syms[i] = a + b
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                push(prv[i])
            push(i)
        return [sym for sym, live in zip(syms, alive) if live]


    # -- decode ------------------------------------------------------------
    def token_bytes(self, token_id: int) -> bytes:
        if not (0 <= token_id < len(self.tokens)):
            return b""
        t = self.tokens[token_id]
        tt = self.token_types[token_id]
        if tt == TOKEN_TYPE_BYTE and t.startswith("<0x"):
            return bytes([int(t[3:-1], 16)])
        if tt in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNKNOWN, TOKEN_TYPE_UNUSED):
            return b""
        return t.replace("▁", " ").encode("utf-8")

    def decode(self, ids) -> str:
        out = b"".join(self.token_bytes(i) for i in ids)
        text = out.decode("utf-8", errors="replace")
        # SentencePiece strips the artificial leading space.
        return text[1:] if text.startswith(" ") else text

    def is_eos(self, token_id: int) -> bool:
        return self.eos_token_id is not None and token_id == self.eos_token_id


def tokenizer_from_gguf(g: Gguf | GgufMetadata):
    """Build the embedded tokenizer from GGUF metadata."""
    md = g.metadata() if isinstance(g, Gguf) else g
    model = md.get_str("tokenizer.ggml.model") or "llama"
    tokens = md.get_array("tokenizer.ggml.tokens")
    if tokens is None:
        raise ValueError("GGUF has no embedded tokenizer (tokenizer.ggml.tokens)")
    bos = md.get_u32("tokenizer.ggml.bos_token_id")
    eos = md.get_u32("tokenizer.ggml.eos_token_id")
    token_types = md.get_array("tokenizer.ggml.token_type")

    if model in ("llama", "spm"):
        scores = md.get_array("tokenizer.ggml.scores") or [0.0] * len(tokens)
        add_bos = md.get("tokenizer.ggml.add_bos_token")
        return SentencePieceBpeTokenizer(
            tokens, scores, token_types, bos, eos,
            add_bos=bool(add_bos) if add_bos is not None else True,
        )

    # gpt2-style byte-level BPE with merges
    merges = md.get_array("tokenizer.ggml.merges") or []
    ranks: dict[bytes, int] = {}
    special: dict[str, int] = {}
    for i, t in enumerate(tokens):
        tt = token_types[i] if token_types else TOKEN_TYPE_NORMAL
        if tt in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED):
            special[t] = i
        else:
            ranks[gpt2_unicode_to_bytes(t)] = i
    return BpeTokenizer(ranks, pattern=PATTERN_GPT2, special_tokens=special,
                        bos_token_id=bos, eos_token_id=eos)
