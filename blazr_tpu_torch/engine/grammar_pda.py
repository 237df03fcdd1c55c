"""Exact-PDA grammar tier (native).

Copy of ``blazr_tpu/engine/grammar_pda.py``. The DFA tiers in
``grammar.py`` are exact only to a bounded recursion depth; deeply
recursive grammars (generic JSON, expression languages) get
over-approximate masks beyond ``EXACT_DEPTH``. This tier compiles the GBNF
AST to a compact table blob and runs a real pushdown automaton in C++
(``blazr_tpu_torch/native/pda.cpp``, built with g++ on first use): a set of
rule stacks advanced byte by byte, with token masks computed by a DFS over
a byte trie of the vocabulary.

``PdaUnsupported`` is the compiler's own refusal (left recursion, an
overflowing start state): ``grammar.make_grammar_state`` then keeps the
DFA, as the JAX package does. A library that does not build or load
raises ``RuntimeError`` from ``native.load_library`` instead (ROADMAP §C).
"""


from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from ..native import load_library
from .grammar_parser import (
    Alt,
    CharClass,
    Literal,
    Node,
    Repeat,
    RuleRef,
    Seq,
    parse_gbnf,
)

EL_END, EL_CHAR, EL_REF = 0, 1, 2


class PdaUnsupported(ValueError):
    """Grammar/vocab cannot use the PDA tier (caller falls back to DFA)."""


# ---------------------------------------------------------------------------
# AST → table blob
# ---------------------------------------------------------------------------

class _Compiler:
    def __init__(self, rules: dict[str, Node]):
        self.src_rules = rules
        self.classes: list[bytes] = []
        self.class_ids: dict[bytes, int] = {}
        self.rule_ids: dict[str, int] = {}
        self.rule_alts: list[Optional[list[list[tuple[int, int]]]]] = []

    # -- byte classes ------------------------------------------------------
    def _class_id(self, bitmap: bytearray) -> int:
        key = bytes(bitmap)
        cid = self.class_ids.get(key)
        if cid is None:
            cid = len(self.classes)
            self.classes.append(key)
            self.class_ids[key] = cid
        return cid

    def _single_byte_class(self, b: int) -> int:
        bm = bytearray(32)
        bm[b >> 3] |= 1 << (b & 7)
        return self._class_id(bm)

    def _char_class(self, node: CharClass) -> int:
        bm = bytearray(32)
        for lo, hi in node.ranges:
            for b in range(lo, hi + 1):
                bm[b >> 3] |= 1 << (b & 7)
        if node.negated:
            bm = bytearray((~x) & 0xFF for x in bm)
        return self._class_id(bm)

    # -- rules -------------------------------------------------------------
    def _new_rule(self) -> int:
        rid = len(self.rule_alts)
        self.rule_alts.append(None)
        return rid

    def _rule_id(self, name: str) -> int:
        rid = self.rule_ids.get(name)
        if rid is None:
            if name not in self.src_rules:
                raise PdaUnsupported(f"undefined rule {name!r}")
            rid = self._new_rule()
            self.rule_ids[name] = rid
            self.rule_alts[rid] = self._alts(self.src_rules[name])
        return rid

    def _alts(self, node: Node) -> list[list[tuple[int, int]]]:
        options = node.options if isinstance(node, Alt) else [node]
        return [self._seq(opt) for opt in options]

    def _seq(self, node: Node) -> list[tuple[int, int]]:
        items = node.items if isinstance(node, Seq) else [node]
        out: list[tuple[int, int]] = []
        for it in items:
            out.extend(self._item(it))
        return out

    def _item(self, node: Node) -> list[tuple[int, int]]:
        if isinstance(node, Literal):
            return [(EL_CHAR, self._single_byte_class(b)) for b in node.data]
        if isinstance(node, CharClass):
            return [(EL_CHAR, self._char_class(node))]
        if isinstance(node, RuleRef):
            return [(EL_REF, self._rule_id(node.name))]
        if isinstance(node, (Alt, Seq)):
            rid = self._new_rule()
            self.rule_alts[rid] = self._alts(node)
            return [(EL_REF, rid)]
        if isinstance(node, Repeat):
            body = self._item(node.item)
            out = []
            for _ in range(node.min):
                out.extend(body)
            if node.max is None:
                star = self._new_rule()                    # S ::= body S | ε
                self.rule_alts[star] = [body + [(EL_REF, star)], []]
                out.append((EL_REF, star))
            else:
                extra = node.max - node.min
                if extra < 0:
                    raise PdaUnsupported("repeat max < min")
                opt_chain: list[tuple[int, int]] = []
                for _ in range(extra):                     # O ::= body O' | ε
                    rid = self._new_rule()
                    self.rule_alts[rid] = [body + opt_chain, []]
                    opt_chain = [(EL_REF, rid)]
                out.extend(opt_chain)
            return out
        raise PdaUnsupported(f"unsupported node {type(node).__name__}")

    def compile(self) -> bytes:
        root = self._rule_id("root")
        assert root == 0
        parts = [struct.pack("<I", len(self.classes))]
        parts += self.classes
        parts.append(struct.pack("<I", len(self.rule_alts)))
        for alts in self.rule_alts:
            assert alts is not None
            parts.append(struct.pack("<I", len(alts)))
            for alt in alts:
                parts.append(struct.pack("<I", len(alt)))
                for kind, arg in alt:
                    parts.append(struct.pack("<BI", kind, arg))
        return b"".join(parts)


def compile_gbnf_blob(src: str) -> bytes:
    """GBNF source → PDA table blob (root is rule 0)."""
    return _Compiler(parse_gbnf(src)).compile()


# ---------------------------------------------------------------------------
# ctypes binding
# ---------------------------------------------------------------------------

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_library("pda")
        lib.pda_new.restype = ctypes.c_void_p
        lib.pda_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.pda_free.argtypes = [ctypes.c_void_p]
        lib.pda_vocab_new.restype = ctypes.c_void_p
        lib.pda_vocab_new.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32]
        lib.pda_vocab_free.argtypes = [ctypes.c_void_p]
        lib.pda_state_new.restype = ctypes.c_void_p
        lib.pda_state_new.argtypes = [ctypes.c_void_p]
        lib.pda_state_free.argtypes = [ctypes.c_void_p]
        lib.pda_state_clone.restype = ctypes.c_void_p
        lib.pda_state_clone.argtypes = [ctypes.c_void_p]
        lib.pda_state_accept.restype = ctypes.c_int
        lib.pda_state_accept.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.pda_state_accepting.restype = ctypes.c_int
        lib.pda_state_accepting.argtypes = [ctypes.c_void_p]
        lib.pda_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
    return _lib


class _Vocab:
    """Shared byte-trie over the tokenizer vocab (built once per vocab)."""

    def __init__(self, token_bytes: list[bytes]):
        lib = _load()
        blob = b"".join(token_bytes)
        offsets = np.zeros(len(token_bytes) + 1, dtype=np.uint32)
        np.cumsum([len(t) for t in token_bytes], out=offsets[1:])
        self._offsets = offsets                 # keep alive for the call
        self.ptr = lib.pda_vocab_new(
            blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(token_bytes))
        self.vocab_size = len(token_bytes)
        self._free = lib.pda_vocab_free     # survives interpreter shutdown

    def __del__(self):
        if getattr(self, "ptr", None):
            self._free(self.ptr)


_VOCAB_CACHE: dict[int, _Vocab] = {}


def _vocab_for(token_bytes: list[bytes]) -> _Vocab:
    key = id(token_bytes)
    v = _VOCAB_CACHE.get(key)
    if v is None:
        if len(_VOCAB_CACHE) > 4:
            _VOCAB_CACHE.clear()
        v = _Vocab(token_bytes)
        _VOCAB_CACHE[key] = v
    return v


class PdaGrammar:
    """Compiled grammar handle (shared across sequences)."""

    def __init__(self, src: str):
        lib = _load()
        blob = compile_gbnf_blob(src)
        self.ptr = lib.pda_new(blob, len(blob))
        if not self.ptr:
            raise PdaUnsupported("pda table parse failed")
        self._free = lib.pda_free

    def __del__(self):
        if getattr(self, "ptr", None):
            self._free(self.ptr)


_PDA_CACHE: dict[str, PdaGrammar] = {}


def compile_grammar_to_pda(src: str) -> PdaGrammar:
    g = _PDA_CACHE.get(src)
    if g is None:
        g = PdaGrammar(src)
        if len(_PDA_CACHE) < 64:
            _PDA_CACHE[src] = g
    return g


class PdaGrammarState:
    """Drop-in for ``grammar.GrammarState`` backed by the native PDA."""

    def __init__(self, grammar: PdaGrammar, token_bytes: list[bytes],
                 eos_token_id: Optional[int] = None):
        lib = _load()
        self.grammar = grammar
        self.token_bytes = token_bytes
        self.eos_token_id = eos_token_id
        self._vocab = _vocab_for(token_bytes)
        self._state = lib.pda_state_new(grammar.ptr)
        if not self._state:
            raise PdaUnsupported("grammar start-state overflow")
        self._free = lib.pda_state_free
        self._mask_buf = np.zeros(len(token_bytes), dtype=np.uint8)
        # Set when the configuration set overflows mid-sequence
        # (pathological grammar): stop constraining rather than reject.
        self._permissive = False

    def __del__(self):
        if getattr(self, "_state", None):
            self._free(self._state)

    def mask(self) -> np.ndarray:
        lib = _load()
        if self._permissive:
            return np.ones(len(self.token_bytes), dtype=bool)
        lib.pda_mask(self.grammar.ptr, self._vocab.ptr, self._state,
                     self._mask_buf.ctypes.data_as(
                         ctypes.POINTER(ctypes.c_uint8)))
        m = self._mask_buf.astype(bool)
        if self.eos_token_id is not None and 0 <= self.eos_token_id < len(m):
            m[self.eos_token_id] = bool(
                lib.pda_state_accepting(self._state))
        return m

    def accept_token(self, token_id: int) -> bool:
        lib = _load()
        if token_id == self.eos_token_id:
            return bool(lib.pda_state_accepting(self._state))
        data = self.token_bytes[token_id]
        if not data:
            return False
        if self._permissive:
            return True
        r = lib.pda_state_accept(self.grammar.ptr, self._state, data,
                                 len(data))
        if r < 0:
            self._permissive = True
            return True
        return r == 1

    @property
    def is_complete(self) -> bool:
        return bool(_load().pda_state_accepting(self._state))
