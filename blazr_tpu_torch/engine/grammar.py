"""Grammar-constrained decoding: GBNF → byte NFA → DFA → token masks.

Copy of ``blazr_tpu/engine/grammar.py``: GBNF compiles through Thompson
construction and subset construction into a byte-level DFA with a
flattened ``[states, 256]`` transition table. Recursive rules are expanded
to a bounded depth (a DFA cannot represent unbounded nesting; such
grammars take the exact-PDA tier of ``grammar_pda.py``).

A token mask is a table lookup, not a kernel: the allowed-token mask of a
DFA state is computed on the host (a vectorized walk of the tokenizer's
token bytes) and cached. ``GrammarDfa.token_tables`` builds the mask and
next-state planes of every state, ``[S, V]`` each, which
``BatchEngine`` uploads once per DFA so that a grammar row advances on
the device inside the decode graph (``decode_graph.BatchStep``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .grammar_parser import (
    Alt,
    CharClass,
    GrammarParseError,
    Literal,
    Node,
    Repeat,
    RuleRef,
    Seq,
    parse_gbnf,
)

logger = logging.getLogger(__name__)

INVALID_STATE = -1
# Global rule-expansion depth budget. Rule references are memoized per
# (name, depth) in the fallback tier, and the DFA grows ~3x per depth
# level for recursive grammars: 12 bounds JSON mode's DFA at 3,664 states
# (≈4 nesting levels; deeper nesting takes the exact-PDA tier).
MAX_RECURSION_DEPTH = 12
EXACT_DEPTH = 3            # memoized tier: top levels expanded exactly
MAX_NFA_STATES = 200_000


# ---------------------------------------------------------------------------
# Thompson NFA construction
# ---------------------------------------------------------------------------

class _NFABudget(GrammarParseError):
    pass


class _NFA:
    def __init__(self, limit: int = MAX_NFA_STATES) -> None:
        self.limit = limit
        self.eps: list[list[int]] = []            # epsilon edges
        self.trans: list[list[tuple[int, int, int]]] = []  # (lo, hi, target)

    def new_state(self) -> int:
        if len(self.eps) >= self.limit:
            raise _NFABudget("grammar too large (NFA state limit)")
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def add_range(self, a: int, lo: int, hi: int, b: int) -> None:
        self.trans[a].append((lo, hi, b))


def _build_nfa(node: Node, nfa: _NFA, rules: dict[str, Node],
               depth: int, memo: dict) -> tuple[int, int]:
    """Thompson construction → (start, end) NFA states.

    Rule references are memoized on (rule, depth): every call site at the
    same depth shares one sub-NFA via epsilon edges, keeping recursive
    grammars (JSON!) linear instead of exponential in the depth budget.
    """
    if isinstance(node, Literal):
        start = nfa.new_state()
        cur = start
        for byte in node.data:
            nxt = nfa.new_state()
            nfa.add_range(cur, byte, byte, nxt)
            cur = nxt
        return start, cur
    if isinstance(node, CharClass):
        start = nfa.new_state()
        end = nfa.new_state()
        if node.negated:
            allowed = np.ones(256, dtype=bool)
            for lo, hi in node.ranges:
                allowed[lo : hi + 1] = False
            # merge into ranges
            b = 0
            while b < 256:
                if allowed[b]:
                    e = b
                    while e + 1 < 256 and allowed[e + 1]:
                        e += 1
                    nfa.add_range(start, b, e, end)
                    b = e + 1
                else:
                    b += 1
        else:
            for lo, hi in node.ranges:
                nfa.add_range(start, lo, hi, end)
        return start, end
    if isinstance(node, RuleRef):
        if depth >= MAX_RECURSION_DEPTH:
            # Bounded recursion: dead-end (no transitions) at max depth.
            s = nfa.new_state()
            e = nfa.new_state()
            return s, e
        if node.name not in rules:
            raise GrammarParseError(f"undefined rule {node.name!r}")
        if memo is None or depth < EXACT_DEPTH:
            # Exact mode: every call site gets its own expansion. Even in
            # the memoized tier the first EXACT_DEPTH levels stay exact so
            # shallow cross-context strings (e.g. "{]") are rejected; only
            # deep nesting pays the sharing over-approximation.
            return _build_nfa(rules[node.name], nfa, rules, depth + 1, memo)
        key = (node.name, depth)
        hit = memo.get(key)
        if hit is not None:
            # Share the memoized sub-NFA through fresh eps-connected ports.
            # NOTE: sharing merges call-site contexts (an over-approximation
            # — a shared sub-NFA's exit can continue into another call
            # site's suffix). Used only as the fallback tier for grammars
            # too recursive to expand exactly.
            s, e = hit
            s2 = nfa.new_state()
            e2 = nfa.new_state()
            nfa.add_eps(s2, s)
            nfa.add_eps(e, e2)
            return s2, e2
        s, e = _build_nfa(rules[node.name], nfa, rules, depth + 1, memo)
        memo[key] = (s, e)
        return s, e
    if isinstance(node, Seq):
        if not node.items:
            s = nfa.new_state()
            return s, s
        start, end = _build_nfa(node.items[0], nfa, rules, depth, memo)
        for item in node.items[1:]:
            s2, e2 = _build_nfa(item, nfa, rules, depth, memo)
            nfa.add_eps(end, s2)
            end = e2
        return start, end
    if isinstance(node, Alt):
        start = nfa.new_state()
        end = nfa.new_state()
        for opt in node.options:
            s, e = _build_nfa(opt, nfa, rules, depth, memo)
            nfa.add_eps(start, s)
            nfa.add_eps(e, end)
        return start, end
    if isinstance(node, Repeat):
        start = nfa.new_state()
        cur = start
        for _ in range(node.min):
            s, e = _build_nfa(node.item, nfa, rules, depth, memo)
            nfa.add_eps(cur, s)
            cur = e
        end = nfa.new_state()
        nfa.add_eps(cur, end)
        if node.max is None:
            s, e = _build_nfa(node.item, nfa, rules, depth, memo)
            nfa.add_eps(cur, s)
            nfa.add_eps(e, s)      # loop
            nfa.add_eps(e, end)
        else:
            for _ in range(node.max - node.min):
                s, e = _build_nfa(node.item, nfa, rules, depth, memo)
                nfa.add_eps(cur, s)
                nfa.add_eps(e, end)
                cur = e
        return start, end
    raise TypeError(f"unknown node {node!r}")


# ---------------------------------------------------------------------------
# Subset construction → DFA
# ---------------------------------------------------------------------------

@dataclass
class GrammarDfa:
    """Deterministic byte automaton with cached per-state token masks."""

    table: np.ndarray                 # int32 [S, 256], INVALID_STATE = dead
    accepting: np.ndarray             # bool [S]
    start_state: int = 0
    exact: bool = True                # False: memoized (depth-bounded) tier
    _mask_cache: dict = field(default_factory=dict, repr=False)

    @property
    def num_states(self) -> int:
        return self.table.shape[0]

    # -- state tracking (host-side, reference CPU DFA path) ----------------
    def advance_bytes(self, state: int, data: bytes) -> int:
        for byte in data:
            if state == INVALID_STATE:
                return INVALID_STATE
            state = int(self.table[state, byte])
        return state

    def is_accepting(self, state: int) -> bool:
        return state != INVALID_STATE and bool(self.accepting[state])

    # -- token masks -------------------------------------------------------
    def token_mask(self, state: int, token_bytes: list[bytes],
                   eos_token_id: Optional[int] = None) -> np.ndarray:
        """Boolean [V] mask of tokens legal from ``state``.

        A token is legal if consuming all its bytes never hits the dead
        state. EOS is legal iff the state is accepting. Rows are cached per
        (state, vocab size, eos) — DFAs are shared process-wide by grammar
        source, and two loaded models may use different tokenizers.
        """
        key = (state, len(token_bytes), eos_token_id)
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached

        v = len(token_bytes)
        # Vectorized multi-step walk: states [V] advance byte-position-wise.
        max_len = max((len(t) for t in token_bytes), default=1)
        arr = np.full((v, max_len), -2, dtype=np.int32)   # -2 = past end
        for i, t in enumerate(token_bytes):
            if t:
                arr[i, : len(t)] = np.frombuffer(t, dtype=np.uint8)
        states = np.full(v, state, dtype=np.int32)
        alive = np.ones(v, dtype=bool)
        for pos in range(max_len):
            byte = arr[:, pos]
            active = alive & (byte >= 0)
            if not active.any():
                break
            nxt = self.table[states[active], byte[active]]
            states[active] = nxt
            dead = np.zeros(v, dtype=bool)
            dead[active] = nxt == INVALID_STATE
            alive &= ~dead
        mask = alive
        # Zero-length tokens are never legal (would loop forever).
        for i, t in enumerate(token_bytes):
            if not t:
                mask[i] = False
        if eos_token_id is not None and 0 <= eos_token_id < v:
            mask[eos_token_id] = self.is_accepting(state)
        self._mask_cache[key] = mask
        return mask


    # -- full token tables (device-side grammar stepping) -------------------
    def token_tables(self, token_bytes: list[bytes],
                     eos_token_id: Optional[int] = None,
                     max_states: int = 512
                     ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """(mask [S, V] bool, next_state [S, V] i32) over EVERY state —
        the tables a device decode loop needs to advance the grammar
        without a host round-trip per token: ``mask[s]`` gates sampling,
        ``next[s, tok]`` is the state after consuming ``tok``'s bytes
        (INVALID_STATE if illegal; EOS self-loops). Returns None when the
        automaton is too large to materialize (caller falls back to
        per-step host masks). Cached on the DFA per (vocab size, eos) —
        DFAs are shared process-wide and tokenizers may differ."""
        if self.num_states > max_states:
            return None
        tkey = ("__tables__", len(token_bytes), eos_token_id)
        cached = self._mask_cache.get(tkey)
        if cached is not None:
            return cached

        v = len(token_bytes)
        s_count = self.num_states
        masks = np.zeros((s_count, v), dtype=bool)
        nxt = np.full((s_count, v), INVALID_STATE, dtype=np.int32)
        max_len = max((len(t) for t in token_bytes), default=1)
        arr = np.full((v, max_len), -2, dtype=np.int32)   # -2 = past end
        empty = np.zeros(v, dtype=bool)
        for i, t in enumerate(token_bytes):
            if t:
                arr[i, : len(t)] = np.frombuffer(t, dtype=np.uint8)
            else:
                empty[i] = True
        for s in range(s_count):
            states = np.full(v, s, dtype=np.int32)
            alive = np.ones(v, dtype=bool)
            for pos in range(max_len):
                byte = arr[:, pos]
                active = alive & (byte >= 0)
                if not active.any():
                    break
                nx = self.table[states[active], byte[active]]
                states[active] = nx
                dead = np.zeros(v, dtype=bool)
                dead[active] = nx == INVALID_STATE
                alive &= ~dead
            alive &= ~empty                   # zero-length tokens never legal
            masks[s] = alive
            nxt[s] = np.where(alive, states, INVALID_STATE)
            if eos_token_id is not None and 0 <= eos_token_id < v:
                masks[s, eos_token_id] = bool(self.accepting[s])
                nxt[s, eos_token_id] = s      # EOS ends generation anyway
        self._mask_cache[tkey] = (masks, nxt)
        return masks, nxt


_DFA_CACHE: dict[str, GrammarDfa] = {}


def compile_grammar_to_dfa(src: str) -> GrammarDfa:
    """GBNF source → DFA (reference compile_grammar_to_dfa, grammar.rs:165).

    Compiled DFAs are cached by source (JSON mode reuses one grammar)."""
    cached = _DFA_CACHE.get(src)
    if cached is not None:
        return cached
    dfa = _compile_uncached(src)
    if len(_DFA_CACHE) < 64:
        _DFA_CACHE[src] = dfa
    return dfa


def _compile_uncached(src: str) -> GrammarDfa:
    rules = parse_gbnf(src)
    # Tier 1: exact per-call-site expansion under a 30k-state budget —
    # exact masks for typical schemas/enums/DSLs.
    # Tier 2 (deeply recursive grammars, e.g. generic JSON): memoized shared
    # expansion — linear size, slightly over-approximate across contexts.
    exact = True
    try:
        nfa = _NFA(limit=30_000)
        start, end = _build_nfa(rules["root"], nfa, rules, 0, None)
    except _NFABudget:
        exact = False
        nfa = _NFA()
        start, end = _build_nfa(rules["root"], nfa, rules, 0, {})

    # Flatten transitions into numpy arrays for vectorized subset
    # construction (the pure-Python triple loop is too slow for the memoized
    # JSON grammar's NFA).
    t_src, t_lo, t_hi, t_tgt = [], [], [], []
    for s, lst in enumerate(nfa.trans):
        for lo, hi, t in lst:
            t_src.append(s)
            t_lo.append(lo)
            t_hi.append(hi)
            t_tgt.append(t)
    t_src = np.asarray(t_src, dtype=np.int32)
    t_lo = np.asarray(t_lo, dtype=np.int16)
    t_hi = np.asarray(t_hi, dtype=np.int16)
    t_tgt = np.asarray(t_tgt, dtype=np.int32)
    bytes_col = np.arange(256, dtype=np.int16)[:, None]

    def closure(states) -> np.ndarray:
        stack = list(states)
        seen = set(stack)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return np.fromiter(sorted(seen), dtype=np.int32, count=len(seen))

    def key_of(arr: np.ndarray) -> bytes:
        return arr.tobytes()

    start_arr = closure([start])
    dfa_states: dict[bytes, int] = {key_of(start_arr): 0}
    table_rows: list[np.ndarray] = [np.full(256, INVALID_STATE, dtype=np.int32)]
    accepting: list[bool] = [bool(np.isin(end, start_arr))]
    work: list[np.ndarray] = [start_arr]
    while work:
        cur = work.pop()
        idx = dfa_states[key_of(cur)]
        row = table_rows[idx]
        sel = np.isin(t_src, cur, assume_unique=False)
        if not sel.any():
            continue
        lo, hi, tgt = t_lo[sel], t_hi[sel], t_tgt[sel]
        # [256, T] byte-matches-transition matrix; identical rows share the
        # same successor set, so group bytes by unique rows.
        match = (bytes_col >= lo[None, :]) & (bytes_col <= hi[None, :])
        rows_u, inv = np.unique(match, axis=0, return_inverse=True)
        for ri in range(rows_u.shape[0]):
            hit = rows_u[ri]
            if not hit.any():
                continue
            targets = np.unique(tgt[hit])
            clo = closure(targets.tolist())
            k = key_of(clo)
            j = dfa_states.get(k)
            if j is None:
                j = len(dfa_states)
                dfa_states[k] = j
                table_rows.append(np.full(256, INVALID_STATE, dtype=np.int32))
                accepting.append(bool(np.isin(end, clo)))
                work.append(clo)
            row[inv == ri] = j

    table = np.stack(table_rows)
    acc = np.array(accepting, dtype=bool)
    return GrammarDfa(table=table, accepting=acc, start_state=0, exact=exact)


# ---------------------------------------------------------------------------
# Per-sequence grammar state
# ---------------------------------------------------------------------------

class GrammarState:
    """Tracks one sequence's DFA state across emitted tokens."""

    def __init__(self, dfa: GrammarDfa, token_bytes: list[bytes],
                 eos_token_id: Optional[int] = None):
        self.dfa = dfa
        self.token_bytes = token_bytes
        self.eos_token_id = eos_token_id
        self.state = dfa.start_state

    def mask(self) -> np.ndarray:
        return self.dfa.token_mask(self.state, self.token_bytes, self.eos_token_id)

    def accept_token(self, token_id: int) -> bool:
        if token_id == self.eos_token_id:
            return self.dfa.is_accepting(self.state)
        nxt = self.dfa.advance_bytes(self.state, self.token_bytes[token_id])
        if nxt == INVALID_STATE:
            return False
        self.state = nxt
        return True

    @property
    def is_complete(self) -> bool:
        return self.dfa.is_accepting(self.state)


def padded_mask(state, vocab_size: int) -> np.ndarray:
    """A grammar state's mask over a model vocabulary of ``vocab_size``: ids
    past the tokenizer's (a padded vocabulary) are never legal."""
    m = state.mask()
    out = np.zeros(vocab_size, dtype=bool)
    n = min(len(m), vocab_size)
    out[:n] = m[:n]
    return out


def make_grammar_state(src: str, token_bytes: list,
                       eos_token_id: Optional[int] = None):
    """Best grammar state for ``src``: exact DFA when the grammar fits the
    exact tier; otherwise the native exact-PDA tier (``grammar_pda``); the
    depth-bounded DFA only where the PDA compiler's own caps refuse the
    grammar (``PdaUnsupported``: left recursion, start-state overflow).
    A PDA library that does not build or load raises (ROADMAP §C): the
    JAX package logs it and falls back to the DFA."""
    dfa = compile_grammar_to_dfa(src)
    if not dfa.exact:
        from .grammar_pda import PdaGrammarState, PdaUnsupported, compile_grammar_to_pda

        try:
            st = PdaGrammarState(compile_grammar_to_pda(src), token_bytes,
                                 eos_token_id=eos_token_id)
            logger.info("grammar: exact-PDA tier (deep grammar)")
            return st
        except PdaUnsupported:
            logger.info("PDA tier refuses the grammar; using depth-bounded DFA",
                        exc_info=True)
    return GrammarState(dfa, token_bytes, eos_token_id=eos_token_id)
