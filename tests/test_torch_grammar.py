"""Port parity: the grammar tiers of blazr_tpu_torch (GBNF parser, DFA and
its token tables, JSON schema to GBNF, the exact-PDA tier and its native
library, the tier factory) against blazr_tpu's on the CPU. Token byte
strings come from a seeded numpy generator; every table, mask and string
must be exactly equal."""

import ctypes
import dataclasses
import os
import shutil
import subprocess
import time

import numpy as np
import pytest

from blazr_tpu.engine import grammar as jg
from blazr_tpu.engine import grammar_json as jj
from blazr_tpu.engine import grammar_parser as jp
from blazr_tpu.engine import grammar_pda as jpda
from blazr_tpu_torch import native
from blazr_tpu_torch.engine import grammar as tg
from blazr_tpu_torch.engine import grammar_json as tj
from blazr_tpu_torch.engine import grammar_parser as tp
from blazr_tpu_torch.engine import grammar_pda as tpda

def ensure_jax_pda() -> None:
    """Make sure the JAX package's PDA library is loaded in this process.

    Its loader (``blazr_tpu/native/__init__.py``) compiles ``pda.cpp`` with
    ``g++ -o`` straight onto ``libpda.so`` and caches a failed load as None
    for the life of the process; an xdist worker that loads while another
    worker's g++ is still writing the file gets None, and every JAX grammar
    that needs the PDA then takes another tier (PdaUnsupported). Here the
    cached None is dropped and the load retried, after building the library
    once more into a temporary file that replaces ``libpda.so`` atomically;
    a library that still does not load fails the test with the loader's
    own message, never a skip."""
    from blazr_tpu import native as jnative

    so = jnative._DIR / "libpda.so"
    err = None
    for attempt in range(20):
        lib = jnative.load_library("pda")
        if lib is not None:
            jpda._load()
            return
        try:
            ctypes.CDLL(str(so))
        except OSError as e:
            err = e
        if attempt:
            time.sleep(0.5)               # a builder in another process finishing
        tmp = so.with_name(f".libpda.{os.getpid()}.so")
        build = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                                "-march=native", str(jnative._DIR / "pda.cpp"), "-o",
                                str(tmp)], capture_output=True, text=True, timeout=300)
        if build.returncode == 0:
            os.replace(tmp, so)
        else:
            err = build.stderr
        with jnative._LOCK:
            jnative._LIBS.pop("pda", None)
        jpda._lib = None
    pytest.fail(f"the JAX PDA library does not load: {err}")


@pytest.fixture(autouse=True, scope="module")
def _jax_pda_loaded():
    ensure_jax_pda()


GRAMMARS = {
    "yes_no": 'root ::= "yes" | "no"',
    "digits": 'root ::= [0-9]+ ("," [0-9]+)*',
    "repeat": 'root ::= [a-z]{2,4} "-" [^a-z\\n]? [0-9]{3}',
    "rules": 'root ::= greet ws name\ngreet ::= "hi" | "hello"  # a comment\n'
             'ws ::= [ \\t]+\nname ::= [A-Z] [a-z]*',
    "escapes": 'root ::= "\\"q\\"" [\\x41-\\x43] "\\u00e9" | "\\\\n"',
    "unicode": 'root ::= [a-zé]+ "!"',
    "schema": None,                 # filled from SCHEMAS["nested"]
}
BAD = ["", 'foo ::= "a"', 'root ::= "a', "root ::= [a", 'root ::= ("a"',
       "::= x", 'root := "a"', 'root ::= "\\q"', "root ::= x{2,"]
DEEP = {"arrays": 'root ::= v\nv ::= "[" (v ("," v)*)? "]" | "1"\n',
        "brackets": 'root ::= e\ne ::= "(" e ")" | "[" e "]" | "{" e "}" | "x"\n'}
SCHEMAS = {
    "object": {"type": "object", "properties": {"name": {"type": "string"},
                                                "age": {"type": "integer"}},
               "required": ["name", "age"]},
    "enum": {"type": "object", "properties": {"answer": {"enum": ["yes", "no", 3, None]}},
             "required": ["answer"]},
    "array": {"type": "array", "items": {"type": "number"}},
    "nested": {"type": "object", "properties": {
        "user": {"type": "object", "properties": {"id": {"type": "integer"},
                                                  "tags": {"type": "array",
                                                           "items": {"enum": ["a", "b"]}}}},
        "ok": {"type": "boolean"}, "note": {"type": ["string", "null"]},
        "k": {"const": "v\"q"}}},
    "ref_and_empty": {"type": "object", "properties": {"x": {"$ref": "#/d"}, "y": {}}},
    "bare": {"type": "string"},
}
GRAMMARS["schema"] = jj.json_schema_to_gbnf(SCHEMAS["nested"])


def _ast(node):
    """A parse tree as plain nested tuples (the two packages' node classes
    are distinct types)."""
    if isinstance(node, dict):
        return {k: _ast(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_ast(v) for v in node]
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,) + tuple(_ast(getattr(node, f.name))
                                             for f in dataclasses.fields(node))
    return node


def _token_bytes(seed: int, n: int = 400) -> list[bytes]:
    """``n`` synthetic token byte strings: every single byte, then random
    runs of 1-6 bytes drawn mostly from the grammars' alphabets, and one
    empty token."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'0123456789,abcdefghijklmnopqrstuvwxyzABCXYZ -!"\\{}[]:\n\t'
                             b"\xc3\xa9", dtype=np.uint8)
    out = [bytes([i]) for i in range(256)] + [b""]
    while len(out) < n:
        k = int(rng.integers(1, 7))
        pool = alphabet if rng.random() < 0.85 else np.arange(256, dtype=np.uint8)
        out.append(bytes(rng.choice(pool, k).tolist()))
    return out


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_parse_tree_matches_jax(name):
    src = GRAMMARS[name]
    assert _ast(tp.parse_gbnf(src)) == _ast(jp.parse_gbnf(src))


@pytest.mark.parametrize("src", BAD)
def test_parse_errors_match_jax(src):
    with pytest.raises(jp.GrammarParseError) as want:
        jp.parse_gbnf(src)
    with pytest.raises(tp.GrammarParseError) as got:
        tp.parse_gbnf(src)
    assert isinstance(got.value, ValueError)          # the server's 400
    assert str(got.value) == str(want.value)


def test_unterminated_class_range_is_a_parse_error():
    """A grammar ending inside a class range ("[a-") is a GrammarParseError
    in the port (the server's 400); the JAX parser raises TypeError (its
    server's 500)."""
    with pytest.raises(TypeError):
        jp.parse_gbnf("root ::= [a-")
    with pytest.raises(tp.GrammarParseError, match="unterminated char class"):
        tp.parse_gbnf("root ::= [a-")


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_dfa_and_token_tables_match_jax(name):
    """The DFA's table and accepting states, every state's token mask and
    the [S, V] mask and next-state planes on 400 seeded token strings."""
    src = GRAMMARS[name]
    jd, td = jg._compile_uncached(src), tg._compile_uncached(src)
    np.testing.assert_array_equal(td.table, jd.table)
    np.testing.assert_array_equal(td.accepting, jd.accepting)
    assert td.exact == jd.exact and td.start_state == jd.start_state
    toks = _token_bytes(seed=len(src))
    eos = len(toks) - 1
    for s in range(jd.num_states):
        np.testing.assert_array_equal(td.token_mask(s, toks, eos), jd.token_mask(s, toks, eos))
    jt, tt = jd.token_tables(toks, eos), td.token_tables(toks, eos)
    np.testing.assert_array_equal(tt[0], jt[0])
    np.testing.assert_array_equal(tt[1], jt[1])
    assert tt[0].shape == (jd.num_states, len(toks))
    assert td.token_tables(toks, eos, max_states=jd.num_states - 1) is None


def test_dfa_cache_is_by_source():
    src = GRAMMARS["digits"]
    assert tg.compile_grammar_to_dfa(src) is tg.compile_grammar_to_dfa(src)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_json_schema_to_gbnf_matches_jax(name):
    assert tj.json_schema_to_gbnf(SCHEMAS[name]) == jj.json_schema_to_gbnf(SCHEMAS[name])
    assert tj.JSON_GRAMMAR == jj.JSON_GRAMMAR


@pytest.mark.parametrize("name", sorted(DEEP))
def test_pda_blob_matches_jax(name):
    assert tpda.compile_gbnf_blob(DEEP[name]) == jpda.compile_gbnf_blob(DEEP[name])


def _walk(state_cls_pair, toks, eos, seed, steps=14):
    """Masks and accept results of the two PDA states over one token
    sequence: each step takes a seeded pick among the legal tokens, and
    every third step also offers an illegal one first."""
    js, ts = state_cls_pair
    rng = np.random.default_rng(seed)
    for i in range(steps):
        jm, tm = js.mask(), ts.mask()
        np.testing.assert_array_equal(tm, jm)
        assert ts.is_complete == js.is_complete
        if i % 3 == 2 and (~jm[:eos]).any():
            bad = int(rng.choice(np.flatnonzero(~jm[:eos])))
            assert ts.accept_token(bad) == js.accept_token(bad)
        legal = np.flatnonzero(jm[:eos])
        if not len(legal):
            break
        tok = int(rng.choice(legal))
        assert ts.accept_token(tok) == js.accept_token(tok) is True
    assert ts.accept_token(eos) == js.accept_token(eos)


@pytest.mark.parametrize("name", sorted(DEEP) + ["json"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pda_masks_and_accepts_match_jax(name, seed):
    src = jj.JSON_GRAMMAR if name == "json" else DEEP[name]
    toks = _token_bytes(seed=100 + seed)
    eos = len(toks) - 1
    pair = (jpda.PdaGrammarState(jpda.compile_grammar_to_pda(src), toks, eos_token_id=eos),
            tpda.PdaGrammarState(tpda.compile_grammar_to_pda(src), toks, eos_token_id=eos))
    _walk(pair, toks, eos, seed)


@pytest.mark.parametrize("name,src", [
    ("shallow", 'root ::= "a" | "b"'),
    ("digits", GRAMMARS["digits"]),
    ("deep", DEEP["brackets"]),
    ("left_recursive", 'root ::= item\nitem ::= item "x" | item "z" | item "w" | "y"\n'),
])
def test_factory_picks_the_jax_tier(name, src):
    """The tier factory takes the same tier as the JAX one: the exact DFA
    for a shallow grammar, the PDA for a deep one, the depth-bounded DFA
    where the PDA's caps refuse it (PdaUnsupported)."""
    toks = [bytes([i]) for i in range(256)] + [b""]
    js = jg.make_grammar_state(src, toks, eos_token_id=256)
    ts = tg.make_grammar_state(src, toks, eos_token_id=256)
    assert type(ts).__name__ == type(js).__name__
    if isinstance(js, jg.GrammarState):
        assert ts.dfa.exact == js.dfa.exact
    np.testing.assert_array_equal(ts.mask(), js.mask())
    want = {"shallow": "GrammarState", "digits": "GrammarState", "deep": "PdaGrammarState",
            "left_recursive": "GrammarState"}[name]
    assert type(ts).__name__ == want


def test_pda_library_builds_from_the_port_source():
    path = native.lib_path("pda")
    assert path.parent == native.BUILD_DIR and path.name.startswith("libpda-")
    assert native.load_library("pda") is native.load_library("pda")
    assert path.exists()


def test_pda_build_failure_raises(tmp_path, monkeypatch):
    """No g++: the build raises, and so does the tier factory for a deep
    grammar (the JAX package logs it and takes the depth-bounded DFA)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(tpda, "_lib", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library("pda")
    toks = [bytes([i]) for i in range(256)]
    with pytest.raises(RuntimeError):
        tg.make_grammar_state(DEEP["arrays"], toks, eos_token_id=None)
    # The JAX factory hides the same failure behind its DFA fallback.
    assert isinstance(jg.make_grammar_state(DEEP["arrays"], toks), (jg.GrammarState,
                                                                   jpda.PdaGrammarState))


def test_compile_error_in_gxx_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/broken.cpp"):
        native.load_library("broken")


@pytest.mark.parametrize("kind", ["bpe_json", "byte", "sentencepiece"])
def test_vocab_bytes_match_jax(kind, tmp_path):
    """The token byte strings the masks walk: a byte-level BPE token's raw
    bytes (not its display string), the byte tokenizer's, a SentencePiece
    vocabulary's (▁ as a space, <0xNN> as its byte, control tokens empty)."""
    if kind == "bpe_json":
        from blazr_tpu.tokenizer.hf_tokenizer import load_hf_tokenizer as jax_load
        from blazr_tpu_torch.tokenizer.hf_tokenizer import load_hf_tokenizer
        from blazr_tpu_torch.utils.synthetic import write_bpe_tokenizer_json

        write_bpe_tokenizer_json(tmp_path, 1024, seed=3)
        want, got = jax_load(tmp_path).vocab_bytes(), load_hf_tokenizer(tmp_path).vocab_bytes()
        assert len(got) == 1024 and got[ord(" ")] == b" "
    elif kind == "byte":
        from blazr_tpu.tokenizer.byte_tok import ByteTokenizer as JaxByte
        from blazr_tpu_torch.tokenizer.byte_tok import ByteTokenizer

        want, got = JaxByte().vocab_bytes(), ByteTokenizer().vocab_bytes()
    else:
        from blazr_tpu.tokenizer.gguf_tokenizer import SentencePieceBpeTokenizer as JaxSp
        from blazr_tpu_torch.tokenizer.gguf_tokenizer import SentencePieceBpeTokenizer

        tokens = ["<unk>", "<s>", "</s>", "<0x0A>", "<0xC3>", "▁the", "▁é", "ab", "▁"]
        types = [2, 3, 3, 6, 6, 1, 1, 1, 1]
        args = (tokens, [0.0] * len(tokens), types, 1, 2)
        want, got = JaxSp(*args).vocab_bytes(), SentencePieceBpeTokenizer(*args).vocab_bytes()
        assert got[:5] == [b"", b"", b"", b"\n", b"\xc3"] and got[5] == b" the"
    assert got == want
