"""Port parity: the C++ BPE core of blazr_tpu_torch (``native/bpe.cpp``
through ``tokenizer/bpe_native.py``) against the port's Python merge loop
and blazr_tpu's encoder on the CPU. Rank tables are trained from a seeded
corpus; the texts are seeded mixes of ASCII words, accented letters, CJK,
emoji, digit runs, whitespace runs and special tokens. Token ids must be
exactly equal for every pattern: the GPT-2 and cl100k ones pre-tokenize in
C++, the o200k one merges the pieces Python's pattern cuts."""

import collections

import numpy as np
import pytest

from blazr_tpu.tokenizer import bpe as jbpe
from blazr_tpu_torch import native
from blazr_tpu_torch.tokenizer import bpe as tbpe
from blazr_tpu_torch.tokenizer import bpe_native

PATTERNS = {"gpt2": tbpe.PATTERN_GPT2, "cl100k": tbpe.PATTERN_CL100K,
            "o200k": tbpe.PATTERN_O200K}
SPECIAL = {"<|endoftext|>": 5000, "<|im_start|>": 5001}
PARTS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "naïve", "café",
         "Ünïcödé", "straße", "日本語", "中文字符", "한국어", "😀", "🚀🌍", "👍🏽", "12345",
         "3.14159", "2024", "   ", "\t", "\n", "\r\n", "  \n\n ", "don't", "I'LL",
         "we've", "!?", "...", "—", "«»", "x+y=z", "<|endoftext|>", "<|im_start|>"]


def _texts(seed: int, n: int = 24) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 40))
        out.append("".join(PARTS[i] + (" " if rng.random() < 0.6 else "")
                           for i in rng.integers(0, len(PARTS), k)))
    return out + ["", " ", "a", "\n\n\n", "1234567890123", "😀" * 5, "ab  \n  cd"]


def _train(merges: int = 400) -> dict[bytes, int]:
    """A byte-level rank table: the 256 bytes, then the most frequent
    adjacent pairs of a seeded corpus, merged greedily."""
    ranks = {bytes([b]): b for b in range(256)}
    words = collections.Counter(
        w.encode() for t in _texts(99, 200) for w in t.split(" ") if w)
    seqs = {w: [bytes([b]) for b in w] for w in words}
    for _ in range(merges):
        pairs = collections.Counter()
        for w, parts in seqs.items():
            for a, b in zip(parts, parts[1:]):
                pairs[a, b] += words[w]
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        ranks.setdefault(a + b, len(ranks))
        for w, parts in seqs.items():
            i, new = 0, []
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == a and parts[i + 1] == b:
                    new.append(a + b)
                    i += 2
                else:
                    new.append(parts[i])
                    i += 1
            seqs[w] = new
    return ranks


@pytest.fixture(scope="module")
def ranks():
    return _train()


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("seed", [0, 1])
def test_native_ids_equal_python_and_jax(ranks, name, seed):
    pattern = PATTERNS[name]
    core = tbpe.BpeTokenizer(ranks, pattern=pattern, special_tokens=SPECIAL)
    plain = tbpe.BpeTokenizer(ranks, pattern=pattern, special_tokens=SPECIAL, native=False)
    jax = jbpe.BpeTokenizer(ranks, pattern=pattern, special_tokens=SPECIAL)
    assert core._native is not None and plain._native is None
    assert (core._native_mode is None) == (name == "o200k")
    for text in _texts(seed):
        want = jax.encode(text)
        assert plain.encode(text) == want, text
        assert core.encode(text) == want, text
        assert core.encode_ordinary(text) == jax.encode_ordinary(text), text
        assert core.decode(core.encode(text)) == text


def test_class_table_matches_the_python_classes():
    r"""Each code point's class in the C++ scanner's table is the one the
    Python pattern's ``\p{L}``, ``\p{N}`` and ``\s`` classes give it, and
    the table is cached in the build directory."""
    import re

    t = bpe_native.unicode_class_table()
    assert t.shape == (0x110000,)
    rng = np.random.default_rng(0)
    cps = np.concatenate([np.arange(0, 0x3000), rng.integers(0x3000, 0x110000, 20000)])
    cls = {1: re.compile(f"[{tbpe.property_ranges('L')}]"),
           2: re.compile(f"[{tbpe.property_ranges('N')}]"),
           3: re.compile(tbpe.translate_pattern(r"\s"))}
    for cp in cps:
        if 0xD800 <= cp < 0xE000:
            continue
        ch = chr(int(cp))
        want = next((k for k, rx in cls.items() if rx.fullmatch(ch)), 0)
        assert t[cp] == want, hex(cp)
    assert list(native.BUILD_DIR.glob("unicode_classes-*.npy"))


def test_core_builds_from_the_port_source():
    path = native.lib_path("bpe")
    assert path.parent == native.BUILD_DIR and path.name.startswith("libbpe-")
    assert native.load_library("bpe") is native.load_library("bpe")
    assert (native.SRC_DIR / "bpe.cpp").read_bytes() == (
        native.SRC_DIR.parent.parent / "blazr_tpu" / "native" / "bpe.cpp").read_bytes()


def test_core_build_failure_raises(tmp_path, monkeypatch):
    """No g++: the tokenizer does not fall back to Python, it raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tbpe.BpeTokenizer({b"a": 0}, pattern=tbpe.PATTERN_GPT2)
    assert tbpe.BpeTokenizer({b"a": 0}, pattern=tbpe.PATTERN_GPT2, native=False).encode(
        "aa") == [0, 0]
