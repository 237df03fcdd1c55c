"""Port parity: the tokenizer of blazr_tpu_torch (stdlib ``re`` with
explicit Unicode classes) against blazr_tpu's (the ``regex`` package) on
the CPU.

The port builds ``\\p{..}`` classes from ``unicodedata`` (Unicode 15.0 in
Python 3.12); ``regex`` carries newer tables. Where they differ is pinned
here: every codepoint in one class and not the other is either unassigned
in Unicode 15.0 (category Cn: letters, digits and marks added since) or
U+0295 LATIN LETTER PHARYNGEAL VOICED FRICATIVE, Ll in 15.0 and Lo from
Unicode 16.0. On this repository's ``regex`` that is 9,568 letters, 93
numbers and 93 marks unassigned in 15.0, and U+0295. Text that uses none
of them pre-tokenizes alike; token ids are then equal."""

import re
import sys
import unicodedata

import numpy as np
import pytest
import regex

from blazr_tpu.tokenizer import load_hf_tokenizer as jax_load_hf
from blazr_tpu.tokenizer.bpe import BpeTokenizer as JaxBpe
from blazr_tpu_torch.tokenizer import ByteTokenizer, load_tokenizer
from blazr_tpu_torch.tokenizer import bpe as tbpe
from blazr_tpu_torch.tokenizer.hf_tokenizer import load_hf_tokenizer
from blazr_tpu_torch.utils.synthetic import write_bpe_tokenizer_json

from fixtures import write_byte_tokenizer_json

# Llama-3 and Qwen2 Split pre-tokenizer patterns (tokenizer.json, as
# hf_tokenizer._extract_pattern returns them), beside bpe.py's constants.
PATTERN_LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
PATTERN_QWEN2_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
PATTERNS = {"cl100k": tbpe.PATTERN_CL100K, "o200k": tbpe.PATTERN_O200K,
            "gpt2": tbpe.PATTERN_GPT2, "llama3_split": PATTERN_LLAMA3_SPLIT,
            "qwen2_split": PATTERN_QWEN2_SPLIT}
TEXTS = [
    "Hello world! It's 12345 numbers, don't you'LL SEE?",
    "été naïve café — Ünïcödé  Straße ΑΒΓ δεζ Ωμέγα",
    "中文字符和日本語のテキスト 한국어 텍스트",
    "emoji \U0001F600\U0001F680 and symbols ∑∫√ ©®™ €$¥",
    "tabs\tand\nnewlines\r\n\n  mixed   spacing  nbsp em",
    "code: def f(x): return x**2 + 3.14159  # comment\n    indented",
    "digits 1234567890 ١٢٣ ४५६ ⅧⅨ ½¾",
    "combining é ä कि and zero​width",
    "",
    "   ",
    "trailing space ",
    "'s 't 're 've 'm 'll 'd 'S 'T",
]
# Codepoints whose category changed between Unicode 15.0 and the regex
# package's tables.
RECATEGORIZED = {0x295}


def _all_chars() -> str:
    return "".join(chr(c) for c in range(sys.maxunicode + 1)
                   if not 0xD800 <= c <= 0xDFFF)


@pytest.mark.parametrize("name", ["L", "N", "M", "Lu", "Ll", "Lt", "Lm", "Lo"])
def test_property_class_matches_regex_on_every_codepoint(name):
    allc = _all_chars()
    port = set(re.findall("[" + tbpe.property_ranges(name) + "]", allc))
    ref = set(regex.findall(rf"\p{{{name}}}", allc))
    for ch in ref - port:
        assert unicodedata.category(ch) == "Cn" or ord(ch) in RECATEGORIZED, hex(ord(ch))
    assert {ord(c) for c in port - ref} <= RECATEGORIZED


def test_whitespace_class_matches_regex_on_every_codepoint():
    allc = _all_chars()
    ws = tbpe._ranges_to_class(tbpe.WHITE_SPACE)
    assert set(re.findall("[" + ws + "]", allc)) == set(regex.findall(r"\s", allc))
    assert set(re.findall("[^" + ws + "]", allc)) == set(regex.findall(r"\S", allc))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_pretokenizer_pieces_match_regex(pattern):
    port = tbpe.compile_pattern(PATTERNS[pattern])
    ref = regex.compile(PATTERNS[pattern])
    for text in TEXTS:
        assert ([m.group() for m in port.finditer(text)]
                == [m.group() for m in ref.finditer(text)]), (pattern, text)


def test_translate_rejects_what_re_cannot_express():
    with pytest.raises(ValueError):
        tbpe.translate_pattern(r"[^\P{L}]")
    with pytest.raises(ValueError):
        tbpe.translate_pattern(r"\p{Xyz}")
    assert tbpe.translate_pattern(r"[]a]") == r"[\]a]"


def _both(path):
    return load_hf_tokenizer(path), jax_load_hf(path)


@pytest.mark.parametrize("vocab", ["byte_level", "synthetic_merges"])
def test_encode_decode_match_jax(tmp_path, vocab):
    if vocab == "byte_level":
        write_byte_tokenizer_json(tmp_path)
        texts = TEXTS
    else:
        merged = write_bpe_tokenizer_json(tmp_path, 2048, seed=3)
        rng = np.random.default_rng(4)
        texts = TEXTS + [" ".join(merged[i].decode() for i in rng.integers(0, len(merged), 40))]
    port, ref = _both(tmp_path / "tokenizer.json")
    assert (port.vocab_size, port.eos_token_id, port.bos_token_id) == (
        ref.vocab_size, ref.eos_token_id, ref.bos_token_id)
    for text in texts:
        ids = port.encode(text)
        assert ids == ref.encode(text), text
        assert port.decode(ids) == ref.decode(ids) == text
    if vocab == "synthetic_merges":
        assert len(port.encode(texts[-1])) < len(texts[-1].encode())


def test_special_tokens_and_eos_match_jax(tmp_path):
    write_bpe_tokenizer_json(tmp_path, 600, seed=1)
    port, ref = _both(tmp_path / "tokenizer.json")
    text = "abc</s>def </s>"
    assert port.encode(text) == ref.encode(text)
    assert port.is_eos(599) and ref.is_eos(599)
    assert port.special_token_id("</s>") == 599


def test_bpe_tokenizer_with_each_pattern_matches_jax():
    ranks = {bytes([i]): i for i in range(256)}
    for i, m in enumerate([b"he", b"ll", b"llo", b"hello", b" w", b"or", b"ld"]):
        ranks[m] = 256 + i
    for name, pat in PATTERNS.items():
        port = tbpe.BpeTokenizer(ranks, pattern=pat)
        ref = JaxBpe(ranks, pattern=pat)
        for text in TEXTS:
            assert port.encode(text) == ref.encode(text), (name, text)


def test_load_tokenizer_resolution(tmp_path):
    with pytest.raises(FileNotFoundError, match="item 8"):
        load_tokenizer(tmp_path)
    (tmp_path / "m.gguf").write_bytes(b"GGUF")
    with pytest.raises(NotImplementedError, match="item 8"):
        load_tokenizer(tmp_path)
    write_byte_tokenizer_json(tmp_path)
    assert load_tokenizer(tmp_path).decode([104, 105]) == "hi"
    bt = ByteTokenizer()
    assert bt.decode(bt.encode("héllo")) == "héllo" and bt.is_eos(0)
