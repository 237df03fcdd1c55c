"""Port parity: GGUF checkpoints (reader, writer, every ggml and IQ codec,
``from_ggml``, metadata → config, the config chain, embedded tokenizers
and the GGUF slice end to end) of blazr_tpu_torch against blazr_tpu on the
CPU, on tiny files written from seeded numpy data.

Codecs and canonical words must be bit-identical; f32 logits agree within
1e-4 of the largest logit (f32 sums in another order), greedy streams
exactly. Where the port deviates on purpose (llama.cpp's Q/K row order,
the two-way IQ grid stamp check, quantized pre-stacked experts, the
deepseek_v3 vocab band; ROADMAP §C) the deviation is pinned: the JAX side
is fed the unpermuted file and the port the permuted one."""

import asyncio
import importlib
import json

import numpy as np
import pytest
import torch

from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.formats import detect_arch as jarch
from blazr_tpu.formats import ggml_quants as jgq
from blazr_tpu.formats import gguf as jgguf
from blazr_tpu.formats import iq_quants as jiq
from blazr_tpu.loader import load_model as jax_load_model
from blazr_tpu.loader.gguf_config import universal_from_gguf_metadata as jax_md_cfg
from blazr_tpu.quant import qtensor as jqt
from blazr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from blazr_tpu_torch.config import GenerationConfig
from blazr_tpu_torch.config.model_config import AttentionConfig, MoeConfig, UniversalConfig
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.formats import detect_arch as tarch
from blazr_tpu_torch.formats import ggml_quants as tgq
from blazr_tpu_torch.formats import gguf as tgguf
from blazr_tpu_torch.formats import iq_quants as tiq
from blazr_tpu_torch.formats.names import qk_row_order
from blazr_tpu_torch.loader import load_model, universal_from_gguf_metadata
from blazr_tpu_torch.loader.varmap import varmap_from_gguf
from blazr_tpu_torch.quant import qtensor as tqt
from blazr_tpu_torch.tokenizer import load_tokenizer, vocab_name_for_size
from blazr_tpu_torch.tokenizer.pretrained import write_vocab
from blazr_tpu_torch.utils.synthetic import (q4_k_m_types, use_more_bits,
                                             write_gguf_checkpoint)

from test_torch_engine import _Tok, _serve
from test_torch_loader import _logits, _same_params

CPU = "cpu"
JT = jgguf.GgmlType
TT = tgguf.GgmlType
ROWS, COLS = 4, 512            # every block size divides 512
PLAIN = {"F32", "F16", "BF16", "F64", "I8", "I16", "I32", "I64"}
QUANT_TYPES = sorted(t.name for t in jgq.supported_quant_types() if t.name not in PLAIN)
ENCODED = sorted(t.name for t in jgq._QUANT_FNS)
CANONICAL = sorted(t.name for t in jqt.CANONICAL_GGML_TYPES)
TINY = UniversalConfig(model_type="llama", vocab_size=320, hidden_size=256, num_layers=2,
                       max_seq_len=256, intermediate_size=512,
                       attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=64,
                                                 rope_theta=1e6))
TINY_MOE = UniversalConfig(model_type="mixtral", vocab_size=320, hidden_size=256,
                           num_layers=2, max_seq_len=256, intermediate_size=512,
                           attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                                     head_dim=64, rope_theta=1e6),
                           moe=MoeConfig(num_experts=4, experts_per_tok=2,
                                         intermediate_size=256))
STRINGS = ["Hello world", "  leading and  double  spaces ", "naïve café — Ünïcödé",
           "中文 and emoji \U0001F600", "tabs\tand\nnewlines", "", "x", "<s> is text"]


def _raw_blocks(name: str, seed: int = 0) -> bytes:
    """Raw blocks of type ``name`` for a [ROWS, COLS] tensor: the JAX
    encoder's output where it has one (valid scales), else seeded bytes."""
    rng = np.random.default_rng(seed)
    gt = JT[name]
    if gt in jgq._QUANT_FNS:
        return jgq.quantize_ggml(rng.standard_normal((ROWS, COLS)).astype(np.float32), gt)
    bs, epb = jgguf.GGML_BLOCK_INFO[gt]
    return rng.integers(0, 256, ROWS * COLS // epb * bs, dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def test_type_tables_match_jax():
    assert {t.name: int(t) for t in TT} == {t.name: int(t) for t in JT}
    assert {k.name: v for k, v in tgguf.GGML_BLOCK_INFO.items()} == {
        k.name: v for k, v in jgguf.GGML_BLOCK_INFO.items()}
    assert [t.name for t in tgq.supported_quant_types()] == [
        t.name for t in jgq.supported_quant_types()]
    assert sorted(t.name for t in tqt.CANONICAL_GGML_TYPES) == CANONICAL
    assert len(CANONICAL) == 12


@pytest.mark.parametrize("name", QUANT_TYPES + sorted(PLAIN))
def test_dequant_matches_jax_exactly(name):
    """The same raw blocks (and random bytes, NaN bit patterns included)
    dequantize to the same f32 values."""
    bs, epb = jgguf.GGML_BLOCK_INFO[JT[name]]
    for raw in (_raw_blocks(name), np.random.default_rng(1).integers(
            0, 256, ROWS * COLS // epb * bs, dtype=np.uint8).tobytes()):
        want = jgq.dequantize_ggml(raw, JT[name], (ROWS, COLS))
        got = tgq.dequantize_ggml(raw, TT[name], (ROWS, COLS))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ENCODED)
def test_encoder_bytes_match_jax(name):
    x = np.random.default_rng(2).standard_normal((ROWS, COLS)).astype(np.float32) * 0.3
    assert tgq.quantize_ggml(x, TT[name]) == jgq.quantize_ggml(x, JT[name])


@pytest.mark.parametrize("name", CANONICAL)
def test_from_ggml_words_bit_exact(name):
    raw = _raw_blocks(name, seed=3)
    j = jqt.from_ggml(raw, JT[name], (ROWS, COLS))
    t = tqt.from_ggml(raw, TT[name], (ROWS, COLS), device=CPU)
    np.testing.assert_array_equal(t.qweight.numpy().view(np.uint32), np.asarray(j.qweight))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(t.mins.numpy(), np.asarray(j.mins))
    assert (t.bits, t.group_size, t.signed, t.in_features, t.out_features, t.fmt) == (
        j.bits, j.group_size, j.signed, j.in_features, j.out_features, j.fmt)
    # the canonical tensor holds the dequantized values ([K, N] of [N, K])
    np.testing.assert_allclose(tqt.dequantize_np(t),
                               tgq.dequantize_ggml(raw, TT[name], (ROWS, COLS)).T,
                               rtol=1e-6, atol=1e-6)


def _grid_types():
    return sorted(t.name for t in tiq.IQ_GRID_TYPES)


def _other_grids(path):
    """An .npz of grids that differ from the synthetic ones (rows reversed)."""
    tables = {k: np.ascontiguousarray(v[::-1]) for k, v in tiq.active_grids().tables.items()}
    np.savez(path, **tables)
    return tables


@pytest.fixture
def env_grids(tmp_path, monkeypatch):
    """BLAZR_TPU_IQ_GRIDS set to other grids, in both packages (the JAX
    module reads it at import, so it is reloaded, and reloaded back)."""
    path = tmp_path / "grids.npz"
    _other_grids(path)
    monkeypatch.setenv("BLAZR_TPU_IQ_GRIDS", str(path))
    importlib.reload(jiq)
    try:
        yield path
    finally:
        monkeypatch.delenv("BLAZR_TPU_IQ_GRIDS")
        importlib.reload(jiq)


def test_synthetic_grids_match_jax():
    assert tiq.active_grids().source == "synthetic" and jiq.GRIDS_SOURCE == "synthetic"
    assert tiq.grids_fingerprint() == jiq.grids_fingerprint()
    for k, v in tiq.active_grids().tables.items():
        np.testing.assert_array_equal(v, jiq._GRIDS[k])


def test_env_grids_codecs_match_jax(env_grids):
    assert tiq.active_grids().source == jiq.GRIDS_SOURCE == "env"
    assert tiq.grids_fingerprint() == jiq.grids_fingerprint()
    x = np.random.default_rng(4).standard_normal((2, 256)).astype(np.float32)
    for name in _grid_types():
        raw = jgq.quantize_ggml(x, JT[name])
        assert tgq.quantize_ggml(x, TT[name]) == raw, name
        np.testing.assert_array_equal(tgq.dequantize_ggml(raw, TT[name], (2, 256)),
                                      jgq.dequantize_ggml(raw, JT[name], (2, 256)))


def _iq_file(path):
    """A GGUF file with one IQ2_XS tensor, stamped with the active grids."""
    x = np.random.default_rng(5).standard_normal((2, 256)).astype(np.float32)
    tgguf.write_gguf(path, {"general.architecture": "qwen2"}, {
        "blk.0.ffn_down.weight": (tgq.quantize_ggml(x, TT.IQ2_XS), TT.IQ2_XS, (2, 256))})


def _write_unstamped(path, kv, tensors):
    """write_gguf stamps grid-coded files; an external file has no stamp."""
    import unittest.mock as mock

    with mock.patch.object(tgguf, "_iq_grid_types", lambda: frozenset()):
        tgguf.write_gguf(path, kv, tensors)


def test_grid_stamp_refused_both_ways(tmp_path, monkeypatch):
    """A file encoded with synthetic grids is refused under other (env)
    grids, and one encoded under env grids is refused with the synthetic
    ones. The JAX check accepts the first once its grids are canonical."""
    synth = tmp_path / "synth.gguf"
    _iq_file(synth)
    assert len(varmap_from_gguf(synth)) == 1
    env = tmp_path / "grids.npz"
    _other_grids(env)
    monkeypatch.setenv("BLAZR_TPU_IQ_GRIDS", str(env))
    with pytest.raises(RuntimeError, match="fingerprint"):
        varmap_from_gguf(synth)
    envfile = tmp_path / "env.gguf"
    _iq_file(envfile)
    assert len(varmap_from_gguf(envfile)) == 1
    importlib.reload(jiq)
    try:
        with tgguf.Gguf(synth) as g:
            stamp = g.metadata().get(tiq.IQ_GRIDS_META_KEY)
        jiq.check_grid_interop(stamp, "synthetic-grid file")     # the JAX fault
    finally:
        monkeypatch.delenv("BLAZR_TPU_IQ_GRIDS")
        importlib.reload(jiq)
    with pytest.raises(RuntimeError, match="fingerprint"):
        varmap_from_gguf(envfile)


def test_unstamped_iq_file_needs_official_grids(tmp_path, monkeypatch):
    x = np.random.default_rng(5).standard_normal((2, 256)).astype(np.float32)
    f = tmp_path / "ext.gguf"
    _write_unstamped(f, {"general.architecture": "qwen2"}, {
        "blk.0.ffn_down.weight": (tgq.quantize_ggml(x, TT.IQ2_XS), TT.IQ2_XS, (2, 256))})
    with tgguf.Gguf(f) as g:
        assert tiq.IQ_GRIDS_META_KEY not in g.metadata().kv
    with pytest.raises(RuntimeError, match="no grid stamp"):
        varmap_from_gguf(f)
    env = tmp_path / "grids.npz"
    _other_grids(env)
    monkeypatch.setenv("BLAZR_TPU_IQ_GRIDS", str(env))
    assert tiq.grids_are_canonical()
    assert len(varmap_from_gguf(f)) == 1


# ---------------------------------------------------------------------------
# reader and writer
# ---------------------------------------------------------------------------

def _meta_and_tensors():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    meta = {"general.architecture": "qwen2", "general.name": "t", "qwen2.block_count": 2,
            "qwen2.rope.freq_base": 1e6, "neg": -3, "big": 2 ** 40, "flag": True,
            "ints": [1, 2, 3], "floats": [0.5, -1.0], "strs": ["a", "▁b", ""],
            "mixed": [1, -2], "empty": []}
    tensors = {"a": (x, TT.F32, (4, 256)), "b": (x, TT.F16, (4, 256)),
               "c": (tgq.quantize_ggml(x, TT.Q4_K), TT.Q4_K, (4, 256)),
               "d": (np.arange(6, dtype=np.int32), TT.I32, (6,))}
    jtensors = {n: (d, JT[t.name], s) for n, (d, t, s) in tensors.items()}
    return meta, tensors, jtensors


@pytest.mark.parametrize("alignment", [32, 64])
def test_writer_bytes_match_jax(tmp_path, alignment):
    meta, tensors, jtensors = _meta_and_tensors()
    tgguf.write_gguf(tmp_path / "t.gguf", meta, tensors, alignment=alignment)
    jgguf.write_gguf(tmp_path / "j.gguf", meta, jtensors, alignment=alignment)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_reader_reads_the_other_writer(tmp_path, writer):
    meta, tensors, jtensors = _meta_and_tensors()
    f = tmp_path / "m.gguf"
    if writer == "jax":
        jgguf.write_gguf(f, meta, jtensors)
    else:
        tgguf.write_gguf(f, meta, tensors)
    with tgguf.Gguf(f) as t, jgguf.Gguf(f) as j:
        assert t.metadata().kv == j.metadata().kv
        assert t.tensor_names() == j.tensor_names() == list(tensors)
        assert t.data_start == j.data_start and t.version == j.version == 3
        for n in t.tensor_names():
            ti, ji = t.tensor_info(n), j.tensor_info(n)
            assert (ti.shape, ti.ggml_type.name, ti.offset, ti.size_bytes) == (
                ji.shape, ji.ggml_type.name, ji.offset, ji.size_bytes)
            assert bytes(t.tensor_bytes(n)) == bytes(j.tensor_bytes(n))
            np.testing.assert_array_equal(t.load_numpy(n), j.load_numpy(n))


# ---------------------------------------------------------------------------
# metadata → config, and the config chain
# ---------------------------------------------------------------------------

_MD = {
    "llama": {"general.architecture": "llama", "llama.embedding_length": 256,
              "llama.block_count": 3, "llama.attention.head_count": 4,
              "llama.attention.head_count_kv": 2, "llama.rope.freq_base": 1e6,
              "llama.context_length": 32768, "llama.feed_forward_length": 512,
              "tokenizer.ggml.tokens": ["a"] * 300},
    "mixtral": {"general.architecture": "llama", "llama.embedding_length": 256,
                "llama.block_count": 2, "llama.expert_count": 8,
                "llama.expert_used_count": 2, "general.vocab_size": 1000},
    "qwen2": {"general.architecture": "qwen2", "qwen2.embedding_length": 128,
              "qwen2.block_count": 2, "qwen2.attention.head_count": 2,
              "qwen2.attention.layer_norm_rms_epsilon": 1e-6},
    "falcon": {"general.architecture": "falcon", "falcon.embedding_length": 128,
               "falcon.block_count": 2, "falcon.attention.head_count": 2,
               "falcon.attention.head_count_kv": 1,
               "falcon.attention.layer_norm_epsilon": 1e-5},
    "deepseek2": {"general.architecture": "deepseek2", "deepseek2.embedding_length": 128,
                  "deepseek2.block_count": 2, "deepseek2.attention.kv_lora_rank": 32,
                  "deepseek2.attention.q_lora_rank": 48,
                  "deepseek2.rope.dimension_count": 16,
                  "deepseek2.attention.value_length": 32, "deepseek2.expert_count": 4,
                  "deepseek2.expert_shared_count": 1},
    "mamba2": {"general.architecture": "mamba2", "mamba2.embedding_length": 128,
               "mamba2.block_count": 2, "mamba2.ssm.inner_size": 256,
               "mamba2.ssm.state_size": 16, "mamba2.ssm.group_count": 2},
    "starcoder2": {"general.architecture": "starcoder2",
                   "starcoder2.embedding_length": 128, "starcoder2.block_count": 2},
}


@pytest.mark.parametrize("arch", sorted(_MD))
def test_metadata_config_matches_jax(arch):
    t = universal_from_gguf_metadata(tgguf.GgufMetadata(_MD[arch]))
    j = jax_md_cfg(jgguf.GgufMetadata(_MD[arch]))
    assert t.to_dict() == j.to_dict()


_NAMES = {
    "llama": {"model.embed_tokens.weight": (320, 256), "lm_head.weight": (320, 256),
              "model.layers.0.self_attn.q_proj.weight": (256, 256),
              "model.layers.0.self_attn.k_proj.weight": (128, 256),
              "model.layers.0.mlp.gate_proj.weight": (512, 256),
              "model.layers.1.input_layernorm.weight": (256,)},
    "gguf": {"token_embd.weight": (320, 96), "blk.0.attn_q.weight": (96, 96),
             "blk.0.attn_k.weight": (32, 96), "blk.0.ffn_gate.weight": (192, 96),
             "blk.2.ffn_gate_exps.weight": (4, 192, 96)},
    "moe": {"model.embed_tokens.weight": (100, 64),
            "model.layers.0.mlp.experts.0.gate_proj.weight": (32, 64),
            "model.layers.0.mlp.experts.3.gate_proj.weight": (32, 64),
            "model.layers.0.mlp.gate.weight": (4, 64)},
    "hybrid": {"model.embed_tokens.weight": (100, 64),
               "model.layers.0.mixer.in_proj.weight": (300, 64),
               "model.layers.1.self_attn.q_proj.weight": (64, 64)},
    "mla": {"model.embed_tokens.weight": (100, 64),
            "model.layers.0.self_attn.kv_a_proj_with_mqa.weight": (40, 64)},
}


@pytest.mark.parametrize("case", sorted(_NAMES))
def test_shape_inference_matches_jax(case):
    names = list(_NAMES[case])
    shape = _NAMES[case].__getitem__
    td, jd = tarch.detect_architecture_from_names(names), jarch.detect_architecture_from_names(names)
    assert td.__dict__ == jd.__dict__
    t = tarch.infer_config_from_shapes(names, shape, td)
    j = jarch.infer_config_from_shapes(names, shape, jd)
    assert t.to_dict() == j.to_dict()


def test_safetensors_without_config_json_matches_jax(tmp_path):
    """The last link of the chain: a plain checkpoint with no config.json
    loads with the config inferred from its names and shapes."""
    from blazr_tpu_torch.utils.synthetic import write_hf_checkpoint

    cfg = UniversalConfig(model_type="llama", vocab_size=320, hidden_size=256, num_layers=2,
                          intermediate_size=512,
                          attention=AttentionConfig(num_heads=2, num_kv_heads=1, head_dim=128))
    write_hf_checkpoint(tmp_path, cfg, quant="plain", dtype="float32", seed=7)
    (tmp_path / "config.json").unlink()
    tm, tcfg = load_model(tmp_path, dtype="f32", device=CPU)
    jm, jcfg = jax_load_model(tmp_path, dtype="f32")
    assert tcfg.model.to_dict() == jcfg.model.to_dict()
    _same_params(tm, jm)
    for t, j in zip(*_logits(tm, jm)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * float(np.abs(j).max()))


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

def test_spm_tokenizer_ids_match_jax(tmp_path):
    f = tmp_path / "m.gguf"
    write_gguf_checkpoint(f, dataclass_replace(TINY, vocab_size=2000), "Q8_0")
    t, j = load_tokenizer(tmp_path, gguf_path=f), jax_load_tokenizer(tmp_path, gguf_path=f)
    assert t.vocab_size == j.vocab_size == 2000
    words = " ".join(t.tokens[400 + 37 * i].replace("▁", " ") for i in range(30))
    for s in STRINGS + [words, words.upper()]:
        assert t.encode(s) == j.encode(s), s
        assert t.encode(s, add_bos=False) == j.encode(s, add_bos=False)
        ids = t.encode(s)
        assert t.decode(ids) == j.decode(ids)
    assert max(len(t.tokens[i]) for i in t.encode(words)) > 2     # merges happen
    assert t.is_eos(2) and t.bos_token_id == 1


@pytest.mark.parametrize("scores", ["ranked", "tied"])
def test_spm_merges_match_the_jax_loop_on_long_text(scores):
    """The heap takes the JAX loop's merges (highest score, leftmost of
    equal scores) on 32000-token vocabs, over prompts of up to ~2000
    characters, and with every score equal."""
    from blazr_tpu.tokenizer.gguf_tokenizer import SentencePieceBpeTokenizer as JSpm
    from blazr_tpu_torch.tokenizer.gguf_tokenizer import SentencePieceBpeTokenizer as TSpm
    from blazr_tpu_torch.utils.synthetic import spm_vocab

    tokens, sc, types = spm_vocab(32000, seed=3)
    if scores == "tied":
        sc = [0.0] * len(sc)
    t, j = TSpm(tokens, sc, types, 1, 2), JSpm(tokens, sc, types, 1, 2)
    rng = np.random.default_rng(8)
    for n in (1, 17, 120, 300):
        text = j.decode(rng.integers(259, 32000, n).tolist()) + " ünï 中文  x"
        assert t.encode(text) == j.encode(text), n


def test_gpt2_tokenizer_ids_match_jax(tmp_path):
    from blazr_tpu_torch.tokenizer.bpe import gpt2_byte_encoder

    enc = gpt2_byte_encoder()
    pieces = [bytes([b]) for b in range(256)] + [b"he", b"ll", b"llo", b"hello", b" w",
                                                 b"or", b"ld", b" world"]
    tokens = ["".join(enc[b] for b in p) for p in pieces] + ["<|end|>"]
    types = [1] * len(pieces) + [3]
    md = {"general.architecture": "qwen2", "tokenizer.ggml.model": "gpt2",
          "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types,
          "tokenizer.ggml.eos_token_id": len(pieces)}
    f = tmp_path / "g.gguf"
    tgguf.write_gguf(f, md, {})
    t, j = load_tokenizer(tmp_path), jax_load_tokenizer(tmp_path)
    for s in STRINGS + ["hello world<|end|>hello"]:
        assert t.encode(s) == j.encode(s), s
        assert t.decode(t.encode(s)) == j.decode(j.encode(s))
    assert t.is_eos(len(pieces))


def test_tokenizer_resolution_order(tmp_path):
    """A given GGUF's embedded tokenizer, then tokenizer.json, then a
    sibling *.gguf, then the pretrained tier, as in the JAX package."""
    from fixtures import write_byte_tokenizer_json

    f = tmp_path / "m.gguf"
    write_gguf_checkpoint(f, TINY, "Q8_0")
    assert load_tokenizer(tmp_path).vocab_size == TINY.vocab_size       # sibling gguf
    write_byte_tokenizer_json(tmp_path)
    assert load_tokenizer(tmp_path).decode([104, 105]) == "hi"         # tokenizer.json
    assert load_tokenizer(tmp_path, gguf_path=f).vocab_size == TINY.vocab_size


def test_pretrained_tier_on_a_written_table(tmp_path, monkeypatch):
    ranks = {bytes([b]): b for b in range(256)}
    ranks.update({b"ab": 256, b"abc": 257})
    vocab_dir = tmp_path / "vocabs"
    write_vocab("mistral", ranks, pattern="gpt2", special_tokens={"</s>": 258},
                eos_token_id=258, directory=vocab_dir)
    model = tmp_path / "m"
    model.mkdir()
    (model / "config.json").write_text(json.dumps({"vocab_size": 32000}))
    with pytest.raises(FileNotFoundError, match="pretrained"):
        load_tokenizer(model)
    monkeypatch.setenv("BLAZR_TPU_VOCAB_DIR", str(vocab_dir))
    t, j = load_tokenizer(model), jax_load_tokenizer(model)
    for s in ["abc ab abcabc", "x</s>"]:
        assert t.encode(s) == j.encode(s)
    assert t.is_eos(258)


@pytest.mark.parametrize("size,name", [(32000, "mistral"), (50257, "gpt2"),
                                       (100256, "cl100k_base"), (128256, "llama3"),
                                       (128400, "llama3"), (128401, "deepseek_v3"),
                                       (129000, "deepseek_v3"), (129001, "qwen2"),
                                       (151936, "qwen2"), (200019, "o200k_base"),
                                       (300000, "o200k_base")])
def test_vocab_bands(size, name):
    """The JAX bands, with the deepseek_v3 band (128400 < v <= 129000) that
    the JAX package lacks (ROADMAP §C)."""
    from blazr_tpu.tokenizer import vocab_name_for_size as jax_band

    assert vocab_name_for_size(size) == name
    if not 128400 < size <= 129000:
        assert jax_band(size) == name


# ---------------------------------------------------------------------------
# the slice: GGUF files through load_model, Executor and BatchEngine
# ---------------------------------------------------------------------------

def dataclass_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def _pair_files(tmp_path, cfg, quant):
    """(port file with llama.cpp's Q/K order, JAX file in HF order): the
    same weights otherwise."""
    port, ref = tmp_path / "port" / "m.gguf", tmp_path / "ref" / "m.gguf"
    port.parent.mkdir()
    ref.parent.mkdir()
    kinds = write_gguf_checkpoint(port, cfg, quant)
    write_gguf_checkpoint(ref, cfg, quant, llama_cpp_qk=False)
    return port, ref, kinds


@pytest.mark.parametrize("quant", ["Q4_K", "Q6_K", "Q8_0", "Q4_K_M"])
def test_gguf_logits_match_jax(tmp_path, quant):
    """A tiny llama GGUF with nothing beside it: config from the metadata,
    2-D weights quantized (words equal to the JAX loader's), f32 logits
    within 1e-4 of the largest."""
    port, ref, kinds = _pair_files(tmp_path, TINY, quant)
    tm, tcfg = load_model(port, dtype="f32", device=CPU)
    jm, jcfg = jax_load_model(ref, dtype="f32")
    assert tcfg.model.to_dict() == jcfg.model.to_dict()
    assert tm.params["layers"][0]["q"].fmt == "ggml_" + kinds["blk.0.attn_q.weight"].lower()
    _same_params(tm, jm)
    for t, j in zip(*_logits(tm, jm)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * float(np.abs(j).max()))


def test_gguf_default_dtype_is_bf16(tmp_path):
    port, _, _ = _pair_files(tmp_path, TINY, "Q8_0")
    tm, tcfg = load_model(port, device=CPU)
    assert tcfg.inference.dtype == "bf16" and tm.params["embed"].dtype == torch.bfloat16


def _gen():
    return GenerationConfig(max_tokens=8, temperature=0.0)


def test_gguf_greedy_streams_match_jax_engines(tmp_path):
    """Greedy tokens of the Q4_K_M file through the Executor and the
    BatchEngine equal the JAX package's (on its HF-order file)."""
    port, ref, _ = _pair_files(tmp_path, TINY, "Q4_K_M")
    tm, ta = load_model(port, dtype="f32", device=CPU)
    jm, ja = jax_load_model(ref, dtype="f32")
    prompts = [[1, 5, 9, 17], [1] + list(range(40, 60)), [1, 7, 3] * 6]
    ref_ex = [[g.token_id for g in JExecutor(jm, _Tok(), ja).generate(
        p, JGen(max_tokens=8, temperature=0.0))] for p in prompts]
    got_ex = [[g.token_id for g in Executor(tm, _Tok(), ta).generate(p, _gen())]
              for p in prompts]
    assert got_ex == ref_ex
    for a in (ja, ta):
        a.inference.max_seq_len = 64
        a.inference.max_batch_size = 4
    waves = [prompts[:2], prompts[2:]]
    ref_be = asyncio.run(_serve(JEngine(jm, _Tok(), ja), waves,
                                lambda: JGen(max_tokens=8, temperature=0.0)))
    got_be = asyncio.run(_serve(BatchEngine(tm, _Tok(), ta), waves, _gen))
    assert got_be == ref_be


def test_stacked_experts_stay_quantized_and_match_jax(tmp_path):
    """A Mixtral-layout GGUF with pre-stacked ffn_*_exps: the port keeps
    each stack a quantized stacked QuantTensor whose values equal the JAX
    loader's dense f32 stack exactly; logits agree within 1e-4."""
    port, ref, _ = _pair_files(tmp_path, TINY_MOE, "Q4_K_M")
    tm, tcfg = load_model(port, dtype="f32", device=CPU)
    jm, jcfg = jax_load_model(ref, dtype="f32")
    assert tcfg.model.to_dict() == jcfg.model.to_dict()
    for i in range(TINY_MOE.num_layers):
        tmoe, jmoe = tm.params["layers"][i]["moe"], jm.params["layers"][i]["moe"]
        for key in ("experts_gate", "experts_up", "experts_down"):
            assert tqt.is_stacked(tmoe[key]) and tmoe[key].fmt.startswith("ggml_q")
            np.testing.assert_array_equal(tqt.dequantize_stack_np(tmoe[key]),
                                          np.asarray(jmoe[key], np.float32))
    for t, j in zip(*_logits(tm, jm)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * float(np.abs(j).max()))


def test_qk_unpermute_matches_transformers(tmp_path):
    """llama.cpp's permuted attn_q/attn_k rows come back in HF order as
    transformers' LlamaTensorProcessor._reverse_permute_weights returns
    them: an F32 file row for row, and a Q8_0 file on whole block rows."""
    from transformers.modeling_gguf_pytorch_utils import LlamaTensorProcessor

    undo = LlamaTensorProcessor()._reverse_permute_weights
    for quant in ("F32", "Q8_0"):
        f = tmp_path / f"{quant}.gguf"
        write_gguf_checkpoint(f, TINY, quant)
        vm = varmap_from_gguf(f)
        with tgguf.Gguf(f) as g:
            for side, heads in (("q", 4), ("k", 2)):
                raw = g.load_numpy(f"blk.1.attn_{side}.weight")
                want = undo(raw, 4, 2 if side == "k" else 4)
                got = vm.take(f"model.layers.1.self_attn.{side}_proj.weight")
                got = (tqt.dequantize_np(got).T if isinstance(got, tqt.QuantTensor)
                       else got.numpy())
                np.testing.assert_array_equal(got, want)
                assert not np.array_equal(raw, want)


def test_qk_permutation_is_a_pair_of_inverses():
    for n_rows, heads in ((64, 4), (256, 2), (1024, 8)):
        fwd, back = qk_row_order(n_rows, heads, True), qk_row_order(n_rows, heads, False)
        np.testing.assert_array_equal(fwd[back], np.arange(n_rows))
        np.testing.assert_array_equal(back[fwd], np.arange(n_rows))


def test_q4_k_m_mix_follows_llama_cpp():
    """use_more_bits(i, n): i < n/8 or i >= 7n/8 or (i - n/8) % 3 == 2."""
    assert [i for i in range(32) if use_more_bits(i, 32)] == [
        0, 1, 2, 3, 6, 9, 12, 15, 18, 21, 24, 27, 28, 29, 30, 31]
    kinds = q4_k_m_types(4)
    assert kinds["output"] == "Q6_K" and kinds["token_embd"] == "Q4_K"
    assert [kinds[f"blk.{i}.ffn_down"] for i in range(4)] == ["Q4_K", "Q4_K", "Q6_K", "Q6_K"]
    assert {kinds[f"blk.{i}.attn_q"] for i in range(4)} == {"Q4_K"}


def test_gguf_served_through_the_scheduler(tmp_path):
    """``serve --model FILE.gguf``: the scheduler loads the file with its
    embedded tokenizer."""
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler

    f = tmp_path / "m.gguf"
    write_gguf_checkpoint(f, TINY, "Q8_0")
    sched = ModelScheduler(f, device=CPU)
    assert sched.discover_models() == ["m.gguf"]
    ex = sched.get_executor("default")
    assert ex.tokenizer.vocab_size == TINY.vocab_size
    ids = ex.tokenizer.encode("hi there")
    assert ids[0] == 1 and len(list(ex.generate(ids, _gen()))) == 8
