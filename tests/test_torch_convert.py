"""Port parity: ``cli convert`` (``loader/convert.py``), safetensors ↔ GGUF,
of blazr_tpu_torch against blazr_tpu on the CPU, on tiny seeded
checkpoints with a BPE ``tokenizer.json``.

The port's GGUF equals the JAX converter's byte for byte except the rows
of attn_q and attn_k of a llama-architecture file, which go out in
llama.cpp's permuted order (ROADMAP §C); the way back restores HF order,
so both round trips end at the same safetensors."""

import json

import numpy as np
import pytest

from blazr_tpu.loader.convert import convert_checkpoint as jax_convert
from blazr_tpu_torch.cli.main import main as cli_main
from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig
from blazr_tpu_torch.formats import Gguf, SafeTensorsReader
from blazr_tpu_torch.formats.names import qk_row_order
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.loader.convert import convert_checkpoint
from blazr_tpu_torch.utils.synthetic import write_bpe_tokenizer_json, write_hf_checkpoint

CPU = "cpu"


def _cfg(model_type):
    return UniversalConfig(model_type=model_type, vocab_size=300, hidden_size=256,
                           num_layers=2, max_seq_len=512, intermediate_size=512,
                           attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                                     head_dim=64))


def _src(tmp_path, model_type="llama"):
    src = tmp_path / f"src_{model_type}"
    write_hf_checkpoint(src, _cfg(model_type), quant="plain", dtype="float32", seed=11)
    write_bpe_tokenizer_json(src, 300, seed=1)
    return src


def _both(tmp_path, src, quant):
    t, j = tmp_path / "port" / "m.gguf", tmp_path / "jax" / "m.gguf"
    t.parent.mkdir()
    j.parent.mkdir()
    convert_checkpoint(src, t, quant=quant)
    jax_convert(src, j, quant=quant)
    return t, j


@pytest.mark.parametrize("quant", [None, "Q8_0", "Q4_K"])
def test_gguf_matches_jax_but_the_permuted_qk_rows(tmp_path, quant):
    t, j = _both(tmp_path, _src(tmp_path), quant)
    with Gguf(t) as tg, Gguf(j) as jg:
        assert tg.metadata().kv == jg.metadata().kv
        assert "tokenizer.ggml.tokens" in tg.metadata().kv
        assert tg.tensor_names() == jg.tensor_names()
        permuted = 0
        for n in tg.tensor_names():
            ti, ji = tg.tensor_info(n), jg.tensor_info(n)
            assert (ti.shape, ti.ggml_type, ti.offset) == (ji.shape, ji.ggml_type, ji.offset)
            tb, jb = bytes(tg.tensor_bytes(n)), bytes(jg.tensor_bytes(n))
            side = n.split(".")[2] if n.startswith("blk.") else ""
            if side in ("attn_q", "attn_k"):
                heads = 4 if side == "attn_q" else 2
                rows = np.frombuffer(jb, np.uint8).reshape(ti.shape[0], -1)
                assert tb == rows[qk_row_order(ti.shape[0], heads, to_gguf=True)].tobytes()
                assert tb != jb
                permuted += 1
            else:
                assert tb == jb, n
        assert permuted == 4
    assert (t.read_bytes() != j.read_bytes())


@pytest.mark.parametrize("quant", [None, "Q8_0", "Q4_K"])
def test_round_trip_back_to_safetensors(tmp_path, quant):
    """safetensors → GGUF → safetensors through the port ends where the JAX
    round trip ends (f32 exactly), and at the source itself without a quant."""
    src = _src(tmp_path)
    t, j = _both(tmp_path, src, quant)
    convert_checkpoint(t, tmp_path / "port_st")
    jax_convert(j, tmp_path / "jax_st")
    assert (json.loads((tmp_path / "port_st" / "config.json").read_text())
            == json.loads((tmp_path / "jax_st" / "config.json").read_text()))
    with SafeTensorsReader(tmp_path / "port_st" / "model.safetensors") as rt, \
            SafeTensorsReader(tmp_path / "jax_st" / "model.safetensors") as rj, \
            SafeTensorsReader(src / "model.safetensors") as rs:
        assert sorted(rt.tensor_names()) == sorted(rj.tensor_names()) == sorted(
            rs.tensor_names())
        for n in rt.tensor_names():
            np.testing.assert_array_equal(rt.load_numpy(n), rj.load_numpy(n), err_msg=n)
            if quant is None:
                np.testing.assert_array_equal(rt.load_numpy(n), rs.load_numpy(n))
    model, cfg = load_model(tmp_path / "port_st", dtype="f32", device=CPU)
    assert cfg.model.num_layers == 2 and model.vocab_size == 300


def test_mistral_file_keeps_hf_order(tmp_path):
    """A mistral-architecture file (not llama.cpp's permuted `llama`) is the
    JAX converter's file byte for byte."""
    t, j = _both(tmp_path, _src(tmp_path, "mistral"), "Q8_0")
    assert t.read_bytes() == j.read_bytes()


def test_converted_gguf_loads_like_its_source(tmp_path):
    """An F32 GGUF written by convert (permuted Q/K) loads to the source's
    weights: the loader's un-permute undoes convert's permute."""
    src = _src(tmp_path)
    dst = tmp_path / "m.gguf"
    assert cli_main(["--device", "cpu", "convert", str(src), str(dst)]) == 0
    a, _ = load_model(src, dtype="f32", device=CPU)
    b, _ = load_model(dst, dtype="f32", device=CPU)
    for i in range(2):
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            np.testing.assert_array_equal(a.params["layers"][i][key].numpy(),
                                          b.params["layers"][i][key].numpy())


def test_convert_refuses_what_it_cannot_do(tmp_path):
    src = _src(tmp_path)
    with pytest.raises(ValueError, match="not needed"):
        convert_checkpoint(src, tmp_path / "out.safetensors")
    g = tmp_path / "m.gguf"
    convert_checkpoint(src, g)
    with pytest.raises(ValueError, match="requantization"):
        convert_checkpoint(g, tmp_path / "n.gguf", quant="Q8_0")
    (src / "config.json").unlink()
    with pytest.raises(ValueError, match="config.json"):
        convert_checkpoint(src, tmp_path / "x.gguf")
