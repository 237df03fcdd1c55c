"""Port parity: checkpoint loading (formats, detection, VarMap, load_model)
of blazr_tpu_torch against blazr_tpu on the CPU, on tiny plain, AWQ and
GPTQ (desc-act) checkpoints written to disk.

Integer data must be equal (packed words, permutations); f32 logits agree
within 1e-5 of the largest logit (f32 sums in another order). The AWQ
checkpoint at its default dtype (f16, as both loaders choose for AWQ/GPTQ)
runs through the Pallas kernels in interpret mode on the JAX side
(BLAZR_TPU_FORCE_PALLAS_QUANT=1), so both packages round x to bf16 in the
matmuls; the rest of the forward is f16 in both, in another order:
2e-2 of the largest logit."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.formats import detect_model_source as jax_detect
from blazr_tpu.kvcache.contiguous import init_kv_cache as jax_init_cache
from blazr_tpu.loader import load_model as jax_load_model
from blazr_tpu.models import llama as jllama
from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig
from blazr_tpu_torch.formats import (QuantMethod, SafeTensorsReader,
                                     detect_model_source, write_safetensors)
from blazr_tpu_torch.kvcache.contiguous import init_kv_cache
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models import llama as tllama
from blazr_tpu_torch.utils.synthetic import write_awq_checkpoint

from fixtures import write_tiny_llama_checkpoint
from test_qtensor import _make_awq

CPU = "cpu"
# hidden 128 and group 128: every projection is one the JAX tiles accept,
# so the JAX package really takes its Pallas kernel under FORCE_PALLAS.
AWQ_CFG = UniversalConfig(model_type="mistral", vocab_size=256, hidden_size=128,
                          num_layers=2, max_seq_len=256, intermediate_size=256,
                          attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                                    head_dim=64, sliding_window=64))


def _gptq_checkpoint(path, rng, gs=32):
    """Tiny GPTQ checkpoint with desc-act g_idx (fixture geometry)."""
    path.mkdir(parents=True, exist_ok=True)
    dense = {k: v for k, v in write_tiny_llama_checkpoint(path, rng).items()
             if not k.endswith("_proj.weight")}
    cfg = json.loads((path / "config.json").read_text())
    cfg["quantization_config"] = {"quant_method": "gptq", "bits": 4,
                                  "group_size": gs, "desc_act": True}
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    hd = h // cfg["num_attention_heads"]
    shapes = {"self_attn.q_proj": (h, cfg["num_attention_heads"] * hd),
              "self_attn.k_proj": (h, cfg["num_key_value_heads"] * hd),
              "self_attn.v_proj": (h, cfg["num_key_value_heads"] * hd),
              "self_attn.o_proj": (h, h), "mlp.gate_proj": (h, inter),
              "mlp.up_proj": (h, inter), "mlp.down_proj": (inter, h)}
    tensors = dict(dense)
    for i in range(cfg["num_hidden_layers"]):
        for name, (k, n) in shapes.items():
            p = f"model.layers.{i}.{name}."
            tensors[p + "qweight"] = rng.integers(0, 2 ** 32, (k // 8, n),
                                                  dtype=np.uint64).astype(np.uint32)
            tensors[p + "qzeros"] = rng.integers(0, 2 ** 32, (k // gs, n // 8),
                                                 dtype=np.uint64).astype(np.uint32)
            tensors[p + "scales"] = (rng.random((k // gs, n)) * 0.01
                                     + 0.001).astype(np.float16)
            tensors[p + "g_idx"] = rng.permutation(np.arange(k) // gs).astype(np.int32)
    write_safetensors(path / "model.safetensors", tensors)
    (path / "config.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    rng = np.random.default_rng(0)
    write_tiny_llama_checkpoint(root / "plain", rng)
    write_awq_checkpoint(root / "awq", AWQ_CFG, group_size=128, seed=1)
    _gptq_checkpoint(root / "gptq", rng)
    return root


def _leaves(params):
    if isinstance(params, dict):
        for k in sorted(params):
            yield from ((f"{k}.{n}", v) for n, v in _leaves(params[k]))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            yield from ((f"{i}.{n}", x) for n, x in _leaves(v))
    else:
        yield "", params


def _same_params(tm, jm):
    """Every leaf: quantized words and permutations integer-equal, planes
    and dense weights equal in f32 (f16 stored values, exactly widened)."""
    tl = dict(_leaves(tm.params))
    jl = {n: v for n, v in _leaves(jm.params) if v is not None}
    assert sorted(n for n, v in tl.items() if v is not None) == sorted(jl)
    for name, jv in jl.items():
        tv = tl[name]
        if hasattr(jv, "qweight"):
            np.testing.assert_array_equal(tv.qweight.numpy().view(np.uint32),
                                          np.asarray(jv.qweight))
            np.testing.assert_array_equal(tv.scales.numpy(), np.asarray(jv.scales))
            np.testing.assert_array_equal(tv.mins.numpy(), np.asarray(jv.mins))
            assert (jv.perm is None) == (tv.perm is None)
            if jv.perm is not None:
                np.testing.assert_array_equal(tv.perm.numpy(), np.asarray(jv.perm))
        else:
            np.testing.assert_array_equal(tv.float().numpy(),
                                          np.asarray(jv, np.float32), err_msg=name)


def _logits(tm, jm, steps=(12, 1, 1)):
    """Teacher-forced logits of both packages through the contiguous forward."""
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, sum(steps))
    hd, kv = tm.head_dim, tm.num_kv_heads
    tc = init_kv_cache(cfg.num_layers, 1, 64, kv, hd, dtype=tm.dtype, device=CPU)
    jdt = {torch.float32: jnp.float32, torch.float16: jnp.float16}[tm.dtype]
    jc = jax_init_cache(cfg.num_layers, 1, 64, kv, hd, dtype=jdt)
    out_t, out_j = [], []
    pos = 0
    for n in steps:
        tok = toks[None, pos:pos + n]
        p = np.arange(pos, pos + n)[None]
        sl = np.array([pos + n], np.int32)
        jl, jc = jllama.forward(jm.params, jm.cfg, jnp.asarray(tok, jnp.int32), jc,
                                jnp.asarray(p, jnp.int32), jnp.asarray(sl))
        with torch.no_grad():
            tl, tc = tllama.forward(tm.params, tm.cfg, torch.from_numpy(tok), tc,
                                    torch.from_numpy(p), torch.from_numpy(sl))
        out_j.append(np.asarray(jl, np.float32))
        out_t.append(tl.float().numpy())
        pos += n
    return out_t, out_j


@pytest.mark.parametrize("kind", ["plain", "awq", "gptq"])
def test_detect_model_source_agrees(ckpts, kind):
    t = detect_model_source(ckpts / kind)
    j = jax_detect(ckpts / kind)
    assert (t.format.value, t.quant.value, t.path, t.model_dir, t.config_path) == (
        j.format.value, j.quant.value, j.path, j.model_dir, j.config_path)


@pytest.mark.parametrize("kind", ["plain", "awq", "gptq"])
def test_load_model_f32_matches_jax(ckpts, kind):
    tm, tcfg = load_model(ckpts / kind, dtype="f32", device=CPU)
    jm, jcfg = jax_load_model(ckpts / kind, dtype="f32")
    assert tm.cfg.to_dict() == jcfg.model.to_dict() and tcfg.inference.dtype == "f32"
    _same_params(tm, jm)
    for t, j in zip(*_logits(tm, jm)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * float(np.abs(j).max()))


@pytest.mark.parametrize("kind", ["awq", "gptq"])
def test_quantized_checkpoints_default_to_f16(ckpts, kind):
    tm, tcfg = load_model(ckpts / kind, device=CPU)
    _, jcfg = jax_load_model(ckpts / kind)
    assert tcfg.inference.dtype == jcfg.inference.dtype == "f16"
    assert tm.dtype == torch.float16 and tm.params["embed"].dtype == torch.float16


def test_awq_default_dtype_logits_match_jax(ckpts, monkeypatch):
    """The AWQ checkpoint at its default dtype (f16) through both packages'
    forwards; the JAX side runs kernel B1 in interpret mode."""
    monkeypatch.setenv("BLAZR_TPU_FORCE_PALLAS_QUANT", "1")
    tm, _ = load_model(ckpts / "awq", device=CPU)
    jm, _ = jax_load_model(ckpts / "awq")
    for t, j in zip(*_logits(tm, jm)):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-2 * float(np.abs(j).max()))


def test_awq_loader_dequantizes_to_the_packed_reference(tmp_path):
    """AWQ triplets packed as tests/test_qtensor.py packs them (known q, z, s
    and their reference dequant): every loaded projection dequantizes to the
    reference [in, out] weight."""
    from blazr_tpu_torch.quant.qtensor import dequantize

    rng = np.random.default_rng(9)
    write_tiny_llama_checkpoint(tmp_path, rng)
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg["quantization_config"] = {"quant_method": "awq", "bits": 4, "group_size": 32}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with SafeTensorsReader(tmp_path / "model.safetensors") as r:
        tensors = {n: np.array(r.load_numpy(n)) for n in r.tensor_names()}
    refs = {}
    for name in [n for n in tensors if n.endswith("_proj.weight")]:
        n_out, k_in = tensors.pop(name).shape
        qweight, s, qzeros, ref = _make_awq(rng, k=k_in, n=n_out, gs=32)
        base = name[: -len(".weight")]
        tensors.update({base + ".qweight": qweight, base + ".scales": s,
                        base + ".qzeros": qzeros})
        refs[base] = ref
    write_safetensors(tmp_path / "model.safetensors", tensors)
    tm, _ = load_model(tmp_path, dtype="f32", device=CPU)
    for base, ref in refs.items():
        i, rest = base.split(".")[2], base.split(".")[-1]
        key = rest[: -len("_proj")]
        got = dequantize(tm.params["layers"][int(i)][key]).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7, err_msg=base)


def test_safetensors_roundtrip_bf16_without_ml_dtypes(tmp_path):
    """bf16 goes through a uint16 view: the port writes and reads it, and
    the JAX reader (ml_dtypes) reads the same values."""
    from blazr_tpu.formats import SafeTensorsReader as JaxReader

    x = torch.randn(3, 5).to(torch.bfloat16)
    write_safetensors(tmp_path / "t.safetensors", {"x": x, "n": np.arange(4, dtype=np.int64)})
    with SafeTensorsReader(tmp_path / "t.safetensors") as r:
        assert r.tensor_info("x").dtype_str == "BF16"
        assert torch.equal(r.load_torch("x"), x)
        assert r.load_torch("n").tolist() == [0, 1, 2, 3]
    with JaxReader(tmp_path / "t.safetensors") as r:
        np.testing.assert_array_equal(r.load_numpy("x").astype(np.float32),
                                      x.float().numpy())


def test_unserved_families_and_gguf_raise(tmp_path, ckpts):
    d = tmp_path / "gemma"
    write_tiny_llama_checkpoint(d, np.random.default_rng(5), cfg={"model_type": "gemma2"})
    with pytest.raises(NotImplementedError, match="item 11"):
        load_model(d, device=CPU)
    g = tmp_path / "model.gguf"
    g.write_bytes(b"GGUF")
    assert detect_model_source(g).quant == QuantMethod.GGUF
    with pytest.raises(NotImplementedError, match="item 10"):
        load_model(g, device=CPU)
