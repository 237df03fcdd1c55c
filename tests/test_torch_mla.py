"""Port parity: DeepSeek's MLA family of blazr_tpu_torch (``models/mla.py``,
the latent pages of ``models/paged_multi.py``, both engines) against
blazr_tpu on the CPU, and against transformers where the JAX package is
wrong (ROADMAP §C: the YaRN softmax scale, a quantized ``kv_b_proj``).

Tiny checkpoints (``utils.synthetic.tiny_recurrent_config("deepseek")``:
hidden 64, layer 0 dense, layer 1 with 4 experts of 32, top-2, one shared
expert, latent 32, 16 nope + 16 rope dims) are written to disk by
``write_hf_checkpoint`` (plain f32, or AWQ-INT4 in groups of 32 with
``kv_b_proj`` plain, which the JAX loader needs) and read by both
packages' ``load_model``; inputs come from numpy seeds.

Tolerances: logits within 1e-4 of their largest magnitude (the same f32
arithmetic in another order); a prefill plus decode steps within 1e-5 of
one forward over the whole sequence; transformers at 1e-3, the tolerance
``tests/test_mla_moe.py`` holds the JAX package to; greedy streams and
dequantized weights exactly equal."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.config.model_config import \
    universal_from_hf_config as jax_universal_from_hf_config
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.formats.detect import detect_model_source as jdetect
from blazr_tpu.loader import api as japi
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.models import mla as jmla
from blazr_tpu.models import paged_multi as jpm
from blazr_tpu.models.registry import build_model as jbuild
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.model_config import RopeScaling, universal_from_hf_config
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.formats import SafeTensorsReader
from blazr_tpu_torch.kvcache import paged as tpaged
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models import mla as tmla
from blazr_tpu_torch.models import paged_multi as tpm
from blazr_tpu_torch.models.registry import SERVED_FAMILIES, resolve_paged_kind
from blazr_tpu_torch.quant import qtensor as tqt
from blazr_tpu_torch.utils.synthetic import (RECURRENT_CONFIGS, hf_config,
                                             tiny_recurrent_config, write_gguf_recurrent,
                                             write_hf_checkpoint)

from test_torch_engine import _Tok, _serve
from test_torch_moe import _paged_steps

CPU = "cpu"
VOCAB = 256


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("mla")
    out = {}
    for i, quant in enumerate(("plain", "awq")):
        d = root / quant
        write_hf_checkpoint(d, tiny_recurrent_config("deepseek"), quant=quant, group_size=32,
                            seed=30 + i, dtype="float32", weight_exp=-4,
                            keep_plain=("kv_b_proj",))
        out[quant] = d
    return out


def _pair(d):
    jm, _ = jax_load(d, dtype="f32")
    tm, _ = load_model(d, dtype="f32", device=CPU)
    return jm, tm


def _teacher_forced(jm, tm, t0=20, steps=3, quantized=False):
    """A t0-token prefill and ``steps`` decode steps through both contiguous
    forwards (bf16-free f32 caches, or int8 latents); the worst relative
    logit error."""
    toks = np.random.default_rng(7).integers(0, VOCAB, (1, t0 + steps))
    jc = jmla.init_mla_cache(jm.cfg, 1, 64, dtype=jnp.float32, quantized=quantized)
    tc = tm.init_cache(1, 64, kv_quant=quantized)
    assert tc.quantized is quantized
    worst = 0.0
    for lo, hi in [(0, t0)] + [(t0 + i, t0 + i + 1) for i in range(steps)]:
        tok, pos = toks[:, lo:hi], np.arange(lo, hi)[None]
        jl, jc = jm.forward(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tm.forward(torch.from_numpy(tok), tc, torch.from_numpy(pos))
        jl = np.asarray(jl)
        worst = max(worst, _rel(tl.numpy(), jl))
        assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
    return worst


@pytest.mark.parametrize("quant", ["plain", "awq"])
@pytest.mark.parametrize("latents", ["float", "int8"])
def test_contiguous_forward_matches_jax(ckpts, quant, latents):
    """Both loaders read the checkpoint alike (the q branch, the absorbed
    kv_b halves, layer 0 dense and layer 1 MoE) and the contiguous forwards
    agree over a prefill and three decode steps, in both latent modes."""
    jm, tm = _pair(ckpts[quant])
    assert tm.cfg.model_type == jm.cfg.model_type == "deepseek"
    for j, t in zip(jm.params["layers"], tm.params["layers"]):
        assert {k for k, v in t.items() if v is not None} == \
            {k for k, v in j.items() if v is not None}
    np.testing.assert_allclose(tm.params["layers"][0]["kv_b_k"].numpy(),
                               np.asarray(jm.params["layers"][0]["kv_b_k"]), rtol=0, atol=0)
    assert "moe" in tm.params["layers"][1] and "gate" in tm.params["layers"][0]
    assert _teacher_forced(jm, tm, quantized=latents == "int8") < 1e-4


@pytest.mark.parametrize("latents", ["float", "int8"])
def test_paged_forward_matches_jax(ckpts, latents):
    """Two sequences prefilled in one padded batch on latent pages, then
    decode steps: the port's paged logits equal the JAX package's."""
    jm, tm = _pair(ckpts["awq"])
    q = latents == "int8"
    tc = tpm.init_paged_mla_cache(tm.cfg, 8, 8, dtype=torch.float32, quantized=q, device=CPU)
    jc = jpm.init_paged_mla_cache(jm.cfg, 8, 8, dtype=jnp.float32, quantized=q)
    assert tc.trash_slot == jc.trash_slot == 64

    def port(params, cfg, tok, cache, pos, sl, tables, seq_lens, last):
        return tpm.mla_forward_paged(params, cfg, tok, cache, pos, sl, tables, seq_lens,
                                     last_idx=last)

    def jax(params, cfg, tok, cache, pos, sl, tables, seq_lens, last):
        return jpm.mla_forward_paged(params, cfg, tok, cache, pos, sl, tables, seq_lens,
                                     last_idx=last)

    got = _paged_steps(port, tm.params, tm.cfg, tc, torch.from_numpy)
    ref = _paged_steps(jax, jm.params, jm.cfg, jc, jnp.asarray)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g, r) < 1e-4, f"step {k}"


def test_prefill_then_decode_matches_one_forward(ckpts):
    """The latent cache carries a sequence: a 12-token prefill and four
    decode steps give the logits of one 16-token forward at each position."""
    tm, _ = load_model(ckpts["plain"], dtype="f32", device=CPU)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, VOCAB, (1, 16)))
    full, _ = tm.forward(toks, tm.init_cache(1, 32), torch.arange(16)[None])
    cache = tm.init_cache(1, 32)
    parts = [tm.forward(toks[:, :12], cache, torch.arange(12)[None])[0]]
    for p in range(12, 16):
        parts.append(tm.forward(toks[:, p:p + 1], cache, torch.tensor([[p]]))[0])
    assert _rel(torch.cat(parts, dim=1).numpy(), full.numpy()) < 1e-5
    assert int(cache.length[0]) == 16


def test_quantized_kv_b_proj_dequantizes_at_load(tmp_path):
    """AutoAWQ quantizes ``kv_b_proj``: the port dequantizes it to f32 at
    load, exactly the dense weight the QuantTensor holds, and the model
    equals the one whose checkpoint holds that weight plain. The JAX
    package cannot load it (``build_mla_params`` reshapes a QuantTensor)."""
    cfg = tiny_recurrent_config("deepseek")
    write_hf_checkpoint(tmp_path, cfg, quant="awq", group_size=32, seed=5, dtype="float32",
                        weight_exp=-4)
    tm, _ = load_model(tmp_path, dtype="f32", device=CPU)
    with SafeTensorsReader(tmp_path / "model.safetensors") as r:
        names = r.tensor_names()
        assert "model.layers.0.self_attn.kv_b_proj.qweight" in names
        base = "model.layers.0.self_attn.kv_b_proj."
        qt = tqt.from_awq(r.load_numpy(base + "qweight", dtype=np.uint32),
                          r.load_numpy(base + "scales").astype(np.float32),
                          r.load_numpy(base + "qzeros", dtype=np.uint32), 32, device=CPU)
    kb_k, kb_v = tmla.split_kv_b(tqt.dequantize(qt).t().contiguous(), cfg.attention)
    assert torch.equal(tm.params["layers"][0]["kv_b_k"], kb_k)
    assert torch.equal(tm.params["layers"][0]["kv_b_v"], kb_v)
    with pytest.raises(Exception):
        jax_load(tmp_path, dtype="f32")


def _hf_deepseek_v3(tmp_path, rope_scaling):
    """A tiny DeepseekV3ForCausalLM (no q_lora_rank, sigmoid routing with a
    correction bias) saved by transformers."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(3)
    hf = transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2, n_group=1,
        topk_group=1, norm_topk_prob=True, first_k_dense_replace=1, kv_lora_rank=32,
        q_lora_rank=None, qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16,
        max_position_embeddings=40 * 64, rope_theta=10000.0, rope_scaling=rope_scaling,
        rope_interleave=True, tie_word_embeddings=False)).eval()
    with torch.no_grad():
        for layer in hf.model.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.normal_(0, 0.1)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    return hf


YARN = {"type": "yarn", "factor": 40.0, "original_max_position_embeddings": 64,
        "beta_fast": 32.0, "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707}


def test_yarn_softmax_scale_follows_transformers(tmp_path):
    """Under DeepSeek's YaRN config the scores scale by (d_nope + d_rope)^-0.5
    times mscale² (about 1.59 at factor 40), as ``DeepseekV3Attention``
    does: both of the port's forwards agree with transformers at 1e-3; the
    JAX package, which leaves the mscale out, does not at that tolerance."""
    hf = _hf_deepseek_v3(tmp_path, YARN)
    tm, _ = load_model(tmp_path, dtype="f32", device=CPU)
    att = tm.cfg.attention
    assert att.rope_scaling.rope_type == "yarn"
    m = 0.1 * 0.707 * np.log(40.0) + 1.0
    assert tmla.softmax_scale(att) == pytest.approx(32 ** -0.5 * m * m, rel=1e-12)
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, 40))
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    got, _ = tm.forward(torch.from_numpy(toks), tm.init_cache(1, 64), torch.arange(40)[None])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
    cache = tpm.init_paged_mla_cache(tm.cfg, 8, 8, dtype=torch.float32, device=CPU)
    blocks = [4, 1, 6, 0, 2]
    paged, _ = tpm.mla_forward_paged(
        tm.params, tm.cfg, torch.from_numpy(toks), cache, torch.arange(40)[None],
        torch.from_numpy(tpaged.compute_slot_mapping(blocks, 0, 40, 8, cache.trash_slot)
                         .astype(np.int64))[None],
        torch.from_numpy(tpaged.pad_block_table(blocks, 5))[None],
        torch.tensor([40], dtype=torch.int32))
    np.testing.assert_allclose(paged.numpy(), ref, rtol=1e-3, atol=1e-3)
    jm, _ = jax_load(tmp_path, dtype="f32")
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 64),
                       jnp.arange(40, dtype=jnp.int32)[None])
    assert not np.allclose(np.asarray(jl), ref, rtol=1e-3, atol=1e-3)


def test_agrees_with_transformers_and_jax_without_rope_scaling(tmp_path):
    """With ``rope_scaling`` null the deviation cannot show: the port agrees
    with transformers at 1e-3 and with the JAX package at 1e-4."""
    hf = _hf_deepseek_v3(tmp_path, None)
    tm, _ = load_model(tmp_path, dtype="f32", device=CPU)
    toks = np.random.default_rng(1).integers(0, VOCAB, (1, 24))
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    got, _ = tm.forward(torch.from_numpy(toks), tm.init_cache(1, 32), torch.arange(24)[None])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
    jm, _ = jax_load(tmp_path, dtype="f32")
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 32),
                       jnp.arange(24, dtype=jnp.int32)[None])
    assert _rel(got.numpy(), np.asarray(jl)) < 1e-4


def test_quantized_kv_b_proj_follows_transformers(tmp_path):
    """A DeepseekV3 checkpoint whose ``kv_b_proj`` layers are AWQ triplets
    (groups of 32), the rest plain: the port dequantizes them at load and
    agrees at 1e-3 with transformers running the same dequantized weights,
    on both forwards."""
    import json

    from blazr_tpu_torch.formats import write_safetensors

    hf = _hf_deepseek_v3(tmp_path, None)
    f = tmp_path / "model.safetensors"
    with SafeTensorsReader(f) as r:
        tensors = {n: np.array(r.load_numpy(n)) for n in r.tensor_names()}
    rng = np.random.default_rng(11)
    for i, layer in enumerate(hf.model.layers):
        base = f"model.layers.{i}.self_attn.kv_b_proj."
        n, k = tensors.pop(base + "weight").shape                 # [out, in]
        qw = rng.integers(0, 2 ** 32, (k, n // 8), dtype=np.uint64).astype(np.uint32)
        qz = rng.integers(0, 2 ** 32, (k // 32, n // 8), dtype=np.uint64).astype(np.uint32)
        sc = (rng.random((k // 32, n), dtype=np.float32) * 0.01 + 0.001).astype(np.float16)
        tensors.update({base + "qweight": qw, base + "qzeros": qz, base + "scales": sc})
        w = tqt.dequantize(tqt.from_awq(qw, sc.astype(np.float32), qz, 32, device=CPU))
        with torch.no_grad():
            layer.self_attn.kv_b_proj.weight.copy_(w.t())
    write_safetensors(f, tensors)
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg["quantization_config"] = {"quant_method": "awq", "bits": 4, "group_size": 32,
                                  "zero_point": True, "version": "gemm"}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    tm, _ = load_model(tmp_path, dtype="f32", device=CPU)
    assert isinstance(tm.params["layers"][0]["q"], torch.Tensor)      # the rest plain
    toks = np.random.default_rng(2).integers(0, VOCAB, (1, 24))
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    got, _ = tm.forward(torch.from_numpy(toks), tm.init_cache(1, 32), torch.arange(24)[None])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
    cache = tpm.init_paged_mla_cache(tm.cfg, 8, 8, dtype=torch.float32, device=CPU)
    blocks = [3, 0, 5]
    paged, _ = tpm.mla_forward_paged(
        tm.params, tm.cfg, torch.from_numpy(toks), cache, torch.arange(24)[None],
        torch.from_numpy(tpaged.compute_slot_mapping(blocks, 0, 24, 8, cache.trash_slot)
                         .astype(np.int64))[None],
        torch.from_numpy(tpaged.pad_block_table(blocks, 3))[None],
        torch.tensor([24], dtype=torch.int32))
    np.testing.assert_allclose(paged.numpy(), ref, rtol=1e-3, atol=1e-3)


def _jax_gguf(path):
    """The JAX package's model of a DeepSeek GGUF file. Its GGUF config
    reads neither the nope width (only the whole key width) nor the leading
    dense layers, so both are supplied here."""
    src = jdetect(path)
    vm = japi.load_varmap(src)
    cfg = japi.resolve_config(src, vm).model
    cfg.attention.d_nope = cfg.attention.head_dim - cfg.attention.d_rope
    cfg.moe.num_dense_layers = 1
    japi._reconcile_config_with_weights(cfg, vm)
    return jbuild(cfg, vm, jnp.float32)


def test_gguf_matches_jax(tmp_path):
    """A deepseek2 GGUF file (Q8_0 projections, llama.cpp's pre-stacked
    experts, an F32 ``attn_kv_b``) loads into the port with its config from
    the metadata, the experts as one stacked QuantTensor, and the forward
    agrees with the JAX package's model of the same file."""
    f = tmp_path / "deepseek.gguf"
    write_gguf_recurrent(f, tiny_recurrent_config("deepseek"), "Q8_0", seed=4)
    tm, _ = load_model(f, dtype="f32", device=CPU)
    assert tm.cfg.model_type == "deepseek" and tmla.d_nope(tm.cfg.attention) == 16
    assert tqt.is_stacked(tm.params["layers"][1]["moe"]["experts_gate"])
    assert tm.params["layers"][0]["q"].fmt == "ggml_q8_0"
    jm = _jax_gguf(f)
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, 24))
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 32),
                       jnp.arange(24, dtype=jnp.int32)[None])
    tl, _ = tm.forward(torch.from_numpy(toks), tm.init_cache(1, 32), torch.arange(24)[None])
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4


def test_gguf_quantized_kv_b_loads(tmp_path):
    """A GGUF file whose ``attn_kv_b`` is Q8_0 too: the port dequantizes it
    and computes what the F32 file computes, to Q8_0's rounding."""
    cfg = tiny_recurrent_config("deepseek")
    for name, keep in (("f32.gguf", ("attn_kv_b",)), ("q8.gguf", ())):
        write_gguf_recurrent(tmp_path / name, cfg, "Q8_0", seed=4, keep_f32=keep)
    a, _ = load_model(tmp_path / "f32.gguf", dtype="f32", device=CPU)
    b, _ = load_model(tmp_path / "q8.gguf", dtype="f32", device=CPU)
    assert not torch.equal(a.params["layers"][0]["kv_b_k"], b.params["layers"][0]["kv_b_k"])
    assert _rel(b.params["layers"][0]["kv_b_k"], a.params["layers"][0]["kv_b_k"]) < 1e-2
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, VOCAB, (1, 16)))
    la, _ = a.forward(toks, a.init_cache(1, 32), torch.arange(16)[None])
    lb, _ = b.forward(toks, b.init_cache(1, 32), torch.arange(16)[None])
    assert _rel(lb.numpy(), la.numpy()) < 2e-2


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

def test_executor_greedy_matches_jax(ckpts):
    jm, tm = _pair(ckpts["awq"])
    prompts = [[5, 9, 17], list(range(1, 21)), [7] * 40]
    ref = [[e.token_id for e in JExecutor(jm, _Tok(), JApp(model=jm.cfg)).generate(
        p, JGen(max_tokens=8, temperature=0.0))] for p in prompts]
    ex = Executor(tm, _Tok(), AppConfig(model=tm.cfg))
    got = [[e.token_id for e in ex.generate(p, GenerationConfig(max_tokens=8,
                                                                temperature=0.0))]
           for p in prompts]
    assert got == ref and all(len(s) == 8 for s in got)


@pytest.mark.parametrize("latents", ["auto", "int8"])
def test_batch_engine_greedy_matches_jax(ckpts, latents):
    """Four greedy requests in two staggered waves on latent pages (bf16-free
    f32, or int8 latents): the JAX engine's streams."""
    jm, tm = _pair(ckpts["awq"])
    waves = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]], [[42] * 20, list(range(1, 18))]]

    def app(cls, cfg):
        a = cls(model=cfg)
        a.inference.max_seq_len = 64
        a.inference.max_batch_size = 4
        a.inference.kv_cache_dtype = latents
        return a

    ref = asyncio.run(_serve(JEngine(jm, _Tok(), app(JApp, jm.cfg)), waves,
                             lambda: JGen(max_tokens=8, temperature=0.0)))
    eng = BatchEngine(tm, _Tok(), app(AppConfig, tm.cfg))
    assert isinstance(eng.cache, tpm.PagedMLACache) and eng.cache.quantized is (
        latents == "int8")
    got = asyncio.run(_serve(eng, waves, lambda: GenerationConfig(max_tokens=8,
                                                                  temperature=0.0)))
    assert got == ref and all(len(s) == 8 for s in got)


# ---------------------------------------------------------------------------
# Dispatch and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["llama", "deepseek", "mamba2", "bamba"])
def test_resolve_paged_kind_matches_jax(family):
    from blazr_tpu_torch.utils.synthetic import mistral_7b_config

    cfg = mistral_7b_config() if family == "llama" else tiny_recurrent_config(family)
    jcfg = jax_universal_from_hf_config(hf_config(cfg)) if family != "llama" else None
    kind = resolve_paged_kind(cfg)
    assert kind == {"llama": "llama", "deepseek": "mla", "mamba2": "mamba2",
                    "bamba": "hybrid"}[family]
    if jcfg is not None:
        assert jpm.resolve_paged_kind(jcfg) == kind


@pytest.mark.parametrize("family", sorted(RECURRENT_CONFIGS))
def test_published_configs_round_trip(family):
    """Each published-width config survives its config.json, names a served
    family, and parses as the JAX package parses it."""
    cfg = RECURRENT_CONFIGS[family]()
    raw = hf_config(cfg)
    back = universal_from_hf_config(raw)
    assert back.model_type == family and family in SERVED_FAMILIES
    assert back.layer_types() == cfg.layer_types()
    assert back.to_dict() == jax_universal_from_hf_config(raw).to_dict()
    for key in ("vocab_size", "hidden_size", "num_layers"):
        assert getattr(back, key) == getattr(cfg, key), key
    if cfg.ssm is not None:
        assert dataclasses.asdict(back.ssm) == dataclasses.asdict(cfg.ssm)
    if family == "deepseek":
        assert back.attention.rope_scaling == cfg.attention.rope_scaling
        assert dataclasses.asdict(back.moe) == dataclasses.asdict(cfg.moe)


def test_deepseek_v2_lite_scale_and_shapes():
    """DeepSeek-V2-Lite's softmax scale (192^-0.5 x mscale², mscale =
    0.1 x 0.707 x ln 40 + 1) and its B1 shapes: kv_a N 576, q N 3072."""
    cfg = RECURRENT_CONFIGS["deepseek"]()
    m = 0.1 * 0.707 * np.log(40.0) + 1.0
    assert tmla.softmax_scale(cfg.attention) == pytest.approx(192 ** -0.5 * m * m)
    assert m * m == pytest.approx(1.590, abs=1e-3)
    att = cfg.attention
    assert att.kv_latent_dim + att.d_rope == 576
    assert att.num_heads * (att.d_nope + att.d_rope) == 3072
    plain = dataclasses.replace(att, rope_scaling=RopeScaling(rope_type="linear", factor=2.0))
    assert tmla.softmax_scale(plain) == pytest.approx(192 ** -0.5)
