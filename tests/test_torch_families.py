"""Port parity: the dense model families (Qwen2, Qwen3, Phi-3, Gemma,
Gemma2, Starcoder2 and the three Falcon layouts) of blazr_tpu_torch against
blazr_tpu on the CPU, each from one tiny HF-layout checkpoint written to
disk by ``utils.synthetic.write_hf_checkpoint`` (plain f32 and, but for
Falcon, AWQ-INT4 with groups of 32) and loaded by both packages'
``load_model``.

Tolerances: f32 logits within 1e-4 of their largest magnitude (the same
arithmetic in another order); greedy token streams exactly equal. Gemma2's
two corrections (the window on the even layers only, the
``query_pre_attn_scalar`` score scale) are held to transformers'
``Gemma2ForCausalLM`` at 2e-3, the tolerance of
``tests/test_more_families.py``, and to the JAX package where neither can
show."""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.kvcache import paged as jpaged
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.model_meta.chat_template import ChatMessage as JMessage
from blazr_tpu.model_meta.chat_template import ChatTemplate as JTemplate
from blazr_tpu.models.llama_paged import forward_paged as jax_forward_paged
from blazr_tpu.tokenizer.hf_tokenizer import load_hf_tokenizer as jax_tokenizer
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.model_config import (AttentionConfig, UniversalConfig,
                                                 universal_from_hf_config)
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.formats import SafeTensorsReader, write_safetensors
from blazr_tpu_torch.kvcache import paged as tpaged
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.model_meta.chat_template import ChatMessage, ChatTemplate
from blazr_tpu_torch.models import llama as tllama
from blazr_tpu_torch.models.llama_paged import forward_paged
from blazr_tpu_torch.models.registry import SERVED_FAMILIES, Model
from blazr_tpu_torch.tokenizer.hf_tokenizer import load_hf_tokenizer
from blazr_tpu_torch.utils.synthetic import (FAMILY_CONFIGS, hf_config,
                                             write_bpe_tokenizer_json, write_hf_checkpoint,
                                             write_metaspace_tokenizer_json)

from test_torch_engine import _Tok, _serve

CPU = "cpu"
VOCAB = 256
BS = 8


def tiny_config(family: str) -> UniversalConfig:
    """Two layers, hidden 64, 4 heads of 16; each family's switches on, and
    a window of 8 where the family has one on every layer, so prompts of
    12 tokens run past it. Gemma2's window (64) and query_pre_attn_scalar
    (= head_dim) keep its two corrections out of the JAX comparison."""
    model_type = family.split("_")[0]
    att = dict(num_heads=4, num_kv_heads=2, head_dim=16)
    extra: dict = {}
    if model_type == "qwen2":
        att["qkv_bias"] = True
    if model_type == "phi3":
        att.update(num_kv_heads=4, sliding_window=8)
    if model_type in ("gemma", "gemma2"):
        extra.update(tie_word_embeddings=True, scale_embeddings=True)
    if model_type == "gemma2":
        att.update(sliding_window=64, window_layers=[True, False], query_pre_attn_scalar=16)
        extra.update(attn_logit_softcapping=50.0, final_logit_softcapping=30.0)
    if model_type in ("starcoder2", "falcon"):
        extra.update(tie_word_embeddings=True, norm_type="layernorm", mlp_type="plain")
    if model_type == "starcoder2":
        att.update(sliding_window=8, qkv_bias=True)
        extra["hidden_act"] = "gelu_tanh"
    if model_type == "falcon":
        extra.update(hidden_act="gelu_exact", parallel_residual=family != "falcon_rw")
        att["num_kv_heads"] = {"falcon": 1, "falcon_40b": 2, "falcon_rw": 4}[family]
        if family == "falcon_rw":                    # ALiBi, sequential, biases
            att.update(use_alibi=True, qkv_bias=True)
    return UniversalConfig(model_type=model_type, vocab_size=VOCAB, hidden_size=64,
                           num_layers=2, max_seq_len=128, intermediate_size=128,
                           attention=AttentionConfig(**att), **extra)


FAMILIES = ["qwen2", "qwen3", "phi3", "gemma", "gemma2", "starcoder2", "falcon",
            "falcon_40b", "falcon_rw"]
CASES = [(f, q) for f in FAMILIES for q in ("plain", "awq") if q == "plain"
         or not f.startswith("falcon")]
# The format each family is served in: AWQ, Falcon plain (a quantized fused
# query_key_value is refused).
SERVED = [(f, "plain" if f.startswith("falcon") else "awq") for f in FAMILIES]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    out = {}
    for i, (family, quant) in enumerate(CASES):
        d = root / f"{family}-{quant}"
        write_hf_checkpoint(d, tiny_config(family), quant=quant, group_size=32,
                            seed=10 + i, dtype="float32", weight_exp=-4)
        out[(family, quant)] = d
    return out


def _pair(ckpts, family, quant):
    jm, _ = jax_load(ckpts[(family, quant)], dtype="f32")
    tm, _ = load_model(ckpts[(family, quant)], dtype="f32", device=CPU)
    return jm, tm


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _teacher_forced(jm, tm_, params=None, steps=3, t0=12):
    """Prefill t0 tokens, then ``steps`` single-token steps, through both
    contiguous forwards; the worst relative logit error."""
    toks = np.random.default_rng(7).integers(0, VOCAB, (1, t0 + steps))
    jc, tc = jm.init_cache(1, 32), tm_.init_cache(1, 32)
    params = tm_.params if params is None else params
    worst = 0.0
    for lo, hi in [(0, t0)] + [(t0 + i, t0 + i + 1) for i in range(steps)]:
        tok, pos = toks[:, lo:hi], np.arange(lo, hi)[None]
        jl, jc = jm.forward(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tllama.forward(params, tm_.cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        jl = np.asarray(jl)
        worst = max(worst, _rel(tl.numpy(), jl))
        assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
    return worst


@pytest.mark.parametrize("family,quant", CASES)
def test_contiguous_forward_matches_jax(ckpts, family, quant):
    """Both loaders read the checkpoint alike (config, params, the family's
    extras) and the contiguous forwards agree over a prefill past the window
    and three decode steps."""
    jm, tm = _pair(ckpts, family, quant)
    assert tm.cfg.model_type == jm.cfg.model_type == family.split("_")[0]
    assert tm.cfg.tie_word_embeddings == jm.cfg.tie_word_embeddings
    assert ({k for k, v in tm.params["layers"][0].items() if v is not None}
            == {k for k, v in jm.params["layers"][0].items() if v is not None})
    assert _teacher_forced(jm, tm) < 1e-4


@pytest.mark.parametrize("family,quant", CASES)
def test_paged_forward_matches_jax(ckpts, family, quant):
    """Two sequences (7 and 12 tokens) prefilled in one padded batch, then
    three decode steps through the decode path (B2's plain version here):
    the port's paged logits equal the JAX package's."""
    jm, tm = _pair(ckpts, family, quant)
    att = tm.cfg.attention
    hd, n_kv = att.resolved_head_dim(64), att.kv_heads()
    lens, blocks, mb = [7, 12], [[3, 0, 5], [1, 6, 2]], 4
    tables = np.stack([tpaged.pad_block_table(b, mb) for b in blocks])
    jc = jpaged.init_paged_cache(2, 8, BS, n_kv, hd, dtype=jnp.float32)
    tc = tpaged.init_paged_cache(2, 8, BS, n_kv, hd, dtype=torch.float32, device=CPU)
    trash = tc.trash_slot
    rng = np.random.default_rng(1)
    tokens = np.zeros((2, 16), np.int64)
    positions = np.zeros((2, 16), np.int64)
    slots = np.full((2, 16), trash, np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, VOCAB, n)
        positions[i, :n] = np.arange(n)
        slots[i, :n] = tpaged.compute_slot_mapping(blocks[i], 0, n, BS, trash)
    step = (tokens, positions, slots, np.array(lens, np.int32),
            np.array([n - 1 for n in lens], np.int64))
    for k in range(4):
        tok, pos, sl, seq_lens, last = step
        jl, jc = jax_forward_paged(
            jm.params, jm.cfg, jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(sl),
            jnp.asarray(tables), jnp.asarray(seq_lens),
            last_idx=None if last is None else jnp.asarray(last))
        tl, tc = forward_paged(
            tm.params, tm.cfg, torch.from_numpy(tok), tc, torch.from_numpy(pos),
            torch.from_numpy(sl), torch.from_numpy(tables), torch.from_numpy(seq_lens),
            last_idx=None if last is None else torch.from_numpy(last), device=CPU)
        jl, tl = np.asarray(jl), tl.numpy()
        assert _rel(tl, jl) < 1e-4, f"step {k}"
        nxt = tl[:, -1].argmax(-1).astype(np.int64)[:, None]
        pos = np.array([[n + k] for n in lens], np.int64)
        sl = np.stack([tpaged.compute_slot_mapping(blocks[i], int(pos[i, 0]), 1, BS, trash)
                       for i in range(2)]).astype(np.int64)
        step = (nxt, pos, sl, (pos[:, 0] + 1).astype(np.int32), None)


@pytest.mark.parametrize("family", [f for f in FAMILIES if not f.startswith("falcon")])
def test_gptq_family_checkpoints_match_jax(tmp_path, family):
    """GPTQ tensors (desc-act, groups of 32) under each family's names:
    Phi-3's fused qkv_proj and gate_up_proj, Starcoder2's c_fc/c_proj with
    their biases, the q/k/v biases of Qwen2: both loaders read them alike."""
    cfg = tiny_config(family)
    write_hf_checkpoint(tmp_path / "plain", cfg, quant="plain", seed=5, dtype="float32",
                        weight_exp=-4)
    rng = np.random.default_rng(5)
    gs = 32
    tensors = {}
    with SafeTensorsReader(tmp_path / "plain" / "model.safetensors") as r:
        for name in r.tensor_names():
            w = r.load_numpy(name)
            base = name[: -len(".weight")]
            if w.ndim != 2 or "embed" in name or "lm_head" in name:
                tensors[name] = w
                continue
            n, k = w.shape
            tensors[base + ".qweight"] = rng.integers(0, 2 ** 32, (k // 8, n),
                                                      dtype=np.uint64).astype(np.uint32)
            tensors[base + ".qzeros"] = rng.integers(0, 2 ** 32, (k // gs, n // 8),
                                                     dtype=np.uint64).astype(np.uint32)
            tensors[base + ".scales"] = (rng.random((k // gs, n)) * 0.01
                                         + 0.001).astype(np.float16)
            tensors[base + ".g_idx"] = rng.permutation(np.arange(k) // gs).astype(np.int32)
    d = tmp_path / "gptq"
    d.mkdir()
    write_safetensors(d / "model.safetensors", tensors)
    config = hf_config(cfg)
    config["quantization_config"] = {"quant_method": "gptq", "bits": 4,
                                     "group_size": gs, "desc_act": True}
    (d / "config.json").write_text(json.dumps(config))
    jm, _ = jax_load(d, dtype="f32")
    tm, _ = load_model(d, dtype="f32", device=CPU)
    assert tm.params["layers"][0][("qkv" if family == "phi3" else "q")].perm is not None
    assert _teacher_forced(jm, tm) < 1e-4


@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_family_chat_templates_match_jax(family):
    """Each family's model_type picks the JAX package's template (ChatML for
    Qwen, Phi-3's, Gemma's for Gemma and Gemma2, the generic one for
    Starcoder2 and Falcon) and renders a conversation alike."""
    turns = [("system", "be brief"), ("user", "hi <|im_end|> there"),
             ("assistant", "hello"), ("user", "and now?")]
    got = ChatTemplate.detect(model_type=family)
    ref = JTemplate.detect(model_type=family)
    assert got.format.value == ref.format.value
    assert (got.apply([ChatMessage(r, c) for r, c in turns])
            == ref.apply([JMessage(r, c) for r, c in turns]))


@pytest.mark.parametrize("family,quant", SERVED)
def test_executor_greedy_matches_jax(ckpts, family, quant):
    jm, tm = _pair(ckpts, family, quant)
    prompts = [[5, 9, 17], list(range(1, 21))]
    ref = [[e.token_id for e in JExecutor(jm, _Tok(), JApp(model=jm.cfg)).generate(
        p, JGen(max_tokens=8, temperature=0.0))] for p in prompts]
    ex = Executor(tm, _Tok(), AppConfig(model=tm.cfg))
    got = [[e.token_id for e in ex.generate(p, GenerationConfig(max_tokens=8,
                                                                temperature=0.0))]
           for p in prompts]
    assert got == ref and all(len(s) == 8 for s in got)


@pytest.mark.parametrize("family,quant", SERVED)
def test_batch_engine_greedy_matches_jax(ckpts, family, quant):
    """Four greedy requests in two staggered waves: equal streams."""
    jm, tm = _pair(ckpts, family, quant)
    waves = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]], [[42] * 20, list(range(1, 18))]]

    def app(cls, cfg):
        a = cls(model=cfg)
        a.inference.max_seq_len = 64
        a.inference.max_batch_size = 4
        return a

    ref = asyncio.run(_serve(JEngine(jm, _Tok(), app(JApp, jm.cfg)), waves,
                             lambda: JGen(max_tokens=8, temperature=0.0)))
    got = asyncio.run(_serve(BatchEngine(tm, _Tok(), app(AppConfig, tm.cfg)), waves,
                             lambda: GenerationConfig(max_tokens=8, temperature=0.0)))
    assert got == ref and all(len(s) == 8 for s in got)


@pytest.mark.parametrize("family,quant", SERVED)
def test_params_from_jax_match(ckpts, family, quant):
    """The JAX params carried across by ``convert.params_from_jax`` (every
    family key: fc and its biases, LayerNorm biases, sandwich norms, q/k
    norms, qkv biases, Falcon's split q/k/v) give the JAX logits."""
    jm, tm = _pair(ckpts, family, quant)
    conv = params_from_jax(jax.tree.map(np.asarray, jm.params), device=CPU)
    assert _teacher_forced(jm, Model(tm.cfg, conv, torch.float32)) < 1e-4


# ---------------------------------------------------------------------------
# Gemma2's corrections, against transformers
# ---------------------------------------------------------------------------

def _gemma2(tmp_path, window, qpas):
    cfg = tiny_config("gemma2")
    cfg.attention.sliding_window = window
    cfg.attention.query_pre_attn_scalar = qpas
    write_hf_checkpoint(tmp_path, cfg, quant="plain", seed=3, dtype="float32",
                        weight_exp=-4)
    return load_model(tmp_path, dtype="f32", device=CPU)[0], jax_load(tmp_path,
                                                                        dtype="f32")[0]


def _contiguous(tm, toks):
    pos = torch.arange(toks.shape[1])[None]
    return tllama.forward(tm.params, tm.cfg, torch.from_numpy(toks),
                          tm.init_cache(1, 32), pos)[0].numpy()


@pytest.mark.parametrize("window,qpas", [(8, 16), (64, 24), (8, 24)])
def test_gemma2_follows_transformers(tmp_path, window, qpas):
    """A window of 8 at 24 tokens (layer 0 slides, layer 1 attends to all)
    and query_pre_attn_scalar 24 against head_dim 16: the port agrees with
    Gemma2ForCausalLM; the JAX package, which slides every layer and scales
    by head_dim, does not."""
    transformers = pytest.importorskip("transformers")
    tm, jm = _gemma2(tmp_path, window, qpas)
    assert tm.cfg.attention.window_layers == [True, False]
    hf = transformers.Gemma2ForCausalLM.from_pretrained(
        tmp_path, dtype=torch.float32, attn_implementation="eager").eval()
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, 24))
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(_contiguous(tm, toks), ref, rtol=2e-3, atol=2e-3)
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 32),
                       jnp.arange(24, dtype=jnp.int32)[None])
    assert _rel(np.asarray(jl), ref) > 1e-2


def test_gemma2_agrees_with_jax_where_the_faults_cannot_show(tmp_path):
    """Window past the sequence, query_pre_attn_scalar = head_dim: the
    three agree."""
    tm, jm = _gemma2(tmp_path, 64, 16)
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, 24))
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 32),
                       jnp.arange(24, dtype=jnp.int32)[None])
    assert _rel(_contiguous(tm, toks), np.asarray(jl)) < 1e-4


def test_gemma2_paged_decode_keeps_the_corrections(tmp_path):
    """Decode through the paged path (B2's plain version, the layer's window
    and the query_pre_attn_scalar scale passed to it) past the window gives
    the contiguous forward's logits."""
    tm, _ = _gemma2(tmp_path, 8, 24)
    toks = np.random.default_rng(2).integers(0, VOCAB, (1, 24))
    ref = _contiguous(tm, toks)[0]
    blocks = [0, 1, 2]
    table = torch.from_numpy(tpaged.pad_block_table(blocks, 4)[None])
    cache = tpaged.init_paged_cache(2, 4, BS, 2, 16, dtype=torch.float32, device=CPU)
    t0 = 12
    sl = tpaged.compute_slot_mapping(blocks, 0, t0, BS, cache.trash_slot)
    logits, cache = forward_paged(
        tm.params, tm.cfg, torch.from_numpy(toks[:, :t0]), cache,
        torch.arange(t0)[None], torch.as_tensor(np.asarray(sl))[None], table,
        torch.tensor([t0], dtype=torch.int32), device=CPU)
    np.testing.assert_allclose(logits[0].numpy(), ref[:t0], rtol=1e-4, atol=1e-4)
    for p in range(t0, 24):
        sl = tpaged.compute_slot_mapping(blocks, p, 1, BS, cache.trash_slot)
        logits, cache = forward_paged(
            tm.params, tm.cfg, torch.from_numpy(toks[:, p:p + 1]), cache,
            torch.tensor([[p]]), torch.as_tensor(np.asarray(sl))[None], table,
            torch.tensor([p + 1], dtype=torch.int32), device=CPU)
        np.testing.assert_allclose(logits[0, 0].numpy(), ref[p], rtol=1e-4, atol=1e-4,
                                   err_msg=f"position {p}")


def test_layer_windows_from_hf_config():
    """Gemma2 slides on its even layers unless ``layer_types`` says
    otherwise; every other family keeps one window for all layers."""
    base = hf_config(FAMILY_CONFIGS["gemma2"]())
    base.pop("layer_types")
    cfg = universal_from_hf_config(base)
    assert [cfg.attention.layer_window(i) for i in range(4)] == [4096, None, 4096, None]
    assert cfg.attention.score_scale(256) == 256 ** -0.5
    cfg = universal_from_hf_config(dict(base, num_hidden_layers=3, layer_types=[
        "full_attention", "sliding_attention", "sliding_attention"]))
    assert [cfg.attention.layer_window(i) for i in range(3)] == [None, 4096, 4096]
    cfg = universal_from_hf_config(dict(base, query_pre_attn_scalar=144, head_dim=128))
    assert cfg.attention.score_scale(128) == 144 ** -0.5
    for family in ("qwen2", "phi3", "starcoder2"):
        cfg = universal_from_hf_config(hf_config(FAMILY_CONFIGS[family]()))
        assert cfg.attention.window_layers is None
        assert cfg.attention.layer_window(1) == cfg.attention.sliding_window
        assert cfg.attention.score_scale(128) == 128 ** -0.5


@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_published_configs_round_trip(family):
    """Each published-width config survives its own config.json: the loader
    reads back the geometry and the family's switches."""
    cfg = FAMILY_CONFIGS[family]()
    back = universal_from_hf_config(hf_config(cfg))
    assert back.model_type == family and family in SERVED_FAMILIES
    for key in ("vocab_size", "hidden_size", "num_layers", "norm_type", "mlp_type",
                "parallel_residual", "scale_embeddings", "tie_word_embeddings",
                "final_logit_softcapping", "attn_logit_softcapping"):
        assert getattr(back, key) == getattr(cfg, key), key
    assert back.resolved_intermediate_size() == cfg.resolved_intermediate_size()
    for key in ("num_heads", "num_kv_heads", "head_dim", "sliding_window",
                "window_layers", "rope_theta"):
        assert getattr(back.attention, key) == getattr(cfg.attention, key), key
    assert back.attention.score_scale(cfg.attention.head_dim) == \
        cfg.attention.score_scale(cfg.attention.head_dim)


def test_quantized_fused_falcon_qkv_is_refused(tmp_path):
    write_hf_checkpoint(tmp_path, tiny_config("falcon"), quant="awq", group_size=32)
    with pytest.raises(ValueError, match="query_key_value"):
        load_model(tmp_path, device=CPU)


# ---------------------------------------------------------------------------
# Tokenizers of the families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["qwen", "metaspace"])
def test_family_tokenizers_match_jax(tmp_path, style):
    """A Qwen-style byte-level tokenizer.json (its Split regex) and a
    Gemma-style metaspace one with byte fallback: the port reads both as the
    JAX tokenizer does."""
    if style == "qwen":
        write_bpe_tokenizer_json(tmp_path, 1000, seed=2, eos_token="<|im_end|>",
                                 style="qwen")
    else:
        write_metaspace_tokenizer_json(tmp_path, 1000, seed=2)
    jt, tt = jax_tokenizer(tmp_path), load_hf_tokenizer(tmp_path)
    plain = "hello world the quick brown fox jumps over the lazy dogs  twice"
    mixed = plain + " it's 123!\nnew line\r\n\ttab"
    for text in (plain, mixed):
        assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(plain)) == plain
    assert (tt.bos_token_id, tt.eos_token_id) == (jt.bos_token_id, jt.eos_token_id)
    assert tt.eos_token_id == (999 if style == "qwen" else 1)
