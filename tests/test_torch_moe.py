"""Port parity: the mixture-of-experts FFN of blazr_tpu_torch
(``models/moe.py``) and the MoE families that ride the llama forward
(Mixtral, Qwen2-MoE, Qwen3-MoE) against blazr_tpu on the CPU, and against
transformers where the JAX package is wrong.

Inputs are made from numpy seeds; tiny checkpoints (hidden 64, 2 layers, 4
experts of 32, top-2) are written to disk by
``utils.synthetic.write_hf_checkpoint`` (plain f32, or AWQ-INT4 with groups
of 32) and read by both packages' ``load_model``.

Tolerances: routing indices equal and weights within 1e-6 (the same f32
softmax or sigmoid); the FFN within 1e-5 of its largest output and the
logits within 1e-4 of theirs (f32 arithmetic in another order); the prefill
(routed rows) and decode (all rows) forms within 1e-6 (the same sums; only
a matmul's row count differs); transformers at 1e-3, the tolerance
``tests/test_mla_moe.py:144`` holds the JAX package to; greedy streams
exactly equal."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.config.model_config import MoeConfig as JMoe
from blazr_tpu.config.model_config import \
    universal_from_hf_config as jax_universal_from_hf_config
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.kvcache import paged as jpaged
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.models import moe as jmoe
from blazr_tpu.models.llama_paged import forward_paged as jax_forward_paged
from blazr_tpu.quant import qtensor as jqt
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.model_config import (MoeConfig, SsmConfig, UniversalConfig,
                                                 universal_from_hf_config)
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.formats import SafeTensorsReader, write_safetensors
from blazr_tpu_torch.kvcache import paged as tpaged
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models import llama as tllama
from blazr_tpu_torch.models import moe as tmoe
from blazr_tpu_torch.models.llama_paged import forward_paged
from blazr_tpu_torch.models.registry import SERVED_FAMILIES
from blazr_tpu_torch.quant import qtensor as tqt
from blazr_tpu_torch.utils.synthetic import MOE_CONFIGS, hf_config, write_hf_checkpoint

from test_torch_engine import _Tok, _serve

CPU = "cpu"
VOCAB = 256
BS = 8
H = 64


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


# ---------------------------------------------------------------------------
# route, moe_ffn and the two dispatch forms, on params made from a seed
# ---------------------------------------------------------------------------

ROUTES = {
    "softmax, norm_topk_prob": dict(num_experts=16, experts_per_tok=4, norm_topk_prob=True),
    "softmax": dict(num_experts=16, experts_per_tok=4, norm_topk_prob=False),
    "sigmoid, bias, groups": dict(num_experts=16, experts_per_tok=4, norm_topk_prob=True,
                                  scoring_func="sigmoid", n_group=4, topk_group=2,
                                  routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_matches_jax(name):
    """Softmax top-k with and without renormalizing, and DeepSeek-V3's
    sigmoid scores with the correction bias, group-limited routing and the
    routed scaling factor: the same experts, the same weights."""
    kw = ROUTES[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, H), dtype=np.float32)
    router = (rng.standard_normal((H, kw["num_experts"])) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(kw["num_experts"]) * 0.1).astype(np.float32) \
        if kw.get("scoring_func") == "sigmoid" else None
    ji, jw = jmoe.route(jnp.asarray(x), jnp.asarray(router), JMoe(**kw),
                        None if bias is None else jnp.asarray(bias))
    ti, tw = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), MoeConfig(**kw),
                        None if bias is None else torch.from_numpy(bias))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    if kw.get("n_group", 1) > 1:                # every chosen expert in a kept group
        groups = ti.numpy() // (kw["num_experts"] // kw["n_group"])
        assert all(len(set(g)) <= kw["topk_group"] for g in groups)


E, I_MOE = 4, 32


def _moe_params(quant: bool, shared: bool, seed: int = 3) -> dict:
    """The JAX package's MoE params: a router, dense or AWQ-INT4 (groups of
    32) expert stacks, and DeepSeek-named shared experts."""
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), 3 * E + 3)

    def dense(*shape):
        return jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * 0.1)

    def awq(key, k, n):
        from blazr_tpu.utils.synthetic import _rand_awq_qt

        return _rand_awq_qt(key, k, n, group_size=32)

    p = {"router": dense(H, E), "correction_bias": None}
    if quant:
        p["experts_gate"] = jqt.stack_quant([awq(keys[e], H, I_MOE) for e in range(E)])
        p["experts_up"] = jqt.stack_quant([awq(keys[E + e], H, I_MOE) for e in range(E)])
        p["experts_down"] = jqt.stack_quant([awq(keys[2 * E + e], I_MOE, H)
                                             for e in range(E)])
    else:
        p.update(experts_gate=dense(E, H, I_MOE), experts_up=dense(E, H, I_MOE),
                 experts_down=dense(E, I_MOE, H))
    if shared:
        if quant:
            p.update(shared_gate=awq(keys[-3], H, 64), shared_up=awq(keys[-2], H, 64),
                     shared_down=awq(keys[-1], 64, H))
        else:
            p.update(shared_gate=dense(H, 64), shared_up=dense(H, 64),
                     shared_down=dense(64, H))
    return p


def _to_port(jp: dict) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, jp), device=CPU)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "awq"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared_experts"])
@pytest.mark.parametrize("t", [1, 6], ids=["decode", "prefill"])
def test_moe_ffn_matches_jax(quant, shared, t):
    """The FFN over [B, T, H] (T = 1: every expert over every row; T = 6:
    each expert over its routed rows) against the JAX scan or einsum."""
    jp = _moe_params(quant, shared)
    kw = dict(num_experts=E, experts_per_tok=2, norm_topk_prob=True)
    x = np.random.default_rng(4).standard_normal((3, t, H), dtype=np.float32)
    ref = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jp, JMoe(**kw)))
    got = tmoe.moe_ffn(torch.from_numpy(x), _to_port(jp), MoeConfig(**kw)).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-5


def test_prefill_and_decode_forms_agree(monkeypatch):
    """The same 18 rows as [18, 1, H] (decode: 4 experts × 18 rows) and as
    [1, 18, H] (prefill: each expert over its routed rows only, 18 × 2 rows
    in all): equal outputs, and the prefill form skips every row an expert
    was not chosen for."""
    tp = _to_port(_moe_params(True, True, seed=5))
    moe = MoeConfig(num_experts=E, experts_per_tok=2, norm_topk_prob=True)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((18, H),
                                                                  dtype=np.float32))
    rows: list[int] = []
    real = tmoe._expert_mlp

    def counting(xe, *w):
        rows.append(xe.shape[0])
        return real(xe, *w)

    monkeypatch.setattr(tmoe, "_expert_mlp", counting)
    dec = tmoe.moe_ffn(x[:, None, :], tp, moe)[:, 0]
    dec_rows, rows[:] = list(rows), []
    pre = tmoe.moe_ffn(x[None], tp, moe)[0]
    assert dec_rows == [18] * E + [18]                   # the experts, the shared one
    assert sum(rows[:-1]) == 18 * 2 and rows[-1] == 18 and len(rows) <= E + 1
    assert _rel(pre.numpy(), dec.numpy()) < 1e-6


def test_stacked_weights_carry_over_bit_exact(tmp_path):
    """A Mixtral AWQ checkpoint read by both loaders: the stacked expert
    planes (words, scales, mins) are equal bit for bit, as are the JAX
    stacks carried over by params_from_jax, and both dequantize alike."""
    write_hf_checkpoint(tmp_path, _tiny("mixtral"), quant="awq", group_size=32, seed=2,
                        dtype="float32", weight_exp=-4)
    jm, _ = jax_load(tmp_path, dtype="f32")
    tm, _ = load_model(tmp_path, dtype="f32", device=CPU)
    conv = _to_port(jm.params["layers"][1]["moe"])
    for key in ("experts_gate", "experts_up", "experts_down"):
        jw, tw = jm.params["layers"][1]["moe"][key], tm.params["layers"][1]["moe"][key]
        assert tqt.is_stacked(tw) and tw.qweight.shape[0] == E
        for got in (tw, conv[key]):
            np.testing.assert_array_equal(got.qweight.numpy().view(np.uint32),
                                          np.asarray(jw.qweight).view(np.uint32))
            np.testing.assert_array_equal(got.scales.numpy(), np.asarray(jw.scales))
            np.testing.assert_array_equal(got.mins.numpy(), np.asarray(jw.mins))
        np.testing.assert_array_equal(tqt.dequantize_stack_np(tw),
                                      jqt.dequantize_stack_np(jw))
        np.testing.assert_array_equal(tqt.dequantize(tqt.expert_slice(tw, 2)).numpy(),
                                      tqt.dequantize_stack_np(tw)[2])


def test_quant_compute_leaves_stacked_experts_on_b1():
    """Under w4a8, w8a8 and w4a8-prefill only the attention projections are
    tagged for B3 (w8a8 widens them); stacked experts stay as they are, as
    in the JAX package."""
    from blazr_tpu_torch.quant.qtensor import apply_quant_compute
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    params = synth_llama_params(_tiny("qwen2_moe"), group_size=32, dtype=torch.float32,
                                device=CPU)
    for mode in ("w4a8", "w8a8", "w4a8-prefill"):
        out = apply_quant_compute(params, mode)
        layer = out["layers"][0]
        assert layer["qkv"].act_quant and layer["o"].act_quant
        assert layer["moe"]["shared_gate"].act_quant
        for key in ("experts_gate", "experts_up", "experts_down"):
            st = layer["moe"][key]
            assert st is params["layers"][0]["moe"][key] and not st.act_quant
        jp = jqt.apply_quant_compute(_moe_params(True, True), mode)
        assert jp["shared_gate"].act_quant and not jp["experts_gate"].act_quant


# ---------------------------------------------------------------------------
# The families, from tiny checkpoints on disk
# ---------------------------------------------------------------------------

def _tiny(family: str, shared: bool = True) -> UniversalConfig:
    """The family's published config cut to hidden 64, 2 layers, 4 heads of
    16 (2 kv heads), 4 experts of 32, top-2; Qwen2-MoE's shared expert 64
    wide."""
    cfg = MOE_CONFIGS[family]()
    att = dataclasses.replace(cfg.attention, num_heads=4, num_kv_heads=2, head_dim=16)
    moe = dataclasses.replace(cfg.moe, num_experts=E, experts_per_tok=2,
                              intermediate_size=I_MOE,
                              shared_expert_intermediate_size=(
                                  64 if cfg.moe.shared_expert_intermediate_size
                                  and shared else None))
    return dataclasses.replace(cfg, vocab_size=VOCAB, hidden_size=H, num_layers=2,
                               max_seq_len=128, intermediate_size=96, attention=att,
                               moe=moe)


# Mixtral and Qwen3-MoE, which the JAX package computes as transformers does.
FAMILIES = ["mixtral", "qwen3_moe"]
CASES = [(f, q) for f in FAMILIES for q in ("plain", "awq")]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    out = {}
    for i, (family, quant) in enumerate(CASES):
        d = root / f"{family}-{quant}"
        write_hf_checkpoint(d, _tiny(family), quant=quant, group_size=32, seed=20 + i,
                            dtype="float32", weight_exp=-4)
        out[(family, quant)] = d
    return out


def _pair(d):
    jm, _ = jax_load(d, dtype="f32")
    tm, _ = load_model(d, dtype="f32", device=CPU)
    return jm, tm


def _teacher_forced(jm, tm, steps=3, t0=12):
    """Prefill t0 tokens, then ``steps`` single-token steps, through both
    contiguous forwards; the worst relative logit error."""
    toks = np.random.default_rng(7).integers(0, VOCAB, (1, t0 + steps))
    jc, tc = jm.init_cache(1, 32), tm.init_cache(1, 32)
    worst = 0.0
    for lo, hi in [(0, t0)] + [(t0 + i, t0 + i + 1) for i in range(steps)]:
        tok, pos = toks[:, lo:hi], np.arange(lo, hi)[None]
        jl, jc = jm.forward(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tllama.forward(tm.params, tm.cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        jl = np.asarray(jl)
        worst = max(worst, _rel(tl.numpy(), jl))
        assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
    return worst


def _paged_steps(fwd, params, cfg, cache, lib, steps=4):
    """Two sequences (7 and 12 tokens) prefilled in one padded batch, then
    decode steps fed the port's greedy tokens; the logits of each step."""
    lens, blocks, mb = [7, 12], [[3, 0, 5], [1, 6, 2]], 4
    tables = np.stack([tpaged.pad_block_table(b, mb) for b in blocks])
    trash = 8 * BS
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
    out = []
    for k in range(steps):
        tok, pos, sl, seq_lens, last = step
        logits, cache = fwd(params, cfg, lib(tok), cache, lib(pos), lib(sl), lib(tables),
                            lib(seq_lens), None if last is None else lib(last))
        logits = np.asarray(logits)
        out.append(logits)
        nxt = logits[:, -1].argmax(-1).astype(np.int64)[:, None]
        pos = np.array([[n + k] for n in lens], np.int64)
        sl = np.stack([tpaged.compute_slot_mapping(blocks[i], int(pos[i, 0]), 1, BS, trash)
                       for i in range(2)]).astype(np.int64)
        step = (nxt, pos, sl, (pos[:, 0] + 1).astype(np.int32), None)
    return out


def _port_paged(tm):
    att = tm.cfg.attention
    cache = tpaged.init_paged_cache(2, 8, BS, att.kv_heads(), 16, dtype=torch.float32,
                                    device=CPU)

    def fwd(params, cfg, tok, cache, pos, sl, tables, seq_lens, last):
        return forward_paged(params, cfg, tok, cache, pos, sl, tables, seq_lens,
                             last_idx=last, device=CPU)
    return _paged_steps(fwd, tm.params, tm.cfg, cache, torch.from_numpy)


def _jax_paged(jm):
    att = jm.cfg.attention
    cache = jpaged.init_paged_cache(2, 8, BS, att.kv_heads(), 16, dtype=jnp.float32)

    def fwd(params, cfg, tok, cache, pos, sl, tables, seq_lens, last):
        return jax_forward_paged(params, cfg, tok, cache, pos, sl, tables, seq_lens,
                                 last_idx=last)
    return _paged_steps(fwd, jm.params, jm.cfg, cache, jnp.asarray)


@pytest.mark.parametrize("family,quant", CASES)
def test_contiguous_forward_matches_jax(ckpts, family, quant):
    """Both loaders read the checkpoint alike (the MoE config, the stacked
    experts, Qwen3-MoE's QK norms) and the contiguous forwards agree over a
    12-token prefill (routed rows) and three decode steps (all rows)."""
    jm, tm = _pair(ckpts[(family, quant)])
    assert tm.cfg.model_type == jm.cfg.model_type == family
    assert tm.cfg.moe.norm_topk_prob == jm.cfg.moe.norm_topk_prob
    assert ({k for k, v in tm.params["layers"][0].items() if v is not None}
            == {k for k, v in jm.params["layers"][0].items() if v is not None})
    assert ({k for k, v in tm.params["layers"][0]["moe"].items() if v is not None}
            == {k for k, v in jm.params["layers"][0]["moe"].items() if v is not None})
    assert _teacher_forced(jm, tm) < 1e-4


@pytest.mark.parametrize("family,quant", CASES)
def test_paged_forward_matches_jax(ckpts, family, quant):
    """Two sequences prefilled in one padded batch, then three decode steps
    through B2's plain version: the port's paged logits equal the JAX
    package's."""
    jm, tm = _pair(ckpts[(family, quant)])
    for k, (got, ref) in enumerate(zip(_port_paged(tm), _jax_paged(jm))):
        assert _rel(got, ref) < 1e-4, f"step {k}"


def _hf(family, d):
    import transformers

    cls = {"mixtral": transformers.MixtralForCausalLM,
           "qwen2_moe": transformers.Qwen2MoeForCausalLM,
           "qwen3_moe": transformers.Qwen3MoeForCausalLM}[family]
    return cls.from_pretrained(d, dtype=torch.float32, attn_implementation="eager").eval()


def _hf_logits(hf, toks):
    with torch.no_grad():
        return hf(torch.from_numpy(toks)).logits.numpy()


def _both_forwards(tm, toks):
    """The port's logits over ``toks`` [1, T] through the contiguous forward
    and through a paged prefill."""
    t = toks.shape[1]
    cont = tllama.forward(tm.params, tm.cfg, torch.from_numpy(toks), tm.init_cache(1, 32),
                          torch.arange(t)[None])[0].numpy()
    att = tm.cfg.attention
    cache = tpaged.init_paged_cache(2, 4, BS, att.kv_heads(), 16, dtype=torch.float32,
                                    device=CPU)
    blocks = [2, 0, 3]
    sl = tpaged.compute_slot_mapping(blocks, 0, t, BS, cache.trash_slot)
    paged = forward_paged(tm.params, tm.cfg, torch.from_numpy(toks), cache,
                          torch.arange(t)[None], torch.as_tensor(np.asarray(sl))[None],
                          torch.from_numpy(tpaged.pad_block_table(blocks, 4)[None]),
                          torch.tensor([t], dtype=torch.int32), device=CPU)[0].numpy()
    return cont, paged


@pytest.mark.parametrize("family", FAMILIES)
def test_families_match_transformers(ckpts, family):
    """Mixtral and Qwen3-MoE (norm_topk_prob true), read from the same
    checkpoint by transformers: both of the port's forwards within 1e-3."""
    pytest.importorskip("transformers")
    d = ckpts[(family, "plain")]
    tm, _ = load_model(d, dtype="f32", device=CPU)
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, 20))
    ref = _hf_logits(_hf(family, d), toks)
    for got in _both_forwards(tm, toks):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def _qwen2_moe(tmp_path, zero_shared: bool = False, **cfg_over):
    cfg = dataclasses.replace(_tiny("qwen2_moe"), **cfg_over)
    write_hf_checkpoint(tmp_path, cfg, quant="plain", seed=9, dtype="float32",
                        weight_exp=-4)
    if zero_shared:
        f = tmp_path / "model.safetensors"
        with SafeTensorsReader(f) as r:
            tensors = {n: np.array(r.load_numpy(n)) for n in r.tensor_names()}
        for n in tensors:
            if ".shared_expert." in n:
                tensors[n] = np.zeros_like(tensors[n])
        write_safetensors(f, tensors)
    return load_model(tmp_path, dtype="f32", device=CPU)[0]


def test_qwen2_moe_shared_expert_follows_transformers(tmp_path):
    """Qwen2-MoE adds its shared expert scaled by sigmoid(shared_expert_gate
    x): the port agrees with Qwen2MoeForCausalLM on both forwards; the JAX
    package, which drops the shared expert, does not."""
    pytest.importorskip("transformers")
    tm = _qwen2_moe(tmp_path)
    assert tm.cfg.moe.shared_expert_intermediate_size == 64
    assert tm.params["layers"][0]["moe"]["shared_expert_gate"].shape == (H, 1)
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, 20))
    ref = _hf_logits(_hf("qwen2_moe", tmp_path), toks)
    for got in _both_forwards(tm, toks):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    jm, _ = jax_load(tmp_path, dtype="f32")
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 32),
                       jnp.arange(20, dtype=jnp.int32)[None])
    assert _rel(np.asarray(jl), ref) > 1e-2


def test_qwen2_moe_agrees_with_jax_without_shared_expert(tmp_path):
    """With the shared expert's weights zero the deviation cannot show: the
    port and the JAX package agree on both forwards."""
    tm = _qwen2_moe(tmp_path, zero_shared=True)
    jm, _ = jax_load(tmp_path, dtype="f32")
    assert tm.cfg.moe.norm_topk_prob is jm.cfg.moe.norm_topk_prob is False
    assert _teacher_forced(jm, tm) < 1e-4
    for got, ref in zip(_port_paged(tm), _jax_paged(jm)):
        assert _rel(got, ref) < 1e-4


def test_dense_layers_by_weights_follow_transformers(tmp_path):
    """A Qwen2-MoE checkpoint saved by transformers with ``mlp_only_layers
    [0]``: layer 0 loads as a dense MLP, layer 1 as MoE, by their weights,
    and both forwards match Qwen2MoeForCausalLM."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    hf = transformers.Qwen2MoeForCausalLM(transformers.Qwen2MoeConfig(
        vocab_size=VOCAB, hidden_size=H, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_experts=E,
        num_experts_per_tok=2, moe_intermediate_size=I_MOE,
        shared_expert_intermediate_size=64, mlp_only_layers=[0],
        max_position_embeddings=128, tie_word_embeddings=False)).eval()
    hf.save_pretrained(tmp_path, safe_serialization=True)
    tm, _ = load_model(tmp_path, dtype="f32", device=CPU)
    assert "moe" not in tm.params["layers"][0] and tm.params["layers"][0]["gate"] is not None
    assert "moe" in tm.params["layers"][1]
    toks = np.random.default_rng(3).integers(0, VOCAB, (1, 16))
    ref = _hf_logits(hf, toks)
    for got in _both_forwards(tm, toks):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

SERVED = [(f, "awq") for f in FAMILIES]


@pytest.mark.parametrize("family,quant", SERVED)
def test_executor_greedy_matches_jax(ckpts, family, quant):
    jm, tm = _pair(ckpts[(family, quant)])
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
    """Four greedy requests in two staggered waves through the paged engine
    (its decode rounds run every expert over the padded batch, its prefill
    groups the routed rows): equal streams."""
    jm, tm = _pair(ckpts[(family, quant)])
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


# ---------------------------------------------------------------------------
# Configs, and what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(MOE_CONFIGS))
def test_published_moe_configs_round_trip(family):
    """Each published-width MoE config survives its own config.json and
    names a served family."""
    cfg = MOE_CONFIGS[family]()
    back = universal_from_hf_config(hf_config(cfg))
    assert back.model_type == family and family in SERVED_FAMILIES
    for key in ("vocab_size", "hidden_size", "num_layers"):
        assert getattr(back, key) == getattr(cfg, key), key
    for key in ("num_heads", "num_kv_heads", "head_dim", "rope_theta", "qkv_bias",
                "sliding_window"):
        assert getattr(back.attention, key) == getattr(cfg.attention, key), key
    for key in ("num_experts", "experts_per_tok", "intermediate_size",
                "shared_expert_intermediate_size", "norm_topk_prob"):
        assert getattr(back.moe, key) == getattr(cfg.moe, key), key


@pytest.mark.parametrize("model_type,arch,port,jax_default", [
    ("mixtral", "MixtralForCausalLM", True, True),
    ("qwen2_moe", "Qwen2MoeForCausalLM", False, True),
    ("qwen3_moe", "Qwen3MoeForCausalLM", False, True)])
def test_norm_topk_prob_default_follows_transformers(model_type, arch, port, jax_default):
    """Without ``norm_topk_prob`` in config.json transformers renormalizes
    Mixtral's top-k weights and not Qwen-MoE's; the JAX package takes True
    for all three. The architecture name alone picks the family."""
    base = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_local_experts" if model_type == "mixtral" else "num_experts": 4,
            "shared_expert_intermediate_size": 64}
    for raw in (dict(base, model_type=model_type), dict(base, architectures=[arch])):
        cfg = universal_from_hf_config(raw)
        assert cfg.model_type == model_type
        assert cfg.moe.norm_topk_prob is port
    assert jax_universal_from_hf_config(
        dict(base, model_type=model_type)).moe.norm_topk_prob is jax_default
    assert universal_from_hf_config(dict(base, model_type=model_type,
                                         norm_topk_prob=True)).moe.norm_topk_prob
    assert universal_from_hf_config(
        dict(base, model_type="qwen2_moe")).moe.shared_expert_intermediate_size == 64


@pytest.mark.parametrize("kind", ["mla", "mamba2", "hybrid"])
def test_unserved_families_raise_item_11(kind):
    """MLA, Mamba2 and hybrid models are served now (tests/test_torch_mla.py,
    test_torch_mamba2.py, test_torch_hybrid.py); what stays of item 11 is the
    Mamba3 mixer, which raises naming it for each kind of recurrent config,
    and a vision tower raises naming item 12."""
    cfg = _tiny("mixtral")
    if kind == "mla":
        cfg = dataclasses.replace(cfg, model_type="deepseek", attention=dataclasses.replace(
            cfg.attention, kv_latent_dim=32, d_rope=16, d_nope=16, v_head_dim=16))
    elif kind == "mamba2":
        cfg = dataclasses.replace(cfg, model_type="mamba2", attention=None,
                                  ssm=SsmConfig(), moe=None)
    else:
        cfg = dataclasses.replace(cfg, hybrid_layers=["attention", "mamba2"],
                                  ssm=SsmConfig())
    tllama.check_config(cfg)
    if kind == "mla":
        cfg = dataclasses.replace(cfg, hybrid_layers=["mamba2", "attention"],
                                  ssm=SsmConfig())
    mamba3 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, variant="mamba3"))
    with pytest.raises(NotImplementedError, match="item 11"):
        tllama.check_config(mamba3)
    from blazr_tpu_torch.config.model_config import VisionConfig

    with pytest.raises(NotImplementedError, match="item 12"):
        tllama.check_config(dataclasses.replace(cfg, vision=VisionConfig()))


@pytest.mark.parametrize("what,item", [("offload", 12), ("ep", 13)])
def test_offload_and_expert_parallelism_raise(what, item):
    tp = _to_port(_moe_params(False, False))
    moe = MoeConfig(num_experts=E, experts_per_tok=2)
    if what == "offload":
        tp["resident_ids"] = torch.arange(2)
    else:
        moe.use_ep = True
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tmoe.moe_forward(torch.zeros(1, 1, H), tp, moe)


def test_pre_stacked_expert_names_raise(tmp_path):
    """GGUF-style pre-stacked expert tensors ([E, out, in] under
    ``mlp.experts.{gate,up,down}_proj``) load: layer 0's experts restacked
    so give the per-expert checkpoint's params and logits exactly. (They
    raised until GGUF was ported; tests/test_torch_gguf.py covers the
    quantized stacks of a GGUF file.)"""
    cfg = _tiny("qwen3_moe")
    write_hf_checkpoint(tmp_path / "a", cfg, quant="plain", dtype="float32")
    write_hf_checkpoint(tmp_path / "b", cfg, quant="plain", dtype="float32")
    f = tmp_path / "b" / "model.safetensors"
    with SafeTensorsReader(f) as r:
        tensors = {n: np.array(r.load_numpy(n)) for n in r.tensor_names()}
    p = "model.layers.0.mlp.experts."
    for part in ("gate_proj", "up_proj", "down_proj"):
        tensors[p + part + ".weight"] = np.stack(
            [tensors.pop(f"{p}{e}.{part}.weight") for e in range(E)])
    write_safetensors(f, tensors)
    a, _ = load_model(tmp_path / "a", dtype="f32", device=CPU)
    b, _ = load_model(tmp_path / "b", dtype="f32", device=CPU)
    for key in ("experts_gate", "experts_up", "experts_down"):
        assert torch.equal(a.params["layers"][0]["moe"][key],
                           b.params["layers"][0]["moe"][key])
    tokens = torch.tensor([[3, 1, 4, 1, 5, 9]])
    outs = []
    for m in (a, b):
        cache = m.init_cache(1, 16)
        logits, _ = m.forward(tokens, cache, torch.arange(6)[None])
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])
