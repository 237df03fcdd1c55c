"""Port parity: the contiguous llama forward, the single-stream Executor,
generate_text, perplexity and the w4a8-prefill BatchEngine of
blazr_tpu_torch against blazr_tpu on the CPU.

The geometry (hidden 256, intermediate 512, heads 4/2 x 64, vocab 256, AWQ
group 128) is one the JAX tiles accept, so under the int8 modes both
packages take kernel B3 (the JAX one in interpret mode: its int8 route runs
on the CPU only under BLAZR_TPU_FORCE_PALLAS_QUANT=1, otherwise the
reference would silently compute w4a16).

Tolerances: greedy token streams exactly equal; f32 logits within 1e-4 of
their largest magnitude where both sides run the same arithmetic in another
order, 2e-3 under w8a8, where a float32 rounding difference upstream can move
one activation by one int8 step."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.config.model_config import AttentionConfig as JAttn
from blazr_tpu.config.model_config import UniversalConfig as JCfg
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.kvcache.contiguous import init_kv_cache as jax_init_cache
from blazr_tpu.models import llama as jllama
from blazr_tpu.models.registry import Model as JModel
from blazr_tpu.quant import qtensor as jq
from blazr_tpu.quant.pallas import int_matmul as im
from blazr_tpu.utils.ppl import perplexity as jax_perplexity
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.engine.generate_text import collect_generation, stream_generation
from blazr_tpu_torch.engine.types import FinishReason
from blazr_tpu_torch.kvcache.contiguous import init_kv_cache
from blazr_tpu_torch.models import llama as tllama
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.quant import matmul as tm
from blazr_tpu_torch.utils.ppl import perplexity

from test_torch_engine import _Tok, _serve

CPU = "cpu"
_GEO = dict(model_type="llama", vocab_size=256, hidden_size=256, num_layers=2,
            max_seq_len=512, intermediate_size=512)
_ATT = dict(num_heads=4, num_kv_heads=2, head_dim=64)


def _cfgs(window=None):
    att = dict(_ATT, sliding_window=window)
    return (JCfg(attention=JAttn(**att), **_GEO),
            UniversalConfig(attention=AttentionConfig(**att), **_GEO))


def _jax_params(jcfg, seed=0, mode=None):
    jp = jax_synth(jcfg, quant="awq", dtype=jnp.float32, group_size=128, seed=seed)
    rng = np.random.default_rng(seed)
    for layer in jp["layers"]:                # norms of ones hide wrong paths
        for k in ("input_norm", "post_norm"):
            layer[k] = jnp.asarray(1 + 0.1 * rng.standard_normal(
                layer[k].shape).astype(np.float32))
    return jq.apply_quant_compute(jp, mode) if mode else jp


def _pair(window=None, seed=0, mode=None):
    """(JAX model, port model) on bit-identical weights."""
    jcfg, tcfg = _cfgs(window)
    jp = _jax_params(jcfg, seed, mode)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device=CPU)
    return (JModel(jcfg, jp, jnp.float32, jllama.forward),
            Model(tcfg, tp, torch.float32))


def _apps(**inf):
    out = []
    for cls, cfg in ((JApp, None), (AppConfig, None)):
        a = cls()
        for k, v in inf.items():
            setattr(a.inference, k, v)
        out.append(a)
    return out


def _streams(ex, prompts, gen):
    return [[t.token_id for t in ex.generate(p, gen())] for p in prompts]


_PROMPTS = [[5, 9, 17], list(range(1, 21)), [7, 3] * 20]


def _tf_inputs(rng, t0=16, steps=4):
    toks = rng.integers(0, 256, t0 + steps)
    out = [(toks[None, :t0], np.arange(t0)[None, :], np.array([t0]))]
    out += [(toks[None, t0 + i:t0 + i + 1], np.array([[t0 + i]]), np.array([t0 + i + 1]))
            for i in range(steps)]
    return out


def _teacher_forced(jm, tm_, kv_quant=False, kv_dtype="int8", steps=4, window=None):
    jc = jax_init_cache(2, 1, 64, 2, 64, dtype=jnp.float32, quantized=kv_quant,
                        kv_dtype=kv_dtype)
    tc = init_kv_cache(2, 1, 64, 2, 64, dtype=torch.float32, quantized=kv_quant,
                       kv_dtype=kv_dtype, device=CPU)
    worst = 0.0
    for tok, pos, sl in _tf_inputs(np.random.default_rng(1), steps=steps):
        jl, jc = jllama.forward(jm.params, jm.cfg, jnp.asarray(tok, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32), jnp.asarray(sl, jnp.int32))
        tl, tc = tllama.forward(tm_.params, tm_.cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos), torch.from_numpy(sl))
        jl = np.asarray(jl)
        worst = max(worst, float(np.abs(tl.numpy() - jl).max() / np.abs(jl).max()))
        assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    return worst


@pytest.mark.parametrize("window,kv", [(None, None), (8, None), (None, "int8"),
                                       (None, "int4")])
def test_contiguous_forward_matches_jax(window, kv):
    """Teacher-forced prefill + 4 decode steps, w4a16, with and without a
    sliding window and with int8/int4 KV: logits within 1e-4."""
    jm, tmodel = _pair(window)
    assert _teacher_forced(jm, tmodel, kv_quant=kv is not None,
                           kv_dtype=kv or "int8", window=window) < 1e-4


def test_contiguous_forward_w8a8_matches_jax(monkeypatch):
    """w8a8 (widened weights, B3 on every matmul): logits within 2e-3."""
    monkeypatch.setenv("BLAZR_TPU_FORCE_PALLAS_QUANT", "1")
    calls = []
    real = im.quant_matmul_int8mxu
    monkeypatch.setattr(im, "quant_matmul_int8mxu",
                        lambda x, q: calls.append(1) or real(x, q))
    jm, tmodel = _pair(mode="w8a8")
    assert _teacher_forced(jm, tmodel) < 2e-3
    assert calls, "the JAX reference did not take its int8 route"


def test_executor_w4a16_greedy_matches_jax():
    jm, tmodel = _pair(seed=1)
    ja, ta = _apps()
    ref = _streams(JExecutor(jm, _Tok(), ja), _PROMPTS,
                   lambda: JGen(max_tokens=10, temperature=0.0))
    got = _streams(Executor(tmodel, _Tok(), ta), _PROMPTS,
                   lambda: GenerationConfig(max_tokens=10, temperature=0.0))
    assert got == ref and all(len(s) == 10 for s in got)


@pytest.mark.parametrize("seed", [2, 3])
def test_executor_w8a8_greedy_matches_jax(seed, monkeypatch):
    """quant_compute=w8a8 on both executors: the params are widened in place
    and the greedy streams are equal on these seeds."""
    monkeypatch.setenv("BLAZR_TPU_FORCE_PALLAS_QUANT", "1")
    jm, tmodel = _pair(seed=seed)
    ja, ta = _apps(quant_compute="w8a8")
    jex = JExecutor(jm, _Tok(), ja)
    tex = Executor(tmodel, _Tok(), ta)
    qkv = tmodel.params["layers"][0]["qkv"]
    assert qkv.bits == 8 and qkv.act_quant
    calls = []
    real = tm.qmm_int8
    monkeypatch.setattr(tm, "qmm_int8", lambda x, *a, **k: calls.append(1) or real(x, *a, **k))
    ref = _streams(jex, _PROMPTS[:2], lambda: JGen(max_tokens=8, temperature=0.0))
    got = _streams(tex, _PROMPTS[:2], lambda: GenerationConfig(max_tokens=8,
                                                               temperature=0.0))
    assert got == ref
    # 4 projections x 2 layers per forward; 2 prompts x 8 forwards.
    assert len(calls) == 8 * 2 * 8


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_executor_quantized_kv_matches_jax(kv):
    jm, tmodel = _pair(seed=4)
    ja, ta = _apps(kv_cache_dtype=kv)
    ref = _streams(JExecutor(jm, _Tok(), ja), _PROMPTS[1:],
                   lambda: JGen(max_tokens=8, temperature=0.0))
    ex = Executor(tmodel, _Tok(), ta)
    got = _streams(ex, _PROMPTS[1:], lambda: GenerationConfig(max_tokens=8,
                                                              temperature=0.0))
    assert got == ref
    cache = ex._init_cache(1)
    assert cache.quantized and cache.qmax == (7.0 if kv == "int4" else 127.0)
    # int4 packs two values a byte: half of int8's KV bytes (ROADMAP §C).
    int8 = tmodel.init_cache(1, ex.capacity, kv_quant=True, kv_dtype="int8")
    nbytes = sum(t.numel() * t.element_size() for t in (cache.k, cache.v))
    assert nbytes == sum(t.numel() * t.element_size()
                         for t in (int8.k, int8.v)) // (2 if kv == "int4" else 1)


def test_session_reuse_matches_fresh_run(monkeypatch):
    """With prefix_cache a prompt that extends the previous session reuses
    its KV (prefill starts past the shared prefix) and gives the tokens of
    a fresh run."""
    _, tmodel = _pair(seed=5)
    _, ta = _apps(prefix_cache=True)
    ex = Executor(tmodel, _Tok(), ta)
    gen = lambda: GenerationConfig(max_tokens=6, temperature=0.0)  # noqa: E731
    first = list(range(10, 40))
    out1 = _streams(ex, [first], gen)[0]
    second = first + out1 + [3, 4, 5]
    starts = []
    real = ex.prefill
    monkeypatch.setattr(ex, "prefill", lambda c, p, start_pos=0:
                        starts.append(start_pos) or real(c, p, start_pos))
    out2 = _streams(ex, [second], gen)[0]
    assert starts == [len(first) + len(out1) - 1]
    _, fresh_model = _pair(seed=5)
    assert out2 == _streams(Executor(fresh_model, _Tok(), _apps()[1]), [second], gen)[0]


def test_prefill_chunks_match_one_pass():
    _, tmodel = _pair(seed=6)
    prompt = list(range(1, 60))
    gen = lambda: GenerationConfig(max_tokens=5, temperature=0.0)  # noqa: E731
    one = _streams(Executor(tmodel, _Tok(), _apps()[1]), [prompt], gen)
    chunked = _streams(Executor(tmodel, _Tok(), _apps(prefill_chunk_size=16)[1]),
                       [prompt], gen)
    assert one == chunked


def test_executor_refuses_what_it_does_not_serve():
    """A mesh is served (item 13; tests/test_torch_parallel.py runs its
    ranks), but needs a world of its ranks: without one the executor says
    how to start it. Under a mesh a LoRA adapter raises the JAX Executor's
    ``ValueError`` (blazr_tpu/engine/executor.py:572-574), naming no queue
    item."""
    _, tmodel = _pair()
    with pytest.raises(RuntimeError, match="init_distributed"):
        Executor(tmodel, _Tok(), _apps(tensor_parallel_size=2)[1])
    import blazr_tpu_torch.parallel.tp as ttp

    mesh_ex = object.__new__(Executor)
    mesh_ex.mesh = object()
    with pytest.raises(ValueError) as e:
        Executor.set_lora(mesh_ex, object())
    assert str(e.value) == "LoRA under mesh-sharded serving is not supported yet"
    assert not hasattr(ttp, "not_served_under_mesh")
    ex = Executor(tmodel, _Tok(), _apps()[1])
    # A LoRA adapter is served (tests/test_torch_lora.py); one the registry
    # lacks fails as not loaded.
    with pytest.raises(KeyError, match="not loaded"):
        list(ex.generate([1, 2], GenerationConfig(lora_adapter="x")))
    # A grammar and a host sampler are served (tests/test_torch_constrained.py
    # holds the streams to the JAX executor's).
    toks = [t.token_id for t in ex.generate([1, 2], GenerationConfig(
        max_tokens=3, temperature=0.0, grammar='root ::= "a" | "b"'))]
    assert toks[0] in (ord("a"), ord("b"))
    toks = list(ex.generate([1, 2], GenerationConfig(max_tokens=3, temperature=0.8,
                                                     mirostat=2, seed=1)))
    assert len(toks) == 3 and all(t.logprob is None for t in toks)


def test_collect_and_stream_generation():
    """generate_text over the port's Executor: stop sequences cut across
    tokens, LENGTH finishes, and logprobs with the top-k come back."""
    _, tmodel = _pair(seed=7)
    ex = Executor(tmodel, _Tok(), _apps()[1])
    cfg = GenerationConfig(max_tokens=8, temperature=0.0, logprobs=True, top_logprobs=3)
    res = collect_generation(ex, [1, 2, 3], cfg)
    assert res.finish_reason == FinishReason.LENGTH and len(res.tokens) == 8
    assert len(res.logprobs) == 8 and all(len(t) == 3 for t in res.top_logprobs)
    assert res.top_logprobs[0][0].logprob >= res.top_logprobs[0][1].logprob
    text = "".join(_Tok().decode([t]) for t in res.tokens)
    stop = text[3:5]
    cut = collect_generation(ex, [1, 2, 3], GenerationConfig(
        max_tokens=8, temperature=0.0, stop_sequences=[stop]))
    assert cut.finish_reason == FinishReason.STOP and cut.text == text[:text.index(stop)]
    pieces = list(stream_generation(ex, [1, 2, 3], GenerationConfig(
        max_tokens=8, temperature=0.0, stop_sequences=[stop])))
    assert "".join(p[0] for p in pieces) == cut.text and pieces[-1][1] == FinishReason.STOP


@pytest.mark.parametrize("mode", [None, "w4a8-prefill"])
def test_perplexity_matches_jax(mode, monkeypatch):
    """Sliding-window perplexity over a 512-token stream in 256-token
    windows (256 rows: w4a8-prefill takes B3 there); 1e-4 relative in w4a16,
    2e-3 with activation quant."""
    monkeypatch.setenv("BLAZR_TPU_FORCE_PALLAS_QUANT", "1")
    monkeypatch.setattr(im, "quant_matmul_pallas", _no_b1)
    jm, tmodel = _pair(seed=8, mode=mode)
    stream = (np.random.default_rng(7).integers(1, 250, 64).tolist() * 8)[:512]
    p_ref = jax_perplexity(jm, stream, window=256)
    p = perplexity(tmodel, stream, window=256)
    assert abs(p - p_ref) / p_ref < (1e-4 if mode is None else 2e-3)


def _no_b1(x, qt):
    """The JAX package's B1 casts x to bf16 in its body; with it out of the
    way, the JAX reference's untagged matmuls take its exact f32 dequant
    path, the arithmetic of the port's plain B1."""
    raise NotImplementedError("B1 left to the dequant path in this test")


def test_batch_engine_w4a8_prefill_pads_groups_like_jax(monkeypatch):
    """Three prompts in one 64-token bucket: the JAX engine pads the group to
    4 rows (256 matmul rows, so B3 under w4a8-prefill); the port pads it the
    same way and gives the JAX engine's greedy streams."""
    monkeypatch.setenv("BLAZR_TPU_FORCE_PALLAS_QUANT", "1")
    monkeypatch.setattr(im, "quant_matmul_pallas", _no_b1)
    jrows, trows = [], []
    real_j = im.quant_matmul_int8mxu
    monkeypatch.setattr(im, "quant_matmul_int8mxu", lambda x, q: jrows.append(
        int(np.prod(x.shape[:-1]))) or real_j(x, q))
    real_t = tm.qmm_int8
    monkeypatch.setattr(tm, "qmm_int8", lambda x, *a, **k: trows.append(
        x.shape[0]) or real_t(x, *a, **k))
    jm, tmodel = _pair(seed=9)
    ja, ta = _apps(quant_compute="w4a8-prefill", max_batch_size=4, max_seq_len=128)
    prompts = [list(np.random.default_rng(i).integers(1, 250, n))
               for i, n in enumerate((40, 50, 60))]
    prompts = [[int(t) for t in p] for p in prompts]
    jm.cfg.max_seq_len = tmodel.cfg.max_seq_len = 128
    ref = asyncio.run(_serve(JEngine(jm, _Tok(), ja), [prompts],
                             lambda: JGen(max_tokens=6, temperature=0.0)))
    got = asyncio.run(_serve(BatchEngine(tmodel, _Tok(), ta), [prompts],
                             lambda: GenerationConfig(max_tokens=6, temperature=0.0)))
    assert got == ref
    assert set(jrows) == {256} and set(trows) == {256}
    assert len(trows) == 8                       # 4 projections x 2 layers
