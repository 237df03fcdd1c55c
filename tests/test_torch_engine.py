"""Port parity: blazr_tpu_torch's BatchEngine against blazr_tpu's on the
CPU, the seeded sampler, the no-JAX import guard and the CUDA default of
the entry points."""

import asyncio
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.sampling import apply_penalties as jax_penalties
from blazr_tpu.engine.sampling import apply_top_k_top_p as jax_topkp
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine import sampling as ts
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.utils.synthetic import tiny_llama_config

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Tok:
    """Stub tokenizer: no EOS, so every request runs to max_tokens."""

    eos_token_id = -1

    def is_eos(self, t):
        return False

    def decode(self, ids):
        return "".join(chr(32 + i % 90) for i in ids)

    def vocab_bytes(self):
        return [bytes([i % 256]) for i in range(256)]


async def _collect(handle):
    return [t.token_id async for t in handle.tokens()]


async def _serve(eng, waves, gen):
    """Submit ``waves`` of prompts; each later wave is submitted once every
    request of the previous wave has its first token (so its prefill joins
    a running decode batch). Returns the token streams in submit order."""
    task = asyncio.create_task(eng.run())
    streams = []
    for wave in waves:
        handles = [eng.submit(p, gen()) for p in wave]
        firsts = [await asyncio.wait_for(h.queue.get(), timeout=120)
                  for h in handles]
        streams.append((handles, firsts))
    out = []
    for handles, firsts in streams:
        rest = await asyncio.gather(*[asyncio.wait_for(_collect(h), 120)
                                      for h in handles])
        out += [[f[0].token_id] + r for f, r in zip(firsts, rest)]
    eng.stop()
    await task
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny()
    jmodel = synth_model(jcfg, quant="dense", dtype=jnp.float32)
    jmodel.params = jax_synth(jcfg, quant="awq", dtype=jnp.float32,
                              group_size=32, seed=3)
    tcfg = tiny_llama_config()
    tparams = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device=CPU)
    return jmodel, Model(tcfg, tparams, torch.float32)


def test_greedy_streams_match_jax_engine(models):
    """Four greedy requests (default penalties: repeat 1.1, window 64) in
    two staggered waves: the port's token streams equal the JAX engine's
    exactly."""
    jmodel, tmodel = models
    waves = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]],
             [[42] * 20, [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]]]

    def app(cls, cfg):
        a = cls(model=cfg)
        a.inference.max_seq_len = 64
        a.inference.max_batch_size = 4
        return a

    jeng = JEngine(jmodel, _Tok(), app(JApp, jmodel.cfg))
    ref = asyncio.run(_serve(jeng, waves,
                             lambda: JGen(max_tokens=12, temperature=0.0)))
    teng = BatchEngine(tmodel, _Tok(), app(AppConfig, tmodel.cfg))
    got = asyncio.run(_serve(teng, waves,
                             lambda: GenerationConfig(max_tokens=12, temperature=0.0)))
    assert got == ref
    assert all(len(s) == 12 for s in got)
    assert teng.horizon_steps > teng.horizon_dispatches     # multi-step rounds


def test_horizon_1_matches_horizon_8(models):
    _, tmodel = models
    waves = [[[7, 8, 9], [10, 11]], [[12, 13, 14, 15]]]

    def run(h):
        a = AppConfig(model=tmodel.cfg)
        a.inference.max_seq_len = 64
        a.inference.max_batch_size = 4
        a.inference.decode_horizon = h
        return asyncio.run(_serve(BatchEngine(tmodel, _Tok(), a), waves,
                                  lambda: GenerationConfig(max_tokens=9,
                                                           temperature=0.0)))
    assert run(1) == run(8)


def test_seeded_rows_repeat(models):
    _, tmodel = models

    def run():
        a = AppConfig(model=tmodel.cfg)
        a.inference.max_seq_len = 64
        eng = BatchEngine(tmodel, _Tok(), a)
        return asyncio.run(_serve(eng, [[[3, 4, 5], [6, 7]]], lambda: GenerationConfig(
            max_tokens=8, temperature=0.7, top_p=0.9, seed=11)))
    assert run() == run()


def test_engine_refuses_what_it_does_not_serve(models):
    _, tmodel = models
    a = AppConfig(model=tmodel.cfg)
    a.inference.kv_cache_dtype = "int4"
    with pytest.raises(ValueError, match="int4"):
        BatchEngine(tmodel, _Tok(), a)
    a = AppConfig(model=tmodel.cfg)
    a.inference.speculative = SpeculativeDecodingConfig(num_speculative_tokens=2)
    with pytest.raises(NotImplementedError, match="queue A"):
        BatchEngine(tmodel, _Tok(), a)
    # The prefix cache (and its host tier) is served now.
    a = AppConfig(model=tmodel.cfg)
    a.inference.prefix_cache = True
    a.inference.gpu_prefix_cache = True
    eng = BatchEngine(tmodel, _Tok(), a)
    assert eng.scheduler.prefix_cache is eng.prefix_cache is not None
    assert eng.prefix_cache.host_tier is not None
    eng = BatchEngine(tmodel, _Tok(), AppConfig(model=tmodel.cfg))
    with pytest.raises(NotImplementedError, match="queue A"):
        eng.submit([1, 2], GenerationConfig(json_mode=True))


def test_int8_kv_engine_runs(models):
    _, tmodel = models
    a = AppConfig(model=tmodel.cfg)
    a.inference.max_seq_len = 64
    a.inference.kv_cache_dtype = "int8"
    out = asyncio.run(_serve(BatchEngine(tmodel, _Tok(), a), [[[1, 2, 3]]],
                             lambda: GenerationConfig(max_tokens=5, temperature=0.0)))
    assert len(out[0]) == 5


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_penalties_and_filters_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    window = np.full((3, 64), -1, np.int64)
    window[0, :5] = [1, 2, 2, 0, 7]
    window[2, :3] = [49, 49, 49]
    rp = np.array([1.1, 1.3, 1.0], np.float32)
    fp = np.array([0.0, 0.2, 0.5], np.float32)
    pp = np.array([0.1, 0.0, 0.3], np.float32)
    ref = np.asarray(jax_penalties(jnp.asarray(logits), jnp.asarray(window),
                                   jnp.asarray(rp), jnp.asarray(fp), jnp.asarray(pp)))
    got = ts.apply_penalties(torch.from_numpy(logits), torch.from_numpy(window),
                             torch.from_numpy(rp), torch.from_numpy(fp),
                             torch.from_numpy(pp)).numpy()
    np.testing.assert_array_equal(got, ref)
    k = np.array([0, 5, 1], np.int64)
    p = np.array([0.9, 1.0, 0.0], np.float32)
    ref = np.asarray(jax_topkp(jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p)))
    got = ts.apply_top_k_top_p(torch.from_numpy(logits), torch.from_numpy(k),
                               torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))


def test_seeded_sampling_deterministic_per_seed_step():
    logits = torch.randn(1, 64, generator=torch.Generator().manual_seed(1)).expand(4, -1)
    cfgs = [GenerationConfig(temperature=1.0, top_p=1.0, min_p=0.0, seed=s)
            for s in (1, 2, 1, 3)]
    a, _ = ts.sample_tokens(logits, ts.SamplingParams.from_config(cfgs, [5, 5, 5, 5], CPU))
    b, _ = ts.sample_tokens(logits, ts.SamplingParams.from_config(cfgs, [5, 5, 5, 5], CPU))
    assert torch.equal(a, b)
    assert a[0] == a[2]                        # same (seed, step), same draw
    noise = ts.gumbel_noise(torch.tensor([[1, 5], [1, 6]]), 64)
    assert not torch.equal(noise[0], noise[1])  # the step changes the draw


def test_sampled_distribution_matches_softmax():
    """Gumbel-max over the counter-based noise: empirical frequencies over
    4000 (seed, step) keys are within 0.03 of softmax (about 4 standard
    errors at p ≈ 0.3)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    n = 4000
    cfgs = [GenerationConfig(temperature=1.0, top_p=1.0, min_p=0.0, seed=i)
            for i in range(n)]
    toks, _ = ts.sample_tokens(logits.expand(n, -1),
                               ts.SamplingParams.from_config(cfgs, 7, CPU))
    freq = torch.bincount(toks, minlength=6).float() / n
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0], 0).numpy(),
                               atol=0.03)


def test_greedy_rows_are_exact_argmax():
    logits = torch.randn(3, 40, generator=torch.Generator().manual_seed(2))
    cfgs = [GenerationConfig(temperature=0.0), GenerationConfig(temperature=0.9, seed=4),
            GenerationConfig(temperature=0.0)]
    toks, _ = ts.sample_tokens(logits, ts.SamplingParams.from_config(cfgs, 0, CPU))
    assert toks[0] == logits[0].argmax() and toks[2] == logits[2].argmax()


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

# Packages the port and chip_smoke.py must not import: JAX, the JAX package,
# and what the JAX entry path leans on that the card's machine lacks.
FORBIDDEN = ("jax", "blazr_tpu", "aiohttp", "regex", "prometheus_client",
             "ml_dtypes", "safetensors", "tokenizers")


def test_port_imports_without_jax_or_blazr_tpu():
    code = textwrap.dedent(f"""
        import sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None      # any import of it raises ImportError
        import importlib, pkgutil
        import blazr_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            blazr_tpu_torch.__path__, 'blazr_tpu_torch.')
            if not m.name.endswith('.__main__')]
        for n in names:
            importlib.import_module(n)
        sys.path.insert(0, '.')
        import chip_smoke
        assert not any(k.split('.')[0] in {FORBIDDEN!r} for k, v in
                       sys.modules.items() if v is not None)
        print(' '.join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 77
    assert {f"blazr_tpu_torch.{m}" for m in (
        "kvcache.prefix_cache", "kvcache.host_tier", "server.metrics", "server.slo",
        "quant.int8", "kvcache.contiguous", "models.llama", "models.moe", "engine.executor",
        "engine.generate_text", "model_meta.think", "utils.ppl",
        "tools.bench_pa_wide", "tools.bench_pa_headmajor", "formats.safetensors",
        "formats.detect", "loader.varmap", "loader.api", "tokenizer.bpe",
        "tokenizer.hf_tokenizer", "model_meta.chat_template", "engine.model_scheduler",
        "server.app", "server.api_types", "server.streaming", "cli.main",
        "formats.gguf", "formats.ggml_quants", "formats.iq_quants", "formats.names",
        "formats.detect_arch", "loader.gguf_config", "loader.convert",
        "tokenizer.gguf_tokenizer", "tokenizer.pretrained", "engine.bench",
        "models.mla", "models.mamba2", "models.hybrid", "models.paged_multi",
        "kvcache.ssm_state")} <= names


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device argument every entry point asks for CUDA, and raises
    where there is none; it never falls back to the CPU."""
    from blazr_tpu_torch.attention.paged_attention import paged_attention_decode
    from blazr_tpu_torch.models.llama_paged import forward_paged
    from blazr_tpu_torch.quant.kernels import qmm
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_llama_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        synth_llama_params(cfg)
    params = synth_llama_params(cfg, group_size=32, dtype=torch.float32, device=CPU)
    qt = params["layers"][0]["o"]
    with pytest.raises(RuntimeError, match="CUDA"):
        qmm(torch.zeros(1, 64), qt.qweight, qt.scales, qt.mins, bits=4,
            signed=True, group_size=32)
    z = torch.zeros(1, 4, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_attention_decode(z, torch.zeros(9, 2, 16), torch.zeros(9, 2, 16),
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32), block_size=8,
                               num_blocks=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        forward_paged(params, cfg, None, None, None, None, None, None)
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide

    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(REPO)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelScheduler(REPO)
    with pytest.raises(RuntimeError, match="CUDA"):
        pa_wide(z, torch.zeros(9, 2, 16), torch.zeros(9, 2, 16),
                torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
                block_size=8, num_blocks=1)
