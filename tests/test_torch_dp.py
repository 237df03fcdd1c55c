"""Port parity: data-parallel routing (``engine/data_parallel.py``,
``engine/cache_router.py``) and tracing (``utils/tracing.py``) of
blazr_tpu_torch against blazr_tpu on the CPU.

Prompts and loads come from numpy seeds; the router's choices, the group's
selections and the span lines must be exactly the JAX package's. Two
``BatchEngine`` replicas of one tiny model behind a group serve greedy
requests with the streams of one engine."""

import asyncio
import json
import logging

import numpy as np
import pytest
import torch

from blazr_tpu.engine import cache_router as jcr
from blazr_tpu.engine import data_parallel as jdp
from blazr_tpu.utils import tracing as jtr
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.engine import cache_router as tcr
from blazr_tpu_torch.engine import data_parallel as tdp
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.utils import tracing as ttr
from blazr_tpu_torch.utils.synthetic import synth_llama_params, tiny_llama_config

from test_torch_engine import _Tok, _collect


def _prompts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "δέλτα", "ε", "zeta " * 120, "東京", ""]
    return ["".join(rng.choice(words, int(rng.integers(1, 8)))) for _ in range(n)]


def test_fnv1a_and_router_match_jax():
    """FNV-1a over the first 512 characters' UTF-8, sticky with the
    least-loaded fallback: the same replica for 200 seeded prompts under
    seeded loads, for 1-5 replicas."""
    rng = np.random.default_rng(0)
    for p in _prompts(1, 50):
        assert tcr.fnv1a(p.encode()) == jcr.fnv1a(p.encode())
    assert tcr.PREFIX_CHARS == jcr.PREFIX_CHARS == 512
    for n in range(1, 6):
        t, j = tcr.CacheAwareRouter(n), jcr.CacheAwareRouter(n)
        for p in _prompts(n, 40):
            loads = [int(x) for x in rng.integers(0, 6, n)] if rng.random() < 0.8 else []
            assert t.route(p, loads) == j.route(p, loads)
    long = "x" * 512
    assert (tcr.CacheAwareRouter(7).route(long + "a", [])
            == tcr.CacheAwareRouter(7).route(long + "b", []))


@pytest.mark.parametrize("cache_aware", [True, False], ids=["cache-aware", "round-robin"])
def test_group_selections_match_jax(cache_aware):
    """A seeded sequence of selects (with and without a prompt) and
    releases through 3 replicas: the same replica each time and the same
    active counts."""
    rng = np.random.default_rng(5)
    t = tdp.DataParallelGroup(["a", "b", "c"], cache_aware=cache_aware)
    j = jdp.DataParallelGroup(["a", "b", "c"], cache_aware=cache_aware)
    held = []
    for p in _prompts(9, 60):
        if held and rng.random() < 0.4:
            i = int(rng.integers(0, len(held)))
            tr, jr = held.pop(i)
            t.release(tr)
            j.release(jr)
            continue
        prompt = p if rng.random() < 0.7 else ""
        tr, jr = t.select(prompt), j.select(prompt)
        assert (tr.index, tr.engine) == (jr.index, jr.engine)
        held.append((tr, jr))
        assert t.stats() == j.stats()
    with pytest.raises(ValueError):
        tdp.DataParallelGroup([])


def test_two_engine_replicas_behind_a_group():
    """Two BatchEngines of one model behind a cache-aware group: requests
    spread over both, each stream equals one engine's, and the active
    counts fall back to 0 on release."""
    cfg = tiny_llama_config()
    model = Model(cfg, synth_llama_params(cfg, quant="awq", group_size=32, dtype=torch.float32,
                                         device="cpu"), torch.float32)

    def engine():
        a = AppConfig(model=cfg)
        a.inference.max_seq_len = 64
        return BatchEngine(model, _Tok(), a)

    prompts = [[i + 1, 2 * i + 3, 7] for i in range(8)]
    gen = lambda: GenerationConfig(max_tokens=6, temperature=0.0)

    async def serve(engines, route):
        tasks = [asyncio.create_task(e.run()) for e in engines]
        handles = [route(i, p).submit(p, gen()) for i, p in enumerate(prompts)]
        out = await asyncio.gather(*[asyncio.wait_for(_collect(h), 120) for h in handles])
        for e in engines:
            e.stop()
        await asyncio.gather(*tasks)
        return out

    single = engine()
    want = asyncio.run(serve([single], lambda i, p: single))
    group = tdp.DataParallelGroup([engine(), engine()])
    picked = []

    def route(i, p):
        r = group.select("".join(chr(97 + t % 26) for t in p))
        picked.append(r)
        return r.engine

    got = asyncio.run(serve([r.engine for r in group.replicas], route))
    assert got == want
    assert {r.index for r in picked} == {0, 1}
    for r in picked:
        group.release(r)
    assert [s["active"] for s in group.stats()] == [0, 0]


def _span_lines(mod, caplog) -> list[str]:
    caplog.clear()
    with caplog.at_level(logging.DEBUG, logger=mod.logger.name):
        with mod.span("prefill", backend="paged", batch=3):
            pass
        with pytest.raises(RuntimeError):
            with mod.span("decode", batch=1):
                raise RuntimeError("inside")
        with mod.span("plain"):
            pass
    return [r.getMessage().split(" elapsed_ms=")[0] + (" elapsed_ms" if "elapsed_ms=" in
                                                       r.getMessage() else "")
            for r in caplog.records if r.name == mod.logger.name]


def test_span_lines_match_jax(caplog):
    """``span`` logs the JAX package's phase lines at DEBUG (the elapsed
    time aside), also when the block raises, on its own trace logger."""
    got, want = _span_lines(ttr, caplog), _span_lines(jtr, caplog)
    assert got == want and len(got) == 6
    assert got[0] == "phase=prefill_start backend=paged batch=3"
    assert ttr.logger.name == "blazr_tpu_torch.trace"


@pytest.mark.parametrize("env,level", [("trace", logging.DEBUG), ("WARN", logging.WARNING),
                                       ("error", logging.ERROR), ("bogus", logging.INFO),
                                       (None, logging.INFO)])
def test_setup_logging_reads_the_env(monkeypatch, env, level):
    """``BLAZR_TPU_LOG`` picks the level as in the JAX package."""
    seen = {}
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: seen.update(kw))
    if env is None:
        monkeypatch.delenv("BLAZR_TPU_LOG", raising=False)
    else:
        monkeypatch.setenv("BLAZR_TPU_LOG", env)
    ttr.setup_logging()
    assert seen["level"] == level
    seen.clear()
    jtr.setup_logging()
    assert seen["level"] == level


def test_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    """``profile`` writes a Chrome trace of the block to the directory
    given, or to ``BLAZR_TPU_PROFILE_DIR``; without either it records
    nothing."""
    monkeypatch.delenv("BLAZR_TPU_PROFILE_DIR", raising=False)
    with ttr.profile():
        torch.ones(4).sum()
    with ttr.profile(str(tmp_path / "a")):
        torch.ones(4).sum()
    monkeypatch.setenv("BLAZR_TPU_PROFILE_DIR", str(tmp_path / "b"))
    with ttr.profile():
        torch.ones(4).sum()
    for sub in ("a", "b"):
        (trace,) = (tmp_path / sub).glob("trace_*.json")
        assert "traceEvents" in json.loads(trace.read_text())


def test_engines_trace_their_phases(caplog):
    """The BatchEngine's prefill and decode phases and the Executor's
    prefill log their spans, as the JAX engines do."""
    cfg = tiny_llama_config()
    model = Model(cfg, synth_llama_params(cfg, quant="dense", dtype=torch.float32,
                                         device="cpu"), torch.float32)
    a = AppConfig(model=cfg)
    a.inference.max_seq_len = 64
    with caplog.at_level(logging.DEBUG, logger=ttr.logger.name):
        list(Executor(model, _Tok(), a).generate([1, 2, 3], GenerationConfig(
            max_tokens=3, temperature=0.0)))
        eng = BatchEngine(model, _Tok(), a)

        async def one():
            task = asyncio.create_task(eng.run())
            out = await asyncio.wait_for(_collect(eng.submit(
                [4, 5], GenerationConfig(max_tokens=3, temperature=0.0))), 60)
            eng.stop()
            await task
            return out

        asyncio.run(one())
    msgs = [r.getMessage() for r in caplog.records if r.name == ttr.logger.name]
    assert "phase=prefill_start backend=contiguous tokens=3 cached=0" in msgs
    assert "phase=prefill_start backend=paged batch=1" in msgs
    assert any(m.startswith("phase=decode_end backend=paged batch=1 elapsed_ms=")
               for m in msgs)
