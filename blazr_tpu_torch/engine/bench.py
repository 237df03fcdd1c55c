"""Benchmark harness.

Counterpart of ``blazr_tpu/engine/bench.py``: a prompt-length sweep over the
single-stream ``Executor`` with one warmup and N runs, measuring prefill
and decode throughput, TTFT and ITL on the host clock; the standard
workload profiles and the concurrency sweep. Without a model it runs the
JAX package's synthetic case: ``tiny_llama_config`` with dense f32 weights
and the ``ByteTokenizer``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.device import DeviceLike, resolve_device

# Standard workload profiles: (prompt tokens, decode tokens).
WORKLOAD_PROFILES = {
    "short": (32, 64),
    "medium": (128, 256),
    "long": (512, 256),
    "long_context": (2048, 128),
    "code_gen": (256, 512),
}

# Concurrency sweep.
CONCURRENCY_SWEEP = [1, 2, 4, 8, 16, 32]


@dataclass
class BenchMetrics:
    """One prompt length's results."""

    prompt_tokens: int
    decode_tokens: int
    prefill_tok_s: float
    decode_tok_s: float
    ttft_ms: float
    itl_p50_ms: float
    itl_p95_ms: float
    itl_p99_ms: float
    e2e_ms: float
    runs: int

    def to_dict(self) -> dict:
        return self.__dict__


def _percentiles(vals: list[float]) -> tuple[float, float, float]:
    if not vals:
        return 0.0, 0.0, 0.0
    a = np.asarray(vals)
    return (float(np.percentile(a, 50)), float(np.percentile(a, 95)),
            float(np.percentile(a, 99)))


def bench_executor(executor, prompt_len: int, decode_tokens: int,
                   runs: int = 3, warmup: int = 1) -> BenchMetrics:
    """Greedy generations of random prompts of ``prompt_len`` tokens: each
    token is on the host when the executor yields it, so the host clock
    sees the device's time."""
    from ..config.generation import GenerationConfig

    rng = np.random.default_rng(0)
    vocab = executor.model.vocab_size
    cfg = GenerationConfig(max_tokens=decode_tokens, temperature=0.0)

    def once() -> tuple[float, float, list[float], int]:
        prompt = rng.integers(1, vocab, prompt_len).tolist()
        t0 = time.time()
        first = None
        last = None
        itls = []
        n = 0
        for _ in executor.generate(prompt, cfg):
            now = time.time()
            if first is None:
                first = now
            elif last is not None:
                itls.append((now - last) * 1e3)
            last = now
            n += 1
        return t0, first or t0, itls, n

    for _ in range(warmup):
        once()

    ttfts, itls_all, decode_rates, prefill_rates, e2es = [], [], [], [], []
    for _ in range(runs):
        t0, first, itls, n = once()
        end = time.time()
        ttfts.append((first - t0) * 1e3)
        itls_all.extend(itls)
        if itls:
            decode_rates.append(1e3 / (sum(itls) / len(itls)))
        prefill_rates.append(prompt_len / max(first - t0, 1e-9))
        e2es.append((end - t0) * 1e3)

    p50, p95, p99 = _percentiles(itls_all)
    return BenchMetrics(
        prompt_tokens=prompt_len,
        decode_tokens=decode_tokens,
        prefill_tok_s=float(np.mean(prefill_rates)),
        decode_tok_s=float(np.mean(decode_rates)) if decode_rates else 0.0,
        ttft_ms=float(np.mean(ttfts)),
        itl_p50_ms=p50, itl_p95_ms=p95, itl_p99_ms=p99,
        e2e_ms=float(np.mean(e2es)),
        runs=runs,
    )


def run_benchmark(model_path: Optional[str] = None,
                  prompt_lens: list[int] = (32, 128, 512),
                  decode_tokens: int = 128, runs: int = 3,
                  dtype: Optional[str] = None, device: DeviceLike = None) -> dict:
    """The CLI's bench: load the model (or the synthetic one) onto
    ``device`` (default ``cuda``) and sweep the prompt lengths."""
    from .executor import Executor

    dev = resolve_device(device)
    if model_path:
        from ..loader import load_model
        from ..tokenizer import load_tokenizer

        model, app_cfg = load_model(model_path, dtype=dtype, device=dev)
        p = Path(model_path)
        tok = load_tokenizer(p.parent if p.is_file() else p,
                             gguf_path=p if p.suffix == ".gguf" else None)
        executor = Executor(model, tok, app_cfg)
        name = str(model_path)
    else:
        import torch

        from ..models.registry import Model
        from ..tokenizer.byte_tok import ByteTokenizer
        from ..utils.synthetic import synth_llama_params, tiny_llama_config

        cfg = tiny_llama_config()
        params = synth_llama_params(cfg, quant="dense", dtype=torch.float32, device=dev)
        executor = Executor(Model(cfg, params, torch.float32), ByteTokenizer())
        name = "synthetic-tiny"

    results = {
        "model": name,
        "platform": dev.type,
        "decode_tokens": decode_tokens,
        "profiles": {},
    }
    for plen in prompt_lens:
        m = bench_executor(executor, plen, decode_tokens, runs=runs)
        results["profiles"][str(plen)] = m.to_dict()
    return results
