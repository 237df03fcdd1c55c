"""Single-stream executor over the contiguous KV cache.

Counterpart of ``blazr_tpu/engine/executor.py::Executor`` (:56): model +
tokenizer + cache, bucketed prefill, a streaming ``generate`` loop with
sampling fused on the device (``engine/sampling.py``) and top-20 logprobs,
and session KV reuse when a prompt extends the previous one.

What is ported is the executor's semantics, not its TPU machinery: PyTorch
runs eagerly, so there are no jitted step functions or donated buffers; the
cache is written in place and a reused session cache is taken over instead
of copied. Prompts are still padded to power-of-two buckets (pads write to
the cache's trash slot), so every matmul sees the row count the JAX
executor's programs see, and the row-count routing of ``w4a8-prefill``
agrees. ``inference.quant_compute`` is applied to the model's params in
place when the executor is built.

Not served yet; each raises ``NotImplementedError`` naming ROADMAP queue A,
as ``BatchEngine`` does: grammars and JSON mode, host samplers (mirostat/
DRY/typical/dynatemp), LoRA, TP/EP/SP meshes and ring prefill, MoE offload
and streaming (host-offloaded) models.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..config.app import AppConfig
from ..config.generation import GenerationConfig
from ..models.registry import Model
from ..quant.qtensor import apply_quant_compute
from .batch_engine import TOPK_K, _next_pow2, _not_served, check_request
from .sampling import SamplingParams, make_bias_rows, make_window, sample_tokens
from .types import GeneratedToken, TokenLogprob

logger = logging.getLogger(__name__)


class Executor:
    """Single-model inference executor (contiguous-cache path) on the
    device the model's params lie on. The paged, continuous-batching path
    is ``batch_engine.BatchEngine``."""

    _MIN_REUSE_TOKENS = 16   # below this a fresh prefill beats the reuse

    def __init__(self, model: Model, tokenizer, app_cfg: Optional[AppConfig] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.app_cfg = app_cfg or AppConfig(model=model.cfg)
        inf = self.app_cfg.inference
        self._check_config(inf)
        self.capacity = min(self.app_cfg.effective_max_seq_len() or 4096,
                            model.cfg.max_seq_len or 4096)
        # Last completed session's (fed tokens, cache), reused when the next
        # prompt extends it (reference executor_generate.rs:230-249).
        self._session: Optional[tuple[list[int], Any]] = None
        # In place: a w8a8-widened weight replaces its 4-bit copy one leaf
        # at a time, so the 4-bit copy is freed.
        apply_quant_compute(model.params, inf.quant_compute, inplace=True)

    @staticmethod
    def _check_config(inf) -> None:
        if inf.kv_cache_dtype not in ("auto", "int8", "int4"):
            raise ValueError(f"unknown kv_cache_dtype {inf.kv_cache_dtype!r}")
        if max(inf.tensor_parallel_size, inf.data_parallel_size,
               inf.expert_parallel_size, inf.sequence_parallel_size) > 1:
            raise _not_served("multi-device serving and ring prefill")
        if inf.moe_offload:
            raise _not_served("MoE expert offload")
        if inf.num_device_layers is not None:
            raise _not_served("streaming (host-offloaded) models")

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _init_cache(self, batch: int):
        """Model cache honouring ``inference.kv_cache_dtype`` (int8 or int4
        KV with per-token scales, else the model dtype)."""
        kv_dtype = self.app_cfg.inference.kv_cache_dtype
        return self.model.init_cache(batch, self.capacity,
                                     kv_quant=kv_dtype in ("int8", "int4"),
                                     kv_dtype=kv_dtype)

    # ------------------------------------------------------------------
    # session KV reuse
    # ------------------------------------------------------------------
    def _session_restore(self, prompt_ids: list[int]):
        """(cache, start) reusing the previous session's cache when the new
        prompt extends it; (None, 0) on a miss. The cache is taken over and
        trimmed to the matched prefix: later slots are overwritten by the
        suffix prefill or masked by the length."""
        if not self.app_cfg.inference.prefix_cache or self._session is None:
            return None, 0
        toks, cache = self._session
        limit = min(len(toks), len(prompt_ids) - 1)
        n = 0
        while n < limit and toks[n] == prompt_ids[n]:
            n += 1
        if n < self._MIN_REUSE_TOKENS:
            return None, 0
        self._session = None
        cache.length.clamp_(max=n)
        return cache, n

    def _session_save(self, fed_tokens: list[int], cache) -> None:
        if self.app_cfg.inference.prefix_cache:
            self._session = (list(fed_tokens), cache)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, cache, prompt_ids: list[int], start_pos: int = 0):
        """Bucketed prefill. Returns (last logits [1, V] on the device,
        cache). Chunks of ``prefill_chunk_size`` are padded to a power of
        two; pad positions write to the cache's trash slot."""
        n = len(prompt_ids)
        assert n > 0, "empty prompt"
        bucket = min(_next_pow2(n), self.capacity)
        chunk = min(self.app_cfg.inference.prefill_chunk_size or bucket, bucket)
        dev = self.device
        pos = start_pos
        last = None
        for idx in range(0, n, chunk):
            piece = prompt_ids[idx:idx + chunk]
            padded = min(_next_pow2(len(piece)), chunk)
            toks = np.zeros((1, padded), dtype=np.int64)
            toks[0, :len(piece)] = piece
            positions = np.full((1, padded), cache.trash_position, dtype=np.int64)
            positions[0, :len(piece)] = np.arange(pos, pos + len(piece))
            logits, cache = self.model.forward(
                torch.from_numpy(toks).to(dev), cache,
                torch.from_numpy(positions).to(dev),
                torch.tensor([pos + len(piece)], dtype=torch.int32, device=dev))
            last = logits[:, len(piece) - 1, :]
            pos += len(piece)
        return last, cache

    @torch.no_grad()
    def _decode(self, cache, tok: int, pos: int):
        dev = self.device
        logits, cache = self.model.forward(
            torch.tensor([[tok]], dtype=torch.int64, device=dev), cache,
            torch.tensor([[pos]], dtype=torch.int64, device=dev),
            torch.tensor([pos + 1], dtype=torch.int32, device=dev))
        return logits[:, -1, :], cache

    @torch.no_grad()
    def _sample(self, last: torch.Tensor, cfg: GenerationConfig, step: int,
                history: list[int], bias) -> tuple[int, float, Optional[list]]:
        """Fused device sampling of [1, V] logits; ONE host fetch of the
        token, its logprob and (with ``cfg.logprobs``) the top-20."""
        dev = self.device
        sp = SamplingParams.from_config([cfg], step=step, device=dev)
        window = torch.from_numpy(make_window(history, cfg.repeat_last_n)[None, :]).to(dev)
        tok, logprobs = sample_tokens(last, sp, window, *bias)
        cols = [tok[:, None].to(torch.float64),
                logprobs.gather(1, tok[:, None]).to(torch.float64)]
        if cfg.logprobs:
            top_lp, top_ids = torch.topk(logprobs, TOPK_K, dim=-1)
            cols += [top_ids.to(torch.float64), top_lp.to(torch.float64)]
        row = torch.cat(cols, dim=1)[0].cpu().numpy()
        top = None
        if cfg.logprobs:
            k = min(cfg.top_logprobs, TOPK_K)
            top = [TokenLogprob(int(i), float(lp), self._token_text(int(i)))
                   for i, lp in zip(row[2:2 + k], row[2 + TOPK_K:2 + TOPK_K + k])]
        return int(row[0]), float(row[1]), top

    # ------------------------------------------------------------------
    def generate(self, prompt_ids: list[int],
                 gen_cfg: Optional[GenerationConfig] = None) -> Iterator[GeneratedToken]:
        """Streaming generation (reference executor_generate.rs:43). Yields
        GeneratedToken; the caller handles stop sequences and text
        assembly (``generate_text.py``)."""
        cfg = gen_cfg or self.app_cfg.generation
        cfg.validate()
        check_request(cfg)
        max_new = min(cfg.max_tokens, self.capacity - len(prompt_ids))
        if max_new <= 0:
            return
        cache, start = self._session_restore(prompt_ids)
        if cache is None:
            cache = self._init_cache(1)
        last, cache = self.prefill(cache, prompt_ids[start:], start_pos=start)
        kv_tokens = list(prompt_ids)          # tokens whose KV the cache holds
        history = list(prompt_ids)
        ids, vals = make_bias_rows([cfg])
        bias = (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(vals).to(self.device))
        pos = len(prompt_ids)
        tok, lp, top = self._sample(last, cfg, 0, history, bias)
        try:
            for step in range(max_new):
                is_eos = self.tokenizer.is_eos(tok)
                yield GeneratedToken(token_id=tok,
                                     text="" if is_eos else self._token_text(tok),
                                     logprob=lp, top_logprobs=top)
                history.append(tok)
                if is_eos or step + 1 >= max_new or pos + 1 >= self.capacity:
                    return
                last, cache = self._decode(cache, tok, pos)
                kv_tokens.append(tok)
                pos += 1
                tok, lp, top = self._sample(last, cfg, step + 1, history, bias)
        finally:
            # Runs on a normal finish and on a client disconnect alike.
            self._session_save(kv_tokens, cache)

    # ------------------------------------------------------------------
    def _token_text(self, tok: int) -> str:
        try:
            return self.tokenizer.decode([tok])
        except Exception:
            return ""

    def warmup(self) -> float:
        """Run a 3-token prompt for 2 tokens: builds the kernels the
        served path launches before the first request."""
        t0 = time.time()
        for _ in self.generate([1, 2, 3], GenerationConfig(max_tokens=2,
                                                           temperature=0.0)):
            pass
        dt = time.time() - t0
        logger.info("warmup done in %.2fs", dt)
        return dt
