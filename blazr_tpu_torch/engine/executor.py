"""Single-stream executor over the contiguous KV cache.

Counterpart of ``blazr_tpu/engine/executor.py::Executor`` (:56): model +
tokenizer + cache, bucketed prefill, a streaming ``generate`` loop with
sampling fused on the device (``engine/sampling.py``) and top-20 logprobs,
and session KV reuse when a prompt extends the previous one.

Each decode token is one fixed-shape step, forward plus sampling at one row
(``decode_graph.ExecutorStep``, the counterpart of the jitted
``decode_step`` at :130): token, position, sampling parameters and penalty
window go up in one table, and the token, its logprob (and the top-20) come
back in one fetch a token, as in the JAX executor. On CUDA the step is a
CUDA graph per (top-K logprobs, sampled) and cache, captured on first use
(``inference.graphs``; off, and on the CPU, the same step runs eagerly).
A graph holds its cache's buffers, so the caches live with the executor
and are written in place: a generation takes a free one (a new one while
every one is in use), and a reused session cache is taken over instead of
copied (never for Mamba2 and hybrid models, whose state holds every token
fed; their prompts run in exact power-of-two pieces, JAX :308-332).
Other prompts are still padded to power-of-two buckets (pads write to
the cache's trash slot), so every matmul sees the row count the JAX
executor's programs see, and the row-count routing of ``w4a8-prefill``
agrees. ``inference.quant_compute`` is applied to the model's params in
place when the executor is built.

Not served yet; each raises ``NotImplementedError`` naming its ROADMAP
queue A item, as ``BatchEngine`` does: grammars and JSON mode (5a.4), host
samplers (mirostat/DRY/typical/dynatemp; 5a.3), LoRA (5a.6), TP/EP/SP
meshes and ring prefill (13), MoE offload and streaming (host-offloaded)
models (12).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config.app import AppConfig
from ..config.generation import GenerationConfig
from ..models.registry import Model
from ..quant.qtensor import apply_quant_compute
from .batch_engine import _next_pow2, _not_served, check_request
from .decode_graph import TOPK_K, ExecutorStep, StepGraphs, pack_rows
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
        # Last completed session's (fed tokens, cache step), reused when the
        # next prompt extends it (reference executor_generate.rs:230-249).
        self._session: Optional[tuple[list[int], ExecutorStep]] = None
        # Caches (each with its decode step) that no generation holds.
        self._free: list[ExecutorStep] = []
        self._lock = threading.Lock()
        self.graphs = StepGraphs(model.device, inf.graphs)
        # In place: a w8a8-widened weight replaces its 4-bit copy one leaf
        # at a time, so the 4-bit copy is freed.
        apply_quant_compute(model.params, inf.quant_compute, inplace=True)

    @staticmethod
    def _check_config(inf) -> None:
        if inf.kv_cache_dtype not in ("auto", "int8", "int4"):
            raise ValueError(f"unknown kv_cache_dtype {inf.kv_cache_dtype!r}")
        if max(inf.tensor_parallel_size, inf.data_parallel_size,
               inf.expert_parallel_size, inf.sequence_parallel_size) > 1:
            raise _not_served("multi-device serving and ring prefill", "13")
        if inf.moe_offload:
            raise _not_served("MoE expert offload", "12")
        if inf.num_device_layers is not None:
            raise _not_served("streaming (host-offloaded) models", "12")

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _init_cache(self, batch: int):
        """The family's cache honouring ``inference.kv_cache_dtype`` (int8
        or int4 KV with per-token scales, int8 MLA latents, else the model
        dtype); the recurrent families' caches take no quantized mode, as
        in the JAX executor (:282-287)."""
        kv_dtype = self.app_cfg.inference.kv_cache_dtype
        return self.model.init_cache(
            batch, self.capacity,
            kv_quant=kv_dtype in ("int8", "int4") and not self.model.needs_ssm_state,
            kv_dtype=kv_dtype)

    # ------------------------------------------------------------------
    # session KV reuse
    # ------------------------------------------------------------------
    def _session_restore(self, prompt_ids: list[int]) -> tuple[Optional[ExecutorStep], int]:
        """(cache step, start) reusing the previous session's cache when the
        new prompt extends it and no generation holds it; (None, 0) on a
        miss. The cache is taken over and trimmed to the matched prefix:
        later slots are overwritten by the suffix prefill or masked by the
        length."""
        if (not self.app_cfg.inference.prefix_cache or self._session is None
                or self._session[1] not in self._free):
            return None, 0
        toks, step = self._session
        limit = min(len(toks), len(prompt_ids) - 1)
        n = 0
        while n < limit and toks[n] == prompt_ids[n]:
            n += 1
        if n < self._MIN_REUSE_TOKENS:
            return None, 0
        self._session = None
        step.cache.length.clamp_(max=n)
        return step, n

    def _session_save(self, fed_tokens: list[int], step: ExecutorStep) -> None:
        # Positional caches only (KV, MLA latents): a recurrent state holds
        # every token fed and cannot be trimmed back to a prefix.
        if self.app_cfg.inference.prefix_cache and not self.model.needs_ssm_state:
            self._session = (list(fed_tokens), step)

    def _take(self, prompt_ids: list[int]) -> tuple[ExecutorStep, int]:
        """A cache (with its decode step) for one generation and the prompt
        tokens its KV already holds: the session's on a hit, else a free
        one emptied (the session's last), else a new one."""
        with self._lock:
            step, start = self._session_restore(prompt_ids)
            if step is None:
                session = self._session[1] if self._session else None
                others = [s for s in self._free if s is not session]
                if others:
                    step = others[0]
                elif self._free:
                    step, self._session = self._free[0], None
                else:
                    step = ExecutorStep(self.model, self._init_cache(1), self.device)
                reset = getattr(step.cache, "reset_", None)   # a recurrent state
                if reset is not None:
                    reset()
                else:
                    step.cache.length.zero_()
            if step in self._free:
                self._free.remove(step)
            return step, start

    def _give_back(self, fed_tokens: list[int], step: ExecutorStep) -> None:
        with self._lock:
            self._session_save(fed_tokens, step)
            self._free.append(step)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, cache, prompt_ids: list[int], start_pos: int = 0):
        """Bucketed prefill. Returns (last logits [1, V] on the device,
        cache). Chunks of ``prefill_chunk_size`` are padded to a power of
        two; pad positions write to the cache's trash slot. Models with a
        recurrent state run exact power-of-two pieces instead (JAX :308-332):
        a pad token would enter the scan."""
        n = len(prompt_ids)
        assert n > 0, "empty prompt"
        bucket = min(_next_pow2(n), self.capacity)
        chunk = min(self.app_cfg.inference.prefill_chunk_size or bucket, bucket)
        dev = self.device
        pos = start_pos
        last = None
        if self.model.needs_ssm_state:
            idx = 0
            while idx < n:
                sub = 1 << min(chunk, n - idx).bit_length() - 1
                logits, cache = self.model.forward(
                    torch.tensor([prompt_ids[idx:idx + sub]], device=dev), cache,
                    torch.arange(pos, pos + sub, device=dev)[None],
                    torch.tensor([pos + sub], dtype=torch.int32, device=dev))
                last = logits[:, sub - 1, :]
                pos += sub
                idx += sub
            return last, cache
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
    def _decode(self, step: ExecutorStep, cfg: GenerationConfig, tok: int, pos: int,
                index: int, history: list[int]) -> tuple[int, float, Optional[list]]:
        """One decode token: the table up, the step (a graph replay on the
        card), and ONE host fetch of the token, its logprob and (with
        ``cfg.logprobs``) the top-20."""
        use_topk = bool(cfg.logprobs)
        sampled = cfg.temperature > 0.0
        step.tab.copy_(torch.from_numpy(step.build(
            cfg, tok, pos, index, make_window(history, cfg.repeat_last_n))))
        self.graphs.run((step, use_topk, sampled), step.step_fn(use_topk, sampled))
        return self._row(step.out[use_topk][0].cpu().numpy(), cfg)

    @torch.no_grad()
    def _sample(self, last: torch.Tensor, cfg: GenerationConfig, step: int,
                history: list[int], bias) -> tuple[int, float, Optional[list]]:
        """Fused device sampling of the prefill's [1, V] logits; ONE host
        fetch."""
        dev = self.device
        sp = SamplingParams.from_config([cfg], step=step, device=dev)
        window = torch.from_numpy(make_window(history, cfg.repeat_last_n)[None, :]).to(dev)
        tok, logprobs = sample_tokens(last, sp, window, *bias)
        return self._row(pack_rows(tok, logprobs, bool(cfg.logprobs))[0].cpu().numpy(), cfg)

    def _row(self, row, cfg: GenerationConfig) -> tuple[int, float, Optional[list]]:
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
        step, start = self._take(prompt_ids)
        kv_tokens = list(prompt_ids[:start])     # tokens whose KV the cache holds
        try:
            last, _ = self.prefill(step.cache, prompt_ids[start:], start_pos=start)
            kv_tokens = list(prompt_ids)
            history = list(prompt_ids)
            ids, vals = make_bias_rows([cfg])
            bias = (torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(vals).to(self.device))
            pos = len(prompt_ids)
            tok, lp, top = self._sample(last, cfg, 0, history, bias)
            for i in range(max_new):
                is_eos = self.tokenizer.is_eos(tok)
                yield GeneratedToken(token_id=tok,
                                     text="" if is_eos else self._token_text(tok),
                                     logprob=lp, top_logprobs=top)
                history.append(tok)
                if is_eos or i + 1 >= max_new or pos + 1 >= self.capacity:
                    return
                fed = tok
                tok, lp, top = self._decode(step, cfg, fed, pos, i + 1, history)
                kv_tokens.append(fed)
                pos += 1
        finally:
            # Runs on a normal finish and on a client disconnect alike.
            self._give_back(kv_tokens, step)

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
