"""Non-streaming generation + stop-sequence machinery.

Counterpart of ``blazr_tpu/engine/generate_text.py`` (the reference's
src/engine/generate_text.rs: collect stream → GenerationResult, JSON-mode
retry ≤3, stop-sequence truncation; and the cross-token stop-sequence
scanner from src/server/generation.rs:105-191, streaming with holdback so a
stop sequence split across tokens is never emitted). Works over any executor
with ``generate(prompt_ids, cfg)`` and a ``tokenizer``.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

from ..config.generation import GenerationConfig
from ..model_meta.think import extract_thinking
from .types import FinishReason, GenerationResult, is_valid_json


class StopScanner:
    """Streaming stop-sequence scanner with holdback
    (reference generation.rs stream_with_stop_sequences).

    ``push(text)`` returns (emit_now, stopped): text safe to emit, and
    whether a stop sequence fired. Held-back text that turns out not to be
    a stop prefix is released on the next push or ``flush()``.
    """

    def __init__(self, stop_sequences: list[str]):
        self.stops = [s for s in stop_sequences if s]
        self.max_len = max((len(s) for s in self.stops), default=0)
        self.pending = ""
        self.stopped = False

    def push(self, text: str) -> tuple[str, bool]:
        if self.stopped:
            return "", True
        if not self.stops:
            return text, False
        self.pending += text
        # Full stop sequence present → truncate and stop.
        cut = None
        for s in self.stops:
            i = self.pending.find(s)
            if i != -1 and (cut is None or i < cut):
                cut = i
        if cut is not None:
            out = self.pending[:cut]
            self.pending = ""
            self.stopped = True
            return out, True
        # Hold back the longest suffix that could still grow into a stop.
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.pending)), 0, -1):
                if self.pending.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            out = self.pending[:-hold]
            self.pending = self.pending[-hold:]
        else:
            out = self.pending
            self.pending = ""
        return out, False

    def flush(self) -> str:
        out = self.pending
        self.pending = ""
        return out


def collect_generation(
    executor,
    prompt_ids: list[int],
    cfg: GenerationConfig,
    extract_think: bool = False,
) -> GenerationResult:
    """Run a full generation and collect the result (reference
    generate_text(), generate_text.rs:36). JSON mode retries up to 3 times
    until the output parses (generate_text.rs:46-58)."""
    attempts = 3 if cfg.json_mode else 1
    last_result: Optional[GenerationResult] = None
    for attempt in range(attempts):
        result = _collect_once(executor, prompt_ids, cfg, attempt)
        last_result = result
        if not cfg.json_mode or is_valid_json(result.text):
            break
    assert last_result is not None
    if extract_think:
        thinking, rest = extract_thinking(last_result.text)
        last_result.thinking = thinking
        last_result.text = rest
    return last_result


def _collect_once(executor, prompt_ids: list[int], cfg: GenerationConfig,
                  attempt: int) -> GenerationResult:
    if attempt > 0 and cfg.seed is not None:
        cfg = GenerationConfig.from_dict({**cfg.to_dict(),
                                          "seed": cfg.seed + attempt})
    scanner = StopScanner(cfg.stop_sequences)
    pieces: list[str] = []
    tokens: list[int] = []
    gen_tokens = [] if cfg.logprobs else None
    logprobs = [] if cfg.logprobs else None
    top_logprobs = [] if cfg.logprobs else None
    finish = FinishReason.LENGTH
    t0 = time.time()
    first_token_time = None

    for gt in executor.generate(prompt_ids, cfg):
        if first_token_time is None:
            first_token_time = time.time()
        tokens.append(gt.token_id)
        if gen_tokens is not None:
            gen_tokens.append(gt)
        if logprobs is not None and gt.logprob is not None:
            logprobs.append(gt.logprob)
        if top_logprobs is not None and gt.top_logprobs is not None:
            top_logprobs.append(gt.top_logprobs)
        if executor.tokenizer.is_eos(gt.token_id):
            finish = FinishReason.EOS
            break
        emit, stopped = scanner.push(gt.text)
        pieces.append(emit)
        if stopped:
            finish = FinishReason.STOP
            break
    else:
        pieces.append(scanner.flush())
    eval_duration = time.time() - (first_token_time or t0)

    return GenerationResult(
        text="".join(pieces),
        tokens=tokens,
        finish_reason=finish,
        prompt_tokens=len(prompt_ids),
        completion_tokens=len(tokens),
        logprobs=logprobs,            # type: ignore[arg-type]
        top_logprobs=top_logprobs,    # type: ignore[arg-type]
        gen_tokens=gen_tokens,
        prompt_eval_duration=(first_token_time or t0) - t0,
        eval_duration=eval_duration,
    )


def stream_generation(
    executor,
    prompt_ids: list[int],
    cfg: GenerationConfig,
    with_tokens: bool = False,
) -> Iterator[tuple]:
    """Streaming variant: yields (text_delta, finish_reason|None) — or
    (text_delta, finish_reason|None, GeneratedToken|None) 3-tuples when
    ``with_tokens`` (the logprobs streaming path needs per-token
    logprob/top-k alongside the scanner-gated text)."""
    def _y(delta, fin, gt=None):
        return (delta, fin, gt) if with_tokens else (delta, fin)

    scanner = StopScanner(cfg.stop_sequences)
    emitted_any = False
    count = 0
    for gt in executor.generate(prompt_ids, cfg):
        count += 1
        if executor.tokenizer.is_eos(gt.token_id):
            tail = scanner.flush()
            yield _y(tail, FinishReason.EOS, gt)
            return
        emit, stopped = scanner.push(gt.text)
        if stopped:
            yield _y(emit, FinishReason.STOP, gt)
            return
        if emit:
            emitted_any = True
            yield _y(emit, None, gt)
        elif with_tokens:
            # Scanner held the text back but the token still needs its
            # logprobs entry on a later chunk.
            yield _y("", None, gt)
    yield _y(scanner.flush(), FinishReason.LENGTH)
