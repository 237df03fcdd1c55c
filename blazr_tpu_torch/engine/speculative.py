"""Speculative decoding on the Executor: draft k tokens, verify them in one
target forward, keep the longest prefix the target agrees with.

Counterpart of ``blazr_tpu/engine/speculative.py``: ``SpeculativeStats``
(:35), ``SpeculativeExecutor`` (:50; a draft and a target ``Executor``),
``prompt_lookup_draft`` (:169) and ``PromptLookupExecutor`` (:185; drafts
copied from the sequence's own history). Verification is the target's
argmax over ``[cur, drafts...]`` in one ``Executor._verify_step``, so the
stream is exactly the target's greedy one whatever the drafts; run it with
the penalty-free greedy preset (penalties are not applied inside a block,
as in JAX). Both executors take their caches from the ``Executor``'s own
(``_take``/``_give_back``) and roll a rejected suffix back by the cache's
length, which the contiguous cache masks by.

The draft model sees every token it proposed. The reference feeds the
draft ``cur, d1 … d(k-1)``: after a round that accepts all k drafts, d_k's
K/V is never written and the next round attends over that unwritten slot
(only acceptance suffers; ROADMAP §C). Here such a round writes d_k's K/V
with one more draft forward, and a rejection needs no re-sync forward (the
reference's rewrites a slot the draft chain already wrote). The batched
path of ``BatchEngine`` is ``engine/batch_engine.py``.

Models with a recurrent state (Mamba2, hybrid) raise: a rejected draft
cannot roll the state back.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator, Optional

import torch

from ..config.generation import GenerationConfig
from ..config.inference import SpeculativeDecodingConfig
from .types import GeneratedToken

logger = logging.getLogger(__name__)


@dataclass
class SpeculativeStats:
    """Accepted/rejected counters."""

    drafted: int = 0
    accepted: int = 0
    rejected: int = 0
    rounds: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


def prompt_lookup_draft(tokens: list[int], budget: int,
                        ngram_max: int = 3, ngram_min: int = 1) -> list[int]:
    """Find the most recent earlier occurrence of the longest trailing
    n-gram and copy its continuation (prompt-lookup / n-gram drafting)."""
    t = len(tokens)
    for n in range(min(ngram_max, t - 1), ngram_min - 1, -1):
        tail = tokens[t - n:]
        # most recent first, the trailing match itself excluded
        for s in range(t - n - 1, -1, -1):
            if tokens[s:s + n] == tail:
                cont = tokens[s + n:s + n + budget]
                if cont:
                    return cont
    return []


def check_speculative(*models) -> None:
    """Raise for a model whose cache holds a recurrent state. A model sliced
    to a mesh's rank is served: its verify and draft forwards cross the mesh
    like its other steps, and every rank drafts the same tokens."""
    for m in models:
        if m.needs_ssm_state:
            raise ValueError(
                f"speculative decoding needs a positional cache: {m.cfg.model_type} "
                "holds a recurrent state, which a rejected draft cannot roll back")


def _warn_penalties(cfg: GenerationConfig) -> None:
    if cfg.repeat_penalty != 1.0 or cfg.frequency_penalty or cfg.presence_penalty:
        logger.warning("speculative verification is pure argmax; repeat/frequency/"
                       "presence penalties are ignored (set repeat_penalty=1.0 to "
                       "silence)")


def _step_inputs(dev: torch.device, toks: list[int], pos: int):
    """(tokens [1, T], positions [1, T], seq_lens [1]) of a block at ``pos``."""
    n = len(toks)
    return (torch.tensor([toks], dtype=torch.long, device=dev),
            torch.arange(pos, pos + n, device=dev)[None],
            torch.tensor([pos + n], dtype=torch.int32, device=dev))


def _trim(cache, length: int) -> None:
    """Roll the contiguous cache back to ``length`` tokens, in place."""
    cache.length.clamp_(max=length)


class _Verifier:
    """What both executors share: the target's verify of ``[cur, drafts]``
    and the accepted prefix."""

    def __init__(self, target):
        self.target = target
        self.stats = SpeculativeStats()

    def _verify(self, cache, cur: int, drafts: list[int], pos: int) -> tuple[int, int]:
        """(accepted drafts, the target's next token) after one verify."""
        logits, _ = self.target._verify_step(
            cache, *_step_inputs(self.target.device, [cur] + drafts, pos))
        greedy = logits[0].argmax(dim=-1).tolist()
        n = 0
        while n < len(drafts) and greedy[n] == drafts[n]:
            n += 1
        self.stats.accepted += n
        self.stats.rejected += len(drafts) - n
        return n, greedy[n]

    def _text(self, tok: int) -> str:
        try:
            return self.target.tokenizer.decode([tok])
        except Exception:
            return ""


class SpeculativeExecutor(_Verifier):
    """Drives a draft + target ``Executor`` pair (greedy)."""

    def __init__(self, draft, target, cfg: Optional[SpeculativeDecodingConfig] = None):
        super().__init__(target)
        check_speculative(draft.model, target.model)
        if draft.model.vocab_size != target.model.vocab_size:
            raise ValueError(f"draft model vocab ({draft.model.vocab_size}) != target "
                             f"vocab ({target.model.vocab_size})")
        self.draft = draft
        self.cfg = cfg or SpeculativeDecodingConfig()

    def generate(self, prompt_ids: list[int], gen_cfg: GenerationConfig
                 ) -> Iterator[GeneratedToken]:
        """Greedy speculative generation (exact target parity)."""
        _warn_penalties(gen_cfg)
        k = self.cfg.num_speculative_tokens
        max_new = gen_cfg.max_tokens
        capacity = min(self.target.capacity, self.draft.capacity)
        t_step, _ = self.target._take(prompt_ids, reuse=False)
        d_step, _ = self.draft._take(prompt_ids, reuse=False)
        t_cache, d_cache = t_step.cache, d_step.cache
        dev = self.draft.device
        try:
            t_last, _ = self.target.prefill(t_cache, prompt_ids)
            self.draft.prefill(d_cache, prompt_ids)
            tokens = list(prompt_ids)
            emitted = 0
            cur = int(t_last[0].argmax())
            while emitted < max_new and len(tokens) + 1 < capacity:
                yield GeneratedToken(token_id=cur, text=self._text(cur))
                emitted += 1
                tokens.append(cur)
                if self.target.tokenizer.is_eos(cur) or emitted >= max_new:
                    return
                # Draft k tokens (greedy), one draft forward each.
                drafts: list[int] = []
                d_in = cur
                pos = len(tokens) - 1
                budget = min(k, capacity - len(tokens) - 1, max_new - emitted)
                for j in range(budget):
                    d_logits, _ = self.draft._forward_step(
                        d_cache, *_step_inputs(dev, [d_in], pos + j))
                    d_in = int(d_logits[0].argmax())
                    drafts.append(d_in)
                self.stats.drafted += len(drafts)
                self.stats.rounds += 1
                n, nxt = self._verify(t_cache, cur, drafts, pos)
                for tok in drafts[:n]:
                    yield GeneratedToken(token_id=tok, text=self._text(tok))
                    emitted += 1
                    tokens.append(tok)
                    if self.target.tokenizer.is_eos(tok) or emitted >= max_new:
                        return
                cur = nxt
                _trim(t_cache, len(tokens))
                _trim(d_cache, len(tokens))
                if drafts and n == len(drafts):
                    # Every draft accepted: write d_k's K/V (logits dropped).
                    self.draft._forward_step(d_cache,
                                             *_step_inputs(dev, [drafts[-1]], pos + n))
                # Adaptive depth (reference adaptive_depth).
                if self.cfg.adaptive_depth and self.stats.rounds % 8 == 0:
                    rate = self.stats.acceptance_rate
                    if rate > 0.8:
                        k = min(k + 1, 16)
                    elif rate < 0.4:
                        k = max(k - 1, 1)
        finally:
            self.target._give_back(None, t_step)
            self.draft._give_back(None, d_step)


class PromptLookupExecutor(_Verifier):
    """Draft-model-free speculation: drafts are copied from the sequence's
    own history (the longest recent n-gram that re-occurs earlier proposes
    its historical continuation); the target verifies them in one forward
    as the draft-model path does."""

    def __init__(self, target, num_speculative_tokens: int = 8,
                 ngram_max: int = 3, ngram_min: int = 1):
        super().__init__(target)
        check_speculative(target.model)
        self.k = num_speculative_tokens
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def _draft(self, tokens: list[int], budget: int) -> list[int]:
        return prompt_lookup_draft(tokens, budget, self.ngram_max, self.ngram_min)

    def generate(self, prompt_ids: list[int], gen_cfg: GenerationConfig
                 ) -> Iterator[GeneratedToken]:
        """Greedy prompt-lookup generation (exact target parity)."""
        _warn_penalties(gen_cfg)
        max_new = gen_cfg.max_tokens
        capacity = self.target.capacity
        step, _ = self.target._take(prompt_ids, reuse=False)
        cache = step.cache
        try:
            last, _ = self.target.prefill(cache, prompt_ids)
            tokens = list(prompt_ids)
            emitted = 0
            cur = int(last[0].argmax())
            while emitted < max_new and len(tokens) + 1 < capacity:
                yield GeneratedToken(token_id=cur, text=self._text(cur))
                emitted += 1
                tokens.append(cur)
                if self.target.tokenizer.is_eos(cur) or emitted >= max_new:
                    return
                pos = len(tokens) - 1
                budget = min(self.k, capacity - len(tokens) - 1, max_new - emitted)
                drafts = self._draft(tokens, budget)
                self.stats.drafted += len(drafts)
                self.stats.rounds += 1
                n, nxt = self._verify(cache, cur, drafts, pos)
                for tok in drafts[:n]:
                    yield GeneratedToken(token_id=tok, text=self._text(tok))
                    emitted += 1
                    tokens.append(tok)
                    if self.target.tokenizer.is_eos(tok) or emitted >= max_new:
                        return
                cur = nxt
                _trim(cache, len(tokens))
        finally:
            self.target._give_back(None, step)
