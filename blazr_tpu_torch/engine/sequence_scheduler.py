"""Continuous-batching sequence scheduler.

Copy of ``blazr_tpu/engine/sequence_scheduler.py`` (boostr
``inference::scheduler::SequenceScheduler``): FIFO admission of waiting
sequences into the running set under batch-size / token / KV-block
budgets; per-step scheduling returns the prefills to run and the decode
batch; block tables grow as sequences decode past block boundaries. With a
prefix cache, admission takes the cached prompt blocks and starts the
prefill after them, and every block goes through the cache.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from ..config.generation import GenerationConfig
from ..kvcache.block_allocator import BlockAllocator, blocks_needed
from ..kvcache.prefix_cache import PrefixCache


class SequenceState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    ABORTED = "aborted"


@dataclass
class SchedulerConfig:
    max_batch_size: int = 8
    max_batch_tokens: int = 4096
    block_size: int = 16
    max_seq_len: int = 4096


@dataclass(eq=False)                  # identity equality: sequences are
class Sequence:                       # unique objects, and list-membership
    seq_id: int                       # checks must not deep-compare 32k-
    prompt_tokens: list[int]          # token prompt lists on the hot path
    gen_cfg: GenerationConfig
    state: SequenceState = SequenceState.WAITING
    output_tokens: list[int] = field(default_factory=list)
    block_table: list[int] = field(default_factory=list)
    cached_tokens: int = 0            # prefix-cache hit length
    prefilled_tokens: int = 0         # how much of the prompt is prefilled
    # Tokens EMITTED to the client — survives preemption (which folds
    # outputs into the prompt and clears output_tokens; counting those
    # would reset the max_tokens budget and over-generate).
    emitted: int = 0

    @property
    def total_len(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def all_tokens(self) -> list[int]:
        return self.prompt_tokens + self.output_tokens

    @property
    def needs_prefill(self) -> bool:
        return self.prefilled_tokens < len(self.prompt_tokens)


@dataclass
class ScheduledBatch:
    prefill_sequences: list[Sequence] = field(default_factory=list)
    decode_sequences: list[Sequence] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not (self.prefill_sequences or self.decode_sequences)


class SequenceScheduler:
    def __init__(self, allocator: BlockAllocator,
                 config: Optional[SchedulerConfig] = None,
                 prefix_cache: Optional[PrefixCache] = None):
        self.allocator = allocator
        self.config = config or SchedulerConfig()
        self.prefix_cache = prefix_cache
        self._ids = itertools.count(1)
        self.waiting: list[Sequence] = []
        self.running: dict[int, Sequence] = {}
        self.sequences: dict[int, Sequence] = {}
        self.preemptions = 0

    # ------------------------------------------------------------------
    def add_request(self, prompt_tokens: list[int],
                    gen_cfg: Optional[GenerationConfig] = None) -> int:
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self.config.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt_tokens)} >= max_seq_len "
                f"{self.config.max_seq_len}")
        seq = Sequence(
            seq_id=next(self._ids),
            prompt_tokens=list(prompt_tokens),
            gen_cfg=gen_cfg or GenerationConfig(),
        )
        self.sequences[seq.seq_id] = seq
        self.waiting.append(seq)
        return seq.seq_id

    # ------------------------------------------------------------------
    def schedule(self) -> ScheduledBatch:
        """Admit waiting sequences (allocating their prompt blocks) and
        return this step's work (reference SequenceScheduler::schedule)."""
        batch = ScheduledBatch()

        # Ensure every running decode sequence has a slot for its next token.
        for seq in list(self.running.values()):
            if seq.seq_id not in self.running:
                continue                 # preempted as a victim below
            while not self._ensure_block_for(seq, seq.total_len):
                # Pool exhausted: preempt the NEWEST running sequence
                # (least progress lost — reference policy), retrying the
                # current one until it fits or becomes the victim itself.
                victim = max(self.running.values(), key=lambda s: s.seq_id)
                self._preempt(victim)
                if victim is seq:
                    break
            if seq.seq_id not in self.running:
                continue
            if not seq.needs_prefill:
                batch.decode_sequences.append(seq)

        # Admission: FIFO while under budgets. A prompt longer than one
        # step's token budget is still admitted — only its first chunk
        # counts against this step; the chunked-prefill path finishes the
        # rest across later steps (reference batch_engine.rs:171-319).
        budget_tokens = self.config.max_batch_tokens - sum(
            1 for _ in batch.decode_sequences)
        while self.waiting:
            if len(self.running) >= self.config.max_batch_size:
                break
            if budget_tokens <= 0:
                break
            seq = self.waiting[0]
            if not self._allocate_prompt_blocks(seq):
                break
            remaining_prefill = len(seq.prompt_tokens) - seq.prefilled_tokens
            self.waiting.pop(0)
            seq.state = SequenceState.RUNNING
            self.running[seq.seq_id] = seq
            batch.prefill_sequences.append(seq)
            budget_tokens -= min(remaining_prefill, budget_tokens)

        # Continuing prefills of already-running sequences (chunked prefill).
        for seq in self.running.values():
            if seq.needs_prefill and seq not in batch.prefill_sequences:
                batch.prefill_sequences.append(seq)
        return batch

    # ------------------------------------------------------------------
    def _allocate_prompt_blocks(self, seq: Sequence) -> bool:
        if seq.block_table:
            return True
        n = blocks_needed(len(seq.prompt_tokens) + 1, self.config.block_size)
        if self.prefix_cache is not None:
            try:
                cached, blocks = self.prefix_cache.get_or_allocate_blocks(
                    seq.seq_id, seq.prompt_tokens)
            except MemoryError:
                return False
            seq.cached_tokens = cached
            # A cache hit covering the whole prompt must still recompute the
            # final token (its logits are needed) — reference behavior.
            if cached >= len(seq.prompt_tokens):
                seq.cached_tokens = len(seq.prompt_tokens) - 1
            seq.prefilled_tokens = seq.cached_tokens
            seq.block_table = blocks
            missing = n - len(blocks)
            if missing > 0:
                try:
                    seq.block_table.extend(
                        self.prefix_cache.extend(seq.seq_id, missing))
                except MemoryError:
                    # Release everything: a WAITING sequence must not
                    # hoard blocks, or admission livelocks while running
                    # decodes can't extend either.
                    self._release_blocks(seq)
                    seq.block_table = []
                    seq.cached_tokens = 0
                    seq.prefilled_tokens = 0
                    return False
            return True
        if not self.allocator.can_allocate(n):
            return False
        seq.block_table = self.allocator.allocate(n)
        return True

    def _ensure_block_for(self, seq: Sequence, pos: int) -> bool:
        need = blocks_needed(pos + 1, self.config.block_size)
        while len(seq.block_table) < need:
            if self.prefix_cache is not None:
                try:
                    seq.block_table.extend(self.prefix_cache.extend(seq.seq_id, 1))
                except MemoryError:
                    return False
            else:
                if not self.allocator.can_allocate(1):
                    return False
                seq.block_table.extend(self.allocator.allocate(1))
        return True

    def _preempt(self, seq: Sequence) -> None:
        """Return a sequence to the waiting queue, dropping its blocks."""
        self.preemptions += 1
        self._release_blocks(seq)
        seq.prefilled_tokens = 0
        seq.cached_tokens = 0
        seq.prompt_tokens = seq.all_tokens
        seq.output_tokens = []
        seq.state = SequenceState.WAITING
        self.running.pop(seq.seq_id, None)
        self.waiting.insert(0, seq)

    # ------------------------------------------------------------------
    def prefill_complete(self, seq_id: int, num_tokens: int) -> None:
        seq = self.sequences[seq_id]
        seq.prefilled_tokens = min(seq.prefilled_tokens + num_tokens,
                                   len(seq.prompt_tokens))
        if self.prefix_cache is not None:
            # Blocks now covered by real KV become servable cache hits.
            self.prefix_cache.mark_computed(seq_id, seq.prefilled_tokens)

    def append_token(self, seq_id: int, token: int) -> None:
        seq = self.sequences[seq_id]
        seq.output_tokens.append(token)
        seq.emitted += 1

    def finish_sequence(self, seq_id: int) -> None:
        seq = self.sequences.get(seq_id)
        if seq is None:
            return
        seq.state = SequenceState.FINISHED
        self.running.pop(seq_id, None)
        self._release_blocks(seq)

    def abort_sequence(self, seq_id: int) -> None:
        seq = self.sequences.get(seq_id)
        if seq is None:
            return
        seq.state = SequenceState.ABORTED
        self.running.pop(seq_id, None)
        if seq in self.waiting:
            self.waiting.remove(seq)
        self._release_blocks(seq)

    def cleanup_finished(self) -> None:
        done = [sid for sid, s in self.sequences.items()
                if s.state in (SequenceState.FINISHED, SequenceState.ABORTED)]
        for sid in done:
            del self.sequences[sid]

    def _release_blocks(self, seq: Sequence) -> None:
        if self.prefix_cache is not None:
            self.prefix_cache.release_blocks(seq.seq_id)
        elif seq.block_table:
            self.allocator.free(seq.block_table)
        seq.block_table = []

    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def get_block_table(self, seq_id: int) -> list[int]:
        return self.sequences[seq_id].block_table

    def stats(self) -> dict:
        return {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "block_stats": self.allocator.stats().__dict__,
        }
