"""Continuous-batching engine over the paged KV cache.

Counterpart of ``blazr_tpu/engine/batch_engine.py::BatchEngine`` (:186): an
asyncio loop admits requests, runs batched (chunked) prefills with the
first token sampled in the same pass, then a decode round over every
running sequence, and streams tokens through per-request asyncio queues.

The decode round is the JAX engine's fixed-shape, pipelined round:
  * a round over ``bmax`` rows, the running count padded to a power of two
    and capped at ``max_batch`` (``_process_decode_batch_plain``, :1671),
    runs up to ``decode_horizon`` steps of ``decode_graph.BatchStep`` with
    the sampled tokens and penalty windows fed back on the device; its
    table carries block tables ``max_blocks_per_seq`` wide, and pad rows
    write to the trash slot (``_build_itab``, :1760);
  * on CUDA each step is a CUDA graph per (bmax, top-K logprobs, sampled
    rows), captured on first use (``inference.graphs``; off: the same steps
    run eagerly, and always on the CPU), so a round is one upload, T graph
    replays and one copy of its outputs into a pinned host ring;
  * rounds are pipelined (``_horizon_round``, :1796): round N+1 is queued
    from round N's carries before round N is read, and up to
    ``decode_pipe_depth`` rounds stay unread (``_emit_round``, :1940;
    ``_flush_pipe``, :1966). Chained rows keep their row; a row's in-flight
    tokens (its lag) advance its position and its sampling step, so a
    stream does not depend on the depth. The JAX engine's ordering argument
    holds as it is: every round and prefill writes the one cache in place
    on one stream, so work runs in the order it was queued, a freed block's
    stray writes land before its next owner's, and stale outputs are
    dropped at emit by the ``state != RUNNING`` check. Where the scheduler
    preempts a sequence, the unread rounds are dropped instead (their
    tokens are recomputed alike: the keys depend on (seed, step) only).
  * prefill rows are grouped by power-of-two token bucket, paced in ramped
    groups (cold bursts: one median-first group), and capped while decode
    rows are running so a decode round runs between prefill groups;
  * prefill groups run at their real number of prompts P, except while a
    weight carries a row threshold (``w4a8-prefill``): then the group is
    padded to the next power of two, as the JAX engine pads every group
    (batch_engine.py:1338), so the row count that picks B3 or B1 is the
    JAX engine's (P x bucket) and the two engines compute alike.
  * with ``inference.prefix_cache`` the scheduler shares full prompt
    blocks between sequences through ``kvcache.prefix_cache`` (a hit
    prefills only the suffix, from ``seq.prefilled_tokens``), and with
    ``gpu_prefix_cache`` too, evicted blocks go to a host-RAM tier and come
    back from it (``kvcache.host_tier``: copies in place, on the stream).
``warmup()`` does before the first request what eager PyTorch would
otherwise do inside it: build the kernels, initialise the libraries, run
one prefill per token bucket and capture every decode graph.
Left out of this slice, each naming its ROADMAP queue A item: speculation
(5a.5), grammars and JSON mode (5a.4), LoRA (5a.6), host samplers
(mirostat/DRY/typical/dynatemp; 5a.3), tensor/sequence parallel meshes
(13) and weight offload (12). A request or config that asks for one
raises instead of being served differently. int4 KV on the paged path
raises instead of being downgraded.

Every family of ``models/paged_multi.py`` is served: MLA models on latent
pages, Mamba2 and hybrid models on the state pool's rows
(``blazr_tpu/engine/batch_engine.py:1182-1221, 1402-1420``). A sequence
takes a row at its first prefill (``_row_for``), zeroed when a prefill
starts at token 0 (an admission, or a restart after preemption), and gives
it back when it ends; rows of sequences that are not running are reclaimed
when none is free. Their prefills run per sequence in exact power-of-two
pieces, so no pad token enters a scan; pad decode rows read and write the
pool's trash row. The prefix cache is off for them.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch

from ..config.app import AppConfig
from ..config.generation import GenerationConfig
from ..kvcache.block_allocator import BlockAllocator, blocks_needed
from ..kvcache.host_tier import attach_host_tier
from ..kvcache.paged import PAD_BLOCK, compute_slot_mapping, pad_block_table
from ..kvcache.prefix_cache import PrefixCache, PrefixCacheConfig
from ..models.paged_multi import trash_slot, zero_state_rows
from ..models.registry import init_engine_cache, make_paged_forward
from ..models.registry import Model
from ..quant.qtensor import apply_quant_compute, quant_leaves
from .decode_graph import TOPK_K, BatchStep, StepGraphs, pack_rows
from .sampling import SamplingParams, make_bias_rows, make_window, sample_tokens
from .sequence_scheduler import (SchedulerConfig, Sequence, SequenceScheduler,
                                 SequenceState)
from .types import FinishReason, GeneratedToken, TokenLogprob

logger = logging.getLogger(__name__)

# Max same-bucket prefill rows fused into one forward.
_PREFILL_GROUP = 32


def _next_pow2(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _ramp_sizes(n: int, first: int, cap: int) -> list[int]:
    """Split an n-row burst of FINISHING prefill rows into flat groups of
    ``first`` so each group's first tokens land when that group completes."""
    if first <= 0 or first >= cap:
        return [min(n, cap)] * -(-n // cap) if n else []
    out = []
    while n > 0:
        s = min(first, n)
        out.append(s)
        n -= s
    return out


def _median_first_sizes(n: int, first: int, cap: int) -> list[int]:
    """Cold-burst pacing: one front-loaded power-of-two group covering the
    median request, then small flat groups."""
    if first <= 0 or first >= cap or n <= first:
        return _ramp_sizes(n, first, cap)
    lead = 1
    while lead < min(-(-n // 2), cap):
        lead *= 2
    out = [min(lead, n)]
    return out + _ramp_sizes(n - out[0], min(first, 2), cap)


@dataclasses.dataclass
class RequestHandle:
    """Token stream handle."""

    seq_id: int
    queue: "asyncio.Queue[tuple[Optional[GeneratedToken], Optional[FinishReason]]]"
    prompt_tokens: int

    async def tokens(self):
        while True:
            tok, fin = await self.queue.get()
            if tok is not None:
                yield tok
            if fin is not None:
                return


def _not_served(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not served by blazr_tpu_torch yet (ROADMAP queue A item {item})")


def check_request(gen_cfg: GenerationConfig) -> None:
    """Raise for a request that asks for what the port does not serve yet."""
    if gen_cfg.grammar or gen_cfg.json_mode or gen_cfg.json_schema:
        raise _not_served("constrained decoding (grammar / JSON mode)", "5a.4")
    if gen_cfg.lora_adapter:
        raise _not_served("LoRA", "5a.6")
    if (gen_cfg.mirostat == 2 or gen_cfg.dry_multiplier > 0.0
            or gen_cfg.typical_p < 1.0 or gen_cfg.dynatemp_range > 0.0):
        raise _not_served("host-side sampling (mirostat/DRY/typical/dynatemp)", "5a.3")


class BatchEngine:
    """Paged-KV continuous-batching executor + scheduler loop. Runs on the
    device the model's params lie on."""

    def __init__(self, model: Model, tokenizer,
                 app_cfg: Optional[AppConfig] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.app_cfg = app_cfg or AppConfig(model=model.cfg)
        inf = self.app_cfg.inference
        self._check_config(inf)
        self.device = model.device
        self.block_size = inf.block_size
        self.max_batch = inf.max_batch_size
        self._horizon = max(1, int(inf.decode_horizon or 1))
        self.max_seq_len = min(self.app_cfg.effective_max_seq_len() or 4096,
                               model.cfg.max_seq_len or 4096)
        self.max_blocks_per_seq = -(-self.max_seq_len // self.block_size)
        num_blocks = inf.num_blocks or inf.kv_pool_blocks or (
            self.max_batch * self.max_blocks_per_seq)
        self.allocator = BlockAllocator(num_blocks, self.block_size)
        self.prefix_cache = (
            PrefixCache(self.allocator,
                        PrefixCacheConfig(max_cached_blocks=inf.max_cached_blocks))
            if inf.prefix_cache else None)
        self._chunk = inf.prefill_chunk_size or 4096
        self.scheduler = SequenceScheduler(
            self.allocator,
            SchedulerConfig(
                max_batch_size=self.max_batch,
                max_batch_tokens=(inf.max_batch_tokens
                                  or self._chunk * _PREFILL_GROUP),
                block_size=self.block_size,
                max_seq_len=self.max_seq_len,
            ),
            prefix_cache=self.prefix_cache)
        model.params = apply_quant_compute(model.params, inf.quant_compute)
        # Row-count routing (w4a8-prefill) needs the JAX engine's padded
        # prefill groups; other modes run the real number of prompts.
        self._pad_groups = any(qt.act_quant_min_m > 0
                               for qt in quant_leaves(model.params))
        self.cache, needs_state_rows = init_engine_cache(
            model.cfg, num_blocks, self.block_size, self.max_batch,
            dtype=model.dtype, quantized=inf.kv_cache_dtype == "int8",
            device=self.device)
        self._needs_state_rows = needs_state_rows
        if needs_state_rows:
            if self.prefix_cache is not None:
                # Recurrent state can never be reconstructed from cached KV
                # blocks — prefix reuse is attention-only.
                logger.warning("prefix cache disabled: model has recurrent (SSM) state")
                self.prefix_cache = None
                self.scheduler.prefix_cache = None
            # The state pool's rows: each running sequence owns one, given
            # out at its first prefill; row max_batch is the pad rows' trash.
            self._free_rows = list(range(self.max_batch))
            self._seq_rows: dict[int, int] = {}
        if self.prefix_cache is not None and inf.gpu_prefix_cache:
            attach_host_tier(self.prefix_cache, self.cache,
                             max_blocks=inf.prefix_cache_ram_tier)
        self._fwd = make_paged_forward(model.cfg)
        self._trash = trash_slot(self.cache)
        self.horizon_dispatches = 0
        self.horizon_steps = 0
        # The decode pipeline: dispatched, unread rounds (newest last;
        # carries chain from the newest), at most _pipe_depth after a call.
        self._pipe_q: deque = deque()
        self._pipe_depth = max(1, int(inf.decode_pipe_depth or 1))
        self._steps: dict[int, BatchStep] = {}          # by bmax
        self.graphs = StepGraphs(self.device, inf.graphs)
        self._preemptions = 0
        # Wall time by phase (seconds; "<phase>_n" counts calls) and the
        # prompt tokens the prefills computed ("prefill_tokens").
        self.perf: dict[str, float] = defaultdict(float)
        self._handles: dict[int, RequestHandle] = {}
        self._windows: dict[int, list[int]] = {}
        self._notify = asyncio.Event()
        self._stop = False
        self._loop = None
        self._loop_thread = None
        self._defer_puts: Optional[list] = None

    @staticmethod
    def _check_config(inf) -> None:
        if inf.kv_cache_dtype == "int4":
            raise ValueError("kv_cache_dtype='int4' is not supported on the "
                             "paged path (use 'int8' or 'auto')")
        if inf.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {inf.kv_cache_dtype!r}")
        if inf.speculative is not None and inf.speculative.num_speculative_tokens > 0:
            raise _not_served("speculative decoding", "5a.5")
        if max(inf.tensor_parallel_size, inf.data_parallel_size,
               inf.expert_parallel_size, inf.sequence_parallel_size) > 1:
            raise _not_served("multi-device serving", "13")
        if inf.moe_offload or inf.num_device_layers is not None:
            raise _not_served("weight offload", "12")

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------
    def submit(self, prompt_tokens: list[int],
               gen_cfg: Optional[GenerationConfig] = None) -> RequestHandle:
        gen_cfg = gen_cfg or GenerationConfig()
        gen_cfg.validate()
        check_request(gen_cfg)
        seq_id = self.scheduler.add_request(prompt_tokens, gen_cfg)
        handle = RequestHandle(seq_id=seq_id, queue=asyncio.Queue(),
                               prompt_tokens=len(prompt_tokens))
        self._handles[seq_id] = handle
        self._windows[seq_id] = list(prompt_tokens)
        self._notify.set()
        return handle

    def cancel(self, seq_id: int) -> None:
        """Abort a sequence (a stop sequence matched, or its client left):
        its blocks go back to the pool and its stream ends."""
        self.scheduler.abort_sequence(seq_id)
        self._finish(seq_id, None)

    def stop(self) -> None:
        self._stop = True
        self._notify.set()

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    async def run(self) -> None:
        self._stop = False
        # Tokens are emitted on to_thread workers; call_soon_threadsafe
        # wakes the loop for each delivery (see _put_now).
        self._loop = asyncio.get_running_loop()
        self._loop_thread = threading.get_ident()
        logger.info("batch engine started (max_batch=%d, blocks=%d, device=%s)",
                    self.max_batch, self.allocator.num_blocks, self.device)
        while not self._stop:
            if not self.scheduler.has_work:
                # No running rows: unread rounds are overrun of finished or
                # aborted sequences; drop them.
                self._pipe_q.clear()
                self._notify.clear()
                await self._notify.wait()
                continue
            try:
                if not await self.step_once():
                    await asyncio.sleep(0.001)
                    continue
            except Exception:
                logger.exception("batch failed; aborting batch sequences")
                self._pipe_q.clear()   # unread rounds are aborted with them
                for seq in list(self.scheduler.running.values()):
                    self.scheduler.abort_sequence(seq.seq_id)
                    self._finish(seq.seq_id, None)
        logger.info("batch engine stopped")

    async def step_once(self) -> bool:
        """One scheduling iteration: schedule, dispatch prefills, run ONE
        decode round, then fetch the prefills' first tokens. Returns False
        when the batch was empty."""
        t0 = time.perf_counter()
        batch = self.scheduler.schedule()
        self.perf["schedule"] += time.perf_counter() - t0
        if self.scheduler.preemptions != self._preemptions:
            # A preempted sequence may be admitted again while a round that
            # holds it is unread: drop the unread rounds (their sequences
            # recompute those tokens alike).
            self._preemptions = self.scheduler.preemptions
            self._pipe_q.clear()
        if batch.is_empty:
            return False
        pending: list = []
        cold = not any(s.state == SequenceState.RUNNING
                       for s in batch.decode_sequences)
        if batch.prefill_sequences:
            t0 = time.perf_counter()
            pending = await asyncio.to_thread(self._dispatch_prefills,
                                              batch.prefill_sequences, cold=cold)
            self.perf["prefill"] += time.perf_counter() - t0
            self.perf["prefill_n"] += 1
        decodes = [s for s in batch.decode_sequences
                   if s.state == SequenceState.RUNNING]
        if decodes:
            t0 = time.perf_counter()
            await asyncio.to_thread(self._horizon_round, decodes)
            self.perf["decode"] += time.perf_counter() - t0
            self.perf["decode_n"] += 1
        if pending:
            t0 = time.perf_counter()
            await asyncio.to_thread(self._finish_prefills, pending)
            self.perf["p_finish"] += time.perf_counter() - t0
        self.scheduler.cleanup_finished()
        return True

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def _sampling(self, cfgs: list[GenerationConfig], steps, rows: list[list[int]]):
        """Device-side sampling inputs: params, penalty windows, bias rows."""
        sp = SamplingParams.from_config(cfgs, steps, device=self.device)
        window = torch.from_numpy(np.stack(rows)).to(self.device)
        ids, vals = make_bias_rows(cfgs)
        return (sp, window, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(vals).to(self.device))

    @torch.no_grad()
    def _dispatch_prefills(self, seqs: list[Sequence], *, cold: bool) -> list:
        """Queue this step's prefill chunks, batching same-bucket chunks into
        one [P, T] forward with first-token sampling in the same pass.
        Returns the un-fetched outputs so the fetch overlaps the decode
        round."""
        chunk_cfg = self._chunk
        if not cold:
            # Decode rows are running: cap this step's finishing prefill
            # rows so their ITL is bounded by one group's wall; deferred
            # rows keep needs_prefill and are re-offered next step.
            inf = self.app_cfg.inference
            cap = inf.mixed_prefill_rows
            if cap is None:
                cap = inf.prefill_first_group
            if cap and cap > 0 and len(seqs) > cap:
                fin_all, cont_all = [], []
                for s in seqs:
                    rem = len(s.prompt_tokens) - s.prefilled_tokens
                    (fin_all if rem <= chunk_cfg else cont_all).append(s)
                kept = fin_all[:max(1, cap)] + cont_all[:_PREFILL_GROUP]
                self.perf["p_deferred_n"] += len(seqs) - len(kept)
                seqs = kept
        if self._needs_state_rows:
            return [self._prefill_rows(seq) for seq in seqs]
        groups: dict[int, list[Sequence]] = {}
        for seq in seqs:
            remaining = len(seq.prompt_tokens) - seq.prefilled_tokens
            groups.setdefault(_next_pow2(min(chunk_cfg, remaining)), []).append(seq)
        pending = []
        first = self.app_cfg.inference.prefill_first_group
        for bucket in sorted(groups):
            group = groups[bucket]
            fin = [s for s in group
                   if len(s.prompt_tokens) - s.prefilled_tokens <= chunk_cfg]
            cont = [s for s in group
                    if len(s.prompt_tokens) - s.prefilled_tokens > chunk_cfg]
            off = 0
            pace = _median_first_sizes if cold else _ramp_sizes
            for sz in pace(len(fin), first, _PREFILL_GROUP):
                pending.append(self._prefill_group(fin[off:off + sz], bucket,
                                                   chunk_cfg))
                off += sz
            for off in range(0, len(cont), _PREFILL_GROUP):
                pending.append(self._prefill_group(
                    cont[off:off + _PREFILL_GROUP], bucket, chunk_cfg))
        return pending

    def _prefill_group(self, group: list[Sequence], bucket: int, chunk_cfg: int):
        """Queue one [P, T] prefill over same-bucket chunks; returns the
        un-fetched outputs."""
        n_real = len(group)
        p = _next_pow2(n_real, minimum=1) if self._pad_groups else n_real
        bs = self.block_size
        starts = [s.prefilled_tokens for s in group]
        chunks = [min(chunk_cfg, len(s.prompt_tokens) - st)
                  for s, st in zip(group, starts)]
        # Tables only as wide as this chunk's keys need.
        mb = max(blocks_needed(st + c, bs) for st, c in zip(starts, chunks))
        # Pad rows: one token at position 0 on the trash slot, no blocks.
        toks = np.zeros((p, bucket), dtype=np.int64)
        pos = np.zeros((p, bucket), dtype=np.int64)
        slots = np.full((p, bucket), self._trash, dtype=np.int64)
        bt = np.full((p, mb), PAD_BLOCK, dtype=np.int32)
        finishing: list[tuple[Sequence, int]] = []
        cfgs, wins = [], []
        for i, (seq, start, chunk) in enumerate(zip(group, starts, chunks)):
            toks[i, :chunk] = seq.prompt_tokens[start:start + chunk]
            pos[i, :chunk] = np.arange(start, start + chunk)
            table = np.asarray(seq.block_table[:mb], dtype=np.int64)
            slots[i, :chunk] = table[pos[i, :chunk] // bs] * bs + pos[i, :chunk] % bs
            bt[i] = pad_block_table(seq.block_table[:mb], mb)
            cfgs.append(seq.gen_cfg)
            wins.append(make_window(self._windows[seq.seq_id],
                                    seq.gen_cfg.repeat_last_n))
            if start + chunk >= len(seq.prompt_tokens):
                finishing.append((seq, i))
        dev = self.device
        pad = p - n_real
        seq_lens = torch.tensor([st + c for st, c in zip(starts, chunks)] + [1] * pad,
                                dtype=torch.int32, device=dev)
        last_idx = torch.tensor([max(c - 1, 0) for c in chunks] + [0] * pad,
                                device=dev)
        self.perf["prefill_tokens"] += sum(chunks)
        logits, self.cache = self._fwd(
            self.model.params, self.model.cfg, torch.from_numpy(toks).to(dev),
            self.cache, torch.from_numpy(pos).to(dev),
            torch.from_numpy(slots).to(dev), torch.from_numpy(bt).to(dev),
            seq_lens, last_idx=last_idx)
        packed = None
        if finishing:
            sp, window, bias_ids, bias_vals = self._sampling(cfgs, 0, wins)
            tok, logprobs = sample_tokens(logits[:n_real, 0, :], sp, window,
                                          bias_ids, bias_vals)
            use_topk = any(s.gen_cfg.logprobs for s, _ in finishing)
            packed = pack_rows(tok, logprobs, use_topk)
        return group, chunks, finishing, packed

    def _row_for(self, seq_id: int) -> int:
        """The state row of ``seq_id``, given out at its first call; when no
        row is free, the rows of sequences that are not running come back."""
        row = self._seq_rows.get(seq_id)
        if row is None:
            if not self._free_rows:
                running = set(self.scheduler.running)
                for sid, r in list(self._seq_rows.items()):
                    if sid not in running:
                        self._seq_rows.pop(sid)
                        self._free_rows.append(r)
            row = self._free_rows.pop()
            self._seq_rows[seq_id] = row
        return row

    def _prefill_rows(self, seq: Sequence):
        """Queue one sequence's prefill chunk on its state row (the JAX
        engine's ``_process_prefill_ssm``): the chunk runs in exact
        power-of-two pieces, so no pad token enters a scan, and the row is
        zeroed first when the chunk starts at token 0. Returns the pending
        entry of ``_prefill_group``."""
        start = seq.prefilled_tokens
        chunk = min(self._chunk, len(seq.prompt_tokens) - start)
        row = self._row_for(seq.seq_id)
        if start == 0:
            zero_state_rows(self.cache, row)
        dev = self.device
        bs = self.block_size
        rows = torch.tensor([row], device=dev)
        pos = start
        while pos < start + chunk:
            sub = 1 << (start + chunk - pos).bit_length() - 1
            mb = blocks_needed(pos + sub, bs)
            slots = compute_slot_mapping(seq.block_table, pos, sub, bs, self._trash)
            logits, self.cache = self._fwd(
                self.model.params, self.model.cfg,
                torch.tensor([seq.prompt_tokens[pos:pos + sub]], device=dev), self.cache,
                torch.arange(pos, pos + sub, device=dev)[None],
                torch.from_numpy(slots.astype(np.int64))[None].to(dev),
                torch.from_numpy(pad_block_table(seq.block_table[:mb], mb))[None].to(dev),
                torch.tensor([pos + sub], dtype=torch.int32, device=dev), rows,
                last_idx=torch.tensor([sub - 1], device=dev))
            pos += sub
        self.perf["prefill_tokens"] += chunk
        finishing, packed = [], None
        if start + chunk >= len(seq.prompt_tokens):
            finishing = [(seq, 0)]
            win = make_window(self._windows[seq.seq_id], seq.gen_cfg.repeat_last_n)
            sp, window, bias_ids, bias_vals = self._sampling([seq.gen_cfg], 0, [win])
            tok, logprobs = sample_tokens(logits[:, 0, :], sp, window, bias_ids, bias_vals)
            packed = pack_rows(tok, logprobs, bool(seq.gen_cfg.logprobs))
        return [seq], [chunk], finishing, packed

    def _finish_prefills(self, pending: list) -> None:
        """Fetch queued prefill outputs and emit first tokens."""
        for group, chunks, finishing, packed in pending:
            for i, seq in enumerate(group):
                self.scheduler.prefill_complete(seq.seq_id, chunks[i])
            if not finishing:
                continue
            out = packed.cpu().numpy()                  # ONE fetch per group
            self._defer_puts = []
            try:
                for seq, i in finishing:
                    self._emit(seq, int(out[i, 0]), float(out[i, 1]),
                               top=self._top_row(seq, out[i]))
            finally:
                buf, self._defer_puts = self._defer_puts, None
                self._flush_puts(buf)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _step(self, bmax: int) -> BatchStep:
        step = self._steps.get(bmax)
        if step is None:
            step = self._steps[bmax] = BatchStep(self, bmax, self._horizon,
                                                 self._pipe_depth + 1)
        return step

    @torch.no_grad()
    def _horizon_round(self, decodes: list[Sequence]) -> None:
        """Dispatch one (possibly chained) decode round of up to
        ``decode_horizon`` steps onto the pipeline, then read and emit the
        oldest rounds while more than ``decode_pipe_depth`` are unread
        (``blazr_tpu/engine/batch_engine.py:1671,1796``). Rows that finish
        inside a round compute overrun steps whose tokens are dropped."""
        bmax = min(_next_pow2(len(decodes), minimum=1), self.max_batch)
        decodes = decodes[:bmax]
        use_topk = any(s.gen_cfg.logprobs for s in decodes)
        newest = self._pipe_q[-1] if self._pipe_q else None
        chain = (newest is not None and newest["bmax"] == bmax
                 and newest["topk"] == use_topk)
        if newest is not None and not chain:
            self._flush_pipe()              # the layout changed
            # The flush's emits can finish sequences of this round.
            decodes = [s for s in decodes if s.state == SequenceState.RUNNING]
            if not decodes:
                return
        if chain:
            # Chained sequences keep their row (their carry lives there);
            # newcomers take free rows as fresh.
            live_ids = {s.seq_id for s in decodes}
            rows: list[Optional[Sequence]] = [
                r if (r is not None and r.seq_id in live_ids
                      and r.state == SequenceState.RUNNING) else None
                for r in newest["rows"]]
            placed = {r.seq_id for r in rows if r is not None}
            free = [i for i, r in enumerate(rows) if r is None]
            for s in decodes:
                if s.seq_id not in placed:
                    rows[free.pop(0)] = s
            fresh = np.array([r is None or r.seq_id not in placed for r in rows])
            # In-flight tokens of the sequence in each row: the queued
            # rounds that hold the same sequence in that row.
            lag = [0 if fresh[i] else sum(q["t"] for q in self._pipe_q
                                          if q["rows"][i] is rows[i])
                   for i in range(bmax)]
        else:
            rows = list(decodes) + [None] * (bmax - len(decodes))
            fresh = np.ones((bmax,), dtype=bool)
            lag = [0] * bmax
        live = [(i, s) for i, s in enumerate(rows) if s is not None]
        rem_max = max(s.gen_cfg.max_tokens - s.emitted - lag[i] for i, s in live)
        if rem_max <= 0:
            # In-flight rounds already cover every row's budget: read the
            # oldest instead of queueing overrun.
            if self._pipe_q:
                self._emit_round(self._pipe_q.popleft())
            return
        # Block tables must cover the whole round, lag included, before the
        # table is built: a write into a block the table lacks goes to the
        # trash slot and loses that token's KV.
        for t_steps in (min(self._horizon, rem_max), 1):
            ok = all(self.scheduler._ensure_block_for(
                seq, min(seq.total_len + lag[i] + t_steps - 1, self.max_seq_len - 1))
                for i, seq in live)
            if ok:
                break
        if not ok and self._pipe_q:
            # Allocator pressure while tokens are in flight: land the oldest
            # round (its finished rows free blocks; lag shrinks).
            self.perf["pipe_pressure_n"] += 1
            self._emit_round(self._pipe_q.popleft())
            return
        step = self._step(bmax)
        windows = [None if s is None else
                   make_window(self._windows[s.seq_id], s.gen_cfg.repeat_last_n)
                   for s in rows]
        table = step.build(rows, lag, fresh, windows)
        any_sampled = any(s.gen_cfg.temperature > 0.0 for _, s in live)
        t0 = time.perf_counter()
        step.up.upload(table, step.tab)
        fn = step.step_fn(use_topk, any_sampled)
        for _ in range(t_steps):
            self.graphs.run((bmax, use_topk, any_sampled), fn)
        slot = step.down[use_topk].download(step.out[use_topk])
        self.perf["h_dispatch"] += time.perf_counter() - t0
        self._pipe_q.append({"rows": rows, "t": t_steps, "bmax": bmax,
                             "topk": use_topk, "ring": step.down[use_topk],
                             "slot": slot})
        self.horizon_dispatches += 1
        self.horizon_steps += t_steps
        while len(self._pipe_q) > self._pipe_depth:
            self._emit_round(self._pipe_q.popleft())
        # If no row of the newest round is running, the unread rounds are
        # pure overrun: drop them unread (their cache writes are inert).
        if self._pipe_q and not any(
                r is not None and r.state == SequenceState.RUNNING
                for r in self._pipe_q[-1]["rows"]):
            self._pipe_q.clear()

    def _emit_round(self, p: dict) -> None:
        """Read a dispatched round ([H, bmax, 2(+2K)], one copy) and emit
        its tokens; rows that finished inside it drop their overrun."""
        t0 = time.perf_counter()
        out = p["ring"].read(p["slot"])
        t1 = time.perf_counter()
        self.perf["h_fetch"] += t1 - t0
        self.perf["h_fetch_n"] += 1
        self._defer_puts = []
        try:
            for s_i in range(p["t"]):
                for i, seq in enumerate(p["rows"]):
                    if seq is None or seq.state != SequenceState.RUNNING:
                        continue
                    self._emit(seq, int(out[s_i, i, 0]), float(out[s_i, i, 1]),
                               top=self._top_row(seq, out[s_i, i]))
        finally:
            buf, self._defer_puts = self._defer_puts, None
            self._flush_puts(buf)
        self.perf["h_emit"] += time.perf_counter() - t1

    def _flush_pipe(self) -> None:
        while self._pipe_q:
            self._emit_round(self._pipe_q.popleft())

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------
    @torch.no_grad()
    def warmup(self) -> float:
        """Do before serving what the first requests would otherwise pay
        for (``blazr_tpu/engine/batch_engine.py:850``): build the kernels
        and initialise the libraries, run one one-row prefill per
        power-of-two token bucket up to the chunk, and capture the decode
        step of every decode batch (``bmax``: each power of two below
        ``max_batch``, and ``max_batch``) under both top-K logprobs
        variants and both sampled keys. Eager PyTorch
        compiles nothing per shape, so the JAX engine's grid of prefill
        group sizes has no counterpart. Every row is a pad row: its writes
        go to the trash slot (and the state pool's trash row), and neither
        the allocator nor the prefix cache is touched. Returns the seconds
        it took."""
        t0 = time.perf_counter()
        dev = self.device
        chunk = min(_next_pow2(self._chunk), _next_pow2(self.max_seq_len))
        t_buckets = []
        t = 16
        while t <= chunk:
            t_buckets.append(t)
            t *= 2
        gen = GenerationConfig()
        win = make_window([], gen.repeat_last_n)
        for t in t_buckets:
            mb = blocks_needed(t, self.block_size)
            logits, self.cache = self._fwd(
                self.model.params, self.model.cfg,
                torch.zeros((1, t), dtype=torch.long, device=dev), self.cache,
                torch.arange(t, device=dev)[None],
                torch.full((1, t), self._trash, dtype=torch.long, device=dev),
                torch.full((1, mb), PAD_BLOCK, dtype=torch.int32, device=dev),
                torch.tensor([t], dtype=torch.int32, device=dev),
                torch.tensor([self.max_batch], device=dev),     # the trash state row
                last_idx=torch.tensor([t - 1], device=dev))
            sp, window, bias_ids, bias_vals = self._sampling([gen], 0, [win])
            tok, logprobs = sample_tokens(logits[:, 0, :], sp, window, bias_ids, bias_vals)
            pack_rows(tok, logprobs, True)
        bmaxes = sorted({min(1 << i, self.max_batch)
                         for i in range(self.max_batch.bit_length() + 1)})
        for bmax in bmaxes:
            step = self._step(bmax)
            table = step.build([None] * bmax, [0] * bmax, np.ones((bmax,), dtype=bool),
                               [None] * bmax)
            for use_topk in (False, True):
                for any_sampled in (False, True):
                    step.up.upload(table, step.tab)
                    self.graphs.run((bmax, use_topk, any_sampled),
                                    step.step_fn(use_topk, any_sampled))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        logger.info("batch engine warmed in %.2fs: %d prefill buckets, %d decode "
                    "graphs (%.1f MiB pool)", dt, len(t_buckets), self.graphs.captured,
                    self.graphs.pool_bytes / 2**20)
        return dt

    # ------------------------------------------------------------------
    # token delivery
    # ------------------------------------------------------------------
    def _top_row(self, seq: Sequence, row: np.ndarray) -> Optional[list]:
        if not seq.gen_cfg.logprobs or row.shape[0] < 2 + 2 * TOPK_K:
            return None
        k = min(seq.gen_cfg.top_logprobs or 5, TOPK_K)
        return [TokenLogprob(int(t), float(lp), self._token_text(int(t)))
                for t, lp in zip(row[2:2 + k], row[2 + TOPK_K:2 + TOPK_K + k])]

    def _emit(self, seq: Sequence, token: int, logprob: float,
              top: Optional[list] = None) -> None:
        """Record a sampled token, stream it, and finish on EOS/length."""
        self.scheduler.append_token(seq.seq_id, token)
        self._windows[seq.seq_id].append(token)
        is_eos = self.tokenizer.is_eos(token)
        hit_len = (seq.emitted >= seq.gen_cfg.max_tokens
                   or seq.total_len >= self.max_seq_len - 1)
        text = "" if is_eos else self._token_text(token)
        gt = GeneratedToken(token_id=token, text=text, logprob=logprob,
                            top_logprobs=top)
        fin = (FinishReason.EOS if is_eos
               else FinishReason.LENGTH if hit_len else None)
        handle = self._handles.get(seq.seq_id)
        if handle is not None:
            self._queue_put(handle.queue, (gt, fin))
        if fin is not None:
            self.scheduler.finish_sequence(seq.seq_id)
            self._cleanup_seq(seq.seq_id)

    def _queue_put(self, q: "asyncio.Queue", item) -> None:
        """Thread-safe delivery; inside a deferred section puts buffer and
        flush in one loop wake-up."""
        if self._defer_puts is not None:
            self._defer_puts.append((q, item))
            return
        self._put_now(q, item)

    def _put_now(self, q: "asyncio.Queue", item) -> None:
        if self._loop is not None and threading.get_ident() != self._loop_thread:
            self._loop.call_soon_threadsafe(q.put_nowait, item)
        else:
            q.put_nowait(item)

    def _flush_puts(self, buf: list) -> None:
        if not buf:
            return

        def drain():
            for q, item in buf:
                q.put_nowait(item)

        if self._loop is not None and threading.get_ident() != self._loop_thread:
            self._loop.call_soon_threadsafe(drain)
        else:
            drain()

    def _finish(self, seq_id: int, fin: Optional[FinishReason]) -> None:
        handle = self._handles.get(seq_id)
        if handle is not None:
            self._queue_put(handle.queue, (None, fin or FinishReason.STOP))
        self._cleanup_seq(seq_id)

    def _cleanup_seq(self, seq_id: int) -> None:
        self._handles.pop(seq_id, None)
        self._windows.pop(seq_id, None)
        if self._needs_state_rows:
            row = self._seq_rows.pop(seq_id, None)
            if row is not None:
                self._free_rows.append(row)

    def _token_text(self, tok: int) -> str:
        try:
            return self.tokenizer.decode([tok])
        except Exception:
            return ""
