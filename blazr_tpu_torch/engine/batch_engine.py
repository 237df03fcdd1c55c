"""Continuous-batching engine over the paged KV cache.

Counterpart of ``blazr_tpu/engine/batch_engine.py::BatchEngine`` (:186): an
asyncio loop admits requests, runs batched (chunked) prefills with the
first token sampled in the same pass, then a decode round over every
running sequence, and streams tokens through per-request asyncio queues.

What is ported is the engine's semantics, not its TPU machinery:
  * prefill rows are grouped by power-of-two token bucket, paced in ramped
    groups (cold bursts: one median-first group), and capped while decode
    rows are running so a decode round runs between prefill groups;
  * a decode round runs up to ``decode_horizon`` steps with the sampled
    tokens and penalty windows fed back on the device and ONE host fetch;
  * the packed upload tables and the pipelined rounds of the JAX engine
    hid round-trips of a remote-attached chip; PyTorch runs eagerly on a
    local card, so this engine passes tensors directly and fetches every
    round.
  * prefill groups run at their real number of prompts P, except while a
    weight carries a row threshold (``w4a8-prefill``): then the group is
    padded to the next power of two, as the JAX engine pads every group
    (batch_engine.py:1338), so the row count that picks B3 or B1 is the
    JAX engine's (P x bucket) and the two engines compute alike.
Left out of this slice (ROADMAP queue A): speculation, grammars and JSON
mode, LoRA, host samplers (mirostat/DRY/typical/dynatemp), the prefix
cache, tensor/sequence parallel meshes and recurrent-state families. A
request or config that asks for one raises instead of being served
differently. int4 KV on the paged path raises instead of being downgraded.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from ..config.app import AppConfig
from ..config.generation import GenerationConfig
from ..kvcache.block_allocator import BlockAllocator, blocks_needed
from ..kvcache.paged import PAD_BLOCK, pad_block_table
from ..models.paged_multi import init_engine_cache, make_paged_forward
from ..models.registry import Model
from ..quant.qtensor import apply_quant_compute, quant_leaves
from .sampling import (PENALTY_WINDOW, SamplingParams, make_bias_rows,
                       make_window, sample_tokens)
from .sequence_scheduler import (SchedulerConfig, Sequence, SequenceScheduler,
                                 SequenceState)
from .types import FinishReason, GeneratedToken, TokenLogprob

logger = logging.getLogger(__name__)

# Max same-bucket prefill rows fused into one forward.
_PREFILL_GROUP = 32
# Top-K width of the logprobs fetch (the OpenAI top_logprobs cap).
TOPK_K = 20
# Pad-row sampling config: greedy.
_PAD_CFG = GenerationConfig(temperature=0.0)


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


def _not_served(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not served by blazr_tpu_torch yet (ROADMAP queue A)")


def check_request(gen_cfg: GenerationConfig) -> None:
    """Raise for a request that asks for what the port does not serve yet."""
    if gen_cfg.grammar or gen_cfg.json_mode or gen_cfg.json_schema:
        raise _not_served("constrained decoding (grammar / JSON mode)")
    if gen_cfg.lora_adapter:
        raise _not_served("LoRA")
    if (gen_cfg.mirostat == 2 or gen_cfg.dry_multiplier > 0.0
            or gen_cfg.typical_p < 1.0 or gen_cfg.dynatemp_range > 0.0):
        raise _not_served("host-side sampling (mirostat/DRY/typical/dynatemp)")


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
        self._chunk = inf.prefill_chunk_size or 4096
        self.scheduler = SequenceScheduler(
            self.allocator,
            SchedulerConfig(
                max_batch_size=self.max_batch,
                max_batch_tokens=(inf.max_batch_tokens
                                  or self._chunk * _PREFILL_GROUP),
                block_size=self.block_size,
                max_seq_len=self.max_seq_len,
            ))
        model.params = apply_quant_compute(model.params, inf.quant_compute)
        # Row-count routing (w4a8-prefill) needs the JAX engine's padded
        # prefill groups; other modes run the real number of prompts.
        self._pad_groups = any(qt.act_quant_min_m > 0
                               for qt in quant_leaves(model.params))
        self.cache, _ = init_engine_cache(
            model.cfg, num_blocks, self.block_size, self.max_batch,
            dtype=model.dtype, quantized=inf.kv_cache_dtype == "int8",
            device=self.device)
        self._fwd = make_paged_forward(model.cfg)
        self._trash = self.cache.trash_slot
        self.horizon_dispatches = 0
        self.horizon_steps = 0
        # Wall time by phase (seconds; "<phase>_n" counts calls).
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
        if inf.prefix_cache:
            raise _not_served("the prefix cache")
        if inf.speculative is not None and inf.speculative.num_speculative_tokens > 0:
            raise _not_served("speculative decoding")
        if max(inf.tensor_parallel_size, inf.data_parallel_size,
               inf.expert_parallel_size, inf.sequence_parallel_size) > 1:
            raise _not_served("multi-device serving")
        if inf.moe_offload or inf.num_device_layers is not None:
            raise _not_served("weight offload")

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
                self._notify.clear()
                await self._notify.wait()
                continue
            try:
                if not await self.step_once():
                    await asyncio.sleep(0.001)
                    continue
            except Exception:
                logger.exception("batch failed; aborting batch sequences")
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
        if batch.is_empty:
            return False
        pending: list = []
        cold = not any(s.state == SequenceState.RUNNING
                       for s in batch.decode_sequences)
        if batch.prefill_sequences:
            t0 = time.perf_counter()
            pending = await asyncio.to_thread(self._dispatch_prefills,
                                              batch.prefill_sequences, cold)
            self.perf["prefill"] += time.perf_counter() - t0
            self.perf["prefill_n"] += 1
        decodes = [s for s in batch.decode_sequences
                   if s.state == SequenceState.RUNNING]
        if decodes:
            t0 = time.perf_counter()
            await asyncio.to_thread(self._decode_round, decodes)
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

    def _pack(self, tok: torch.Tensor, logprobs: torch.Tensor,
              use_topk: bool) -> torch.Tensor:
        """[B, 2] (token, logprob) — or [B, 2+2K] with the top-K ids and
        logprobs — in float64 (exact for both), for ONE host fetch."""
        lp = logprobs.gather(1, tok[:, None])
        cols = [tok[:, None].to(torch.float64), lp.to(torch.float64)]
        if use_topk:
            top_lp, top_ids = torch.topk(logprobs, TOPK_K, dim=-1)
            cols += [top_ids.to(torch.float64), top_lp.to(torch.float64)]
        return torch.cat(cols, dim=1)

    @torch.no_grad()
    def _dispatch_prefills(self, seqs: list[Sequence], cold: bool = False) -> list:
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
            packed = self._pack(tok, logprobs, use_topk)
        return group, chunks, finishing, packed

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
    @torch.no_grad()
    def _decode_round(self, decodes: list[Sequence]) -> None:
        """Up to ``decode_horizon`` decode steps over ``decodes`` with the
        sampled tokens and penalty windows fed back on the device, then ONE
        fetch of the [steps, B, 2(+2K)] outputs. Rows that finish inside the
        horizon compute overrun steps whose tokens are discarded."""
        decodes = decodes[:self.max_batch]
        bs = self.block_size
        rem_max = max(s.gen_cfg.max_tokens - s.emitted for s in decodes)
        t_steps = max(1, min(self._horizon, rem_max))
        # Block tables must cover the whole horizon before the tables are
        # built: a write into a block the table lacks goes to the trash
        # slot and loses that token's KV.
        for trial in (t_steps, 1):
            t_steps = trial
            ok = all(self.scheduler._ensure_block_for(
                seq, min(seq.total_len + t_steps - 1, self.max_seq_len - 1))
                for seq in decodes)
            if ok:
                break
        b = len(decodes)
        mb = max(len(s.block_table) for s in decodes)
        bt = np.stack([pad_block_table(s.block_table, mb) for s in decodes])
        dev = self.device
        cfgs = [s.gen_cfg for s in decodes]
        sp, window, bias_ids, bias_vals = self._sampling(
            cfgs, [s.emitted for s in decodes],
            [make_window(self._windows[s.seq_id], s.gen_cfg.repeat_last_n)
             for s in decodes])
        bt_d = torch.from_numpy(bt).to(dev)
        tok = torch.tensor([s.all_tokens[-1] for s in decodes], dtype=torch.int64,
                           device=dev)
        pos0 = torch.tensor([s.total_len - 1 for s in decodes], dtype=torch.int64,
                            device=dev)
        rln = torch.tensor([min(s.gen_cfg.repeat_last_n, PENALTY_WINDOW)
                            for s in decodes], dtype=torch.int64, device=dev)
        rows = torch.arange(b, device=dev)
        widx = torch.arange(PENALTY_WINDOW, device=dev)[None, :]
        use_topk = any(c.logprobs for c in cfgs)
        outs = []
        for i in range(t_steps):
            pos = pos0 + i
            blk = bt_d.gather(1, (pos // bs).clamp(max=mb - 1)[:, None])[:, 0].long()
            slot = torch.where((blk != PAD_BLOCK) & (pos < mb * bs),
                               blk * bs + pos % bs,
                               torch.full_like(pos, self._trash))
            # Overrun steps of rows that finish inside the horizon are
            # discarded; clamp their rope positions in range.
            posc = pos.clamp(max=self.max_seq_len - 1)
            logits, self.cache = self._fwd(
                self.model.params, self.model.cfg, tok[:, None], self.cache,
                posc[:, None], slot[:, None], bt_d, (pos + 1).to(torch.int32))
            key = sp.key.clone()
            key[:, 1] = (key[:, 1] + i) & 0xFFFFFFFF
            newtok, logprobs = sample_tokens(
                logits[:, -1, :], dataclasses.replace(sp, key=key), window,
                bias_ids, bias_vals)
            outs.append(self._pack(newtok, logprobs, use_topk))
            # Penalty-window update, exact make_window semantics: insert
            # while under repeat_last_n, then shift left within it.
            fill = (window >= 0).sum(dim=1)
            rolled = torch.where(widx < rln[:, None] - 1,
                                 torch.roll(window, -1, dims=1), window)
            rolled[rows, (rln - 1).clamp(min=0)] = newtok
            inserted = window.clone()
            inserted[rows, fill.clamp(max=PENALTY_WINDOW - 1)] = newtok
            wnew = torch.where((fill < rln)[:, None], inserted, rolled)
            window = torch.where((rln > 0)[:, None], wnew, window)
            tok = newtok
        self.horizon_dispatches += 1
        self.horizon_steps += t_steps
        out = torch.stack(outs).cpu().numpy()          # ONE fetch per round
        self._defer_puts = []
        try:
            for s_i in range(t_steps):
                for i, seq in enumerate(decodes):
                    if seq.state != SequenceState.RUNNING:
                        continue          # finished inside the horizon
                    self._emit(seq, int(out[s_i, i, 0]), float(out[s_i, i, 1]),
                               top=self._top_row(seq, out[s_i, i]))
        finally:
            buf, self._defer_puts = self._defer_puts, None
            self._flush_puts(buf)

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

    def _token_text(self, tok: int) -> str:
        try:
            return self.tokenizer.decode([tok])
        except Exception:
            return ""
