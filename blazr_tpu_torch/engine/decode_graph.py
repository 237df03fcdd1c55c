"""Fixed-shape decode steps, captured as CUDA graphs on the card.

Counterpart of the JAX package's jitted decode programs: ``decode_step``
and ``horizon_step`` of ``blazr_tpu/engine/batch_engine.py`` (:512-600),
its speculative ``verify_step``, ``spec_finish`` and ``draft_chain``
(:650-776), and
the Executor's ``decode_step`` (``blazr_tpu/engine/executor.py:130``),
which the JAX config calls the XLA analogue of CUDA graph capture
(``blazr_tpu/config/inference.py:138-140``). A step is a function over
buffers that live as long as the step: it reads ONE packed int32 table
(tokens, positions, sampling parameters, penalty window, logit bias and,
for the batch, the block tables ``max_blocks_per_seq`` wide) that the
caller rewrites with one upload, and writes its outputs and carries in
place.

``StepGraphs`` runs a step under a key:
  * on the CPU, or with ``inference.graphs`` off, it calls the function,
    eagerly, on the same buffers;
  * on CUDA with graphs on, the first call of a key runs the function once
    eagerly on a side stream (that call is the step: it builds the kernel
    libraries, resolves every plan and allocates the kernels' scratch),
    then captures it into a CUDA graph in the memory pool the keys share;
    every later call replays the graph. An error in capture or replay is
    raised; nothing falls back to eager.
The plans the wrappers take from shapes and the knobs they read
(``BLAZR_TPU_STREAM_KERNEL``) are frozen into a graph at capture.

A LoRA switch that replaces the low-rank buffers a graph reads
(``engine/lora.py``) makes its engine call ``reset``: the graphs go, and
each key is captured again at its next use (``captures`` counts them all).

Launch counts: a wrapper counts its launch in Python, which a replay does
not run. The capture takes each wrapper's tally (the counts the captured
call added without launching) and takes it back; every replay adds it, so
the counts stay the kernels' real launches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Hashable, Optional

import numpy as np
import torch

from ..config.generation import GenerationConfig
from ..kvcache.paged import PAD_BLOCK
from .sampling import (PENALTY_WINDOW, SamplingParams, make_bias_rows, sample_tokens,
                       sampling_arrays)

# Top-K width of the logprobs fetch (the OpenAI top_logprobs cap).
TOPK_K = 20
_M32 = 0xFFFFFFFF
_BIAS = 16                              # logit-bias entries a row (make_bias_rows)


def counted() -> tuple:
    """Every kernel wrapper of the port that counts its launches."""
    from ..attention.paged_attention import paged_attention_decode
    from ..models.layers import lora_matmul
    from ..quant import int8, kernels
    from ..tools.bench_pa_headmajor import pa_headmajor
    from ..tools.bench_pa_wide import pa_wide

    return (kernels.qmm, kernels.qmm_stream, int8.qmm_int8, int8.quantize_activations,
            paged_attention_decode, pa_wide, pa_headmajor, lora_matmul)


class StepGraphs:
    """Step functions run by key: captured CUDA graphs on the card when
    ``enabled``, else eager calls."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.enabled = bool(enabled) and device.type == "cuda"
        self._graphs: dict[Hashable, tuple] = {}
        self._pool = None
        self.capture_s = 0.0            # wall time of warm runs and captures
        self.pool_bytes = 0             # memory the graphs' pool holds
        self.captures = 0               # every capture, those before a reset too

    @property
    def captured(self) -> int:
        return len(self._graphs)

    def reset(self) -> None:
        """Drop every graph: the next call of each key captures it again,
        into a new pool. Replays in flight end first: their graphs and
        pool go with this call."""
        if self.enabled and self._graphs:
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._pool = None

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """One step of ``fn`` under ``key``."""
        if not self.enabled:
            fn()
            return
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = self._capture(fn)
            return                       # the warm run was this step
        graph, tally = entry
        graph.replay()
        for wrapper, n in tally:
            wrapper.launches += n

    def _capture(self, fn: Callable[[], None]) -> tuple:
        dev = self.device
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        wrappers = counted()
        before = [w.launches for w in wrappers]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            tally = [(w, w.launches - b) for w, b in zip(wrappers, before)
                     if w.launches != b]
            for w, b in zip(wrappers, before):
                w.launches = b
        # What the graph's pool holds once the cache's free blocks are let go.
        torch.cuda.empty_cache()
        self.pool_bytes += max(0, torch.cuda.memory_reserved(dev) - reserved)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return graph, tally


class HostRing:
    """``slots`` host buffers of one shape, each with an event, between the
    host and a device buffer: an upload ring (the step tables) or a
    download ring (the outputs). On CUDA the buffers are pinned and the
    copies asynchronous, and a slot is rewritten only after its last copy
    has run; on the CPU the copies are plain."""

    def __init__(self, device: torch.device, slots: int, shape: tuple, dtype: torch.dtype):
        self.cuda = device.type == "cuda"
        self.buf = [torch.zeros(shape, dtype=dtype, pin_memory=self.cuda)
                    for _ in range(slots)]
        self.ev = [torch.cuda.Event() if self.cuda else None for _ in range(slots)]
        self._next = 0

    def take(self) -> int:
        k = self._next
        self._next = (k + 1) % len(self.buf)
        return k

    def upload(self, table: np.ndarray, dst: torch.Tensor) -> None:
        """``table`` into ``dst`` through the next slot."""
        k = self.take()
        if self.cuda:
            self.ev[k].synchronize()            # the slot's last copy has run
        self.buf[k].numpy()[...] = table
        dst.copy_(self.buf[k], non_blocking=self.cuda)
        if self.cuda:
            self.ev[k].record()

    def download(self, src: torch.Tensor) -> int:
        """Queue ``src`` into the next slot; returns the slot for ``read``."""
        k = self.take()
        self.buf[k].copy_(src, non_blocking=self.cuda)
        if self.cuda:
            self.ev[k].record()
        return k

    def read(self, k: int) -> np.ndarray:
        if self.cuda:
            self.ev[k].synchronize()
        return self.buf[k].numpy().copy()


# ---------------------------------------------------------------------------
# The packed table: a head of per-row columns, then the sampling tail
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TableLayout:
    """Column offsets of a packed int32 step table: ``head`` named columns,
    then seed, step, top_k, six float32 sampling parameters (as bits), the
    penalty window, the logit-bias ids and values (bits), and ``mb`` block
    table columns."""

    head: tuple
    mb: int = 0

    def __getitem__(self, name: str) -> int:
        return self.head.index(name)

    @property
    def seed(self) -> int:
        return len(self.head)

    @property
    def f32(self) -> int:
        return self.seed + 3

    @property
    def window(self) -> int:
        return self.f32 + 6

    @property
    def bias_ids(self) -> int:
        return self.window + PENALTY_WINDOW

    @property
    def bias_vals(self) -> int:
        return self.bias_ids + _BIAS

    @property
    def bt(self) -> int:
        return self.bias_vals + _BIAS

    @property
    def width(self) -> int:
        return self.bt + self.mb


def fill_sampling(tab: np.ndarray, lay: TableLayout, cfgs: list[GenerationConfig],
                  steps: list[int], windows: list[np.ndarray]) -> None:
    """The sampling tail of every row of ``tab``: the arrays of
    ``SamplingParams.from_config`` (row index i picks an unseeded row's
    seed, as there), the penalty windows and ``make_bias_rows``."""
    f, keys, top_k = sampling_arrays(cfgs, steps)
    tab[:, lay.seed] = keys[:, 0].astype(np.uint32).view(np.int32)
    tab[:, lay.seed + 1] = keys[:, 1].astype(np.uint32).view(np.int32)
    tab[:, lay.seed + 2] = top_k
    tab[:, lay.f32:lay.f32 + 6] = f.view(np.int32)
    tab[:, lay.window:lay.window + PENALTY_WINDOW] = np.stack(windows)
    ids, vals = make_bias_rows(cfgs, _BIAS)
    tab[:, lay.bias_ids:lay.bias_ids + _BIAS] = ids
    tab[:, lay.bias_vals:lay.bias_vals + _BIAS] = vals.view(np.int32)


def unpack_sampling(tab: torch.Tensor, lay: TableLayout, any_sampled: bool,
                    step_add: Optional[torch.Tensor] = None):
    """(SamplingParams, window, bias ids, bias values) from the table on the
    device; ``step_add`` advances every row's key step (the horizon's i)."""
    f = tab[:, lay.f32:lay.f32 + 6].view(torch.float32)
    step = tab[:, lay.seed + 1].long() & _M32
    if step_add is not None:
        step = (step + step_add) & _M32
    sp = SamplingParams(
        temperature=f[:, 0], top_p=f[:, 1], min_p=f[:, 2], repeat_penalty=f[:, 3],
        freq_penalty=f[:, 4], presence_penalty=f[:, 5],
        top_k=tab[:, lay.seed + 2].long(),
        key=torch.stack([tab[:, lay.seed].long() & _M32, step], dim=1),
        any_sampled=any_sampled)
    window = tab[:, lay.window:lay.window + PENALTY_WINDOW].long()
    bias_ids = tab[:, lay.bias_ids:lay.bias_ids + _BIAS].long()
    bias_vals = tab[:, lay.bias_vals:lay.bias_vals + _BIAS].view(torch.float32)
    return sp, window, bias_ids, bias_vals


def pack_rows(tok: torch.Tensor, logprobs: torch.Tensor, use_topk: bool) -> torch.Tensor:
    """[B, 2] (token, logprob) — or [B, 2+2K] with the top-K ids and
    logprobs — in float64 (exact for both), for ONE host fetch."""
    lp = logprobs.gather(1, tok[:, None])
    cols = [tok[:, None].to(torch.float64), lp.to(torch.float64)]
    if use_topk:
        top_lp, top_ids = torch.topk(logprobs, TOPK_K, dim=-1)
        cols += [top_ids.to(torch.float64), top_lp.to(torch.float64)]
    return torch.cat(cols, dim=1)


def out_width(use_topk: bool) -> int:
    return 2 + 2 * TOPK_K if use_topk else 2


# ---------------------------------------------------------------------------
# BatchEngine: one step of the horizon over [bmax] rows of the paged cache
# ---------------------------------------------------------------------------

BATCH_HEAD = ("tok", "pos", "fresh", "live", "rln", "i", "row", "gst", "hasg")


class BatchStep:
    """The fixed-shape decode step of ``BatchEngine`` at ``bmax`` rows: the
    counterpart of the body of ``horizon_step``'s while loop
    (``blazr_tpu/engine/batch_engine.py:596-643``).

    The table (``BATCH_HEAD``, then the sampling tail and the block tables,
    ``max_blocks_per_seq`` wide) is uploaded once a round. Column ``i`` is
    the step index: the step reads it, derives each row's position and slot
    from it and increments it, so a round of T steps is T calls with no
    host work between them. Fresh rows (``fresh``: newly prefilled, or after
    a flush) take their token and penalty window from the table at i = 0;
    the others resume from the carries ``tok`` and ``win``, this step's own
    outputs from the previous round. Column ``row`` is the sequence's row
    of the engine's state pool (Mamba2 and hybrid models; a static operand
    of the step, as the JAX step's ``state_rows``). Pad rows (``live`` 0)
    write to the trash slot and the pool's trash row (``max_batch``) and
    attend over no key. ``out[i]`` gets each row's packed (token,
    logprob[, top-K]) at step i.

    Constrained rows (``step_fn``'s variants):
      * ``gram``: a DFA grammar steps on the device, as ``horizon_step``
        does (JAX :560-634). ``gram`` is the engine's table buffers
        (mask ``[S, V]`` bool, next state ``[S, V]`` int32) of one height;
        a row with ``hasg`` samples under ``mask[state]`` and moves to
        ``next[state, token]`` (a dead transition keeps the state). The
        state starts at column ``gst`` on a fresh row and is carried in
        ``gs`` between steps and rounds, as the token and window are.
      * ``mask``: the host's ``[bmax, V]`` mask of this step (PDA-tier
        grammars, mixed DFAs, a DFA too large for tables, every grammar
        under ``decode_horizon`` 1), uploaded into ``mask`` before a T=1
        step.
      * ``raw``: the step also copies its raw ``[bmax, V]`` logits into
        ``logits``, for rows whose token the host samplers pick."""

    def __init__(self, engine, bmax: int, horizon: int, slots: int):
        self.engine = engine
        self.bmax = bmax
        self.lay = TableLayout(BATCH_HEAD, engine.max_blocks_per_seq)
        dev = engine.device
        self.tab = torch.zeros((bmax, self.lay.width), dtype=torch.int32, device=dev)
        self.tok = torch.zeros((bmax,), dtype=torch.int64, device=dev)
        self.win = torch.full((bmax, PENALTY_WINDOW), -1, dtype=torch.int64, device=dev)
        self.gs = torch.zeros((bmax,), dtype=torch.int64, device=dev)
        self.out = {w: torch.zeros((horizon, bmax, out_width(w)), dtype=torch.float64,
                                   device=dev) for w in (False, True)}
        # One slot a round in flight: ``slots`` is the pipe depth + 1.
        self.up = HostRing(dev, slots, (bmax, self.lay.width), torch.int32)
        self.down = {w: HostRing(dev, slots, (horizon, bmax, out_width(w)), torch.float64)
                     for w in (False, True)}
        # The host-mask and raw-logits buffers, made at their first use.
        self._mask: Optional[tuple[torch.Tensor, HostRing]] = None
        self._raw: Optional[tuple[torch.Tensor, HostRing]] = None

    def _vocab_buf(self, dtype: torch.dtype) -> tuple[torch.Tensor, HostRing]:
        dev = self.engine.device
        shape = (self.bmax, self.engine.model.vocab_size)
        return torch.zeros(shape, dtype=dtype, device=dev), HostRing(dev, 2, shape, dtype)

    @property
    def mask(self) -> tuple[torch.Tensor, HostRing]:
        if self._mask is None:
            self._mask = self._vocab_buf(torch.bool)
        return self._mask

    @property
    def logits(self) -> tuple[torch.Tensor, HostRing]:
        if self._raw is None:
            self._raw = self._vocab_buf(torch.float32)
        return self._raw

    def build(self, rows: list, lag: list[int], fresh: np.ndarray,
              windows: list[np.ndarray], gstates: Optional[list] = None) -> np.ndarray:
        """The round's table over ``rows`` (None: a pad row); ``gstates[i]``
        is row i's DFA state on the host (None: no device grammar)."""
        lay = self.lay
        tab = np.zeros((self.bmax, lay.width), dtype=np.int32)
        tab[:, lay.bt:] = PAD_BLOCK
        tab[:, lay["row"]] = self.engine.max_batch
        cfgs, steps, wins = [], [], []
        pad_win = np.full((PENALTY_WINDOW,), -1, dtype=np.int64)
        for i, seq in enumerate(rows):
            if seq is None:
                cfgs.append(GenerationConfig(temperature=0.0))
                steps.append(0)
                wins.append(pad_win)
                continue
            tab[i, lay["tok"]] = seq.all_tokens[-1]
            tab[i, lay["pos"]] = seq.total_len - 1 + lag[i]
            tab[i, lay["live"]] = 1
            tab[i, lay["rln"]] = min(seq.gen_cfg.repeat_last_n, PENALTY_WINDOW)
            if self.engine._needs_state_rows:
                tab[i, lay["row"]] = self.engine._row_for(seq.seq_id)
            blocks = seq.block_table[:lay.mb]
            tab[i, lay.bt:lay.bt + len(blocks)] = blocks
            if gstates is not None and gstates[i] is not None:
                tab[i, lay["gst"]] = gstates[i]
                tab[i, lay["hasg"]] = 1
            cfgs.append(seq.gen_cfg)
            steps.append(seq.emitted + lag[i])
            wins.append(windows[i])
        tab[:, lay["fresh"]] = fresh
        fill_sampling(tab, lay, cfgs, steps, wins)
        return tab

    def step_fn(self, use_topk: bool, any_sampled: bool,
                gram: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                mask: bool = False, raw: bool = False) -> Callable[[], None]:
        eng = self.engine
        lay = self.lay
        bs, mb, trash = eng.block_size, lay.mb, eng._trash
        max_pos = eng.max_seq_len - 1
        out = self.out[use_topk]
        host_mask = self.mask[0] if mask else None
        raw_out = self.logits[0] if raw else None

        def step() -> None:
            t = self.tab
            i = t[0:1, lay["i"]].long()                                  # [1]
            fresh = (t[:, lay["fresh"]] != 0) & (i == 0)
            sp, window0, bias_ids, bias_vals = unpack_sampling(t, lay, any_sampled, i)
            tok = torch.where(fresh, t[:, lay["tok"]].long(), self.tok)
            window = torch.where(fresh[:, None], window0, self.win)
            live = t[:, lay["live"]] != 0
            pos = t[:, lay["pos"]].long() + i
            bt = t[:, lay.bt:].contiguous()
            blk = bt.gather(1, (pos // bs).clamp(max=mb - 1)[:, None])[:, 0].long()
            slot = torch.where(live & (blk != PAD_BLOCK) & (pos < mb * bs),
                               blk * bs + pos % bs, torch.full_like(pos, trash))
            # Overrun steps of rows that finish inside the horizon are
            # discarded; clamp their rope positions in range.
            posc = pos.clamp(max=max_pos)
            seq_lens = torch.where(live, pos + 1, torch.zeros_like(pos)).to(torch.int32)
            logits, _ = eng._fwd(eng.model.params, eng.model.cfg, tok[:, None], eng.cache,
                                 posc[:, None], slot[:, None], bt, seq_lens,
                                 t[:, lay["row"]].long())
            last = logits[:, -1, :]
            if raw_out is not None:
                raw_out.copy_(last)
            gmask = host_mask
            if gram is not None:
                hasg = t[:, lay["hasg"]] != 0
                gs = torch.where(fresh, t[:, lay["gst"]].long(), self.gs)
                srow = gs.clamp(0, gram[0].shape[0] - 1)
                gmask = gram[0][srow] | ~hasg[:, None]
            newtok, logprobs = sample_tokens(last, sp, window, bias_ids, bias_vals, gmask)
            out.index_copy_(0, i, pack_rows(newtok, logprobs, use_topk)[None])
            if gram is not None:
                # A dead transition (a stuck grammar) keeps the old state.
                ns = gram[1][srow, newtok].long()
                self.gs.copy_(torch.where(hasg & (ns >= 0), ns, gs))
            # Penalty-window update, exact make_window semantics: insert
            # while under repeat_last_n, then shift left within it.
            rln = t[:, lay["rln"]].long()
            rows = torch.arange(self.bmax, device=t.device)
            widx = torch.arange(PENALTY_WINDOW, device=t.device)[None, :]
            fill = (window >= 0).sum(dim=1)
            rolled = torch.where(widx < rln[:, None] - 1,
                                 torch.roll(window, -1, dims=1), window)
            rolled[rows, (rln - 1).clamp(min=0)] = newtok
            inserted = window.clone()
            inserted[rows, fill.clamp(max=PENALTY_WINDOW - 1)] = newtok
            wnew = torch.where((fill < rln)[:, None], inserted, rolled)
            self.win.copy_(torch.where((rln > 0)[:, None], wnew, window))
            self.tok.copy_(newtok)
            t[:, lay["i"]] += 1

        return step


# ---------------------------------------------------------------------------
# BatchEngine's speculative round: the verify step, spec_finish, the draft
# chain
# ---------------------------------------------------------------------------

SPEC_HEAD = ("pos0", "span", "live")


class VerifyStep:
    """The speculative round's fixed-shape steps at ``bmax`` rows and depth
    ``k``: the counterparts of ``verify_step`` and ``spec_finish`` of
    ``blazr_tpu/engine/batch_engine.py`` (:715-776), each a graph of its
    own, over ONE table uploaded a round: ``SPEC_HEAD``, the k+1 tokens
    (``t0``: the row's last token, then its drafts), the sampling tail and
    the block tables.

    ``verify_fn``: the target's forward over ``[bmax, k+1]`` in its verify
    forms (``forward_paged(verify=True)``: B2 a position, MoE's decode
    form). Positions derive from ``pos0``; slots outside a row's ``span``
    (1 + its drafts) and every slot of a pad row (``live`` 0) are the trash
    slot; a row's valid length is ``pos0 + span`` (0 on a pad row). The
    logits ``[bmax, k+1, V]`` stay in ``logits``.

    ``finish_fn``: samples position 0 as the plain step samples (penalty
    window, logit bias, the host's grammar mask under ``masked``, top-K
    logprobs under ``use_topk``) and takes the argmax of every position;
    ``out[use_topk]`` gets ``[argmax x (k+1) | token, logprob(, top-K)]``
    (float64), read once a round. Rows whose token the host samplers pick
    never reach it (they step on the side)."""

    def __init__(self, engine, bmax: int, k: int):
        self.engine = engine
        self.bmax = bmax
        self.k1 = k + 1
        self.lay = TableLayout(SPEC_HEAD + tuple(f"t{j}" for j in range(self.k1)),
                               engine.max_blocks_per_seq)
        dev = engine.device
        v = engine.model.vocab_size
        self.tab = torch.zeros((bmax, self.lay.width), dtype=torch.int32, device=dev)
        self.logits = torch.zeros((bmax, self.k1, v), dtype=torch.float32, device=dev)
        self.mask = torch.ones((bmax, v), dtype=torch.bool, device=dev)
        self.out = {w: torch.zeros((bmax, self.k1 + out_width(w)), dtype=torch.float64,
                                   device=dev) for w in (False, True)}
        # A round is read before the next is built: two slots each.
        self.up = HostRing(dev, 2, (bmax, self.lay.width), torch.int32)
        self.mask_up = HostRing(dev, 2, (bmax, v), torch.bool)
        self.down = {w: HostRing(dev, 2, (bmax, self.k1 + out_width(w)), torch.float64)
                     for w in (False, True)}

    def build(self, rows: list, drafts: list[list[int]], windows: list[np.ndarray]
              ) -> np.ndarray:
        """The round's table over ``rows`` (None: a pad row) with each row's
        drafts."""
        lay = self.lay
        tab = np.zeros((self.bmax, lay.width), dtype=np.int32)
        tab[:, lay.bt:] = PAD_BLOCK
        tab[:, lay["span"]] = 1
        cfgs, steps, wins = [], [], []
        pad_win = np.full((PENALTY_WINDOW,), -1, dtype=np.int64)
        for i, seq in enumerate(rows):
            if seq is None:
                cfgs.append(GenerationConfig(temperature=0.0))
                steps.append(0)
                wins.append(pad_win)
                continue
            tab[i, lay["pos0"]] = seq.total_len - 1
            tab[i, lay["span"]] = 1 + len(drafts[i])
            tab[i, lay["live"]] = 1
            t0 = lay["t0"]
            tab[i, t0] = seq.all_tokens[-1]
            tab[i, t0 + 1:t0 + 1 + len(drafts[i])] = drafts[i]
            blocks = seq.block_table[:lay.mb]
            tab[i, lay.bt:lay.bt + len(blocks)] = blocks
            cfgs.append(seq.gen_cfg)
            steps.append(seq.emitted)
            wins.append(windows[i])
        fill_sampling(tab, lay, cfgs, steps, wins)
        return tab

    def verify_fn(self) -> Callable[[], None]:
        eng = self.engine
        lay = self.lay
        bs, mb, trash = eng.block_size, lay.mb, eng._trash
        max_pos = eng.max_seq_len - 1

        def step() -> None:
            t = self.tab
            pos0 = t[:, lay["pos0"]:lay["pos0"] + 1].long()
            span = t[:, lay["span"]:lay["span"] + 1].long()
            live = t[:, lay["live"]:lay["live"] + 1] != 0
            j = torch.arange(self.k1, device=t.device)[None, :]
            pos = pos0 + j                                               # [B, k+1]
            bt = t[:, lay.bt:].contiguous()
            blk = bt.gather(1, (pos // bs).clamp(max=mb - 1)).long()
            slot = torch.where(live & (j < span) & (blk != PAD_BLOCK) & (pos < mb * bs),
                               blk * bs + pos % bs, torch.full_like(pos, trash))
            seq_lens = torch.where(live, pos0 + span, torch.zeros_like(pos0))[:, 0]
            tokens = t[:, lay["t0"]:lay["t0"] + self.k1].long()
            logits, _ = eng._fwd(eng.model.params, eng.model.cfg, tokens, eng.cache,
                                 pos.clamp(max=max_pos), slot, bt, seq_lens.to(torch.int32),
                                 verify=True)
            self.logits.copy_(logits)

        return step

    def finish_fn(self, use_topk: bool, any_sampled: bool,
                  masked: bool) -> Callable[[], None]:
        out = self.out[use_topk]
        gmask = self.mask if masked else None

        def step() -> None:
            sp, window, bias_ids, bias_vals = unpack_sampling(self.tab, self.lay, any_sampled)
            tok, logprobs = sample_tokens(self.logits[:, 0, :], sp, window, bias_ids,
                                          bias_vals, gmask)
            am = self.logits.argmax(dim=-1).to(torch.float64)
            out.copy_(torch.cat([am, pack_rows(tok, logprobs, use_topk)], dim=1))

        return step


CHAIN_HEAD = ("tok", "pos", "live")


class DraftChain:
    """The draft model's greedy chain at ``bmax`` rows (JAX ``draft_chain``,
    ``blazr_tpu/engine/batch_engine.py:650-687``), one graph: k+1 T=1
    steps over the draft's paged cache and the target's block tables (the
    two caches share block ids), each argmax fed back on the device. Step j
    writes the K/V of its input at ``pos + j``: the row's last token, then
    d1 … dk; ``drafts`` gets d1 … dk. The reference stops after k steps, so
    d_k's K/V is never written and a round that accepts every draft leaves
    the next one an unwritten slot (ROADMAP §C); the last step here writes
    it and its logits are dropped. The table: ``CHAIN_HEAD`` and the block
    tables (its sampling tail unused)."""

    def __init__(self, engine, bmax: int, k: int):
        self.engine = engine
        self.bmax = bmax
        self.k = k
        self.lay = TableLayout(CHAIN_HEAD, engine.max_blocks_per_seq)
        dev = engine.device
        self.tab = torch.zeros((bmax, self.lay.width), dtype=torch.int32, device=dev)
        self.drafts = torch.zeros((bmax, k), dtype=torch.int64, device=dev)
        self.up = HostRing(dev, 2, (bmax, self.lay.width), torch.int32)
        self.down = HostRing(dev, 2, (bmax, k), torch.int64)

    def build(self, rows: list) -> np.ndarray:
        lay = self.lay
        tab = np.zeros((self.bmax, lay.width), dtype=np.int32)
        tab[:, lay.bt:] = PAD_BLOCK
        for i, seq in enumerate(rows):
            if seq is None:
                continue
            tab[i, lay["tok"]] = seq.all_tokens[-1]
            tab[i, lay["pos"]] = seq.total_len - 1
            tab[i, lay["live"]] = 1
            blocks = seq.block_table[:lay.mb]
            tab[i, lay.bt:lay.bt + len(blocks)] = blocks
        return tab

    def chain_fn(self) -> Callable[[], None]:
        eng = self.engine
        draft = eng._draft
        lay = self.lay
        bs, mb, trash = eng.block_size, lay.mb, eng._d_trash
        max_pos = eng.max_seq_len - 1

        def step() -> None:
            t = self.tab
            tok = t[:, lay["tok"]].long()
            pos0 = t[:, lay["pos"]].long()
            live = t[:, lay["live"]] != 0
            bt = t[:, lay.bt:].contiguous()
            for j in range(self.k + 1):
                pos = pos0 + j
                blk = bt.gather(1, (pos // bs).clamp(max=mb - 1)[:, None])[:, 0].long()
                slot = torch.where(live & (blk != PAD_BLOCK) & (pos < mb * bs),
                                   blk * bs + pos % bs, torch.full_like(pos, trash))
                seq_lens = torch.where(live, pos + 1, torch.zeros_like(pos)).to(torch.int32)
                logits, _ = eng._dfwd(draft.params, draft.cfg, tok[:, None], eng._draft_cache,
                                      pos.clamp(max=max_pos)[:, None], slot[:, None], bt,
                                      seq_lens)
                if j < self.k:
                    tok = logits[:, -1, :].argmax(dim=-1)
                    self.drafts[:, j] = tok

        return step


# ---------------------------------------------------------------------------
# Executor: forward plus sampling at one row of the contiguous cache
# ---------------------------------------------------------------------------

EXEC_HEAD = ("tok", "pos")


class ExecutorStep:
    """The fixed-shape decode step of ``Executor`` over one contiguous
    cache: the counterpart of the jitted ``decode_step`` of
    ``blazr_tpu/engine/executor.py:130`` (forward, then the fused sampler;
    the top-K logprobs under ``use_topk``). Token, position, the sampling
    parameters and the penalty window come from one uploaded table. Under
    ``mode`` "mask" the sampler takes the grammar's ``[1, V]`` mask from
    ``mask`` (written before the step); under "raw" the step is the
    forward alone (JAX ``forward_step``) and writes its logits to
    ``logits`` for the host samplers."""

    def __init__(self, model, cache, device: torch.device):
        self.model = model
        self.cache = cache
        self.lay = TableLayout(EXEC_HEAD)
        self.tab = torch.zeros((1, self.lay.width), dtype=torch.int32, device=device)
        self.out = {w: torch.zeros((1, out_width(w)), dtype=torch.float64, device=device)
                    for w in (False, True)}
        self.mask = torch.ones((1, model.vocab_size), dtype=torch.bool, device=device)
        self.logits = torch.zeros((1, model.vocab_size), dtype=torch.float32, device=device)
        self.lora_epoch = 0             # the LoRA switch its K/V was computed after

    def build(self, cfg: GenerationConfig, tok: int, pos: int, step: int,
              window: np.ndarray) -> np.ndarray:
        lay = self.lay
        tab = np.zeros((1, lay.width), dtype=np.int32)
        tab[0, lay["tok"]] = tok
        tab[0, lay["pos"]] = pos
        fill_sampling(tab, lay, [cfg], [step], [window])
        return tab

    def step_fn(self, use_topk: bool, any_sampled: bool,
                mode: str = "free") -> Callable[[], None]:
        lay = self.lay
        out = self.out[use_topk]
        gmask = self.mask if mode == "mask" else None

        def step() -> None:
            t = self.tab
            tok = t[:, lay["tok"]:lay["tok"] + 1].long()
            pos = t[:, lay["pos"]:lay["pos"] + 1].long()
            logits, _ = self.model.forward(tok, self.cache, pos,
                                           (pos[:, 0] + 1).to(torch.int32))
            if mode == "raw":
                self.logits.copy_(logits[:, -1, :])
                return
            sp, window, bias_ids, bias_vals = unpack_sampling(t, lay, any_sampled)
            newtok, logprobs = sample_tokens(logits[:, -1, :], sp, window, bias_ids,
                                             bias_vals, gmask)
            out.copy_(pack_rows(newtok, logprobs, use_topk))

        return step
