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

Constrained decoding and the host samplers (JAX :989-1060, :1473-1506,
:1690-1760, :1971-2056):
  * ``submit`` compiles the request's grammar (a GBNF ``grammar``, a JSON
    schema, JSON mode; ``grammar.make_grammar_state`` picks the DFA or the
    exact-PDA tier) before the scheduler is touched, so a grammar that does
    not parse fails the caller alone; mirostat, DRY, typical-p and dynamic
    temperature rows get their host state (a seeded numpy generator).
  * The first token is drawn in the prefill group under the grammar's mask,
    or by the host samplers from the raw logits (``_host_pick``).
  * Decode: rows whose grammar is a DFA of at most 512 states, all of one
    DFA, step it on the device inside the pipelined horizon round
    (``BatchStep``'s ``gram`` variant, the tables in one buffer pair per
    height, ``_grammar_tables``). Rows that need the host every step (an
    exact-PDA grammar, a host sampler) run a T=1 side step on their own
    ``BatchStep`` that does not flush the pipeline, so the other rows keep
    the horizon. A batch that is all such rows, mixed DFAs, a DFA too large
    for tables, and every grammar under ``decode_horizon`` 1 take a T=1
    step with the host's masks after a flush (``_single_step_batch``).
Speculative decoding (JAX :287-364, :650-776, :1462-1669;
``inference.speculative``): greedy rows (``_spec_eligible``) draft up to
k tokens, from the sequence's own history (``prompt_lookup_draft``) or, with
a ``draft_model``, from one replay of the draft's greedy chain
(``decode_graph.DraftChain``) over the draft's own paged cache on the same
block ids (its prefill mirrors every target prefill group), and the
target verifies every row in ONE ``[bmax, k+1]`` step
(``decode_graph.VerifyStep``: the verify graph, then ``spec_finish``'s, and
one read). A row keeps the longest draft prefix the target's argmax agrees
with, then the target's token; rows that do not draft (sampled, grammar,
logprobs rows) ride along on position 0 with the plain step's sampling.
Side rows step apart as above; a round flushes the pipeline first. The
depth adapts to the acceptance (``_adapt_spec_depth``). Unlike the
reference, the chain writes its last draft's K/V (ROADMAP §C), and a
recurrent-state target or draft raises instead of turning speculation off.

LoRA (``engine/lora.py``): the model has one live adapter, as in the JAX
package, where the engine and the Executor share the model's params.
``set_lora`` queues a switch and returns a future; the loop applies it at
the next step boundary (``_lora_boundary``), stream-ordered after the rounds
in flight, and running rows continue under the new weights, as they do in
JAX. A request's ``lora_adapter`` (an adapter of ``lora_registry``) queues
the switch to it before the request is scheduled. The switch writes dense
weights and same-shaped low-rank buffers in place, so the captured graphs
stay valid; a switch that replaced buffers drops the graphs, which are
captured again at their next use. Every switch drops the prefix cache and
its host tier: their K/V was computed under the previous weights (the JAX
engine keeps serving it; ROADMAP §C). A draft model keeps its own weights.

MoE expert offload (``engine/moe_offload.py``; JAX :1145-1150): the model's
offload runtime (installed here under ``inference.moe_offload`` unless an
Executor over the same model installed it) ticks once per engine step. Its
forward reads the host once a MoE layer, so the engine's steps run eagerly,
without graphs (ROADMAP §C). Prefill and decode phases are traced by
``utils/tracing.span`` (JAX :1125, :1136), outside any graph.

Tensor, expert and sequence parallelism (JAX :263-285, :490-520): with
``tensor_parallel_size``, ``expert_parallel_size`` or
``sequence_parallel_size`` above 1 the engine slices the model to its rank
(``parallel/tp.py::shard_model``) before it allocates its cache, which then
holds the rank's kv heads (int8 scale planes too); MLA latent pages and the
Mamba2 state rows have no head axis and stay whole, and a hybrid's KV part
holds the rank's kv heads (JAX :279-284). Every rank runs the same
steps (``distributed/lockstep.py`` replays rank 0's op stream), eagerly: a
CUDA graph cannot capture a gloo collective (ROADMAP §C). ``sync_device``
drains the device before the lockstep broadcast. Under sp a prompt of at
least ``sp_prefill_threshold`` tokens from position 0 prefills in one
unchunked ring-attention pass (``_sp_prefill``), its K/V then gathered into
every rank's pages. ``data_parallel_size`` is replica routing
(``engine/data_parallel.py``), as in JAX. The recurrent and MLA families
take the ordinary prefill under sp (the JAX ring is llama-only, :498-510).
A draft model is sliced like the target; where it cannot be (its heads,
groups or widths do not divide), it stays whole on every rank with a log
line, as the JAX engine leaves it replicated (:352-360), and the verify and
draft-chain steps run eagerly like every step under a mesh. Under a mesh a
LoRA adapter raises the JAX Executor's ``ValueError``; MoE offload is not
installed.

Left out: a streaming model (layer offload) raises: the JAX engine cannot
be built over one (ROADMAP §C). int4 KV on the paged path raises instead of
being downgraded.

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
import concurrent.futures
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
from ..kvcache.paged import (PAD_BLOCK, compute_slot_mapping, pad_block_table,
                             write_paged_layer)
from ..kvcache.prefix_cache import PrefixCache, PrefixCacheConfig
from ..models.paged_multi import trash_slot, zero_state_rows
from ..models.registry import init_engine_cache, make_paged_forward
from ..models.registry import Model
from ..parallel.ring_attention import ring_eligible, ring_prefill
from ..parallel.tp import shard_model
from ..quant.qtensor import apply_quant_compute, quant_leaves
from ..utils.tracing import span
from .decode_graph import TOPK_K, BatchStep, DraftChain, StepGraphs, VerifyStep, pack_rows
from .grammar import GrammarState, make_grammar_state, padded_mask
from .grammar_json import request_grammar_source
from .lora import LoraAdapter, LoraAdapterRegistry, lora_state, lora_under_mesh
from .moe_offload import ensure_offload
from .samplers import MirostatState, dry_breaker_ids, host_sample, needs_host_sampling
from .sampling import SamplingParams, make_bias_rows, make_window, sample_tokens
from .sequence_scheduler import (SchedulerConfig, Sequence, SequenceScheduler,
                                 SequenceState)
from .speculative import check_speculative, prompt_lookup_draft
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


def _streaming_refused() -> NotImplementedError:
    return NotImplementedError(
        "layer offload (a model streamed from host RAM) is not served by BatchEngine: "
        "the JAX BatchEngine cannot be built over a StreamingModel; serve it through "
        "the Executor (ROADMAP §C)")


class BatchEngine:
    """Paged-KV continuous-batching executor + scheduler loop. Runs on the
    device the model's params lie on."""

    def __init__(self, model: Model, tokenizer,
                 app_cfg: Optional[AppConfig] = None,
                 draft_model: Optional[Model] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.app_cfg = app_cfg or AppConfig(model=model.cfg)
        inf = self.app_cfg.inference
        self._check_config(inf)
        if getattr(model, "is_streaming", False):
            raise _streaming_refused()
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
        self.mesh = shard_model(model, inf)
        if self.mesh is None:
            self._moe_rt = ensure_offload(model, inf)
        else:
            self._moe_rt = None
            if inf.moe_offload:
                logger.warning("moe_offload is not installed under a mesh (JAX executor.py:106)")
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
        self._init_speculation(inf, draft_model, num_blocks)
        if self.prefix_cache is not None and inf.gpu_prefix_cache:
            attach_host_tier(self.prefix_cache, self.cache,
                             max_blocks=inf.prefix_cache_ram_tier,
                             draft_cache=self._draft_cache)
        self._fwd = make_paged_forward(model.cfg)
        self._trash = trash_slot(self.cache)
        self.horizon_dispatches = 0
        self.horizon_steps = 0
        # The decode pipeline: dispatched, unread rounds (newest last;
        # carries chain from the newest), at most _pipe_depth after a call.
        self._pipe_q: deque = deque()
        self._pipe_depth = max(1, int(inf.decode_pipe_depth or 1))
        self._steps: dict[int, BatchStep] = {}          # by bmax
        self._side_steps: dict[int, BatchStep] = {}     # the side step's, by bmax
        self._verify_steps: dict[int, VerifyStep] = {}  # the speculative round's, by bmax
        self._chains: dict[int, DraftChain] = {}        # the draft chain's, by bmax
        eager = self._moe_rt is not None or self.mesh is not None
        if eager and inf.graphs and self.device.type == "cuda":
            logger.info("decode steps run eagerly: the %s", "MoE offload forward reads host "
                        "memory inside the step" if self._moe_rt is not None
                        else "mesh's collectives cannot be captured")
        self.graphs = StepGraphs(self.device, inf.graphs and not eager)
        # Sequence-parallel prefill (JAX :490-520): the llama forward without
        # ALiBi or a softcap, on an sp axis.
        self._sp = self.mesh.size("sp") if self.mesh is not None else 1
        self._sp_ok = self._sp > 1 and not needs_state_rows and ring_eligible(model.cfg)
        self._preemptions = 0
        # Wall time by phase (seconds; "<phase>_n" counts calls) and the
        # prompt tokens the prefills computed ("prefill_tokens").
        self.perf: dict[str, float] = defaultdict(float)
        self._handles: dict[int, RequestHandle] = {}
        self._windows: dict[int, list[int]] = {}
        # Constrained rows: each sequence's grammar state, and the host
        # samplers' state of the rows that need them.
        self._grammars: dict = {}
        self._host_states: dict[int, dict] = {}
        self._vocab_bytes: Optional[list[bytes]] = None
        # Device grammar tables: a DFA's padded planes on the host, by
        # id(dfa), and one device buffer pair per height [mask, next, dfa].
        self._gram_host: dict[int, tuple] = {}
        self._gram_dev: dict[int, list] = {}
        self._notify = asyncio.Event()
        self._stop = False
        self._loop = None
        self._loop_thread = None
        self._running = False
        self._defer_puts: Optional[list] = None
        # LoRA: this engine applies the model's switches (the Executor on the
        # same model hands its own to it); queued (adapter, future) pairs.
        self._lora = lora_state(model)
        self._lora.attach(self)
        self._lora_epoch, self._lora_sig = self._lora.epoch, self._lora.sig
        self._lora_mu = threading.Lock()
        self._lora_pending: list[tuple[Optional[LoraAdapter], concurrent.futures.Future]] = []
        # Where a request's ``lora_adapter`` is looked up (the server's).
        self.lora_registry: Optional[LoraAdapterRegistry] = None

    @staticmethod
    def _check_config(inf) -> None:
        if inf.kv_cache_dtype == "int4":
            raise ValueError("kv_cache_dtype='int4' is not supported on the "
                             "paged path (use 'int8' or 'auto')")
        if inf.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {inf.kv_cache_dtype!r}")
        if inf.num_device_layers is not None:
            raise _streaming_refused()

    def _init_speculation(self, inf, draft_model: Optional[Model], num_blocks: int) -> None:
        """Speculation's state (JAX :287-364): the depth k, the counters,
        and a draft model's paged cache over the target's block geometry
        (its own widths, int8 as the target's KV)."""
        spec = inf.speculative
        self._spec_k = (spec.num_speculative_tokens
                        if spec is not None and spec.num_speculative_tokens > 0 else 0)
        self.spec_drafted = 0
        self.spec_accepted = 0
        # Adaptive depth: drafts fill at most _spec_depth of the k verify
        # positions; the verify step's shapes stay fixed at k+1.
        self._spec_adaptive = bool(spec is not None and spec.adaptive_depth)
        self._spec_depth = self._spec_k
        self._spec_win = [0, 0]          # drafted, accepted (rolling window)
        self._spec_rounds = 0
        self._spec_read_t: Optional[float] = None
        self._draft: Optional[Model] = None
        self._draft_cache = None
        if not self._spec_k:
            return
        check_speculative(self.model)
        if draft_model is None:
            if spec.draft_model:
                logger.warning("speculative.draft_model set but no draft model given; "
                               "using prompt-lookup drafts")
            return
        check_speculative(draft_model)
        if draft_model.vocab_size != self.model.vocab_size:
            raise ValueError(f"draft model vocab ({draft_model.vocab_size}) != target "
                             f"vocab ({self.model.vocab_size})")
        if draft_model.device != self.device:
            raise ValueError(f"draft model on {draft_model.device}, target on {self.device}")
        if self.mesh is not None:
            try:
                shard_model(draft_model, inf)
            except ValueError as e:        # heads, groups or widths that do not divide
                logger.warning("draft model left whole on every rank of the mesh: %s", e)
        self._draft = draft_model
        self._draft_cache, _ = init_engine_cache(
            draft_model.cfg, num_blocks, self.block_size, self.max_batch,
            dtype=draft_model.dtype, quantized=inf.kv_cache_dtype == "int8",
            device=self.device)
        self._dfwd = make_paged_forward(draft_model.cfg)
        self._d_trash = trash_slot(self._draft_cache)

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------
    def submit(self, prompt_tokens: list[int],
               gen_cfg: Optional[GenerationConfig] = None) -> RequestHandle:
        gen_cfg = gen_cfg or GenerationConfig()
        gen_cfg.validate()
        # What can reject the request (an adapter not loaded, the grammar's
        # compile) runs before the scheduler is touched: a failure after
        # add_request would leave an orphaned sequence queued.
        name = gen_cfg.lora_adapter
        adapter = (LoraAdapterRegistry.lookup(self.lora_registry, name)
                   if name and name != self._lora.active else None)
        g = self._grammar_for(gen_cfg)
        if adapter is not None:
            self.set_lora(adapter)          # lands before this request is scheduled
        seq_id = self.scheduler.add_request(prompt_tokens, gen_cfg)
        handle = RequestHandle(seq_id=seq_id, queue=asyncio.Queue(),
                               prompt_tokens=len(prompt_tokens))
        self._handles[seq_id] = handle
        if g is not None:
            self._grammars[seq_id] = g
        self._windows[seq_id] = list(prompt_tokens)
        if needs_host_sampling(gen_cfg):
            self._host_states[seq_id] = {
                "mirostat": (MirostatState.from_config(gen_cfg)
                             if gen_cfg.mirostat == 2 else None),
                "rng": np.random.default_rng(
                    gen_cfg.seed if gen_cfg.seed is not None else 0),
                "breakers": (dry_breaker_ids(self.tokenizer, gen_cfg)
                             if gen_cfg.dry_multiplier > 0 else None),
            }
        self._notify.set()
        return handle

    def vocab_bytes(self) -> list[bytes]:
        if self._vocab_bytes is None:
            self._vocab_bytes = self.tokenizer.vocab_bytes()
        return self._vocab_bytes

    def _grammar_for(self, cfg: GenerationConfig):
        src = request_grammar_source(cfg)
        if src is None:
            return None
        return make_grammar_state(src, self.vocab_bytes(),
                                  eos_token_id=self.tokenizer.eos_token_id)

    def _host_pick(self, seq: Sequence, logits_row: np.ndarray) -> int:
        """The host samplers' token from a row's raw logits, under its
        grammar's mask (ids past the tokenizer's vocabulary never legal)."""
        st = self._host_states[seq.seq_id]
        logits_row = np.asarray(logits_row, dtype=np.float32)
        g = self._grammars.get(seq.seq_id)
        if g is not None:
            logits_row = np.where(padded_mask(g, len(logits_row)), logits_row, -np.inf)
        return host_sample(logits_row, seq.gen_cfg, self._windows[seq.seq_id],
                           st["mirostat"], st["breakers"], st["rng"])

    def detach_handle(self, seq_id: int) -> None:
        """Stop streaming a sequence's tokens while it keeps decoding (JAX
        :1175): a lockstep follower runs every sequence and serves no one."""
        self._handles.pop(seq_id, None)

    def cancel(self, seq_id: int) -> None:
        """Abort a sequence (a stop sequence matched, or its client left):
        its blocks go back to the pool and its stream ends."""
        self.scheduler.abort_sequence(seq_id)
        self._finish(seq_id, None)

    def stop(self) -> None:
        self._stop = True
        self._notify.set()

    # ------------------------------------------------------------------
    # LoRA
    # ------------------------------------------------------------------
    def set_lora(self, adapter: Optional[LoraAdapter]) -> concurrent.futures.Future:
        """Queue a switch to ``adapter`` (None: the base) for the next step
        boundary; the future ends when it landed (its exception: an adapter
        the model cannot take). With no loop running, now is a boundary."""
        if self.mesh is not None and adapter is not None:
            raise lora_under_mesh()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lora_mu:
            self._lora_pending.append((adapter, fut))
        if not self._running:
            self._lora_boundary()
        else:
            self._loop.call_soon_threadsafe(self._notify.set)
        return fut

    def clear_lora(self) -> concurrent.futures.Future:
        return self.set_lora(None)

    @property
    def active_lora(self) -> Optional[str]:
        return self._lora.active

    def _lora_boundary(self) -> None:
        """Between two steps: apply the queued switches, then drop what a
        switch made stale: cached K/V of the previous weights (the prefix
        cache and its host tier) and graphs over replaced LoRA buffers."""
        with self._lora_mu:
            pending, self._lora_pending = self._lora_pending, []
        for adapter, fut in pending:
            try:
                self._lora.activate(adapter)
            except Exception as e:          # the caller's to see
                fut.set_exception(e)
            else:
                fut.set_result(self._lora.active)
        if self._lora.epoch != self._lora_epoch:
            self._lora_epoch = self._lora.epoch
            if self.prefix_cache is not None:
                self.prefix_cache.clear()
            self.perf["lora_switch_n"] += 1
        self._sync_graphs()

    def _sync_graphs(self) -> None:
        if self._lora.sig != self._lora_sig:
            self._lora_sig = self._lora.sig
            self.graphs.reset()

    def _holding_weights(self, fn, *args, **kw):
        """``fn`` with LoRA switches held off (another engine's included)."""
        with self._lora.lock:
            self._sync_graphs()
            return fn(*args, **kw)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def bind_loop(self) -> None:
        """Take the running event loop as the one tokens are delivered on
        (``run``, or a ``LockstepEngine`` driving ``step_once``)."""
        self._stop = False
        # Tokens are emitted on to_thread workers; call_soon_threadsafe
        # wakes the loop for each delivery (see _put_now).
        self._loop = asyncio.get_running_loop()
        self._loop_thread = threading.get_ident()
        self._notify = asyncio.Event()      # of this loop (an engine may serve again)
        self._running = True

    def sync_device(self) -> None:
        """Wait until every queued device operation is done (JAX
        :1154-1165): a lockstep broadcast must not overlap the collectives of
        work still in flight on the same transport (the JAX package's
        dede0e4 fix). Unread rounds stay unread."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unbind_loop(self) -> None:
        """The loop that drove ``step_once`` has ended."""
        self._running = False
        self._lora_boundary()           # a switch queued as the loop ended

    async def run(self) -> None:
        self.bind_loop()
        logger.info("batch engine started (max_batch=%d, blocks=%d, device=%s)",
                    self.max_batch, self.allocator.num_blocks, self.device)
        try:
            await self._serve()
        finally:
            self.unbind_loop()
        logger.info("batch engine stopped")

    async def _serve(self) -> None:
        while not self._stop:
            self._lora_boundary()
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

    async def step_once(self) -> bool:
        """One scheduling iteration: schedule, dispatch prefills, run ONE
        decode round, then fetch the prefills' first tokens. Returns False
        when the batch was empty."""
        if not self.scheduler.has_work:
            # Unread rounds are overrun of finished or aborted sequences.
            self._pipe_q.clear()
            return False
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
            with span("prefill", backend="paged", batch=len(batch.prefill_sequences)):
                t0 = time.perf_counter()
                pending = await asyncio.to_thread(self._holding_weights,
                                                  self._dispatch_prefills,
                                                  batch.prefill_sequences, cold=cold)
                self.perf["prefill"] += time.perf_counter() - t0
                self.perf["prefill_n"] += 1
        decodes = [s for s in batch.decode_sequences
                   if s.state == SequenceState.RUNNING]
        if decodes:
            with span("decode", backend="paged", batch=len(decodes)):
                t0 = time.perf_counter()
                await asyncio.to_thread(self._holding_weights, self._process_decode_batch,
                                        decodes)
                self.perf["decode"] += time.perf_counter() - t0
                self.perf["decode_n"] += 1
        if pending:
            t0 = time.perf_counter()
            await asyncio.to_thread(self._finish_prefills, pending)
            self.perf["p_finish"] += time.perf_counter() - t0
        if self._moe_rt is not None:
            # Once per engine step (JAX :1145-1150): usage decay, rebalance;
            # under the weights' lock, as another engine's forward reads them.
            await asyncio.to_thread(self._holding_weights, self._moe_rt.tick)
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
        pending = []
        if self._sp_ok:
            # Sequence-parallel rows (JAX :1226-1237, :1273-1278): whole
            # prompts from position 0, one ring pass each, unchunked.
            thr = self.app_cfg.inference.sp_prefill_threshold
            ring = [s for s in seqs
                    if s.prefilled_tokens == 0 and len(s.prompt_tokens) >= thr]
            seqs = [s for s in seqs if s not in ring]
            pending += [self._sp_prefill(s) for s in ring]
        groups: dict[int, list[Sequence]] = {}
        for seq in seqs:
            remaining = len(seq.prompt_tokens) - seq.prefilled_tokens
            groups.setdefault(_next_pow2(min(chunk_cfg, remaining)), []).append(seq)
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
        inputs = (torch.from_numpy(toks).to(dev), torch.from_numpy(pos).to(dev),
                  torch.from_numpy(slots).to(dev), torch.from_numpy(bt).to(dev), seq_lens)
        logits, self.cache = self._fwd(
            self.model.params, self.model.cfg, inputs[0], self.cache, *inputs[1:],
            last_idx=last_idx)
        if self._draft is not None:
            self._draft_prefill(*inputs, last_idx)
        packed, last = self._first_tokens(logits[:n_real, 0, :], finishing, cfgs, wins)
        return group, chunks, finishing, packed, last

    def _sp_prefill(self, seq: Sequence):
        """One whole prompt through ring attention over sp (JAX
        ``_prefill_group(step=sp_prefill_step)``; ``parallel/
        ring_attention.py::ring_prefill``) into the sequence's pages, and
        the first token sampled from the last position's logits. Returns
        the pending entry of ``_prefill_group``."""
        n = len(seq.prompt_tokens)
        slots = compute_slot_mapping(seq.block_table, 0, n, self.block_size, self._trash)
        planes = [self.cache.k, self.cache.v]
        if self.cache.quantized:
            planes += [self.cache.k_scale, self.cache.v_scale]
        logits = ring_prefill(
            self.model.params, self.model.cfg, seq.prompt_tokens, slots, self._trash,
            self.mesh.axis("sp"),
            lambda li, k, v, idx: write_paged_layer(self.cache, li, k, v, idx), planes)
        self.perf["prefill_tokens"] += n
        self.perf["sp_prefill_n"] += 1
        win = make_window(self._windows[seq.seq_id], seq.gen_cfg.repeat_last_n)
        finishing = [(seq, 0)]
        packed, last = self._first_tokens(logits[:, 0, :], finishing, [seq.gen_cfg], [win])
        return [seq], [n], finishing, packed, last

    def _draft_prefill(self, toks, pos, slots, bt, seq_lens, last_idx) -> None:
        """The draft's mirror of a target prefill group (JAX
        ``draft_prefill``, :689-701): the same tokens, slots and tables on
        the draft's cache, so its chain attends the whole history; the
        logits are dropped."""
        t0 = time.perf_counter()
        self._dfwd(self._draft.params, self._draft.cfg, toks, self._draft_cache, pos, slots,
                   bt, seq_lens, last_idx=last_idx)
        self.perf["draft_prefill"] += time.perf_counter() - t0
        self.perf["draft_prefill_n"] += 1

    def _first_tokens(self, last: torch.Tensor, finishing: list, cfgs: list, wins: list):
        """The first tokens of a prefill group's finishing rows: sampled on
        the device under each grammar row's mask (the others' rows all
        True); the raw logits come back too where a finishing row's token
        is the host samplers' (JAX :1317-1323, :1368-1375)."""
        if not finishing:
            return None, None
        ids = [-1] * last.shape[0]
        for seq, i in finishing:
            ids[i] = seq.seq_id
        mask = None
        if any(sid in self._grammars for sid in ids):
            mask = torch.from_numpy(self._grammar_mask(ids)).to(self.device)
        sp, window, bias_ids, bias_vals = self._sampling(cfgs, 0, wins)
        tok, logprobs = sample_tokens(last, sp, window, bias_ids, bias_vals, mask)
        use_topk = any(s.gen_cfg.logprobs for s, _ in finishing)
        host = any(s.seq_id in self._host_states for s, _ in finishing)
        return pack_rows(tok, logprobs, use_topk), (last if host else None)

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
        finishing = [(seq, 0)] if start + chunk >= len(seq.prompt_tokens) else []
        win = make_window(self._windows[seq.seq_id], seq.gen_cfg.repeat_last_n)
        packed, last = self._first_tokens(logits[:, 0, :], finishing, [seq.gen_cfg], [win])
        return [seq], [chunk], finishing, packed, last

    def _finish_prefills(self, pending: list) -> None:
        """Fetch queued prefill outputs and emit first tokens."""
        for group, chunks, finishing, packed, last in pending:
            for i, seq in enumerate(group):
                self.scheduler.prefill_complete(seq.seq_id, chunks[i])
            if not finishing:
                continue
            out = packed.cpu().numpy()                  # ONE fetch per group
            last_np = None if last is None else last.float().cpu().numpy()
            self._defer_puts = []
            try:
                for seq, i in finishing:
                    if seq.seq_id in self._host_states:
                        tok, lp = self._host_pick(seq, last_np[i]), float("nan")
                    else:
                        tok, lp = int(out[i, 0]), float(out[i, 1])
                    self._emit(seq, tok, lp, top=self._top_row(seq, out[i]))
            finally:
                buf, self._defer_puts = self._defer_puts, None
                self._flush_puts(buf)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _step(self, bmax: int, side: bool = False) -> BatchStep:
        """The decode step at ``bmax`` rows; the side step has its own, so
        its carries and rings never touch the pipeline's."""
        steps = self._side_steps if side else self._steps
        step = steps.get(bmax)
        if step is None:
            step = steps[bmax] = BatchStep(self, bmax, self._horizon, self._pipe_depth + 1)
        return step

    def _side_row(self, seq: Sequence) -> bool:
        """A row that needs the host every step: a host sampler's, or an
        exact-PDA grammar's (its mask is rebuilt on the host)."""
        if seq.seq_id in self._host_states:
            return True
        g = self._grammars.get(seq.seq_id)
        return g is not None and not isinstance(g, GrammarState)

    def _spec_eligible(self, seq: Sequence) -> bool:
        """Argmax verification is exact only for pure greedy rows (JAX
        :1462-1471); logprobs rows ride position 0 instead of drafting."""
        g = seq.gen_cfg
        return (g.temperature == 0.0 and g.repeat_penalty == 1.0
                and g.frequency_penalty == 0.0 and g.presence_penalty == 0.0
                and not g.logit_bias and not g.logprobs
                and seq.seq_id not in self._grammars
                and seq.seq_id not in self._host_states)

    @torch.no_grad()
    def _process_decode_batch(self, decodes: list[Sequence]) -> None:
        """One decode round (JAX :1484-1506, :1690-1706). Side rows step
        once on their own, without flushing the pipeline, while the other
        rows keep the horizon or the speculative round; a batch with a
        greedy row takes a speculative round when speculation is on; a
        batch that needs the host's masks or logits for every row takes a
        flushed T=1 step."""
        if self._horizon > 1 or self._spec_k:
            side = [s for s in decodes if self._side_row(s)]
            if side and len(side) < len(decodes):
                rest = [s for s in decodes if not self._side_row(s)]
                self._single_step_batch(side, flush=False, side=True)
                decodes = rest
        if self._spec_k and any(self._spec_eligible(s) for s in decodes):
            self._process_decode_batch_spec(decodes)
            return
        self._spec_read_t = None             # the next spec round's gap is not a spec gap
        bmax = min(_next_pow2(len(decodes), minimum=1), self.max_batch)
        decodes = decodes[:bmax]
        host = any(s.seq_id in self._host_states for s in decodes)
        grammar = any(s.seq_id in self._grammars for s in decodes)
        tables = None
        if grammar and not host and self._horizon > 1:
            tables = self._grammar_tables(decodes)
        if host or (grammar and tables is None):
            self._single_step_batch(decodes, flush=True)
        else:
            self._horizon_round(decodes, tables)

    def _single_step_batch(self, decodes: list[Sequence], flush: bool,
                           side: bool = False) -> None:
        """One T=1 decode step over ``decodes`` with the host's grammar
        masks uploaded and, for host-sampler rows, the raw logits read back
        (JAX ``_single_step_batch``, :1708). ``flush`` first lands the
        pipeline's unread rounds, whose tokens these rows' tables need; the
        side step's rows never enter the pipeline."""
        if flush:
            self._flush_pipe()
            decodes = [s for s in decodes if s.state == SequenceState.RUNNING]
            if not decodes:
                return
        n = len(decodes)
        bmax = min(_next_pow2(n, minimum=1), self.max_batch)
        step = self._step(bmax, side)
        rows = list(decodes) + [None] * (bmax - n)
        windows = [None if s is None else
                   make_window(self._windows[s.seq_id], s.gen_cfg.repeat_last_n)
                   for s in rows]
        table = step.build(rows, [0] * bmax, np.ones((bmax,), dtype=bool), windows)
        use_topk = any(s.gen_cfg.logprobs for s in decodes)
        host_rows = [i for i, s in enumerate(decodes) if s.seq_id in self._host_states]
        any_sampled = any(s.gen_cfg.temperature > 0.0 for i, s in enumerate(decodes)
                          if i not in host_rows)
        masked = any(s.seq_id in self._grammars for s in decodes)
        raw = bool(host_rows)
        t0 = time.perf_counter()
        if masked:
            mask_buf, mask_ring = step.mask
            mask_ring.upload(self._grammar_mask([s.seq_id for s in decodes], bmax), mask_buf)
        step.up.upload(table, step.tab)
        self.graphs.run((bmax, side, use_topk, any_sampled, None, masked, raw),
                        step.step_fn(use_topk, any_sampled, mask=masked, raw=raw))
        slot = step.down[use_topk].download(step.out[use_topk])
        if raw:
            logits_buf, logits_ring = step.logits
            logits_slot = logits_ring.download(logits_buf)
        out = step.down[use_topk].read(slot)[0]
        last = logits_ring.read(logits_slot) if raw else None
        self.perf["single_step"] += time.perf_counter() - t0
        self.perf["single_step_n"] += 1
        self._defer_puts = []
        try:
            for i, seq in enumerate(decodes):
                if i in host_rows:
                    tok, lp = self._host_pick(seq, last[i]), float("nan")
                else:
                    tok, lp = int(out[i, 0]), float(out[i, 1])
                self._emit(seq, tok, lp, top=self._top_row(seq, out[i]))
        finally:
            buf, self._defer_puts = self._defer_puts, None
            self._flush_puts(buf)

    def _verify_step(self, bmax: int) -> VerifyStep:
        step = self._verify_steps.get(bmax)
        if step is None:
            step = self._verify_steps[bmax] = VerifyStep(self, bmax, self._spec_k)
        return step

    def _chain(self, bmax: int) -> DraftChain:
        chain = self._chains.get(bmax)
        if chain is None:
            chain = self._chains[bmax] = DraftChain(self, bmax, self._spec_k)
        return chain

    def _device_drafts(self, rows: list) -> np.ndarray:
        """[bmax, k] drafts of one draft-chain replay over ``rows`` (None: a
        pad row). Blocks cover the chain's writes (pos0 … pos0+k) and the
        verify's; where the allocator has none, the writes go to the trash
        slot (drafts degrade, verification stays exact)."""
        chain = self._chain(len(rows))
        for seq in rows:
            if seq is not None:
                self.scheduler._ensure_block_for(
                    seq, min(seq.total_len - 1 + self._spec_k, self.max_seq_len - 1))
        chain.up.upload(chain.build(rows), chain.tab)
        self.graphs.run(("chain", len(rows)), chain.chain_fn())
        return chain.down.read(chain.down.download(chain.drafts))

    def _process_decode_batch_spec(self, decodes: list[Sequence]) -> None:
        """One speculative round (JAX :1508-1651): drafts for the greedy
        rows, ONE verify replay over every row, one ``spec_finish`` replay
        and ONE read; each drafting row accepts the longest prefix of its
        drafts that matches the target's argmax, then emits the target's
        token there. The other rows emit position 0's token, sampled as the
        plain step samples it."""
        # Drafts and tables read the rows' last tokens: land the pipeline.
        self._flush_pipe()
        decodes = [s for s in decodes if s.state == SequenceState.RUNNING]
        if not decodes:
            return
        t0 = time.perf_counter()
        if self._spec_read_t is not None:
            self.perf["spec_gap"] += t0 - self._spec_read_t
            self.perf["spec_gap_n"] += 1
        k1 = self._spec_k + 1
        bmax = min(_next_pow2(len(decodes), minimum=1), self.max_batch)
        decodes = decodes[:bmax]
        rows = list(decodes) + [None] * (bmax - len(decodes))
        device_drafts = None
        if self._draft is not None:
            device_drafts = self._device_drafts(rows)
        drafts: list[list[int]] = []
        for i, seq in enumerate(decodes):
            draft: list[int] = []
            if self._spec_eligible(seq):
                budget = min(self._spec_depth, seq.gen_cfg.max_tokens - seq.emitted,
                             self.max_seq_len - 1 - seq.total_len)
                if budget > 0:
                    draft = (device_drafts[i, :budget].tolist() if device_drafts is not None
                             else prompt_lookup_draft(seq.all_tokens, budget))
                if draft and not self.scheduler._ensure_block_for(
                        seq, seq.total_len - 1 + len(draft)):
                    draft = []            # allocator pressure: a plain row
            drafts.append(draft)
        step = self._verify_step(bmax)
        windows = [None if s is None else
                   make_window(self._windows[s.seq_id], s.gen_cfg.repeat_last_n)
                   for s in rows]
        table = step.build(rows, drafts + [[]] * (bmax - len(decodes)), windows)
        use_topk = any(s.gen_cfg.logprobs for s in decodes)
        any_sampled = any(s.gen_cfg.temperature > 0.0 for s in decodes)
        masked = any(s.seq_id in self._grammars for s in decodes)
        if masked:
            step.mask_up.upload(self._grammar_mask([s.seq_id for s in decodes], bmax),
                                step.mask)
        step.up.upload(table, step.tab)
        self.graphs.run(("verify", bmax), step.verify_fn())
        self.graphs.run(("spec_finish", bmax, use_topk, any_sampled, masked),
                        step.finish_fn(use_topk, any_sampled, masked))
        out = step.down[use_topk].read(step.down[use_topk].download(step.out[use_topk]))
        self._spec_read_t = time.perf_counter()
        self.perf["spec"] += self._spec_read_t - t0
        self.perf["spec_n"] += 1
        drafted0, accepted0 = self.spec_drafted, self.spec_accepted
        self._defer_puts = []
        try:
            for i, seq in enumerate(decodes):
                row, draft = out[i], drafts[i]
                if not draft:
                    self._emit(seq, int(row[k1]), float(row[k1 + 1]),
                               top=self._top_row(seq, row[k1:]))
                    continue
                # Accept drafts while they match the argmax, then emit the
                # target's token at the first mismatch (or after the last).
                self.spec_drafted += len(draft)
                n = 0
                for d in draft:
                    if d != int(row[n]):
                        break
                    self.spec_accepted += 1
                    self._emit(seq, d, float("nan"))
                    n += 1
                    if seq.state != SequenceState.RUNNING:
                        break             # finished (EOS / length) inside the span
                if seq.state == SequenceState.RUNNING:
                    self._emit(seq, int(row[n]), float("nan"))
        finally:
            buf, self._defer_puts = self._defer_puts, None
            self._flush_puts(buf)
        self._adapt_spec_depth(self.spec_drafted - drafted0, self.spec_accepted - accepted0)

    def _adapt_spec_depth(self, drafted: int, accepted: int) -> None:
        """Step the depth from one round's acceptance (JAX :1653-1669):
        rounds that drafted feed a rolling window; every 8 such rounds the
        depth steps within [1, k]: above 80% acceptance up, below 40% down."""
        if not self._spec_adaptive or drafted <= 0:
            return
        self._spec_win[0] += drafted
        self._spec_win[1] += accepted
        self._spec_rounds += 1
        if self._spec_rounds % 8 == 0:
            rate = self._spec_win[1] / max(1, self._spec_win[0])
            if rate > 0.8:
                self._spec_depth = min(self._spec_depth + 1, self._spec_k)
            elif rate < 0.4:
                self._spec_depth = max(self._spec_depth - 1, 1)
            self._spec_win = [0, 0]

    def _horizon_round(self, decodes: list[Sequence], tables=None) -> None:
        """Dispatch one (possibly chained) decode round of up to
        ``decode_horizon`` steps onto the pipeline, then read and emit the
        oldest rounds while more than ``decode_pipe_depth`` are unread
        (``blazr_tpu/engine/batch_engine.py:1671,1796``). Rows that finish
        inside a round compute overrun steps whose tokens are dropped.
        ``tables`` ((height, (mask, next))) steps the rows' DFA on the
        device; a round chains only onto one over the same tables."""
        bmax = min(_next_pow2(len(decodes), minimum=1), self.max_batch)
        decodes = decodes[:bmax]
        use_topk = any(s.gen_cfg.logprobs for s in decodes)
        gkey = None if tables is None else (tables[0], id(self._gram_dev[tables[0]][2]))
        newest = self._pipe_q[-1] if self._pipe_q else None
        chain = (newest is not None and newest["bmax"] == bmax
                 and newest["topk"] == use_topk and newest["gkey"] == gkey)
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
        gstates = None
        if tables is not None:
            gstates = [None if s is None or s.seq_id not in self._grammars
                       else self._grammars[s.seq_id].state for s in rows]
        table = step.build(rows, lag, fresh, windows, gstates)
        any_sampled = any(s.gen_cfg.temperature > 0.0 for _, s in live)
        t0 = time.perf_counter()
        step.up.upload(table, step.tab)
        height = None if tables is None else tables[0]
        fn = step.step_fn(use_topk, any_sampled, gram=None if tables is None else tables[1])
        for _ in range(t_steps):
            self.graphs.run((bmax, False, use_topk, any_sampled, height, False, False), fn)
        slot = step.down[use_topk].download(step.out[use_topk])
        self.perf["h_dispatch"] += time.perf_counter() - t0
        self._pipe_q.append({"rows": rows, "t": t_steps, "bmax": bmax,
                             "topk": use_topk, "gkey": gkey, "ring": step.down[use_topk],
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
    # grammar masks and tables
    # ------------------------------------------------------------------
    def _grammar_tables(self, decodes: list[Sequence]):
        """(height, (mask, next state)) of the one DFA the rows' grammars
        share, loaded into the device buffers of its height, or None where
        device stepping cannot apply: a PDA-tier grammar, mixed DFAs, a DFA
        over 512 states (JAX :1971-2011). A DFA's tables, padded to the
        height (a power of two of at least 16 states) and to the model's
        vocabulary (ids past the tokenizer's are never legal), are built
        once and kept on the host; the card holds one buffer pair per
        height, rewritten when another DFA comes into use (stream-ordered
        after the rounds that read the old one, ROADMAP §C)."""
        dfa = None
        for s in decodes:
            g = self._grammars.get(s.seq_id)
            if g is None:
                continue
            if not isinstance(g, GrammarState):
                return None                     # the exact-PDA tier: host only
            if dfa is not None and g.dfa is not dfa:
                return None                     # mixed grammars in the batch
            dfa = g.dfa
        if dfa is None:
            return None
        host = self._gram_host.get(id(dfa))
        if host is None or host[0] is not dfa:
            tables = dfa.token_tables(self.vocab_bytes(),
                                      eos_token_id=self.tokenizer.eos_token_id)
            if tables is None:
                return None                     # too many states
            masks, nxt = tables
            v = self.model.vocab_size
            height = _next_pow2(masks.shape[0])
            gm = np.zeros((height, v), dtype=bool)
            gn = np.full((height, v), -1, dtype=np.int32)
            tv = min(masks.shape[1], v)
            gm[:masks.shape[0], :tv] = masks[:, :tv]
            gn[:masks.shape[0], :tv] = nxt[:, :tv]
            host = self._gram_host[id(dfa)] = (dfa, torch.from_numpy(gm),
                                               torch.from_numpy(gn))
        _, gm, gn = host
        height = gm.shape[0]
        buf = self._gram_dev.get(height)
        if buf is None:
            buf = self._gram_dev[height] = [torch.empty_like(gm, device=self.device),
                                            torch.empty_like(gn, device=self.device), None]
        if buf[2] is not dfa:
            buf[0].copy_(gm)
            buf[1].copy_(gn)
            buf[2] = dfa
            self.perf["grammar_uploads_n"] += 1
        return height, (buf[0], buf[1])

    def _grammar_mask(self, seq_ids: list[int], bmax: Optional[int] = None) -> np.ndarray:
        """[bmax, V] host masks: a grammar row's legal tokens, every other
        row all True."""
        v = self.model.vocab_size
        mask = np.ones((bmax or len(seq_ids), v), dtype=bool)
        for i, sid in enumerate(seq_ids):
            g = self._grammars.get(sid)
            if g is not None:
                mask[i] = padded_mask(g, v)
        return mask

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
        variants and both sampled keys, and with speculation the draft
        prefill beside each prefill and every graph of the speculative
        round (``_warm_spec``). Eager PyTorch
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
            inputs = (torch.zeros((1, t), dtype=torch.long, device=dev),
                      torch.arange(t, device=dev)[None],
                      torch.full((1, t), self._trash, dtype=torch.long, device=dev),
                      torch.full((1, mb), PAD_BLOCK, dtype=torch.int32, device=dev),
                      torch.tensor([t], dtype=torch.int32, device=dev))
            last_idx = torch.tensor([t - 1], device=dev)
            logits, self.cache = self._fwd(
                self.model.params, self.model.cfg, inputs[0], self.cache, *inputs[1:],
                torch.tensor([self.max_batch], device=dev),     # the trash state row
                last_idx=last_idx)
            if self._draft is not None:
                # The target's trash slot is a pad slot of the draft's too:
                # every cache has NB·BS slots and one trash slot after them.
                self._draft_prefill(*inputs, last_idx)
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
                    self.graphs.run((bmax, False, use_topk, any_sampled, None, False, False),
                                    step.step_fn(use_topk, any_sampled))
            if self._spec_k:
                self._warm_spec(bmax)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        logger.info("batch engine warmed in %.2fs: %d prefill buckets, %d decode "
                    "graphs (%.1f MiB pool)", dt, len(t_buckets), self.graphs.captured,
                    self.graphs.pool_bytes / 2**20)
        return dt

    def _warm_spec(self, bmax: int) -> None:
        """Capture the speculative round's graphs at ``bmax`` pad rows (JAX
        :922-980): the draft chain, the verify step, and ``spec_finish``
        under each (top-K logprobs, sampled rows, grammar mask) key."""
        if self._draft is not None:
            chain = self._chain(bmax)
            chain.up.upload(chain.build([None] * bmax), chain.tab)
            self.graphs.run(("chain", bmax), chain.chain_fn())
        step = self._verify_step(bmax)
        step.up.upload(step.build([None] * bmax, [[]] * bmax, [None] * bmax), step.tab)
        self.graphs.run(("verify", bmax), step.verify_fn())
        for use_topk in (False, True):
            for any_sampled in (False, True):
                for masked in (False, True):
                    self.graphs.run(("spec_finish", bmax, use_topk, any_sampled, masked),
                                    step.finish_fn(use_topk, any_sampled, masked))

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
        g = self._grammars.get(seq.seq_id)
        if g is not None:
            g.accept_token(token)
        is_eos = self.tokenizer.is_eos(token)
        hit_len = (seq.emitted >= seq.gen_cfg.max_tokens
                   or seq.total_len >= self.max_seq_len - 1)
        text = "" if is_eos else self._token_text(token)
        gt = GeneratedToken(token_id=token, text=text,
                            logprob=None if logprob != logprob else logprob,  # NaN: host pick
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
        self._grammars.pop(seq_id, None)
        self._host_states.pop(seq_id, None)
        if self._needs_state_rows:
            row = self._seq_rows.pop(seq_id, None)
            if row is not None:
                self._free_rows.append(row)

    def _token_text(self, tok: int) -> str:
        try:
            return self.tokenizer.decode([tok])
        except Exception:
            return ""
