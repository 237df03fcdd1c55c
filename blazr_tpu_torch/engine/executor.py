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

Constrained decoding and the host samplers (JAX :262-279, :442-560,
:614-623): a request's grammar (``grammar``, a JSON schema, JSON mode) is
compiled when its generation starts; each token is sampled under the
grammar's ``[1, V]`` mask (the step's "mask" variant, the mask uploaded
each token) and accepted by the grammar, which ends the stream on a token
it rejects or on EOS once complete. Mirostat, DRY, typical-p and dynamic
temperature pick on the host from the raw logits (the step's "raw"
variant, a forward alone), with a seeded numpy generator.

Speculative decoding (``engine/speculative.py``) drives ``_forward_step``
and ``_verify_step`` (JAX :147-156) over caches taken from ``_take``.

LoRA (JAX :565-592): ``set_lora`` / ``clear_lora`` switch the model's one
live adapter (``engine/lora.py``), through the model's ``BatchEngine`` at
its next step boundary when one serves the same model; a request's
``lora_adapter`` names an adapter of ``lora_registry`` and switches to it.
Every forward holds the switch's lock. After a switch the session's K/V,
computed under the previous weights, is never reused (the JAX executor
reuses it; ROADMAP §C), and graphs over replaced LoRA buffers are captured
again.

MoE expert offload (JAX :102-114, :596-611): under
``inference.moe_offload`` the model's MoE layers keep their hot experts on
the card and the rest in host RAM (``engine/moe_offload.py``, installed once
per model and shared with a ``BatchEngine`` over it); the runtime ticks once
a forward pass (each prefill piece, each decode token) and rebalances every
``moe_rebalance_interval`` ticks. A streaming model (``device_layers``,
``engine/offload_stream.py``; JAX :179-200) runs its host layers through
the card's two slots. Both read the host inside the forward, so their
decode steps run eagerly, without graphs (ROADMAP §C). A streaming model
given a ``quant_compute`` mode or ``moe_offload`` raises ``ValueError``:
the JAX Executor serves it with neither, without a word (ROADMAP §C). The
prefill is traced by ``utils/tracing.span`` (JAX :453).

Tensor, expert and sequence parallelism (JAX :77-101, :225-259): under
``tensor_parallel_size``, ``expert_parallel_size`` or
``sequence_parallel_size`` above 1 the executor slices the model to its rank
(``parallel/tp.py::shard_model``, in a world started by
``parallel/multihost.py``; every rank runs the same ``generate`` calls) and
its steps run eagerly (a CUDA graph cannot hold a gloo collective; ROADMAP
§C). Every family is served so: the MLA, Mamba2/Mamba3 and hybrid caches
are allocated from the rank's config (the latent and the state rows whole,
a hybrid's KV with the rank's kv heads), and a vision tower runs whole on
every rank around the sharded text forward (``executor_multimodal.py``).
Under sp a prompt from position 0 of at least ``sp_prefill_threshold``
tokens of the llama forward prefills with ring attention
(``_ring_prefill``), its K/V gathered into every rank's cache; the other
families take the ordinary prefill, as the JAX ring is llama-only.
``data_parallel_size`` is replica routing (``engine/data_parallel.py``) and
changes nothing here, as in JAX. Under a mesh a LoRA adapter raises the
JAX ``ValueError`` (JAX :572-574), a streamed model is refused (the JAX
Executor ignores the mesh; ROADMAP §C), and MoE offload is not installed
(JAX :106).
"""

from __future__ import annotations

import contextlib
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
from ..utils.tracing import span
from ..kvcache.contiguous import write_layer
from ..parallel.ring_attention import ring_eligible, ring_prefill
from ..parallel.tp import check_mesh_model, mesh_config, shard_model
from .batch_engine import _next_pow2
from .decode_graph import TOPK_K, ExecutorStep, StepGraphs, pack_rows
from .grammar import make_grammar_state, padded_mask
from .grammar_json import request_grammar_source
from .lora import LoraAdapter, LoraAdapterRegistry, lora_state, lora_under_mesh
from .moe_offload import ensure_offload
from .samplers import MirostatState, dry_breaker_ids, host_sample, needs_host_sampling
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
        self._vocab_bytes: Optional[list[bytes]] = None
        streaming = getattr(model, "is_streaming", False)
        if streaming:
            self._check_streaming(inf)
        self._moe_rt = None
        self.mesh = None
        if not streaming:
            # In place: a w8a8-widened weight replaces its 4-bit copy one
            # leaf at a time, so the 4-bit copy is freed.
            apply_quant_compute(model.params, inf.quant_compute, inplace=True)
            self.mesh = shard_model(model, inf)
            if self.mesh is None:
                self._moe_rt = ensure_offload(model, inf)
            elif inf.moe_offload:
                logger.warning("moe_offload is not installed under a mesh (JAX :106)")
        elif mesh_config(inf).ranks > 1:
            check_mesh_model(model)
        eager = streaming or self._moe_rt is not None or self.mesh is not None
        if eager and inf.graphs and model.device.type == "cuda":
            logger.info("decode steps run eagerly: the %s", "streaming forward reads host "
                        "memory inside the step" if streaming else "MoE offload forward "
                        "reads host memory inside the step" if self._moe_rt is not None
                        else "mesh's collectives cannot be captured")
        self.graphs = StepGraphs(model.device, inf.graphs and not eager)
        self._ring = self.mesh is not None and self.mesh.size("sp") > 1 and ring_eligible(
            model.cfg)
        self._lora = lora_state(model)
        self._lora_sig = self._lora.sig
        # Where a request's ``lora_adapter`` is looked up (the server's).
        self.lora_registry: Optional[LoraAdapterRegistry] = None

    @staticmethod
    def _check_config(inf) -> None:
        if inf.kv_cache_dtype not in ("auto", "int8", "int4"):
            raise ValueError(f"unknown kv_cache_dtype {inf.kv_cache_dtype!r}")

    @staticmethod
    def _check_streaming(inf) -> None:
        """A streamed model runs its weights as loaded: refuse the modes that
        would transform them rather than serve without them."""
        asked = []
        if inf.quant_compute not in (None, "auto", "w4a16"):
            asked.append(f"quant_compute={inf.quant_compute!r}")
        if inf.moe_offload:
            asked.append(f"moe_offload={inf.moe_offload!r}")
        if asked:
            raise ValueError(f"a model with layers streamed from host RAM (device_layers) "
                             f"is served as loaded, without {' or '.join(asked)} "
                             f"(ROADMAP §C)")

    @property
    def device(self) -> torch.device:
        return self.model.device

    def close(self) -> None:
        """Release the MoE offload runtime's host memory (model unload)."""
        if self._moe_rt is not None:
            self._moe_rt.close()
            self._moe_rt = None
            self.model.moe_offload_rt = None

    def _moe_tick(self) -> None:
        """One forward pass done: drive the offload manager (usage decay,
        the periodic rebalance), under the weights' lock: a rebalance
        rewrites resident experts that another engine's forward reads."""
        if self._moe_rt is not None:
            with self._lora.lock:
                self._moe_rt.tick()

    # ------------------------------------------------------------------
    # LoRA
    # ------------------------------------------------------------------
    def set_lora(self, adapter: Optional[LoraAdapter]) -> None:
        """Make ``adapter`` (None: the base) the model's live adapter: over
        the clean base, so adapters replace each other. Raises
        ``ValueError`` for an adapter with modules the model cannot take."""
        if self.mesh is not None and adapter is not None:
            raise lora_under_mesh()
        engine = self._lora.engine
        if engine is not None:
            engine.set_lora(adapter).result()
        else:
            self._lora.activate(adapter)

    def clear_lora(self) -> None:
        self.set_lora(None)

    @property
    def active_lora(self) -> Optional[str]:
        return self._lora.active

    def select_lora(self, name: Optional[str]) -> None:
        """Switch to the registry's adapter ``name`` unless it is live;
        ``KeyError`` when it is not loaded."""
        if name and name != self._lora.active:
            self.set_lora(LoraAdapterRegistry.lookup(self.lora_registry, name))

    @contextlib.contextmanager
    def _weights(self):
        """Hold the LoRA switch off while device work is queued; graphs over
        LoRA buffers a switch replaced are dropped first."""
        with self._lora.lock:
            if self._lora.sig != self._lora_sig:
                self.graphs.reset()
                self._lora_sig = self._lora.sig
            yield

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
        if self._session[1].lora_epoch != self._lora.epoch:
            self._session = None          # K/V of other weights (a LoRA switch)
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
        if (self.app_cfg.inference.prefix_cache and not self.model.needs_ssm_state
                and step.lora_epoch == self._lora.epoch):
            self._session = (list(fed_tokens), step)

    def _take(self, prompt_ids: list[int], reuse: bool = True) -> tuple[ExecutorStep, int]:
        """A cache (with its decode step) for one generation and the prompt
        tokens its KV already holds: the session's on a hit (``reuse``),
        else a free one emptied (the session's last), else a new one."""
        with self._lock:
            step, start = self._session_restore(prompt_ids) if reuse else (None, 0)
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
            if start == 0:
                step.lora_epoch = self._lora.epoch   # the weights its K/V is under
            return step, start

    def _give_back(self, fed_tokens: Optional[list[int]], step: ExecutorStep) -> None:
        """Return a cache; ``fed_tokens`` (None: the KV holds other rows than
        tokens, as after an image prefill) may make it the next session."""
        with self._lock:
            if fed_tokens is not None:
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
        with self._weights():
            return self._prefill(cache, prompt_ids, start_pos)

    def _prefill(self, cache, prompt_ids: list[int], start_pos: int):
        n = len(prompt_ids)
        assert n > 0, "empty prompt"
        if (self._ring and start_pos == 0
                and n >= self.app_cfg.inference.sp_prefill_threshold):
            return self._ring_prefill(cache, prompt_ids)
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
                self._moe_tick()
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
            self._moe_tick()
        return last, cache

    def _ring_prefill(self, cache, prompt_ids: list[int]):
        """The whole prompt in one sequence-parallel pass (JAX
        ``_ring_prefill``, :403-423; ``parallel/ring_attention.py::
        ring_prefill``): positions 0..n-1 of the one-row cache. The last
        position's logits [1, V]."""
        n = len(prompt_ids)
        planes = [cache.k[:, 0], cache.v[:, 0]]
        if cache.quantized:
            planes += [cache.k_scale[:, 0], cache.v_scale[:, 0]]
        logits = ring_prefill(self.model.params, self.model.cfg, prompt_ids, np.arange(n),
                              cache.trash_position, self.mesh.axis("sp"),
                              lambda li, k, v, idx: write_layer(cache, li, k, v, idx), planes)
        cache.length.fill_(n)
        self._moe_tick()
        return logits[:, -1, :], cache

    @torch.no_grad()
    def prefill_embeddings(self, cache, hidden: torch.Tensor) -> torch.Tensor:
        """Prefill from embeddings [1, T, H] (images, text and audio rows
        merged) at positions 0..T-1, unpadded, through the decoder layers and
        the head, as the JAX multimodal executor does (:100-106); the last
        position's logits [1, V]."""
        from ..models.llama import forward_head, forward_layers_range

        model = self.model
        t = hidden.shape[1]
        positions = torch.arange(t, device=self.device)[None]
        with self._weights():
            run_layers = getattr(model, "run_layers", None)      # a streaming model
            if run_layers is not None:
                x = run_layers(hidden.to(model.dtype), cache, positions)
            else:
                x, _ = forward_layers_range(model.params, model.cfg, hidden.to(model.dtype),
                                            cache, positions, 0, model.num_layers)
            return forward_head(model.params, model.cfg, x[:, -1:])[:, -1, :]

    @torch.no_grad()
    def _forward_step(self, cache, tokens: torch.Tensor, positions: torch.Tensor,
                      seq_lens: torch.Tensor):
        """(the last position's logits [1, V], cache): one forward over a
        cache from ``_take`` (JAX ``forward_step``, :147-150), written in
        place; the speculative executors' draft step."""
        with self._weights():
            logits, cache = self.model.forward(tokens, cache, positions, seq_lens)
        return logits[:, -1, :], cache

    @torch.no_grad()
    def _verify_step(self, cache, tokens: torch.Tensor, positions: torch.Tensor,
                     seq_lens: torch.Tensor):
        """(logits [1, T, V] of every position, cache): the speculative
        verify over ``[cur, drafts...]`` (JAX ``verify_step``, :152-156)."""
        with self._weights():
            return self.model.forward(tokens, cache, positions, seq_lens)

    @torch.no_grad()
    def _decode(self, step: ExecutorStep, cfg: GenerationConfig, tok: int, pos: int,
                index: int, history: list[int], pick) -> tuple[int, float, Optional[list]]:
        """One decode token: the table up, the step (a graph replay on the
        card), and ONE host fetch of the token, its logprob and (with
        ``cfg.logprobs``) the top-20. ``pick`` is the request's constraint
        (``_constraint``): the grammar's mask goes up before the step, or
        the host samplers pick from the raw logits it wrote."""
        use_topk = bool(cfg.logprobs)
        sampled = cfg.temperature > 0.0
        grammar, host = pick
        mode = "raw" if host is not None else "mask" if grammar is not None else "free"
        step.tab.copy_(torch.from_numpy(step.build(
            cfg, tok, pos, index, make_window(history, cfg.repeat_last_n))))
        if mode == "mask":
            step.mask.copy_(torch.from_numpy(padded_mask(grammar, self.model.vocab_size))[None])
        with self._weights():
            self.graphs.run((step, use_topk, sampled, mode),
                            step.step_fn(use_topk, sampled, mode))
        if mode == "raw":
            row = self._host_row(step.logits, grammar, host, history)
        else:
            row = self._row(step.out[use_topk][0].cpu().numpy(), cfg)
        self._moe_tick()
        return row

    @torch.no_grad()
    def _sample(self, last: torch.Tensor, cfg: GenerationConfig, step: int,
                history: list[int], bias, pick) -> tuple[int, float, Optional[list]]:
        """The first token from the prefill's [1, V] logits: fused device
        sampling under the grammar's mask, or the host samplers; ONE host
        fetch."""
        grammar, host = pick
        if host is not None:
            return self._host_row(last, grammar, host, history)
        dev = self.device
        sp = SamplingParams.from_config([cfg], step=step, device=dev)
        window = torch.from_numpy(make_window(history, cfg.repeat_last_n)[None, :]).to(dev)
        mask = (None if grammar is None else
                torch.from_numpy(padded_mask(grammar, self.model.vocab_size))[None].to(dev))
        tok, logprobs = sample_tokens(last, sp, window, *bias, mask)
        return self._row(pack_rows(tok, logprobs, bool(cfg.logprobs))[0].cpu().numpy(), cfg)

    # ------------------------------------------------------------------
    # grammars and host samplers
    # ------------------------------------------------------------------
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

    def _constraint(self, cfg: GenerationConfig) -> tuple:
        """(grammar state or None, host-sampler state or None) of one
        generation."""
        grammar = self._grammar_for(cfg)
        host = None
        if needs_host_sampling(cfg):
            host = dict(cfg=cfg,
                        mirostat=MirostatState.from_config(cfg) if cfg.mirostat == 2 else None,
                        rng=np.random.default_rng(cfg.seed if cfg.seed is not None else 0),
                        breakers=(dry_breaker_ids(self.tokenizer, cfg)
                                  if cfg.dry_multiplier > 0 else None))
        return grammar, host

    def _host_row(self, logits: torch.Tensor, grammar, host: dict,
                  history: list[int]) -> tuple[int, float, None]:
        """The host samplers' token from [1, V] raw logits; no logprob."""
        row = logits[0].float().cpu().numpy()
        if grammar is not None:
            row = np.where(padded_mask(grammar, len(row)), row, -np.inf)
        tok = host_sample(row, host["cfg"], history, host["mirostat"], host["breakers"],
                          host["rng"])
        return tok, float("nan"), None

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
        return self._generate(prompt_ids, gen_cfg, None)

    def generate_embedded(self, prompt_ids: list[int], hidden: torch.Tensor,
                          gen_cfg: Optional[GenerationConfig] = None
                          ) -> Iterator[GeneratedToken]:
        """``generate`` after a prefill from merged embeddings ``hidden`` [1,
        T, H] (``prefill_embeddings``; ``executor_multimodal.py``): the same
        decode steps, sampling, grammar and stop handling as a text prompt.
        ``prompt_ids`` (the text) is the penalty window's history; the
        context is T long. The cache is a fresh one and is never kept as a
        session."""
        return self._generate(prompt_ids, gen_cfg, hidden)

    def _generate(self, prompt_ids: list[int], gen_cfg: Optional[GenerationConfig],
                  hidden: Optional[torch.Tensor]) -> Iterator[GeneratedToken]:
        cfg = gen_cfg or self.app_cfg.generation
        cfg.validate()
        self.select_lora(cfg.lora_adapter)
        n_ctx = len(prompt_ids) if hidden is None else hidden.shape[1]
        max_new = min(cfg.max_tokens, self.capacity - n_ctx)
        if max_new <= 0:
            return
        pick = self._constraint(cfg)
        step, start = self._take(prompt_ids, reuse=hidden is None)
        kv_tokens = list(prompt_ids[:start])     # tokens whose KV the cache holds
        try:
            if hidden is None:
                backend = ("mamba2" if self.model.needs_ssm_state
                           and not self.model.needs_kv_cache else "contiguous")
                with span("prefill", backend=backend, tokens=len(prompt_ids) - start,
                          cached=start):
                    last, _ = self.prefill(step.cache, prompt_ids[start:], start_pos=start)
                kv_tokens = list(prompt_ids)
            else:
                kv_tokens = None                 # image rows: no session to reuse
                last = self.prefill_embeddings(step.cache, hidden)
            history = list(prompt_ids)
            ids, vals = make_bias_rows([cfg])
            bias = (torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(vals).to(self.device))
            pos = n_ctx
            tok, lp, top = self._sample(last, cfg, 0, history, bias, pick)
            for i in range(max_new):
                is_eos = self.tokenizer.is_eos(tok)
                # A token the grammar rejects (the mask makes that rare) ends
                # the stream (JAX ``_postprocess_token``, :614-623).
                finished = pick[0] is not None and not pick[0].accept_token(tok)
                yield GeneratedToken(token_id=tok,
                                     text="" if is_eos else self._token_text(tok),
                                     logprob=None if lp != lp else lp,  # NaN: host pick
                                     top_logprobs=top)
                history.append(tok)
                if finished or is_eos or i + 1 >= max_new or pos + 1 >= self.capacity:
                    return
                fed = tok
                tok, lp, top = self._decode(step, cfg, fed, pos, i + 1, history, pick)
                if kv_tokens is not None:
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

    def get_embeddings(self, prompt_ids: list[int]) -> np.ndarray:
        """[T, H] f32 token embeddings of ``prompt_ids``: the model's
        embedding rows, scaled as the forward scales them (JAX :652-660;
        pooling is the server's). A gather on the device, no kernel."""
        from ..models.llama import forward_embed

        ids = torch.tensor([prompt_ids], dtype=torch.long, device=self.device)
        with torch.inference_mode():
            emb = forward_embed(self.model.params, self.model.cfg, ids)[0]
            return emb.float().cpu().numpy()

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
