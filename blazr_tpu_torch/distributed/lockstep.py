"""Multi-process serving: the lockstep op stream.

Counterpart of ``blazr_tpu/distributed/lockstep.py`` (:44-227). Every rank
of a mesh runs the same ``BatchEngine`` steps in the same order: each
forward's collectives pair up only so. Rank 0 alone serves HTTP; it records
the engine's mutations (submit, cancel, stop) and the server's embedding
lookups as ops and broadcasts them before every scheduling iteration,
length then payload, over the mesh's gloo ``control`` group
(``parallel/mesh.py``), apart from the forwards' groups. Every rank, rank 0 included, applies the ops at the same point and
runs one ``step_once``. Scheduling, sequence ids and sampling keys are
functions of the op stream, and every rank samples the same gathered
logits, so the ranks stay in step with no other coordination.

An image chat is an Executor route (the batch engine takes no image rows),
so under a mesh it is an op too (``media``): rank 0 checks and decodes the
request's images (``server/app.py::_bind_media``), ships their bytes, the
prompt and the generation config, and every rank runs the same
``MultimodalExecutor.generate_multimodal`` on its own Executor over the
sharded model between two steps (the tower whole on every rank); rank 0
streams its tokens to the handler (``LockstepMedia``).

Before each broadcast the engine drains its device work
(``BatchEngine.sync_device``): the JAX package found that a host broadcast
overlapping the previous step's collectives on the same transport corrupts
both (its dede0e4 fix). With one process the broadcast is the identity.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import queue
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist

from ..config.generation import GenerationConfig

logger = logging.getLogger(__name__)

# Rank 0 broadcasts at least this often with no traffic, so no follower
# waits in a collective past its timeout.
HEARTBEAT_S = 10.0


def broadcast_payload(data: Optional[bytes], group=None) -> bytes:
    """Rank 0's byte string on every rank: its length, then the bytes, over
    ``group`` (followers pass None). The identity in a one-process world."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return data or b""
    primary = dist.get_rank() == 0
    n = torch.tensor([len(data or b"") if primary else 0], dtype=torch.int64)
    dist.broadcast(n, src=0, group=group)
    size = int(n.item())
    if size == 0:
        return b""
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if primary
           else torch.empty(size, dtype=torch.uint8))
    dist.broadcast(buf, src=0, group=group)
    return buf.numpy().tobytes()


def encode_ops(ops: list[dict[str, Any]]) -> bytes:
    return json.dumps(ops, separators=(",", ":")).encode()


def decode_ops(payload: bytes) -> list[dict[str, Any]]:
    return json.loads(payload.decode()) if payload else []


class LockstepEngine:
    """Drives a ``BatchEngine`` in lockstep across the world's processes.

    Rank 0 (the primary) takes the HTTP layer's calls::

        handle = await lockstep.submit(prompt_tokens, gen_cfg)
        async for tok in handle.tokens(): ...

    The other ranks ``await lockstep.run()`` and mirror every step.
    ``submit``/``cancel`` raise off the primary. ``executor`` (the Executor
    over the engine's model, on every rank) runs the image chats."""

    def __init__(self, engine, heartbeat_s: float = HEARTBEAT_S, executor=None):
        self.engine = engine
        self.executor = executor
        self.heartbeat_s = heartbeat_s
        up = dist.is_initialized()
        self.is_primary = not up or dist.get_rank() == 0
        self._nprocs = dist.get_world_size() if up else 1
        mesh = getattr(engine.model, "mesh", None)
        self._group = mesh.control if mesh is not None else None
        self._pending: list[tuple[dict[str, Any], Optional[asyncio.Future]]] = []
        self._wake: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop = False
        self._steps = 0

    # -- primary-side API ------------------------------------------------
    async def submit(self, prompt_tokens: list[int],
                     gen_cfg: Optional[GenerationConfig] = None):
        """Queue a request; resolves once every rank has admitted it."""
        if not self.is_primary:
            raise RuntimeError("submit() is primary-only in lockstep mode")
        op = {"op": "submit", "tokens": list(prompt_tokens),
              "gen": (gen_cfg or GenerationConfig()).to_dict()}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.append((op, fut))
        self._notify()
        return await fut

    async def get_embeddings(self, prompt_ids: list[int]):
        """``Executor.get_embeddings`` as an op: a sharded embedding's
        lookup all-reduces over the tp group, so every rank runs it at the
        same point between two steps. [T, H] f32 numpy on the primary."""
        if not self.is_primary:
            raise RuntimeError("get_embeddings() is primary-only in lockstep mode")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.append(({"op": "embed", "tokens": [int(t) for t in prompt_ids]}, fut))
        self._notify()
        return await fut

    def submit_media(self, prompt_ids: list[int], images: list[bytes],
                     gen_cfg: GenerationConfig, sink: "queue.Queue",
                     loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        """Queue an image chat from any thread (the handler's worker) onto
        the loop that runs (or will run) ``run()``: every rank runs it; rank
        0 puts each GeneratedToken into ``sink``, then None, or the
        exception that ended it."""
        if not self.is_primary:
            raise RuntimeError("submit_media() is primary-only in lockstep mode")
        loop = self._loop or loop
        if self.executor is None or loop is None:
            raise RuntimeError("the lockstep engine serves no image chats: no executor "
                               "or no event loop")
        op = {"op": "media", "tokens": [int(t) for t in prompt_ids],
              "images": [base64.b64encode(b).decode() for b in images],
              "gen": gen_cfg.to_dict()}

        def enqueue():
            self._pending.append((op, sink))
            self._notify()

        loop.call_soon_threadsafe(enqueue)

    def cancel(self, seq_id: int) -> None:
        if not self.is_primary:
            raise RuntimeError("cancel() is primary-only in lockstep mode")
        self._pending.append(({"op": "cancel", "seq": seq_id}, None))
        self._notify()

    def stop(self) -> None:
        self._stop = True
        self._notify()

    def _notify(self) -> None:
        if self._wake is not None:
            self._wake.set()

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def scheduler(self):
        """The wrapped engine's scheduler (the server's metrics read it)."""
        return self.engine.scheduler

    @property
    def lora_registry(self):
        return self.engine.lora_registry

    @lora_registry.setter
    def lora_registry(self, registry) -> None:
        self.engine.lora_registry = registry

    # -- lockstep loop (every rank) --------------------------------------
    async def run(self) -> None:
        self._wake = asyncio.Event()
        self._loop = asyncio.get_running_loop()
        self.engine.bind_loop()
        logger.info("lockstep engine started (primary=%s, %d processes)",
                    self.is_primary, self._nprocs)
        try:
            while True:
                items: list = []
                payload: Optional[bytes] = None
                if self.is_primary:
                    # Park until there are ops or live sequences, waking at
                    # the heartbeat so followers never sit in a collective
                    # past their timeout.
                    while (not self._pending and not self._stop
                           and not self.engine.scheduler.has_work):
                        self._wake.clear()
                        try:
                            await asyncio.wait_for(self._wake.wait(),
                                                   timeout=self.heartbeat_s)
                        except asyncio.TimeoutError:
                            break          # heartbeat: broadcast no ops
                    items, self._pending = self._pending, []
                    ops = [op for op, _ in items]
                    if self._stop:
                        ops.append({"op": "stop"})
                    payload = encode_ops(ops)
                if self._nprocs > 1:
                    await asyncio.to_thread(self.engine.sync_device)
                payload = await asyncio.to_thread(broadcast_payload, payload, self._group)
                stopping, media = self._apply(decode_ops(payload), [f for _, f in items])
                for op, sink in media:           # after the batch ops, in op order
                    await asyncio.to_thread(self._media, op, sink)
                if stopping:
                    break
                if not await self.engine.step_once():
                    await asyncio.sleep(0.001)
                else:
                    self._steps += 1
        finally:
            self.engine.stop()
            self.engine.unbind_loop()
            # Submits queued after the last broadcast would hang their
            # handlers.
            for _, fut in self._pending:
                if fut is not None and not fut.done():
                    fut.set_exception(RuntimeError("lockstep engine stopped"))
            self._pending.clear()
        logger.info("lockstep engine stopped after %d steps", self._steps)

    # -- op application (identical on every rank) ------------------------
    def _apply(self, ops: list[dict[str, Any]],
               futs: list[Optional[asyncio.Future]]) -> tuple[bool, list]:
        """Apply the batch engine's ops; (whether a stop came, the image
        chats to run after them with their sinks: rank 0's, None elsewhere)."""
        stopping = False
        media = []
        fi = 0
        for op in ops:
            kind = op["op"]
            fut = None
            if kind in ("submit", "cancel", "embed", "media"):
                if fi < len(futs):
                    fut = futs[fi]
                fi += 1
            if kind == "submit":
                # A request that fails (a bad grammar, an invalid config)
                # fails alone: the op raises alike on every rank.
                try:
                    handle = self.engine.submit(
                        op["tokens"], GenerationConfig.from_dict(op["gen"]))
                except Exception as e:
                    logger.warning("lockstep submit rejected: %s", e)
                    if fut is not None and not fut.done():
                        fut.set_exception(e)
                    continue
                if self.is_primary and fut is not None:
                    # The client may have left before the broadcast: the
                    # sequence still runs everywhere; its stream is dropped.
                    if not fut.done():
                        fut.set_result(handle)
                    else:
                        self.engine.detach_handle(handle.seq_id)
                elif not self.is_primary:
                    # Followers decode every sequence but stream to no one.
                    self.engine.detach_handle(handle.seq_id)
            elif kind == "embed":
                try:
                    emb = self._embed(op["tokens"])
                except ValueError as e:         # raised alike on every rank
                    if fut is not None and not fut.done():
                        fut.set_exception(e)
                    continue
                if fut is not None and not fut.done():
                    fut.set_result(emb)
            elif kind == "cancel":
                self.engine.cancel(op["seq"])
            elif kind == "media":
                media.append((op, fut))
            elif kind == "stop":
                stopping = True
            else:       # an op skipped on one rank would desynchronize the world
                raise ValueError(f"unknown lockstep op {kind!r}")
        return stopping, media

    def _media(self, op: dict[str, Any], sink: Optional["queue.Queue"]) -> None:
        """One image chat on this rank's Executor (every rank, the same
        calls); rank 0's tokens go to ``sink``. A failure (an image that
        does not decode, a config that does not validate) raises alike on
        every rank before any collective, so it ends the chat alone."""
        from ..engine.executor_multimodal import MultimodalExecutor

        ex = self.executor
        model = ex.model
        mm = MultimodalExecutor(ex, model.vision_params, model.vision_cfg)
        images = [base64.b64decode(b) for b in op["images"]]
        try:
            for tok in mm.generate_multimodal(op["tokens"], images=images,
                                              gen_cfg=GenerationConfig.from_dict(op["gen"])):
                if sink is not None:
                    sink.put(tok)
        except Exception as e:
            logger.warning("lockstep image chat failed: %s", e)
            if sink is not None:
                sink.put(e)
            return
        if sink is not None:
            sink.put(None)

    def _embed(self, tokens: list[int]):
        from ..models.llama import forward_embed

        model = self.engine.model
        vocab = model.cfg.vocab_size
        if not tokens or not all(0 <= t < vocab for t in tokens):
            raise ValueError(f"token ids must lie in [0, {vocab})")
        ids = torch.tensor([tokens], dtype=torch.long, device=self.engine.device)
        with torch.inference_mode():
            return forward_embed(model.params, model.cfg, ids)[0].float().cpu().numpy()


class LockstepMedia:
    """An image chat bound for the lockstep world, on rank 0's handler side:
    a ``MediaBoundExecutor`` whose ``generate`` runs as a ``media`` op on
    every rank and yields rank 0's tokens."""

    def __init__(self, lockstep: LockstepEngine, bound):
        self.lockstep = lockstep
        self.bound = bound
        try:            # bound on the server's loop, which runs the engine
            self._loop: Optional[asyncio.AbstractEventLoop] = asyncio.get_running_loop()
        except RuntimeError:
            self._loop = None

    def __getattr__(self, name):
        return getattr(self.bound, name)

    @property
    def rows(self) -> int:
        return self.bound.rows

    def generate(self, prompt_ids: list[int],
                 gen_cfg: Optional[GenerationConfig] = None) -> Iterator:
        sink: queue.Queue = queue.Queue()
        self.lockstep.submit_media(prompt_ids, self.bound.images,
                                   gen_cfg or self.bound.executor.app_cfg.generation, sink,
                                   self._loop)
        while True:
            item = sink.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
