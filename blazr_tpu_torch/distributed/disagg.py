"""Disaggregated prefill/decode serving.

Counterpart of ``blazr_tpu/distributed/disagg.py``: a router splits work
between prefill workers (they run the prompt and ship the contiguous KV
cache, ``kv_serialize.py``) and decode workers (they take the KV and run the
token loop). The KV crosses the wire once a request, capped at 2 GiB. Both
workers run the port's Executor-side forward (``Model.forward``), so every
quantized projection is kernel B1 on the card.

``make_router_app`` serves ``/health`` and ``/v1/completions`` on the
router through the port's own standard-library HTTP server
(``server/app.py``), with the model's tokenizer; the JAX router's app is
aiohttp, which the port does not use.
"""

from __future__ import annotations

import logging
import struct
import time
import types
from dataclasses import dataclass, field
from typing import Optional

import torch

from .kv_serialize import MAX_KV_TRANSFER_BYTES, deserialize_kv_cache, serialize_kv_cache
from .transport import TcpMesh, tags

logger = logging.getLogger(__name__)

EOS_SENTINEL = -(2 ** 62)   # reference uses i64::MIN (disaggregated_forward.rs:187)


@dataclass
class DisaggConfig:
    prefill_workers: list[int] = field(default_factory=lambda: [1])
    decode_workers: list[int] = field(default_factory=lambda: [2])
    router_rank: int = 0
    max_kv_transfer_bytes: int = MAX_KV_TRANSFER_BYTES


class DisaggRouter:
    """Round-robin request routing across the prefill and decode pools
    (reference DisaggRouter::route_request)."""

    def __init__(self, mesh: TcpMesh, cfg: DisaggConfig):
        self.mesh = mesh
        self.cfg = cfg
        self._rr_p = 0
        self._rr_d = 0

    def wait_workers(self, timeout: float = 600.0) -> None:
        """Build the pools from the workers' announced roles (ranks come in
        connection order)."""
        prefill, decode = [], []
        for r in range(1, self.mesh.world_size):
            role = self.mesh.recv(r, tags.WORKER_READY, timeout=timeout)
            (prefill if role == b"prefill" else decode).append(r)
        if prefill:
            self.cfg.prefill_workers = prefill
        if decode:
            self.cfg.decode_workers = decode

    def route_request(self, prompt_ids: list[int], max_tokens: int) -> list[int]:
        p_rank = self.cfg.prefill_workers[self._rr_p % len(self.cfg.prefill_workers)]
        d_rank = self.cfg.decode_workers[self._rr_d % len(self.cfg.decode_workers)]
        self._rr_p += 1
        self._rr_d += 1
        # 1. The prefill worker runs the prompt and ships the KV to d_rank.
        req = struct.pack("<II", len(prompt_ids), d_rank) + torch.tensor(
            prompt_ids, dtype=torch.int32).numpy().tobytes()
        self.mesh.send(p_rank, tags.REQUEST, req)
        # 2. Its answer: the first token.
        (first_tok,) = struct.unpack("<q", self.mesh.recv(p_rank, tags.RESPONSE, timeout=600))
        if first_tok == EOS_SENTINEL:
            return []
        # 3. The decode worker streams the rest; the KV's source rank rides
        #    in the request.
        self.mesh.send(d_rank, tags.REQUEST, struct.pack("<qII", first_tok, max_tokens, p_rank))
        out = [int(first_tok)]
        while True:
            # Always drain to the sentinel: one left queued would poison the
            # worker's next request.
            (tok,) = struct.unpack("<q", self.mesh.recv(d_rank, tags.RESPONSE, timeout=600))
            if tok == EOS_SENTINEL:
                break
            if len(out) < max_tokens:
                out.append(int(tok))
        return out

    def shutdown(self) -> None:
        for r in set(self.cfg.prefill_workers + self.cfg.decode_workers):
            self.mesh.send(r, tags.REQUEST, b"__shutdown__")


class PrefillWorker:
    """Prefill pool worker (reference PrefillWorker.run_loop)."""

    def __init__(self, mesh: TcpMesh, model_path: str, capacity: int = 256,
                 dtype: str = "f32", device: str = "cuda"):
        self.mesh = mesh
        self.model_path = model_path
        self.capacity = capacity
        self.dtype = dtype
        self.device = device
        self.kv_bytes = 0             # the last request's shipped KV
        self.ship_ms = 0.0            # its serialize and send

    @torch.no_grad()
    def run_loop(self, router_rank: int = 0) -> None:
        from ..loader import load_model

        model, _ = load_model(self.model_path, dtype=self.dtype, device=self.device)
        self.mesh.send(router_rank, tags.WORKER_READY, b"prefill")
        while True:
            req = self.mesh.recv(router_rank, tags.REQUEST, timeout=None)
            if req == b"__shutdown__":
                return
            n, d_rank = struct.unpack_from("<II", req)
            prompt = torch.frombuffer(bytearray(req[8:8 + 4 * n]), dtype=torch.int32)
            try:
                cache = model.init_cache(1, self.capacity)
                dev = model.device
                logits, cache = model.forward(prompt[None].to(torch.long).to(dev), cache,
                                              torch.arange(n, device=dev)[None])
                first_tok = int(logits[0, -1].argmax())
                t0 = time.perf_counter()
                kv = serialize_kv_cache(cache)
                self.mesh.send(d_rank, tags.KV_CACHE, struct.pack("<I", n) + kv)
                self.ship_ms = (time.perf_counter() - t0) * 1e3
                self.kv_bytes = len(kv)
                self.mesh.send(router_rank, tags.RESPONSE, struct.pack("<q", first_tok))
            except Exception:
                logger.exception("prefill failed")
                # The sentinel, so the router does not wait forever.
                self.mesh.send(router_rank, tags.RESPONSE, struct.pack("<q", EOS_SENTINEL))


class DecodeWorker:
    """Decode pool worker (reference DecodeWorker.run_loop)."""

    def __init__(self, mesh: TcpMesh, model_path: str, capacity: int = 256,
                 dtype: str = "f32", device: str = "cuda"):
        self.mesh = mesh
        self.model_path = model_path
        self.capacity = capacity
        self.dtype = dtype
        self.device = device

    @torch.no_grad()
    def run_loop(self, router_rank: int = 0) -> None:
        from ..loader import load_model

        model, _ = load_model(self.model_path, dtype=self.dtype, device=self.device)
        dev = model.device
        self.mesh.send(router_rank, tags.WORKER_READY, b"decode")
        while True:
            req = self.mesh.recv(router_rank, tags.REQUEST, timeout=None)
            if req == b"__shutdown__":
                return
            cur, max_tokens, p_rank = struct.unpack("<qII", req)
            try:
                # The router names the prefill rank that shipped this KV.
                kv_payload = self.mesh.recv(p_rank, tags.KV_CACHE, timeout=600)
                (n,) = struct.unpack_from("<I", kv_payload)
                cache = deserialize_kv_cache(kv_payload[4:], device=dev)
                # The shipped cache's capacity bounds the loop (the prefill
                # pool may hold less than this worker).
                capacity = int(cache.k.shape[2])
                pos = n
                for _ in range(max_tokens - 1):
                    logits, cache = model.forward(
                        torch.tensor([[cur]], dtype=torch.long, device=dev), cache,
                        torch.tensor([[pos]], dtype=torch.long, device=dev))
                    cur = int(logits[0, -1].argmax())
                    pos += 1
                    self.mesh.send(router_rank, tags.RESPONSE, struct.pack("<q", cur))
                    if pos >= capacity - 1:
                        break
                self.mesh.send(router_rank, tags.RESPONSE, struct.pack("<q", EOS_SENTINEL))
            except Exception:
                logger.exception("decode failed")
                self.mesh.send(router_rank, tags.RESPONSE, struct.pack("<q", EOS_SENTINEL))


def make_router_app(router: DisaggRouter, tokenizer, server_cfg=None):
    """HTTP serving on the disagg router: ``/health`` and OpenAI-shaped
    ``/v1/completions`` whose generation crosses the TCP mesh to the pools,
    through the port's server (its request-id and error middleware)."""
    import asyncio

    from ..config.server import ServerConfig
    from ..server.api_types import (ApiError, completion_response, usage_dict,
                                    validate_generation_params)
    from ..server.app import App, Response

    lock = asyncio.Lock()      # route_request is stateful (round-robin counters)

    async def health(request):
        return Response.json({"status": "ok",
                              "prefill_workers": len(router.cfg.prefill_workers),
                              "decode_workers": len(router.cfg.decode_workers)})

    async def completions(request):
        body = request.json()
        validate_generation_params(body)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            ids = [int(t) for t in prompt]
        elif isinstance(prompt, str):
            ids = tokenizer.encode(prompt)
        else:
            raise ApiError(400, "prompt must be a string or token array")
        if not ids:
            raise ApiError(400, "prompt must not be empty")
        max_tokens = int(body.get("max_tokens", 32))
        async with lock:
            toks = await asyncio.to_thread(router.route_request, ids, max_tokens)
        eos = getattr(tokenizer, "eos_token_id", None)
        finish = "stop" if (toks and eos is not None and toks[-1] == eos) else "length"
        text = tokenizer.decode([t for t in toks if t != eos])
        return Response.json(completion_response(
            body.get("model", "disagg"),
            [{"index": 0, "text": text, "finish_reason": finish,
              "logprobs": None, "tokens": toks}],
            usage_dict(len(ids), len(toks))))

    app = App(types.SimpleNamespace(server_cfg=server_cfg or ServerConfig()))
    app.add("GET", "/health", health)
    app.add("POST", "/v1/completions", completions)
    return app
