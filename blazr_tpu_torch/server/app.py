"""OpenAI-compatible HTTP server on the standard library.

Counterpart of ``blazr_tpu/server/app.py``. The JAX package serves with
aiohttp; this one builds on ``asyncio.start_server`` with a small HTTP/1.1
reader (request line, headers, a ``Content-Length`` body) and closes the
connection after each response, so a streamed (SSE, ``text/event-stream``)
body simply ends when the connection does. The continuous-batching engine's
``run()`` is a task on the same event loop.

Ported routes: ``/health``, ``/metrics`` (the Prometheus text format,
unauthenticated like ``/health``), ``/v1/models``, ``/v1/models/{id}``,
``/v1/completions`` and ``/v1/chat/completions`` (streaming and not),
``/tokenize``, ``/detokenize`` and ``/apply-template``, with bearer/x-api-key
auth and the ``max_inflight_tokens`` admission of the JAX server (503 +
Retry-After), CORS, the per-request timeout (408) and the concurrency cap.
Every other route of the JAX ``create_app`` answers 501 (ROADMAP queue A
item 9). TLS raises at startup.

The request metrics and SLO records follow the JAX handlers, except that a
streamed request also counts its prompt and generated tokens and its e2e
latency, and a streamed completion observes TTFT and ITL as a streamed
chat does (the JAX server records none of these; ROADMAP §C).
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional
from urllib.parse import urlsplit

from ..config.generation import GenerationConfig
from ..config.server import ServerConfig
from ..engine.batch_engine import check_request
from ..engine.generate_text import StopScanner, collect_generation, stream_generation
from ..engine.model_scheduler import ModelScheduler
from ..engine.types import FinishReason, GenerationResult
from ..model_meta.chat_template import ChatMessage, ChatTemplate, TemplateFormat
from ..model_meta.think import extract_thinking
from .api_types import (ApiError, chat_response, completion_logprobs_block,
                        completion_response, gen_config_from_body, logprobs_block,
                        usage_dict, validate_generation_params)
from .metrics import CONTENT_TYPE, Metrics, refresh
from .slo import SloTracker
from .streaming import SSE_DONE, SSE_HEADERS, ChatStream, CompletionStream, sse_event

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
            401: "Unauthorized", 404: "Not Found", 405: "Method Not Allowed",
            408: "Request Timeout", 413: "Payload Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable"}
_MAX_HEADER_BYTES = 64 * 1024

# Routes of the JAX create_app (app.py:1020-1060) this server does not serve.
UNPORTED_ROUTES = [
    ("GET", "/api/tags"), ("GET", "/api/ps"),
    ("POST", "/api/show"), ("DELETE", "/api/delete"), ("POST", "/api/copy"),
    ("POST", "/api/pull"), ("GET", "/api/slots"), ("POST", "/api/slots"),
    ("DELETE", "/api/slots/{slot_id}"), ("POST", "/v1/embeddings"),
    ("POST", "/v1/messages"), ("POST", "/v1/messages/count_tokens"),
    ("POST", "/v1/responses"), ("POST", "/rerank"), ("POST", "/v1/rerank"),
    ("POST", "/v1/infill"), ("POST", "/v1/audio/speech"),
    ("POST", "/v1/audio/transcriptions"), ("POST", "/v1/lora"), ("GET", "/v1/lora"),
    ("DELETE", "/v1/lora/{name}"),
]


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

class Request:
    """One parsed HTTP request."""

    def __init__(self, method: str, target: str, headers: dict[str, str],
                 body: bytes, writer: asyncio.StreamWriter, app: "App"):
        self.method = method
        self.path = urlsplit(target).path
        self.headers = headers                   # lower-case names
        self.body = body
        self.writer = writer
        self.app = app
        self.match_info: dict[str, str] = {}
        self.request_id = headers.get("x-request-id", uuid.uuid4().hex[:16])
        self.streaming = False

    def json(self) -> Any:
        try:
            return json.loads(self.body or b"{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise ApiError(400, "invalid JSON body")


def _head(status: int, headers: dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A complete response: status, headers and body."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[dict[str, str]] = None,
                 content_type: str = "application/json"):
        self.body = body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(json.dumps(obj).encode(), status)

    async def send(self, writer: asyncio.StreamWriter, extra: dict[str, str]) -> None:
        headers = {**self.headers, **extra, "Content-Length": str(len(self.body)),
                   "Connection": "close"}
        writer.write(_head(self.status, headers) + self.body)
        await writer.drain()


class StreamResponse:
    """A streamed response: the head goes out at ``prepare``, then each
    ``write`` is sent as it comes; the body ends when the connection closes."""

    def __init__(self, request: Request, headers: dict[str, str], status: int = 200):
        self.request = request
        self.status = status
        self.headers = headers

    async def prepare(self) -> None:
        self.request.streaming = True           # exempt from the request timeout
        headers = {**self.headers, **self.request.app.common_headers(self.request),
                   "Connection": "close"}
        self.request.writer.write(_head(self.status, headers))
        await self.request.writer.drain()

    async def write(self, data: bytes) -> None:
        self.request.writer.write(data)
        await self.request.writer.drain()


def error_response(status: int, message: str, err_type: str) -> Response:
    return Response.json({"error": {"message": message, "type": err_type}}, status)


def _overloaded() -> Response:
    resp = error_response(503, "server overloaded, retry later", "overloaded_error")
    resp.headers["Retry-After"] = "1"
    return resp


Handler = Callable[[Request], Awaitable[Any]]


class App:
    """Routes, the middleware stack of the JAX server, and the connection
    loop."""

    def __init__(self, state: "AppState"):
        self.state = state
        self.cfg = state.server_cfg
        self._routes: list[tuple[str, re.Pattern, Handler]] = []
        self._sem = (asyncio.Semaphore(self.cfg.max_concurrent_requests)
                     if self.cfg.max_concurrent_requests else None)
        self.on_startup: list[Callable[[], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[[], Awaitable[None]]] = []

    def add(self, method: str, path: str, handler: Handler) -> None:
        pattern = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path) + "$")
        self._routes.append((method, pattern, handler))

    def common_headers(self, request: Request) -> dict[str, str]:
        out = {"x-request-id": request.request_id}
        if self.cfg.enable_cors:
            out.update({
                "Access-Control-Allow-Origin": "*",
                "Access-Control-Allow-Methods": "GET, POST, DELETE, OPTIONS",
                "Access-Control-Allow-Headers": "Content-Type, Authorization, x-api-key",
            })
        return out

    # -- connection ----------------------------------------------------------
    async def handle_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            request = await self._read_request(reader, writer)
            if isinstance(request, Response):
                await request.send(writer, {})
                return
            if request is None:
                return
            resp = await self._dispatch(request)
            # A streamed response has sent its head already.
            if isinstance(resp, Response) and not request.streaming:
                await resp.send(writer, self.common_headers(request))
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("connection failed")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader, writer):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            return error_response(400, "request head too large", "invalid_request_error")
        except asyncio.IncompleteReadError:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return error_response(400, "malformed request line", "invalid_request_error")
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        if headers.get("transfer-encoding", "").lower() == "chunked":
            return error_response(400, "chunked request bodies are not supported; "
                                  "send Content-Length", "invalid_request_error")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            return error_response(400, "bad Content-Length", "invalid_request_error")
        if length > self.cfg.max_body_bytes:
            return error_response(413, "request body too large", "invalid_request_error")
        body = await reader.readexactly(length) if length else b""
        return Request(method.upper(), target, headers, body, writer, self)

    # -- middleware stack ------------------------------------------------------
    async def _dispatch(self, request: Request):
        t0 = time.time()
        try:
            resp = await self._guarded(request)
        except ApiError as e:
            resp = Response.json(e.body(), e.status)
        except NotImplementedError as e:        # what the port does not serve yet
            resp = error_response(501, str(e), "not_implemented_error")
        except Exception:
            logger.exception("unhandled error [%s] %s", request.request_id, request.path)
            resp = error_response(500, "internal server error", "server_error")
        status = resp.status if resp is not None else 0
        logger.info("%s %s -> %d (%.1f ms) [%s]", request.method, request.path,
                    status, (time.time() - t0) * 1e3, request.request_id)
        return resp

    async def _guarded(self, request: Request):
        if request.method == "OPTIONS" and self.cfg.enable_cors:
            return Response(status=204, content_type="text/plain")
        handler = self._route(request)
        keys = self.cfg.api_keys
        if keys and request.path not in ("/health", "/metrics"):
            auth = request.headers.get("authorization", "")
            key = auth[7:] if auth.startswith("Bearer ") else request.headers.get(
                "x-api-key", "")
            if key not in keys:
                return error_response(401, "invalid API key", "authentication_error")
        if self._sem is None:
            return await self._timed(handler, request)
        async with self._sem:
            return await self._timed(handler, request)

    async def _timed(self, handler: Handler, request: Request):
        seconds = self.cfg.request_timeout_secs
        if not seconds:
            return await handler(request)
        task = asyncio.ensure_future(handler(request))
        try:
            return await asyncio.wait_for(asyncio.shield(task), seconds)
        except asyncio.TimeoutError:
            if request.streaming:
                return await task
            task.cancel()
            return error_response(408, "request timeout", "timeout_error")

    def _route(self, request: Request) -> Handler:
        allowed = False
        for method, pattern, handler in self._routes:
            m = pattern.match(request.path)
            if m is None:
                continue
            if method != request.method:
                allowed = True
                continue
            request.match_info = m.groupdict()
            return handler
        if allowed:
            raise ApiError(405, f"method {request.method} not allowed on {request.path}")
        raise ApiError(404, f"no route {request.path}", "not_found_error")


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

@dataclass
class AppState:
    """Shared server state (the JAX AppState without slots)."""

    scheduler: ModelScheduler
    server_cfg: ServerConfig
    batch_engine: Any = None          # optional continuous-batching engine
    start_time: float = field(default_factory=time.time)
    inflight_tokens: int = 0
    metrics: Metrics = field(default_factory=Metrics)
    slo: SloTracker = None            # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.slo is None:
            self.slo = SloTracker(self.server_cfg.slo, self.metrics)

    # -- admission control (the JAX server's, app.py:75-93) ------------------
    def try_admit(self, tokens: int) -> bool:
        limit = self.server_cfg.max_inflight_tokens
        if limit is None:
            return True
        if self.inflight_tokens + tokens > limit:
            return False
        self.inflight_tokens += tokens
        self._update_budget_gauge()
        return True

    def release(self, tokens: int) -> None:
        self.inflight_tokens = max(0, self.inflight_tokens - tokens)
        self._update_budget_gauge()

    def _update_budget_gauge(self) -> None:
        limit = self.server_cfg.max_inflight_tokens
        if limit:
            self.metrics.token_budget_utilization.set(self.inflight_tokens / limit)

    # -- request metrics (the JAX handlers', app.py:411-460, 501-553) --------
    def request_done(self, endpoint: str, t0: float) -> None:
        self.metrics.requests_active.dec()
        self.metrics.requests_total.labels(endpoint=endpoint, status="200").inc()
        self.metrics.request_duration.observe(time.time() - t0)

    def tokens_done(self, prompted: int, generated: int, t0: float) -> None:
        self.metrics.tokens_prompted.inc(prompted)
        self.metrics.tokens_generated.inc(generated)
        self.slo.record_e2e(time.time() - t0)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _content_text(content) -> str:
    """Flatten string-or-parts message content; media parts raise."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        if any(isinstance(p, dict) and p.get("type") != "text" for p in content):
            raise ApiError(400, "model does not support image/audio input")
        return "\n".join(p.get("text", "") for p in content if isinstance(p, dict))
    return str(content)


def _build_prompt(body: dict, model_cfg) -> str:
    """Apply the chat template."""
    if body.get("tools"):
        raise ApiError(501, "tool calling is not served by blazr_tpu_torch yet "
                       "(ROADMAP queue A item 9)", "not_implemented_error")
    messages = [ChatMessage(m.get("role", "user"), _content_text(m.get("content")))
                for m in body.get("messages", [])]
    if not messages:
        raise ApiError(400, "messages must not be empty")
    override = body.get("template")
    if override:
        template = ChatTemplate(TemplateFormat.from_name(override))
    else:
        template = ChatTemplate.detect(model_type=model_cfg.model_type)
    if body.get("raw"):
        return "\n".join(m.content for m in messages)
    return template.apply(messages)


def _get_executor(state: AppState, body: dict):
    name = body.get("model") or "default"
    try:
        return state.scheduler.get_executor(name, body.get("keep_alive"))
    except FileNotFoundError as e:
        raise ApiError(404, str(e), "not_found_error")


def _context_prefix(executor, body: dict) -> str:
    """Ollama-style ``context`` continuation: token ids of a previous turn,
    decoded to a prefix of the prompt."""
    ctx = body.get("context")
    if not ctx:
        return ""
    if not isinstance(ctx, list) or not all(
            isinstance(t, int) and not isinstance(t, bool) for t in ctx):
        raise ApiError(400, "context must be an array of token ids")
    try:
        return executor.tokenizer.decode([int(t) for t in ctx])
    except Exception as e:
        raise ApiError(400, f"Failed to decode context tokens: {e}")


async def _engine_tokens(state: AppState, prompt_ids: list[int], cfg: GenerationConfig,
                         seq_ref: dict):
    """(text delta, finish reason or None, generated tokens) from the batch
    engine, through the stop-sequence scanner; the engine sequence is
    cancelled once a stop sequence matches."""
    eng = state.batch_engine
    handle = eng.submit(prompt_ids, cfg)
    seq_ref["id"] = handle.seq_id
    scanner = StopScanner(cfg.stop_sequences)
    while True:
        tok, fin = await handle.queue.get()
        gts = [tok] if tok is not None else []
        if tok is not None:
            emit, stopped = scanner.push(tok.text)
            if stopped:
                eng.cancel(handle.seq_id)
                yield emit, FinishReason.STOP, gts
                return
            if emit or gts:
                yield emit, None, gts
                gts = []
        if fin is not None:
            yield scanner.flush(), fin, gts
            return


async def _collect_via_engine(state: AppState, prompt_ids, cfg) -> GenerationResult:
    """Continuous-batching path: submit to the BatchEngine and assemble the
    result."""
    pieces, tokens = [], []
    gen_tokens = [] if cfg.logprobs else None
    finish = FinishReason.LENGTH
    async for delta, fin, gts in _engine_tokens(state, prompt_ids, cfg, {}):
        pieces.append(delta)
        tokens += [t.token_id for t in gts]
        if gen_tokens is not None:
            gen_tokens += gts
        if fin is not None:
            finish = fin
    return GenerationResult(text="".join(pieces), tokens=tokens, finish_reason=finish,
                            prompt_tokens=len(prompt_ids), completion_tokens=len(tokens),
                            gen_tokens=gen_tokens)


async def _thread_tokens(executor, prompt_ids, cfg):
    """(delta, finish reason or None, generated tokens) from the Executor's
    stream, run on a worker thread."""
    loop = asyncio.get_running_loop()
    queue: asyncio.Queue = asyncio.Queue()

    def produce():
        try:
            for delta, fin, gt in stream_generation(executor, prompt_ids, cfg,
                                                    with_tokens=True):
                loop.call_soon_threadsafe(
                    queue.put_nowait, (delta, fin, [gt] if gt is not None else []))
        except Exception as e:          # surfaced to the consumer
            loop.call_soon_threadsafe(queue.put_nowait, e)
        loop.call_soon_threadsafe(queue.put_nowait, None)

    task = loop.run_in_executor(None, produce)
    try:
        while True:
            item = await queue.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        await task


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------

async def health(request: Request) -> Response:
    state = request.app.state
    body = {"status": "ok", "uptime_seconds": round(time.time() - state.start_time, 1),
            "models_loaded": state.scheduler.num_loaded}
    dev = state.scheduler.device
    body["device"] = str(dev)
    if dev.type == "cuda":
        import torch

        body["device_memory"] = {"bytes_in_use": torch.cuda.memory_allocated(dev),
                                 "bytes_limit": torch.cuda.get_device_properties(dev)
                                 .total_memory}
    return Response.json(body)


async def metrics_handler(request: Request) -> Response:
    state = request.app.state
    refresh(state.metrics, state.scheduler, state.batch_engine)
    return Response(state.metrics.render(), content_type=CONTENT_TYPE)


async def list_models(request: Request) -> Response:
    names = request.app.state.scheduler.discover_models() or ["default"]
    return Response.json({"object": "list", "data": [
        {"id": n, "object": "model", "created": 0, "owned_by": "blazr_tpu"}
        for n in names]})


async def get_model(request: Request) -> Response:
    mid = request.match_info["model_id"]
    names = request.app.state.scheduler.discover_models() or ["default"]
    if mid not in names:
        raise ApiError(404, f"model {mid!r} not found", "not_found_error")
    return Response.json({"id": mid, "object": "model", "created": 0,
                          "owned_by": "blazr_tpu"})


async def completions(request: Request):
    state = request.app.state
    body = request.json()
    validate_generation_params(body)
    executor = await asyncio.to_thread(_get_executor, state, body)
    cfg = gen_config_from_body(body, executor.app_cfg.generation)
    check_request(cfg)
    ctx_prefix = _context_prefix(executor, body)
    prompt = body.get("prompt", "")
    prompts = prompt if isinstance(prompt, list) else [prompt]
    if prompts and all(isinstance(p, int) for p in prompts):
        prompt_ids_list = [list(map(int, prompts))]
    elif prompts and all(isinstance(p, str) for p in prompts):
        prompt_ids_list = [executor.tokenizer.encode(ctx_prefix + p) for p in prompts]
        ctx_prefix = ""
    elif prompts and all(isinstance(p, list) for p in prompts):
        prompt_ids_list = [list(map(int, p)) for p in prompts]
    else:
        raise ApiError(400, "prompt must be a string or array")
    if ctx_prefix:
        ctx_ids = [int(t) for t in body["context"]]
        prompt_ids_list = [ctx_ids + p for p in prompt_ids_list]
    if any(not p for p in prompt_ids_list):
        raise ApiError(400, "prompt must not be empty")
    n = max(1, int(body.get("n", 1)))
    if body.get("stream") and (len(prompt_ids_list) != 1 or n != 1):
        raise ApiError(400, "streaming supports a single prompt with n=1")
    total_prompt = sum(len(p) for p in prompt_ids_list)
    budget = total_prompt + cfg.max_tokens * len(prompt_ids_list) * n
    if not state.try_admit(budget):
        return _overloaded()
    state.metrics.requests_active.inc()
    t0 = time.time()
    try:
        if body.get("stream"):
            return await _stream_completion(request, state, executor,
                                            prompt_ids_list[0], cfg, body)
        echo = bool(body.get("echo", False))
        choices = []
        usage_p = usage_c = 0
        for ids in prompt_ids_list:
            for i in range(n):
                c = GenerationConfig.from_dict(cfg.to_dict())
                if c.seed is not None:
                    c.seed += i
                if state.batch_engine is not None:
                    res = await _collect_via_engine(state, ids, c)
                else:
                    res = await asyncio.to_thread(collect_generation, executor, ids, c)
                text = res.text
                if echo:
                    text = executor.tokenizer.decode(ids) + text
                lp_block = None
                if cfg.logprobs and res.gen_tokens:
                    lp_block = completion_logprobs_block(
                        res.gen_tokens, min(cfg.top_logprobs, 20),
                        text_offset_base=len(executor.tokenizer.decode(ids))
                        if echo else 0)
                choices.append({"index": len(choices), "text": text,
                                "finish_reason": res.finish_reason.to_openai(),
                                "logprobs": lp_block})
                usage_p += res.prompt_tokens
                usage_c += res.completion_tokens
        state.tokens_done(usage_p, usage_c, t0)
        return Response.json(completion_response(body.get("model", "default"), choices,
                                                 usage_dict(usage_p, usage_c)))
    finally:
        state.release(budget)
        state.request_done("completions", t0)


async def chat_completions(request: Request):
    state = request.app.state
    body = request.json()
    validate_generation_params(body)
    executor = await asyncio.to_thread(_get_executor, state, body)
    cfg = gen_config_from_body(body, executor.app_cfg.generation)
    check_request(cfg)
    prompt = _context_prefix(executor, body) + _build_prompt(body, executor.model.cfg)
    prompt_ids = executor.tokenizer.encode(prompt)
    n = max(1, int(body.get("n", 1)))
    budget = len(prompt_ids) + cfg.max_tokens * n
    if not state.try_admit(budget):
        return _overloaded()
    state.metrics.requests_active.inc()
    t0 = time.time()
    try:
        if body.get("stream"):
            return await _stream_chat(request, state, executor, prompt_ids, cfg, body)
        choices = []
        usage_p = usage_c = 0
        want_think = bool(body.get("think", True))
        for i in range(n):
            c = GenerationConfig.from_dict(cfg.to_dict())
            if c.seed is not None and i:
                c.seed += i
            if state.batch_engine is not None:
                res = await _collect_via_engine(state, prompt_ids, c)
                if want_think:
                    res.thinking, res.text = extract_thinking(res.text)
            else:
                res = await asyncio.to_thread(collect_generation, executor, prompt_ids,
                                              c, want_think)
            msg: dict[str, Any] = {"role": "assistant", "content": res.text}
            if res.thinking and want_think:
                msg["reasoning_content"] = res.thinking
            choices.append({"index": i, "message": msg,
                            "finish_reason": res.finish_reason.to_openai(),
                            "logprobs": (logprobs_block(res.gen_tokens)
                                         if cfg.logprobs and res.gen_tokens else None)})
            usage_p += res.prompt_tokens
            usage_c += res.completion_tokens
        state.tokens_done(usage_p, usage_c, t0)
        return Response.json(chat_response(
            body.get("model", "default"), choices,
            usage_dict(usage_p, usage_c, eval_duration=time.time() - t0)))
    finally:
        state.release(budget)
        state.request_done("chat", t0)


async def _stream(request: Request, state: AppState, executor, prompt_ids, cfg,
                  on_item: Callable, head: Optional[bytes]) -> StreamResponse:
    """Shared SSE loop: the head chunk, one event per delta (``on_item``),
    ``[DONE]``; a client gone mid-stream cancels the engine sequence. The
    first content delta's time goes to the TTFT histogram and SLO window,
    each later one's gap to ITL (the JAX ``_stream_chat``, app.py:664-677);
    a stream that ends counts its tokens and e2e latency."""
    resp = StreamResponse(request, dict(SSE_HEADERS))
    await resp.prepare()
    seq_ref: dict = {}
    if state.batch_engine is not None:
        source = _engine_tokens(state, prompt_ids, cfg, seq_ref)
    else:
        source = _thread_tokens(executor, prompt_ids, cfg)
    t0 = last_t = time.time()
    first = True
    generated = 0
    try:
        if head is not None:
            await resp.write(head)
        async for delta, fin, gts in source:
            now = time.time()
            if first and delta:
                state.slo.record_ttft(now - t0)
                state.metrics.ttft.observe(now - t0)
                first = False
            elif delta:
                state.slo.record_itl(now - last_t)
                state.metrics.itl.observe(now - last_t)
            last_t = now
            generated += len(gts)
            for chunk in on_item(delta, fin, gts):
                await resp.write(chunk)
            if fin is not None:
                state.tokens_done(len(prompt_ids), generated, t0)
                break
        await resp.write(SSE_DONE)
    except (ConnectionError, asyncio.CancelledError):
        logger.info("client disconnected mid-stream")
        if seq_ref.get("id") is not None:
            state.batch_engine.cancel(seq_ref["id"])
    except Exception as e:                      # after the head: an SSE error event
        logger.exception("stream failed")
        await resp.write(sse_event({"error": {"message": str(e), "type": "server_error"}}))
    finally:
        await source.aclose()
    return resp


async def _stream_chat(request, state, executor, prompt_ids, cfg, body):
    stream = ChatStream(body.get("model", "default"))
    count = 0

    def on_item(delta, fin, gts):
        nonlocal count
        lpb = logprobs_block(gts) if cfg.logprobs and gts else None
        if delta or lpb:
            count += 1 if delta else 0
            yield stream.delta(delta, logprobs=lpb)
        if fin is not None:
            yield stream.finish(fin.to_openai(), usage_dict(len(prompt_ids), count))

    return await _stream(request, state, executor, prompt_ids, cfg, on_item,
                         stream.role_chunk())


async def _stream_completion(request, state, executor, prompt_ids, cfg, body):
    stream = CompletionStream(body.get("model", "default"))

    def on_item(delta, fin, gts):
        lpb = (completion_logprobs_block(gts, min(cfg.top_logprobs, 20))
               if cfg.logprobs and gts else None)
        if delta or lpb:
            yield stream.delta(delta, logprobs=lpb)
        if fin is not None:
            yield stream.delta("", finish_reason=fin.to_openai())

    return await _stream(request, state, executor, prompt_ids, cfg, on_item, None)


async def tokenize(request: Request) -> Response:
    body = request.json()
    executor = await asyncio.to_thread(_get_executor, request.app.state, body)
    ids = executor.tokenizer.encode(body.get("content", body.get("text", "")))
    return Response.json({"tokens": ids, "count": len(ids)})


async def detokenize(request: Request) -> Response:
    body = request.json()
    executor = await asyncio.to_thread(_get_executor, request.app.state, body)
    return Response.json({"content": executor.tokenizer.decode(body.get("tokens", []))})


async def apply_template(request: Request) -> Response:
    body = request.json()
    executor = await asyncio.to_thread(_get_executor, request.app.state, body)
    return Response.json({"prompt": _build_prompt(body, executor.model.cfg)})


async def not_ported(request: Request):
    raise ApiError(501, f"{request.method} {request.path} is not served by "
                   "blazr_tpu_torch yet (ROADMAP queue A item 9)", "not_implemented_error")


# ---------------------------------------------------------------------------
# app factory
# ---------------------------------------------------------------------------

def create_app(scheduler: ModelScheduler, server_cfg: Optional[ServerConfig] = None,
               batch_engine=None) -> App:
    """The routes and state of the server; ``serve`` runs it."""
    server_cfg = server_cfg or ServerConfig()
    if server_cfg.tls_cert or server_cfg.tls_key:
        raise NotImplementedError("TLS is not served by blazr_tpu_torch yet "
                                  "(ROADMAP queue A item 9)")
    app = App(AppState(scheduler=scheduler, server_cfg=server_cfg,
                       batch_engine=batch_engine))
    app.add("GET", "/health", health)
    app.add("GET", "/metrics", metrics_handler)
    app.add("GET", "/v1/models", list_models)
    app.add("GET", "/v1/models/{model_id}", get_model)
    app.add("POST", "/v1/completions", completions)
    app.add("POST", "/v1/chat/completions", chat_completions)
    app.add("POST", "/tokenize", tokenize)
    app.add("POST", "/detokenize", detokenize)
    app.add("POST", "/apply-template", apply_template)
    for method, path in UNPORTED_ROUTES:
        app.add(method, path, not_ported)

    tasks: dict[str, asyncio.Task] = {}
    if batch_engine is not None:
        async def start_engine():
            tasks["engine"] = asyncio.create_task(batch_engine.run())

        async def stop_engine():
            batch_engine.stop()
            await tasks["engine"]

        app.on_startup.append(start_engine)
        app.on_cleanup.append(stop_engine)

    async def start_reaper():
        async def reaper():
            while True:
                await asyncio.sleep(30)
                n = await asyncio.to_thread(scheduler.evict_expired)
                if n:
                    logger.info("reaper unloaded %d model(s)", n)
        tasks["reaper"] = asyncio.create_task(reaper())

    async def stop_reaper():
        tasks["reaper"].cancel()

    app.on_startup.append(start_reaper)
    app.on_cleanup.append(stop_reaper)
    return app


async def serve(app: App, host: str, port: int,
                started: Optional[Callable[[int], None]] = None,
                stop: Optional[asyncio.Event] = None) -> None:
    """Run ``app`` on ``host:port`` until ``stop`` is set (forever without
    one); ``started(port)`` is called once the socket listens (port 0 picks
    a free port)."""
    for fn in app.on_startup:
        await fn()
    server = await asyncio.start_server(app.handle_connection, host, port,
                                        limit=_MAX_HEADER_BYTES)
    try:
        bound = server.sockets[0].getsockname()[1]
        logger.info("serving on %s:%d", host, bound)
        if started is not None:
            started(bound)
        if stop is None:
            await server.serve_forever()
        else:
            await stop.wait()
    finally:
        server.close()
        await server.wait_closed()
        for fn in app.on_cleanup:
            await fn()


def run_server(scheduler: ModelScheduler, server_cfg: Optional[ServerConfig] = None,
               batch_engine=None) -> None:
    server_cfg = server_cfg or ServerConfig()
    app = create_app(scheduler, server_cfg, batch_engine)
    try:
        asyncio.run(serve(app, server_cfg.host, server_cfg.port))
    except KeyboardInterrupt:
        pass
