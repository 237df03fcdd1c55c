"""OpenAI-compatible HTTP server on the standard library.

Counterpart of ``blazr_tpu/server/app.py``. The JAX package serves with
aiohttp; this one builds on ``asyncio.start_server`` with a small HTTP/1.1
reader (request line, headers, a ``Content-Length`` body) and closes the
connection after each response, so a streamed (SSE, ``text/event-stream``)
body simply ends when the connection does. The continuous-batching engine's
``run()`` is a task on the same event loop.

Routes: every one of the JAX ``create_app`` (app.py:1020-1060).
``/health``, ``/metrics`` (the Prometheus text format,
unauthenticated like ``/health``), ``/v1/models[/{id}]``,
``/v1/completions`` and ``/v1/chat/completions`` (streaming and not; a chat
with ``tools`` gets the tools system prompt and its reply's tool calls,
``server/tools.py``; a chat with ``image_url`` parts goes to the model's
vision tower through the multimodal Executor, ``server/multimodal.py``,
even when the batch engine serves the other requests, one image chat at a
time and its image rows counted in the token budget), ``/tokenize``, ``/detokenize``, ``/apply-template``,
``/v1/messages`` (the Anthropic API, ``server/anthropic.py``, with its
``event:`` stream) and ``/v1/messages/count_tokens``, ``/v1/responses``,
``/v1/infill``, ``/v1/embeddings``, ``/rerank`` and ``/v1/rerank``, the
audio stubs (the JAX 501 bodies), the Ollama-style management and slot
routes (``server/management.py``; ``/api/pull`` streams NDJSON lines), and
the ``/v1/lora`` routes (``server/lora_routes.py``; a generation request's
``lora_adapter`` switches the model's live adapter on every generation
route, where the JAX server switches on completions and chat only). Bearer/
x-api-key auth, the ``max_inflight_tokens`` admission of the JAX server
(503 + Retry-After), CORS, the per-request timeout (408) and the
concurrency cap. ``ServerConfig.tls_cert`` and ``tls_key`` serve HTTPS
(both or neither). The user config file is polled and reloaded as the JAX
server does (``server/config_watch.py``).

The request metrics and SLO records follow the JAX handlers, except that a
streamed request also counts its prompt and generated tokens and its e2e
latency, and streamed completions and Anthropic messages observe TTFT and
ITL as a streamed chat does (the JAX server records none of these; ROADMAP
§C).
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
from ..engine.generate_text import StopScanner, collect_generation, stream_generation
from ..engine.grammar_json import request_grammar_source
from ..engine.grammar_parser import GrammarParseError
from ..engine.lora import LoraAdapterRegistry, lora_state
from ..engine.model_scheduler import ModelScheduler
from ..engine.types import FinishReason, GenerationResult
from ..model_meta.chat_template import ChatMessage, ChatTemplate, TemplateFormat
from ..model_meta.think import extract_thinking
from .api_types import (ApiError, chat_response, completion_logprobs_block,
                        completion_response, gen_config_from_body, logprobs_block,
                        usage_dict, validate_generation_params)
from .metrics import CONTENT_TYPE, Metrics, refresh
from ..engine.executor_multimodal import MediaBoundExecutor, MultimodalExecutor
from ..utils.preprocess import check_image
from .multimodal import (MultimodalError, content_text, extract_media, has_audio,
                         has_images)
from .slo import SloTracker
from .slots import SlotManager
from .streaming import SSE_DONE, SSE_HEADERS, ChatStream, CompletionStream, sse_event
from .tools import extract_tool_calls, tools_system_prompt

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
            401: "Unauthorized", 404: "Not Found", 405: "Method Not Allowed",
            408: "Request Timeout", 409: "Conflict", 413: "Payload Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable"}
_MAX_HEADER_BYTES = 64 * 1024


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
        except GrammarParseError as e:          # a request's grammar (ROADMAP §C)
            resp = error_response(400, f"invalid grammar: {e}", "invalid_request_error")
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
    """Shared server state (the JAX AppState)."""

    scheduler: ModelScheduler
    server_cfg: ServerConfig
    batch_engine: Any = None          # optional continuous-batching engine
    start_time: float = field(default_factory=time.time)
    inflight_tokens: int = 0
    metrics: Metrics = field(default_factory=Metrics)
    slots: SlotManager = field(default_factory=SlotManager)
    slo: SloTracker = None            # type: ignore[assignment]
    user_config: Any = None           # the hot-reloaded UserConfig
    # Image chats run one at a time: each holds a whole-context Executor
    # cache outside the batch engine's pool (the JAX server neither gates
    # them nor counts their image rows in the token budget).
    media_gate: asyncio.Semaphore = field(default_factory=lambda: asyncio.Semaphore(1))
    # The loaded LoRA adapters (the /v1/lora routes).
    lora_registry: LoraAdapterRegistry = field(default_factory=LoraAdapterRegistry)

    def __post_init__(self) -> None:
        if self.slo is None:
            self.slo = SloTracker(self.server_cfg.slo, self.metrics)
        if self.user_config is None:
            from ..config.user import UserConfig

            self.user_config = UserConfig.load()

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

def _build_prompt(body: dict, model_cfg) -> str:
    """Apply the chat template over the messages' text parts, with the
    tools system prompt when the request has ``tools``."""
    messages = [ChatMessage(m.get("role", "user"), content_text(m.get("content")))
                for m in body.get("messages", [])]
    if not messages:
        raise ApiError(400, "messages must not be empty")
    tools = body.get("tools")
    if tools:
        sys_prompt = tools_system_prompt(tools)
        if messages[0].role == "system":
            messages[0].content += "\n\n" + sys_prompt
        else:
            messages.insert(0, ChatMessage("system", sys_prompt))
    override = body.get("template")
    if override:
        template = ChatTemplate(TemplateFormat.from_name(override))
    else:
        template = ChatTemplate.detect(model_type=model_cfg.model_type)
    if body.get("raw"):
        return "\n".join(m.content for m in messages)
    return template.apply(messages)


def generation_defaults(state: AppState, executor) -> GenerationConfig:
    """The model's generation defaults with the user config's temperature
    and max_tokens over them: a hot reload of the file moves the defaults
    of the next request (the JAX server reloads the file and applies
    nothing; ROADMAP §C)."""
    over = {k: getattr(state.user_config, k, None) for k in ("temperature", "max_tokens")}
    over = {k: v for k, v in over.items() if v is not None}
    if not over:
        return executor.app_cfg.generation
    return GenerationConfig.from_dict({**executor.app_cfg.generation.to_dict(), **over})


def _lockstep(state: AppState) -> bool:
    from ..distributed.lockstep import LockstepEngine

    return isinstance(state.batch_engine, LockstepEngine)


def _get_executor(state: AppState, body: dict):
    name = body.get("model") or "default"
    if _lockstep(state):
        # A lockstep world serves its one model on every rank: loading
        # another on rank 0 alone would build a mesh no follower joins.
        name = "default"
    try:
        ex = state.scheduler.get_executor(name, body.get("keep_alive"))
    except FileNotFoundError as e:
        raise ApiError(404, str(e), "not_found_error")
    ex.lora_registry = state.lora_registry
    return ex


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
    if asyncio.iscoroutine(handle):          # a LockstepEngine admits on every rank first
        handle = await handle
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


async def embed_ids(state: AppState, executor, ids: list[int]):
    """[T, H] f32 token embeddings of ``ids`` (``Executor.get_embeddings``).
    Where a lockstep engine serves, the lookup is one of its ops: a sharded
    embedding all-reduces over the mesh, so every rank must run it."""
    if not _lockstep(state):
        return await asyncio.to_thread(executor.get_embeddings, ids)
    try:
        return await state.batch_engine.get_embeddings(ids)
    except ValueError as e:
        raise ApiError(400, str(e))


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


async def set_live_lora(executor, adapter) -> None:
    """Make ``adapter`` (None: the base) the live adapter of ``executor``'s
    model, off the event loop (through the model's batch engine, at its
    next step boundary, when one serves it); an adapter the model cannot
    take answers 400."""
    if lora_state(executor.model).adapter is adapter:
        return
    try:
        await asyncio.to_thread(executor.set_lora, adapter)
    except ValueError as e:
        raise ApiError(400, str(e))


async def apply_request_lora(request: Request, executor, cfg: GenerationConfig) -> None:
    """A request's ``lora_adapter`` (JAX ``_apply_request_lora``,
    app.py:335-351): 404 when it is not loaded, else it becomes the live
    adapter before the request runs."""
    if not cfg.lora_adapter:
        return
    adapter = request.app.state.lora_registry.get(cfg.lora_adapter)
    if adapter is None:
        raise ApiError(404, f"LoRA adapter {cfg.lora_adapter!r} not loaded",
                       "not_found_error")
    await set_live_lora(executor, adapter)


async def compile_grammar(executor, cfg: GenerationConfig) -> None:
    """Compile a request's grammar off the event loop, before any reply
    byte: a grammar that does not parse answers 400, streamed or not, and
    the engine's own compile finds the automaton cached (JSON mode's DFA
    takes seconds of host time the first time)."""
    if request_grammar_source(cfg) is not None:
        await asyncio.to_thread(executor._grammar_for, cfg)


async def completions(request: Request):
    state = request.app.state
    body = request.json()
    validate_generation_params(body)
    executor = await asyncio.to_thread(_get_executor, state, body)
    cfg = gen_config_from_body(body, generation_defaults(state, executor))
    await apply_request_lora(request, executor, cfg)
    await compile_grammar(executor, cfg)
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
        if body.get("id_slot"):        # llama.cpp-style slot affinity
            state.slots.touch(str(body["id_slot"]), usage_p, usage_c)
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
    cfg = gen_config_from_body(body, generation_defaults(state, executor))
    await apply_request_lora(request, executor, cfg)
    await compile_grammar(executor, cfg)
    prompt = _context_prefix(executor, body) + _build_prompt(body, executor.model.cfg)
    prompt_ids = executor.tokenizer.encode(prompt)
    executor, image_rows = await _bind_media(state, executor, body.get("messages", []))
    media = image_rows > 0
    n = max(1, int(body.get("n", 1)))
    budget = len(prompt_ids) + image_rows + cfg.max_tokens * n
    if not state.try_admit(budget):
        return _overloaded()
    state.metrics.requests_active.inc()
    t0 = time.time()
    gated = False
    try:
        if media:        # one image chat at a time holds an Executor cache
            await state.media_gate.acquire()
            gated = True
        if body.get("stream"):
            return await _stream_chat(request, state, executor, prompt_ids, cfg, body,
                                      direct=media)
        choices = []
        usage_p = usage_c = 0
        want_think = bool(body.get("think", True))
        for i in range(n):
            c = GenerationConfig.from_dict(cfg.to_dict())
            if c.seed is not None and i:
                c.seed += i
            if state.batch_engine is not None and not media:
                res = await _collect_via_engine(state, prompt_ids, c)
                if want_think:
                    res.thinking, res.text = extract_thinking(res.text)
            else:
                res = await asyncio.to_thread(collect_generation, executor, prompt_ids,
                                              c, want_think)
            tool_calls = extract_tool_calls(res.text) if body.get("tools") else None
            msg: dict[str, Any] = {"role": "assistant",
                                   "content": None if tool_calls else res.text}
            if res.thinking and want_think:
                msg["reasoning_content"] = res.thinking
            finish = res.finish_reason.to_openai()
            if tool_calls:
                msg["tool_calls"] = tool_calls
                finish = "tool_calls"
            choices.append({"index": i, "message": msg, "finish_reason": finish,
                            "logprobs": (logprobs_block(res.gen_tokens)
                                         if cfg.logprobs and res.gen_tokens else None)})
            usage_p += res.prompt_tokens
            usage_c += res.completion_tokens
        state.tokens_done(usage_p, usage_c, t0)
        if body.get("id_slot"):
            state.slots.touch(str(body["id_slot"]), usage_p, usage_c)
        return Response.json(chat_response(
            body.get("model", "default"), choices,
            usage_dict(usage_p, usage_c, eval_duration=time.time() - t0)))
    finally:
        if gated:
            state.media_gate.release()
        state.release(budget)
        state.request_done("chat", t0)


async def _bind_media(state: AppState, executor, messages: list) -> tuple[Any, int]:
    """(executor, the context rows its images add; 0 without media): a
    request with image or audio parts gets its images decoded and bound to
    a MultimodalExecutor (the JAX chat route, app.py:481-496). A text model answers 400 before
    any fetch, and so does an audio part (no model of the port has an audio
    encoder; the JAX executor drops the audio); an image that does not
    decode, or that is not a PNG or a baseline JPEG (its header says),
    answers 400 before any compute. Where a lockstep engine serves, the
    bound chat runs as one of its ops on every rank (a sharded model's
    forwards cross the mesh)."""
    parts = [m.get("content") for m in messages if isinstance(m, dict)]
    if not any(has_images(c) or has_audio(c) for c in parts):
        return executor, 0
    if not executor.model.is_multimodal:
        raise ApiError(400, "model does not support image/audio input")
    if any(has_audio(c) for c in parts):
        raise ApiError(400, "model does not support audio input (no audio encoder)")
    try:
        images, audio = await extract_media(messages)
        for img in images:
            check_image(img)
    except MultimodalError as e:
        raise ApiError(400, f"failed to decode multimodal content: {e}")
    model = executor.model
    mm = MultimodalExecutor(executor, model.vision_params, model.vision_cfg)
    bound = MediaBoundExecutor(mm, images, audio)
    if _lockstep(state):
        from ..distributed.lockstep import LockstepMedia

        bound = LockstepMedia(state.batch_engine, bound)
    return bound, bound.rows


async def _stream(request: Request, state: AppState, executor, prompt_ids, cfg,
                  on_item: Callable, head: Optional[bytes], tail: bytes = SSE_DONE,
                  on_error: Optional[Callable[[str], bytes]] = None,
                  direct: bool = False) -> StreamResponse:
    """Shared SSE loop: the head events, the events of each delta
    (``on_item``), the tail (``[DONE]``); an error after the head is one
    more event (``on_error``, else an OpenAI error chunk); a client gone
    mid-stream cancels the engine sequence. ``direct`` streams from the
    Executor even where the batch engine serves (a request with media). The first content delta's time
    goes to the TTFT histogram and SLO window, each later one's gap to ITL
    (the JAX ``_stream_chat``, app.py:664-677); a stream that ends counts
    its tokens and e2e latency."""
    resp = StreamResponse(request, dict(SSE_HEADERS))
    await resp.prepare()
    seq_ref: dict = {}
    if state.batch_engine is not None and not direct:
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
        if tail:
            await resp.write(tail)
    except (ConnectionError, asyncio.CancelledError):
        logger.info("client disconnected mid-stream")
        if seq_ref.get("id") is not None:
            state.batch_engine.cancel(seq_ref["id"])
    except Exception as e:                      # after the head: an SSE error event
        logger.exception("stream failed")
        await resp.write(on_error(str(e)) if on_error else sse_event(
            {"error": {"message": str(e), "type": "server_error"}}))
    finally:
        await source.aclose()
    return resp


async def _stream_chat(request, state, executor, prompt_ids, cfg, body, direct=False):
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
                         stream.role_chunk(), direct=direct)


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


# ---------------------------------------------------------------------------
# app factory
# ---------------------------------------------------------------------------

def create_app(scheduler: ModelScheduler, server_cfg: Optional[ServerConfig] = None,
               batch_engine=None) -> App:
    """The routes and state of the server; ``serve`` runs it."""
    from . import management as mg
    from .anthropic import count_tokens_handler, messages_handler
    from .audio import speech_handler, transcriptions_handler
    from .embeddings import embeddings_handler
    from .infill import infill_handler
    from .lora_routes import lora_delete, lora_list, lora_load
    from .rerank import rerank_handler
    from .responses import responses_handler

    server_cfg = server_cfg or ServerConfig()
    if bool(server_cfg.tls_cert) != bool(server_cfg.tls_key):
        raise ValueError("TLS needs both tls_cert and tls_key")
    state = AppState(scheduler=scheduler, server_cfg=server_cfg, batch_engine=batch_engine)
    app = App(state)
    for method, path, handler in (
            ("GET", "/health", health), ("GET", "/metrics", metrics_handler),
            ("GET", "/v1/models", list_models), ("GET", "/v1/models/{model_id}", get_model),
            ("POST", "/v1/completions", completions),
            ("POST", "/v1/chat/completions", chat_completions),
            ("POST", "/tokenize", tokenize), ("POST", "/detokenize", detokenize),
            ("POST", "/apply-template", apply_template),
            ("GET", "/api/tags", mg.api_tags), ("GET", "/api/ps", mg.api_ps),
            ("POST", "/api/show", mg.api_show), ("DELETE", "/api/delete", mg.api_delete),
            ("POST", "/api/copy", mg.api_copy), ("POST", "/api/pull", mg.api_pull),
            ("GET", "/api/slots", mg.slots_list), ("POST", "/api/slots", mg.slots_create),
            ("DELETE", "/api/slots/{slot_id}", mg.slots_delete),
            ("POST", "/v1/embeddings", embeddings_handler),
            ("POST", "/v1/messages", messages_handler),
            ("POST", "/v1/messages/count_tokens", count_tokens_handler),
            ("POST", "/v1/responses", responses_handler),
            ("POST", "/rerank", rerank_handler), ("POST", "/v1/rerank", rerank_handler),
            ("POST", "/v1/infill", infill_handler),
            ("POST", "/v1/audio/speech", speech_handler),
            ("POST", "/v1/audio/transcriptions", transcriptions_handler),
            ("POST", "/v1/lora", lora_load), ("GET", "/v1/lora", lora_list),
            ("DELETE", "/v1/lora/{name}", lora_delete)):
        app.add(method, path, handler)

    tasks: dict[str, asyncio.Task] = {}
    if batch_engine is not None:
        batch_engine.lora_registry = state.lora_registry

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

    async def start_config_watch():
        from ..config.user import UserConfig, user_config_path
        from .config_watch import watch_config

        def on_change(data: dict) -> None:
            state.user_config = UserConfig.from_dict(data)

        tasks["config_watch"] = asyncio.create_task(watch_config(
            user_config_path(), on_change, poll_interval=server_cfg.config_poll_interval))

    async def stop_config_watch():
        tasks["config_watch"].cancel()

    app.on_startup.append(start_config_watch)
    app.on_cleanup.append(stop_config_watch)
    return app


def ssl_context(cfg: ServerConfig):
    """The server-side TLS context of ``cfg.tls_cert``/``tls_key``, or None
    without them (the JAX ``run_server``, app.py:1124-1129)."""
    if not (cfg.tls_cert and cfg.tls_key):
        return None
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.tls_cert, cfg.tls_key)
    return ctx


async def serve(app: App, host: str, port: int,
                started: Optional[Callable[[int], None]] = None,
                stop: Optional[asyncio.Event] = None) -> None:
    """Run ``app`` on ``host:port`` until ``stop`` is set (forever without
    one); ``started(port)`` is called once the socket listens (port 0 picks
    a free port)."""
    ctx = ssl_context(app.cfg)
    for fn in app.on_startup:
        await fn()
    server = await asyncio.start_server(app.handle_connection, host, port,
                                        limit=_MAX_HEADER_BYTES, ssl=ctx)
    try:
        bound = server.sockets[0].getsockname()[1]
        logger.info("serving on %s://%s:%d", "https" if ctx else "http", host, bound)
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
