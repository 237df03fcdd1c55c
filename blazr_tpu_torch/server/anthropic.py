"""Anthropic Messages API translation.

Counterpart of ``blazr_tpu/server/anthropic.py``, the reference anthropic
module (src/server/anthropic.rs:498): ``/v1/messages`` (content blocks,
system string-or-blocks, stop_sequences, streaming) and
``/v1/messages/count_tokens``, translated onto the chat pipeline.

A streamed reply is the Anthropic event sequence, each an ``event:`` line
and a ``data:`` line: message_start → content_block_start →
content_block_delta per text delta → content_block_stop → message_delta →
message_stop. It runs through the server's shared stream loop, so a client
that disconnects cancels its engine sequence, and the stream counts its
tokens, e2e latency, TTFT and ITL in ``/metrics`` as a streamed chat does
(the JAX handler counts a non-streamed reply only; ROADMAP §C). Its
``output_tokens`` is the count of generated tokens on both paths.
"""

from __future__ import annotations

import asyncio
import json
import time

from ..config.generation import GenerationConfig
from ..engine.generate_text import collect_generation
from ..model_meta.chat_template import ChatMessage, ChatTemplate
from .api_types import ApiError, new_id
from .app import (Response, _collect_via_engine, _get_executor, _overloaded, _stream,
                  apply_request_lora, generation_defaults)

STOP_REASONS = {"eos": "end_turn", "length": "max_tokens", "stop": "stop_sequence"}


def _blocks_to_text(content) -> str:
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(b.get("text", "") for b in content
                       if isinstance(b, dict) and b.get("type") == "text")
    return str(content or "")


def _anthropic_messages(body: dict) -> list[ChatMessage]:
    msgs: list[ChatMessage] = []
    system = body.get("system")
    if system:
        msgs.append(ChatMessage("system", _blocks_to_text(system)))
    for m in body.get("messages", []):
        msgs.append(ChatMessage(m.get("role", "user"), _blocks_to_text(m.get("content"))))
    if not any(m.role != "system" for m in msgs):
        raise ApiError(400, "messages must not be empty")
    return msgs


def _gen_config(body: dict, defaults: GenerationConfig) -> GenerationConfig:
    cfg = GenerationConfig.from_dict(defaults.to_dict())
    try:
        if body.get("max_tokens") is not None:
            cfg.max_tokens = int(body["max_tokens"])
        for k in ("temperature", "top_p", "top_k"):
            if body.get(k) is not None:
                setattr(cfg, k, body[k])
        if body.get("stop_sequences"):
            cfg.stop_sequences = list(body["stop_sequences"])
        cfg.validate()                 # the 400 of chat/completions
    except (TypeError, ValueError) as e:
        raise ApiError(400, f"invalid sampling parameters: {e}")
    return cfg


def _prompt_ids(executor, body: dict) -> list[int]:
    template = ChatTemplate.detect(model_type=executor.model.cfg.model_type)
    return executor.tokenizer.encode(template.apply(_anthropic_messages(body)))


def event(name: str, data: dict) -> bytes:
    """One server-sent event with its ``event:`` line."""
    return f"event: {name}\ndata: {json.dumps(data)}\n\n".encode()


async def messages_handler(request):
    state = request.app.state
    body = request.json()
    if body.get("max_tokens") is None:
        raise ApiError(400, "max_tokens is required")
    executor = await asyncio.to_thread(_get_executor, state, body)
    prompt_ids = _prompt_ids(executor, body)
    cfg = _gen_config(body, generation_defaults(state, executor))
    await apply_request_lora(request, executor, cfg)
    budget = len(prompt_ids) + cfg.max_tokens
    if not state.try_admit(budget):
        return _overloaded()
    state.metrics.requests_active.inc()
    t0 = time.time()
    try:
        if body.get("stream"):
            return await _stream_messages(request, state, executor, prompt_ids, cfg, body)
        if state.batch_engine is not None:
            res = await _collect_via_engine(state, prompt_ids, cfg)
        else:
            res = await asyncio.to_thread(collect_generation, executor, prompt_ids, cfg)
        state.tokens_done(res.prompt_tokens, res.completion_tokens, t0)
        return Response.json({
            "id": new_id("msg"), "type": "message", "role": "assistant",
            "model": body.get("model", "default"),
            "content": [{"type": "text", "text": res.text}],
            "stop_reason": STOP_REASONS.get(res.finish_reason.value, "end_turn"),
            "stop_sequence": None,
            "usage": {"input_tokens": res.prompt_tokens,
                      "output_tokens": res.completion_tokens}})
    finally:
        state.release(budget)
        state.metrics.requests_active.dec()


async def _stream_messages(request, state, executor, prompt_ids, cfg, body):
    head = event("message_start", {
        "type": "message_start",
        "message": {"id": new_id("msg"), "type": "message", "role": "assistant",
                    "model": body.get("model", "default"), "content": [],
                    "usage": {"input_tokens": len(prompt_ids), "output_tokens": 0}}})
    head += event("content_block_start", {"type": "content_block_start", "index": 0,
                                          "content_block": {"type": "text", "text": ""}})
    count = 0

    def on_item(delta, fin, gts):
        nonlocal count
        count += len(gts)
        if delta:
            yield event("content_block_delta", {
                "type": "content_block_delta", "index": 0,
                "delta": {"type": "text_delta", "text": delta}})
        if fin is not None:
            yield event("content_block_stop", {"type": "content_block_stop", "index": 0})
            yield event("message_delta", {
                "type": "message_delta",
                "delta": {"stop_reason": STOP_REASONS.get(fin.value, "end_turn"),
                          "stop_sequence": None},
                "usage": {"output_tokens": count}})
            yield event("message_stop", {"type": "message_stop"})

    def on_error(message: str) -> bytes:
        return event("error", {"type": "error",
                               "error": {"type": "api_error", "message": message}})

    return await _stream(request, state, executor, prompt_ids, cfg, on_item, head,
                         tail=b"", on_error=on_error)


async def count_tokens_handler(request):
    body = request.json()
    executor = await asyncio.to_thread(_get_executor, request.app.state, body)
    return Response.json({"input_tokens": len(_prompt_ids(executor, body))})
