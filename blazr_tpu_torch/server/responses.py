"""OpenAI Responses API.

Counterpart of ``blazr_tpu/server/responses.py``, the reference responses
module (src/server/responses.rs:465): ``/v1/responses`` (input string or
item list, instructions) onto the chat pipeline, answered in the Responses
output-item shape, a ``<think>`` block split off as a reasoning item.
Streaming answers 400, as in the JAX package.
"""

from __future__ import annotations

import asyncio
import time

from ..config.generation import GenerationConfig
from ..engine.generate_text import collect_generation
from ..model_meta.chat_template import ChatMessage, ChatTemplate
from ..model_meta.think import extract_thinking
from .api_types import ApiError, new_id
from .app import (Response, _collect_via_engine, _get_executor, _overloaded,
                  apply_request_lora, generation_defaults)


def _input_to_messages(body: dict) -> list[ChatMessage]:
    msgs: list[ChatMessage] = []
    instructions = body.get("instructions")
    if instructions:
        msgs.append(ChatMessage("system", instructions))
    inp = body.get("input")
    if inp is None:
        raise ApiError(400, "input required")
    if isinstance(inp, str):
        msgs.append(ChatMessage("user", inp))
        return msgs
    for item in inp:
        if not isinstance(item, dict) or item.get("type", "message") != "message":
            continue
        content = item.get("content")
        if isinstance(content, list):
            text = "".join(c.get("text", "") for c in content if isinstance(c, dict)
                           and c.get("type") in ("input_text", "output_text", "text"))
        else:
            text = str(content or "")
        msgs.append(ChatMessage(item.get("role", "user"), text))
    if not any(m.role != "system" for m in msgs):
        raise ApiError(400, "input must contain at least one message")
    return msgs


async def responses_handler(request):
    state = request.app.state
    body = request.json()
    if body.get("stream"):
        raise ApiError(400, "streaming is not supported on /v1/responses; "
                            "use /v1/chat/completions with stream=true")
    executor = await asyncio.to_thread(_get_executor, state, body)
    template = ChatTemplate.detect(model_type=executor.model.cfg.model_type)
    prompt_ids = executor.tokenizer.encode(template.apply(_input_to_messages(body)))
    cfg = GenerationConfig.from_dict(generation_defaults(state, executor).to_dict())
    try:
        if body.get("max_output_tokens") is not None:
            cfg.max_tokens = int(body["max_output_tokens"])
        for k in ("temperature", "top_p"):
            if body.get(k) is not None:
                setattr(cfg, k, body[k])
        cfg.validate()
    except (TypeError, ValueError) as e:
        raise ApiError(400, f"invalid sampling parameters: {e}")
    await apply_request_lora(request, executor, cfg)
    budget = len(prompt_ids) + cfg.max_tokens
    if not state.try_admit(budget):
        return _overloaded()
    try:
        if state.batch_engine is not None:
            res = await _collect_via_engine(state, prompt_ids, cfg)
            res.thinking, res.text = extract_thinking(res.text)
        else:
            res = await asyncio.to_thread(collect_generation, executor, prompt_ids, cfg, True)
    finally:
        state.release(budget)
    output = []
    if res.thinking:
        output.append({"type": "reasoning", "id": new_id("rs"),
                       "summary": [{"type": "summary_text", "text": res.thinking}]})
    output.append({"type": "message", "id": new_id("msg"), "status": "completed",
                   "role": "assistant",
                   "content": [{"type": "output_text", "text": res.text, "annotations": []}]})
    return Response.json({
        "id": new_id("resp"), "object": "response", "created_at": int(time.time()),
        "status": "completed", "model": body.get("model", "default"), "output": output,
        "output_text": res.text,
        "usage": {"input_tokens": res.prompt_tokens, "output_tokens": res.completion_tokens,
                  "total_tokens": res.prompt_tokens + res.completion_tokens}})
