"""SSE streaming chunk formats.

Copy of ``blazr_tpu/server/streaming.py``, the reference streaming module
(src/server/streaming.rs:54-198): OpenAI ``text_completion.chunk`` / ``chat.completion.chunk``
events (role-first chunk for chat), error events, and the ``[DONE]``
sentinel.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from .api_types import new_id


def sse_event(data: dict | str) -> bytes:
    if isinstance(data, str):
        return f"data: {data}\n\n".encode()
    return f"data: {json.dumps(data)}\n\n".encode()


SSE_DONE = b"data: [DONE]\n\n"
SSE_HEADERS = {
    "Content-Type": "text/event-stream",
    "Cache-Control": "no-cache",
    "X-Accel-Buffering": "no",
}


class ChatStream:
    """Builds chat.completion.chunk events (role chunk first)."""

    def __init__(self, model: str):
        self.id = new_id("chatcmpl")
        self.created = int(time.time())
        self.model = model

    def _chunk(self, delta: dict, finish_reason: Optional[str] = None,
               extra: Optional[dict] = None) -> dict:
        out = {
            "id": self.id,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.model,
            "choices": [{"index": 0, "delta": delta,
                         "finish_reason": finish_reason}],
        }
        if extra:
            out.update(extra)
        return out

    def role_chunk(self) -> bytes:
        return sse_event(self._chunk({"role": "assistant", "content": ""}))

    def delta(self, text: str, logprobs: dict | None = None) -> bytes:
        chunk = self._chunk({"content": text})
        if logprobs is not None:
            chunk["choices"][0]["logprobs"] = logprobs
        return sse_event(chunk)

    def finish(self, reason: str, usage: Optional[dict] = None) -> bytes:
        extra = {"usage": usage} if usage else None
        return sse_event(self._chunk({}, finish_reason=reason, extra=extra))

    def error(self, message: str) -> bytes:
        return sse_event({"error": {"message": message, "type": "server_error"}})


class CompletionStream:
    """Builds text_completion.chunk events."""

    def __init__(self, model: str):
        self.id = new_id("cmpl")
        self.created = int(time.time())
        self.model = model

    def delta(self, text: str, index: int = 0,
              finish_reason: Optional[str] = None,
              logprobs: dict | None = None) -> bytes:
        return sse_event({
            "id": self.id,
            "object": "text_completion",
            "created": self.created,
            "model": self.model,
            "choices": [{"index": index, "text": text,
                         "finish_reason": finish_reason,
                         "logprobs": logprobs}],
        })
