"""Shared engine types.

Copy of ``blazr_tpu/engine/types.py`` (reference src/engine/types.rs:4-73).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Optional


class FinishReason(enum.Enum):
    EOS = "eos"
    LENGTH = "length"
    STOP = "stop"
    TOOL_CALLS = "tool_calls"

    def to_openai(self) -> str:
        """OpenAI wire names (reference types.rs FinishReason mapping)."""
        if self == FinishReason.EOS:
            return "stop"
        if self == FinishReason.LENGTH:
            return "length"
        if self == FinishReason.TOOL_CALLS:
            return "tool_calls"
        return "stop"


@dataclass
class TokenLogprob:
    token_id: int
    logprob: float
    token: Optional[str] = None


@dataclass
class GeneratedToken:
    token_id: int
    text: str = ""
    logprob: Optional[float] = None
    top_logprobs: Optional[list[TokenLogprob]] = None


@dataclass
class GenerationResult:
    text: str
    tokens: list[int] = field(default_factory=list)
    finish_reason: FinishReason = FinishReason.LENGTH
    prompt_tokens: int = 0
    completion_tokens: int = 0
    logprobs: Optional[list[TokenLogprob]] = None
    top_logprobs: Optional[list[list[TokenLogprob]]] = None
    # Full per-token records (text + logprob + top-k) for the HTTP
    # logprobs blocks; populated only when cfg.logprobs.
    gen_tokens: Optional[list[GeneratedToken]] = None
    thinking: Optional[str] = None
    # timing (seconds)
    load_duration: float = 0.0
    prompt_eval_duration: float = 0.0
    eval_duration: float = 0.0


def is_valid_json(text: str) -> bool:
    """JSON-mode retry check (reference types.rs / generate_text.rs:46-58)."""
    try:
        json.loads(text)
        return True
    except (json.JSONDecodeError, ValueError):
        return False
