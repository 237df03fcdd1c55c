"""Shared engine types.

Copy of ``blazr_tpu/engine/types.py`` (reference src/engine/types.rs:4-73).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
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
