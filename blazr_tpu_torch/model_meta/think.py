"""Think-tag extraction for reasoning models.

Copy of ``blazr_tpu/model_meta/think.py`` (reference src/model/think.rs:21-59):
extracts ``<think>...</think>`` blocks (multiple blocks concatenated; an
unclosed trailing block counts as thinking) and returns (thinking, answer).
"""

from __future__ import annotations

import re
from typing import Optional

_THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)
_OPEN_RE = re.compile(r"<think>(.*)\Z", re.DOTALL)


def extract_thinking(text: str) -> tuple[Optional[str], str]:
    """Returns (thinking or None, remaining answer text)."""
    blocks = _THINK_RE.findall(text)
    rest = _THINK_RE.sub("", text)
    m = _OPEN_RE.search(rest)
    if m:  # unclosed trailing block
        blocks.append(m.group(1))
        rest = rest[: m.start()]
    if not blocks:
        return None, text
    thinking = "\n".join(b.strip() for b in blocks if b.strip())
    return (thinking or None), rest.strip()
