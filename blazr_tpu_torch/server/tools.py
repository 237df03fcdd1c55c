"""OpenAI function calling: tools → system prompt, tool-call extraction.

Copy of ``blazr_tpu/server/tools.py``, the reference tools module
(src/server/tools.rs:389): tool definitions go into a system prompt
section, and tool-call JSON is extracted from the generated text
(finish_reason becomes "tool_calls").
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Optional

TOOLS_PREAMBLE = (
    "You have access to the following tools. To call a tool, respond with a "
    "JSON object (and nothing else) of the form "
    '{"name": "<tool_name>", "arguments": {...}}.\n\nAvailable tools:\n'
)


def tools_system_prompt(tools: list[dict]) -> str:
    """The tools system-prompt section."""
    lines = [TOOLS_PREAMBLE]
    for t in tools:
        fn = t.get("function", t)
        name = fn.get("name", "unknown")
        desc = fn.get("description", "")
        params = fn.get("parameters", {})
        lines.append(f"- {name}: {desc}\n  parameters: {json.dumps(params)}")
    return "\n".join(lines)


_JSON_BLOCK = re.compile(r"```(?:json)?\s*(\{.*?\})\s*```", re.DOTALL)


def extract_tool_calls(text: str) -> Optional[list[dict]]:
    """Tool calls in generated text: a bare JSON object, a fenced ```json
    block, or a {"tool_calls": [...]} wrapper; None when there is none."""
    objs = []
    stripped = text.strip()
    if stripped.startswith("{"):
        # raw_decode tolerates trailing prose after the JSON object.
        try:
            obj, _ = json.JSONDecoder().raw_decode(stripped)
            objs.append(obj)
        except json.JSONDecodeError:
            pass
    for cand in _JSON_BLOCK.findall(text):
        try:
            objs.append(json.loads(cand))
        except json.JSONDecodeError:
            continue

    for obj in objs:
        calls = None
        if isinstance(obj, dict) and "tool_calls" in obj:
            calls = obj["tool_calls"]
        elif isinstance(obj, dict) and ("name" in obj or "function" in obj):
            calls = [obj]
        if not calls:
            continue
        out = []
        for c in calls:
            if not isinstance(c, dict):
                continue
            # OpenAI-shaped entries nest under "function".
            fn = c.get("function") if isinstance(c.get("function"), dict) else c
            name = fn.get("name")
            if not name:
                continue
            args = fn.get("arguments", fn.get("parameters", {}))
            if not isinstance(args, str):
                # The wire contract types arguments as a JSON string.
                args = json.dumps(args if args is not None else {})
            out.append({"id": f"call_{uuid.uuid4().hex[:24]}", "type": "function",
                        "function": {"name": name, "arguments": args}})
        if out:
            return out
    return None
