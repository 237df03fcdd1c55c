"""API wire types + validation.

Copy of ``blazr_tpu/server/api_types.py``, the reference gen_types.rs /
chat_types.rs / completions request shapes: OpenAI-compatible request parsing into
GenerationConfig, parameter validation (temp ∈ [0,2], top_p ∈ [0,1] —
gen_types.rs:31-45), response_format handling, usage accounting, and the
Ollama-ish extensions (keep_alive, think, template override, raw,
context).
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

from ..config.generation import GenerationConfig


class ApiError(Exception):
    def __init__(self, status: int, message: str, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.message = message
        self.err_type = err_type

    def body(self) -> dict:
        return {"error": {"message": self.message, "type": self.err_type}}


def validate_generation_params(body: dict) -> None:
    """Reference validate_generation_params (gen_types.rs:31-45)."""
    t = body.get("temperature")
    if t is not None and not (0.0 <= float(t) <= 2.0):
        raise ApiError(400, f"temperature must be between 0 and 2, got {t}")
    p = body.get("top_p")
    if p is not None and not (0.0 <= float(p) <= 1.0):
        raise ApiError(400, f"top_p must be between 0 and 1, got {p}")
    n = body.get("max_tokens", body.get("max_completion_tokens"))
    if n is not None and int(n) < 1:
        raise ApiError(400, f"max_tokens must be at least 1, got {n}")
    if body.get("n") is not None and int(body["n"]) < 1:
        raise ApiError(400, "n must be at least 1")


def gen_config_from_body(body: dict, defaults: GenerationConfig
                         ) -> GenerationConfig:
    """OpenAI sampling params → GenerationConfig (reference
    generation.rs:28-95 SamplingParams conversion)."""
    cfg = GenerationConfig.from_dict(defaults.to_dict())
    m = body.get
    if m("max_tokens") is not None:
        cfg.max_tokens = int(body["max_tokens"])
    elif m("max_completion_tokens") is not None:
        cfg.max_tokens = int(body["max_completion_tokens"])
    for k_openai, k_cfg in [
        ("temperature", "temperature"), ("top_p", "top_p"), ("top_k", "top_k"),
        ("min_p", "min_p"), ("frequency_penalty", "frequency_penalty"),
        ("presence_penalty", "presence_penalty"), ("seed", "seed"),
        ("repeat_penalty", "repeat_penalty"), ("repetition_penalty", "repeat_penalty"),
        ("repeat_last_n", "repeat_last_n"), ("typical_p", "typical_p"),
        ("mirostat", "mirostat"), ("mirostat_tau", "mirostat_tau"),
        ("mirostat_eta", "mirostat_eta"), ("grammar", "grammar"),
        ("lora_adapter", "lora_adapter"),
    ]:
        if m(k_openai) is not None:
            setattr(cfg, k_cfg, body[k_openai])
    stop = m("stop") or m("stop_sequences")
    if stop is not None:
        cfg.stop_sequences = [stop] if isinstance(stop, str) else list(stop)
    if m("logit_bias"):
        cfg.logit_bias = {int(k): float(v) for k, v in body["logit_bias"].items()}
    if m("logprobs") is not None:
        lp = body["logprobs"]
        if isinstance(lp, bool):
            cfg.logprobs = lp          # chat shape: bool + top_logprobs
        else:
            # Completions shape: an INT count of alternatives per token
            # (reference generation.rs logprobs/top_logprobs, ≤ 20).
            cfg.logprobs = True
            cfg.top_logprobs = min(max(int(lp), 0), 20)
    if m("top_logprobs") is not None:
        cfg.top_logprobs = min(int(body["top_logprobs"]), 20)
        cfg.logprobs = True

    rf = m("response_format")
    if isinstance(rf, dict):
        t = rf.get("type")
        if t == "json_object":
            cfg.json_mode = True
        elif t == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema") or rf.get("schema")
            if schema:
                cfg.json_schema = schema
            else:
                cfg.json_mode = True
    return cfg


# ---------------------------------------------------------------------------
# Response builders
# ---------------------------------------------------------------------------

def new_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def usage_dict(prompt_tokens: int, completion_tokens: int,
               load_duration: float = 0.0, prompt_eval_duration: float = 0.0,
               eval_duration: float = 0.0) -> dict:
    out = {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }
    # Ollama-style timing extensions (reference chat.rs:324-336)
    if eval_duration > 0:
        out["load_duration_ms"] = round(load_duration * 1e3, 2)
        out["prompt_eval_duration_ms"] = round(prompt_eval_duration * 1e3, 2)
        out["eval_duration_ms"] = round(eval_duration * 1e3, 2)
        if eval_duration > 0 and completion_tokens:
            out["tokens_per_second"] = round(completion_tokens / eval_duration, 2)
    return out


def completion_response(model: str, choices: list[dict], usage: dict) -> dict:
    return {
        "id": new_id("cmpl"),
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage,
    }


def chat_response(model: str, choices: list[dict], usage: dict) -> dict:
    return {
        "id": new_id("chatcmpl"),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage,
    }


def completion_logprobs_block(tokens: list, k: int,
                              text_offset_base: int = 0) -> Optional[dict]:
    """Classic /v1/completions logprobs shape (reference completions.rs):
    parallel ``tokens`` / ``token_logprobs`` / ``top_logprobs`` /
    ``text_offset`` arrays."""
    if not tokens:
        return None
    toks, lps, tops, offs = [], [], [], []
    off = text_offset_base
    for gt in tokens:
        if gt.logprob is None:
            continue
        toks.append(gt.text)
        lps.append(gt.logprob)
        offs.append(off)
        off += len(gt.text)
        tops.append({t.token or "": t.logprob
                     for t in (gt.top_logprobs or [])[:k]} or None)
    if not toks:
        return None
    return {"tokens": toks, "token_logprobs": lps,
            "top_logprobs": tops, "text_offset": offs}


def logprobs_block(tokens: list, text_offsets_base: int = 0) -> Optional[dict]:
    """OpenAI chat logprobs content block from GeneratedToken list."""
    if not tokens:
        return None
    content = []
    for gt in tokens:
        if gt.logprob is None:
            continue
        entry = {
            "token": gt.text,
            "logprob": gt.logprob,
            "bytes": list(gt.text.encode("utf-8")),
        }
        if gt.top_logprobs:
            entry["top_logprobs"] = [
                {"token": t.token or "", "logprob": t.logprob,
                 "bytes": list((t.token or "").encode("utf-8"))}
                for t in gt.top_logprobs
            ]
        content.append(entry)
    return {"content": content} if content else None
