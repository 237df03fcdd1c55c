"""Code infill (fill-in-the-middle) endpoint.

Counterpart of ``blazr_tpu/server/infill.py``, the reference infill module
(src/server/infill.rs:272): a PSM-order prompt ``<fim_prefix>P<fim_suffix>S
<fim_middle>`` built at the token level from the tokenizer's FIM special
tokens, found by their common aliases (reference :29-48); the middle is
generated. A tokenizer with none of them gets the prefix as a plain
continuation, as in the JAX package.
"""

from __future__ import annotations

import asyncio

from ..engine.generate_text import collect_generation
from .api_types import ApiError, gen_config_from_body, new_id, usage_dict
from .app import (Response, _collect_via_engine, _get_executor, _overloaded,
                  apply_request_lora, generation_defaults)

FIM_PREFIX_ALIASES = ["<fim_prefix>", "<|fim_prefix|>", "<PRE>", "<|fim▁begin|>"]
FIM_SUFFIX_ALIASES = ["<fim_suffix>", "<|fim_suffix|>", "<SUF>", "<|fim▁hole|>"]
FIM_MIDDLE_ALIASES = ["<fim_middle>", "<|fim_middle|>", "<MID>", "<|fim▁end|>"]


def _find_special(tokenizer, aliases: list[str]):
    lookup = getattr(tokenizer, "special_token_id", None)
    if lookup is None:
        return None
    for a in aliases:
        tid = lookup(a)
        if tid is not None:
            return tid
    return None


def infill_prompt(tokenizer, prefix: str, suffix: str) -> list[int]:
    """The PSM prompt's ids; the prefix alone without FIM tokens."""
    ids = [_find_special(tokenizer, a) for a in (FIM_PREFIX_ALIASES, FIM_SUFFIX_ALIASES,
                                                 FIM_MIDDLE_ALIASES)]
    enc = tokenizer.encode
    if None in ids:
        return enc(prefix)
    # Token-level: re-encoding the control strings as text fails on
    # SentencePiece tokenizers (CodeLlama's <PRE>/<SUF>/<MID>).
    p_id, s_id, m_id = ids
    return [p_id] + enc(prefix) + [s_id] + enc(suffix) + [m_id]


async def infill_handler(request):
    state = request.app.state
    body = request.json()
    executor = await asyncio.to_thread(_get_executor, state, body)
    prefix = body.get("input_prefix", body.get("prefix", ""))
    suffix = body.get("input_suffix", body.get("suffix", ""))
    if not prefix and not suffix:
        raise ApiError(400, "input_prefix or input_suffix required")
    prompt_ids = infill_prompt(executor.tokenizer, prefix, suffix)
    cfg = gen_config_from_body(body, generation_defaults(state, executor))
    if body.get("max_tokens") is None:
        cfg.max_tokens = 128
    try:
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
        else:
            res = await asyncio.to_thread(collect_generation, executor, prompt_ids, cfg)
    finally:
        state.release(budget)
    return Response.json({"id": new_id("infill"), "content": res.text,
                          "stop": res.finish_reason.value != "length",
                          "usage": usage_dict(res.prompt_tokens, res.completion_tokens)})
