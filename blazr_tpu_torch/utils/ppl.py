"""Perplexity evaluation: the Δppl quality gate.

Counterpart of ``blazr_tpu/utils/ppl.py``. It takes any token stream (no
dataset exists in this environment); the int8 compute modes are gated on
their perplexity against w4a16 (``tests/test_int8_mxu.py:199`` and
``tests/test_ppl_gate.py:164`` in the JAX package). The forward runs on the
model's device; the log-softmax is taken on the host in float64.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


@torch.no_grad()
def perplexity(model, token_ids: list[int], window: int = 512,
               stride: Optional[int] = None) -> float:
    """Sliding-window perplexity of ``model`` over a token stream."""
    stride = stride or window
    n = len(token_ids)
    dev = model.device
    total_nll = 0.0
    total_tok = 0
    for start in range(0, max(n - 1, 1), stride):
        chunk = token_ids[start:start + window + 1]
        if len(chunk) < 2:
            break
        inp = torch.tensor([chunk[:-1]], dtype=torch.int64, device=dev)
        tgt = np.asarray(chunk[1:], dtype=np.int64)
        cache = model.init_cache(1, len(chunk))
        pos = torch.arange(inp.shape[1], dtype=torch.int64, device=dev)[None, :]
        logits, _ = model.forward(inp, cache, pos)
        lp = logits[0].to(torch.float64).cpu().numpy()
        lp = lp - lp.max(axis=-1, keepdims=True)
        lse = np.log(np.exp(lp).sum(axis=-1))
        nll = -(lp[np.arange(len(tgt)), tgt] - lse)
        # Only score the non-overlapping tail when striding.
        score_from = 0 if start == 0 else window - stride
        total_nll += float(nll[score_from:].sum())
        total_tok += len(tgt) - score_from
        if start + window + 1 >= n:
            break
    return math.exp(total_nll / max(total_tok, 1))


def delta_ppl(base_model, quant_model, token_ids: list[int],
              window: int = 512) -> tuple[float, float, float]:
    """(ppl_base, ppl_quant, delta)."""
    p0 = perplexity(base_model, token_ids, window)
    p1 = perplexity(quant_model, token_ids, window)
    return p0, p1, p1 - p0
