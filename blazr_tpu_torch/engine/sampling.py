"""Fused sampling on the device.

Counterpart of ``blazr_tpu/engine/sampling.py``: penalties → logit bias →
grammar mask → temperature → top-k/top-p → min-p → seeded draw, with
greedy rows taking the argmax of the penalized logits. The JAX package
draws its Gumbel noise with threefry from a per-row (seed, step) key; this
port draws it from a counter-based hash of (seed, step, token id). The
hash gives the same bits on the CPU and on the card, but not JAX's bits:
seeded rows are deterministic per (seed, step) and follow the same
distribution; greedy rows are exact. The host samplers (mirostat, DRY,
typical-p, dynamic temperature) are numpy, in ``samplers.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config.generation import GenerationConfig
from ..utils.device import DeviceLike, resolve_device

# Fixed penalty window (repeat_last_n default 64).
PENALTY_WINDOW = 64
PAD_TOKEN = -1
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class SamplingParams:
    """Per-sequence sampling parameters, [B]-shaped tensors on the device."""

    temperature: torch.Tensor        # [B] f32; 0 → greedy
    top_k: torch.Tensor              # [B] i64; 0 → disabled
    top_p: torch.Tensor              # [B] f32; 1 → disabled
    min_p: torch.Tensor              # [B] f32; 0 → disabled
    repeat_penalty: torch.Tensor     # [B] f32; 1 → disabled
    freq_penalty: torch.Tensor       # [B] f32
    presence_penalty: torch.Tensor   # [B] f32
    key: torch.Tensor                # [B, 2] i64 (seed, step)
    any_sampled: bool                # host-known: does any row sample?

    @classmethod
    def from_config(cls, cfgs: list[GenerationConfig],
                    step: "int | list[int]" = 0,
                    device: DeviceLike = None) -> "SamplingParams":
        """Batched params from per-request configs. ``step`` may be per-row
        (each sequence's own emitted-token count), so staggered rows keep
        per-sequence seeded sampling deterministic."""
        device = resolve_device(device)
        steps = step if isinstance(step, (list, tuple)) else [step] * len(cfgs)
        f, keys, top_k = sampling_arrays(cfgs, steps)
        ft = torch.from_numpy(f).to(device)
        return cls(
            temperature=ft[:, 0], top_p=ft[:, 1], min_p=ft[:, 2],
            repeat_penalty=ft[:, 3], freq_penalty=ft[:, 4],
            presence_penalty=ft[:, 5],
            top_k=torch.from_numpy(top_k).to(device),
            key=torch.from_numpy(keys).to(device),
            any_sampled=any(c.temperature > 0.0 for c in cfgs),
        )


def sampling_arrays(cfgs: list[GenerationConfig], steps: list[int]
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host arrays of the per-row parameters: float32 [B, 6] (temperature,
    top_p, min_p, repeat, frequency and presence penalties), int64 [B, 2]
    (seed, step) keys (an unseeded row i takes 0x5EED ^ (i * 7919)) and
    int64 [B] top_k."""
    f = np.array([(c.temperature, c.top_p, c.min_p, c.repeat_penalty,
                   c.frequency_penalty, c.presence_penalty) for c in cfgs],
                 dtype=np.float32).reshape(len(cfgs), 6)
    keys = np.array([((c.seed if c.seed is not None else 0x5EED ^ (i * 7919))
                      & _M32, steps[i] & _M32) for i, c in enumerate(cfgs)],
                    dtype=np.int64).reshape(len(cfgs), 2)
    top_k = np.array([c.top_k for c in cfgs], dtype=np.int64)
    return f, keys, top_k


def apply_penalties(logits: torch.Tensor, window_tokens: torch.Tensor,
                    repeat_penalty: torch.Tensor, freq_penalty: torch.Tensor,
                    presence_penalty: torch.Tensor) -> torch.Tensor:
    """Repetition (CTRL-style), frequency and presence penalties over the
    recent-token window [B, W] (PAD_TOKEN for empty slots). Only the ≤W
    logits the window names change: they are gathered, transformed and
    scattered back (pad slots rewrite token 0's own final value, so
    duplicate writes agree)."""
    valid = window_tokens >= 0
    safe = torch.where(valid, window_tokens, torch.zeros_like(window_tokens)).long()
    eq = (safe[:, :, None] == safe[:, None, :]) & valid[:, None, :]
    counts = eq.sum(dim=2).to(torch.float32)                    # [B, W]
    in_win = counts > 0
    cur = logits.gather(1, safe)
    rp = repeat_penalty[:, None]
    penalized = torch.where(cur > 0, cur / rp, cur * rp)
    val = torch.where(in_win, penalized - counts * freq_penalty[:, None]
                      - presence_penalty[:, None], cur)
    return logits.scatter(1, safe, val)


def apply_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Top-k then nucleus filtering over ONE sort (top_p == 0 keeps the
    argmax)."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    ranks = torch.arange(v, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k.clamp(max=v))
    keep_k = ranks < k[:, None]
    kept = torch.where(keep_k, sorted_desc, torch.full_like(sorted_desc, -torch.inf))
    probs = torch.softmax(kept, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep_k & ((cum - probs) < top_p[:, None])
    keep[:, 0] = True                                          # argmax always kept
    threshold = torch.where(keep, sorted_desc,
                            torch.full_like(sorted_desc, torch.inf)).amin(
        dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits,
                       torch.full_like(logits, -torch.inf))


def apply_min_p(logits: torch.Tensor, min_p: torch.Tensor) -> torch.Tensor:
    """Drop tokens with prob < min_p * max_prob."""
    probs = torch.softmax(logits, dim=-1)
    keep = probs >= min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    return torch.where(keep, logits, torch.full_like(logits, -torch.inf))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without overflowing int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (xorshift-multiply) on int64 tensors."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(key: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] float32 Gumbel noise, a pure function of each row's
    (seed, step) and the token id: counter-based, the same on every device."""
    row = _hash32(_hash32(key[:, 0] ^ 0x5EED5EED) ^ key[:, 1])          # [B]
    ids = torch.arange(vocab, dtype=torch.int64, device=key.device)
    h = _hash32(_hash32(row[:, None] ^ _hash32(ids * 0x9E3779B1 + 1)[None, :]))
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))          # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, params: SamplingParams,
                  window_tokens: Optional[torch.Tensor] = None,
                  logit_bias_ids: Optional[torch.Tensor] = None,
                  logit_bias_vals: Optional[torch.Tensor] = None,
                  grammar_mask: Optional[torch.Tensor] = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused chain. Returns (tokens [B] i64, logprobs [B, V]); the
    logprobs are of the penalized, biased, masked distribution.
    ``grammar_mask`` ([B, V] bool, True = allowed) applies after the
    penalties and the bias and before the temperature (JAX :216-239)."""
    logits = logits.to(torch.float32)
    if window_tokens is not None:
        logits = apply_penalties(logits, window_tokens, params.repeat_penalty,
                                 params.freq_penalty, params.presence_penalty)
    if logit_bias_ids is not None:
        valid = logit_bias_ids >= 0
        safe = torch.where(valid, logit_bias_ids,
                           torch.zeros_like(logit_bias_ids)).long()
        logits = logits.scatter_add(
            1, safe, torch.where(valid, logit_bias_vals,
                                 torch.zeros_like(logit_bias_vals)))
    if grammar_mask is not None:
        logits = torch.where(grammar_mask, logits, torch.full_like(logits, -torch.inf))
    logprobs = torch.log_softmax(logits, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    if not params.any_sampled:
        return greedy, logprobs
    temp = params.temperature.clamp(min=1e-6)[:, None]
    scaled = apply_top_k_top_p(logits / temp, params.top_k, params.top_p)
    scaled = apply_min_p(scaled, params.min_p)
    noisy = torch.where(torch.isfinite(scaled),
                        scaled + gumbel_noise(params.key, scaled.shape[-1]),
                        torch.full_like(scaled, -torch.inf))
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy, sampled), logprobs


# ---------------------------------------------------------------------------
# Host-side helpers for windows / bias (fixed-shape padding)
# ---------------------------------------------------------------------------

def make_window(history: list[int], repeat_last_n: int = PENALTY_WINDOW,
                width: int = PENALTY_WINDOW) -> np.ndarray:
    """Last ``repeat_last_n`` tokens padded to a fixed [W] row."""
    n = min(repeat_last_n, width)
    recent = history[-n:] if n > 0 else []
    row = np.full((width,), PAD_TOKEN, dtype=np.int64)
    if recent:
        row[: len(recent)] = np.asarray(recent[-width:], dtype=np.int64)
    return row


def make_bias_rows(cfgs: list[GenerationConfig], width: int = 16
                   ) -> tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(cfgs), width), PAD_TOKEN, dtype=np.int64)
    vals = np.zeros((len(cfgs), width), dtype=np.float32)
    for i, c in enumerate(cfgs):
        for j, (tid, v) in enumerate(list(c.logit_bias.items())[:width]):
            ids[i, j] = tid
            vals[i, j] = v
    return ids, vals
