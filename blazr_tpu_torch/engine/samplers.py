"""Host-side samplers: mirostat v2, DRY, typical-p, dynamic temperature.

Copy of ``blazr_tpu/engine/samplers.py`` (reference stages: mirostat v2,
src/engine/mirostat.rs; DRY, sampling.rs:262-312; typical-p,
sampling.rs:318-369; dynatemp, sampling.rs:41-86). They run on one
sequence's logits pulled to the host, in numpy with
``np.random.default_rng(seed)``, so a seeded host-sampled stream is the
JAX package's. The engines run such rows in a T=1 side step
(``BatchEngine``) or a forward-only step (``Executor``).
"""


from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..config.generation import GenerationConfig


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


# ---------------------------------------------------------------------------
# Mirostat v2
# ---------------------------------------------------------------------------

@dataclass
class MirostatState:
    """Mirostat v2 sampler state (reference mirostat.rs:40-110)."""

    tau: float = 5.0              # target surprise (bits)
    eta: float = 0.1              # learning rate
    mu: float = field(default=None)  # type: ignore[assignment]
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))

    def __post_init__(self) -> None:
        if self.mu is None:
            self.mu = 2.0 * self.tau

    @classmethod
    def from_config(cls, cfg: GenerationConfig) -> "MirostatState":
        seed = cfg.seed if cfg.seed is not None else 0
        return cls(tau=cfg.mirostat_tau, eta=cfg.mirostat_eta,
                   rng=np.random.default_rng(seed))

    def sample(self, logits: np.ndarray, temperature: float = 1.0) -> int:
        if temperature > 0:
            logits = logits / temperature
        probs = _softmax(logits.astype(np.float64))
        order = np.argsort(-probs)
        sorted_probs = probs[order]
        # Truncate tokens whose surprise exceeds mu.
        surprise = -np.log2(np.maximum(sorted_probs, 1e-30))
        keep = surprise < self.mu
        if not keep.any():
            keep[0] = True
        kept = sorted_probs * keep
        kept = kept / kept.sum()
        idx = self.rng.choice(len(kept), p=kept)
        token = int(order[idx])
        observed = -np.log2(max(probs[token], 1e-30))
        self.mu -= self.eta * (observed - self.tau)
        return token


# ---------------------------------------------------------------------------
# DRY ("don't repeat yourself") penalty
# ---------------------------------------------------------------------------

def apply_dry_penalty(
    logits: np.ndarray,
    history: Sequence[int],
    multiplier: float,
    base: float = 2.0,
    allowed_length: int = 2,
    breaker_ids: Optional[set[int]] = None,
) -> np.ndarray:
    """Penalize tokens that would extend a repeated suffix
    (reference sampling.rs:262-312).

    For each candidate token z: find the longest suffix of ``history`` that
    re-occurred earlier immediately before a z; if its length exceeds
    ``allowed_length``, subtract multiplier * base^(len - allowed_length).
    """
    if multiplier <= 0.0 or not history:
        return logits
    breaker_ids = breaker_ids or set()
    hist = list(history)
    n = len(hist)

    # Truncate the scan at the most recent sequence breaker.
    start = 0
    for i in range(n - 1, -1, -1):
        if hist[i] in breaker_ids:
            start = i + 1
            break
    hist = hist[start:]
    n = len(hist)
    if n < allowed_length:
        return logits

    logits = logits.copy()
    # match_len[z] = longest suffix length that previously preceded token z.
    match_lens: dict[int, int] = {}
    for i in range(n - 1):           # candidate continuation at position i
        z = hist[i + 1] if i + 1 < n else None
        if z is None:
            continue
        # length of common suffix between hist[:i+1] and full history tail
        l = 0
        while l < i + 1 and l < n and hist[i - l] == hist[n - 1 - l]:
            l += 1
        if l > match_lens.get(z, 0):
            match_lens[z] = l

    for z, l in match_lens.items():
        if l >= allowed_length:
            logits[z] -= multiplier * (base ** (l - allowed_length))
    return logits


# ---------------------------------------------------------------------------
# Typical-p filtering
# ---------------------------------------------------------------------------

def apply_typical_p(logits: np.ndarray, typical_p: float) -> np.ndarray:
    """Locally-typical sampling: keep tokens whose surprise is closest to
    the distribution entropy until mass >= p (reference sampling.rs:318-369)."""
    if typical_p >= 1.0:
        return logits
    probs = _softmax(logits.astype(np.float64))
    eps = 1e-30
    surprise = -np.log(np.maximum(probs, eps))
    entropy = float((probs * surprise).sum())
    dev = np.abs(surprise - entropy)
    order = np.argsort(dev, kind="stable")
    cum = np.cumsum(probs[order])
    cutoff = int(np.searchsorted(cum, typical_p) + 1)
    keep = order[:cutoff]
    out = np.full_like(logits, -np.inf)
    out[keep] = logits[keep]
    return out


# ---------------------------------------------------------------------------
# Dynamic temperature
# ---------------------------------------------------------------------------

def dynamic_temperature(
    logits: np.ndarray,
    base_temp: float,
    dynatemp_range: float,
    exponent: float = 1.0,
) -> float:
    """Entropy-scaled temperature in [base-range, base+range]
    (reference sampling.rs:41-86): low entropy → low temp (confident),
    high entropy → high temp."""
    if dynatemp_range <= 0.0:
        return base_temp
    lo = max(0.0, base_temp - dynatemp_range)
    hi = base_temp + dynatemp_range
    probs = _softmax(logits.astype(np.float64))
    probs = probs[probs > 0]
    entropy = float(-(probs * np.log(probs)).sum())
    max_entropy = np.log(len(probs)) if len(probs) > 1 else 1.0
    norm = (entropy / max_entropy) ** exponent if max_entropy > 0 else 0.0
    return lo + (hi - lo) * norm


# ---------------------------------------------------------------------------
# Dispatch: does this config need the host path?
# ---------------------------------------------------------------------------

def needs_host_sampling(cfg: GenerationConfig) -> bool:
    """Mirostat / DRY / typical / dynatemp run host-side
    (reference sample_token_dispatch, sampling.rs:93)."""
    return (
        cfg.mirostat == 2
        or cfg.dry_multiplier > 0.0
        or cfg.typical_p < 1.0
        or cfg.dynatemp_range > 0.0
    )


def dry_breaker_ids(tokenizer, cfg: GenerationConfig) -> set[int]:
    """Every token of each DRY sequence breaker resets the match (the JAX
    engines' ``_dry_breaker_ids`` and ``_breaker_ids``)."""
    out: set[int] = set()
    for brk in cfg.dry_sequence_breakers:
        if hasattr(tokenizer, "encode"):
            out.update(tokenizer.encode(brk))
    return out


def host_sample(
    logits: np.ndarray,
    cfg: GenerationConfig,
    history: Sequence[int],
    mirostat_state: Optional[MirostatState] = None,
    breaker_ids: Optional[set[int]] = None,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Full host-side chain for exotic samplers.

    Mirrors the fused device chain's standard stages (repeat/frequency/
    presence penalties, logit bias, temperature, top-k/top-p/min-p) so a
    request that ALSO uses a host-only sampler doesn't silently lose
    them (reference applies its full stack CPU-side the same way)."""
    logits = np.asarray(logits, dtype=np.float32).copy()
    v = len(logits)

    # Repetition / frequency / presence penalties over the recent window.
    if (cfg.repeat_penalty != 1.0 or cfg.frequency_penalty
            or cfg.presence_penalty):
        n = min(cfg.repeat_last_n, 64)
        recent = [t for t in history[-n:] if 0 <= t < v] if n > 0 else []
        if recent:
            ids, counts = np.unique(recent, return_counts=True)
            rp = cfg.repeat_penalty
            logits[ids] = np.where(logits[ids] > 0, logits[ids] / rp,
                                   logits[ids] * rp)
            logits[ids] -= counts.astype(np.float32) * cfg.frequency_penalty
            logits[ids] -= cfg.presence_penalty
    if cfg.logit_bias:
        for tid, val in cfg.logit_bias.items():
            tid = int(tid)
            if 0 <= tid < v:
                logits[tid] += float(val)

    if cfg.dry_multiplier > 0.0:
        logits = apply_dry_penalty(
            logits, history, cfg.dry_multiplier, cfg.dry_base,
            cfg.dry_allowed_length, breaker_ids,
        )
    if cfg.typical_p < 1.0:
        logits = apply_typical_p(logits, cfg.typical_p)

    temp = cfg.temperature
    if cfg.dynatemp_range > 0.0:
        temp = dynamic_temperature(logits, temp, cfg.dynatemp_range,
                                   cfg.dynatemp_exponent)

    if cfg.mirostat == 2:
        assert mirostat_state is not None
        return mirostat_state.sample(logits, temp)

    if temp <= 0.0:
        return int(np.argmax(logits))
    scaled = logits / temp
    # top-k → top-p → min-p, matching the device chain's order.
    if cfg.top_k and cfg.top_k > 0 and cfg.top_k < v:
        kth = np.partition(scaled, -cfg.top_k)[-cfg.top_k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    if cfg.top_p < 1.0:
        order = np.argsort(scaled)[::-1]
        probs = _softmax(scaled[order].astype(np.float64))
        cum = np.cumsum(probs)
        keep_sorted = (cum - probs) < cfg.top_p
        keep_sorted[0] = True                    # argmax always kept
        thresh = np.min(np.where(keep_sorted, scaled[order], np.inf))
        scaled = np.where(scaled >= thresh, scaled, -np.inf)
    if cfg.min_p > 0.0:
        probs = _softmax(scaled.astype(np.float64))
        keep = probs >= cfg.min_p * probs.max()
        scaled = np.where(keep, scaled, -np.inf)
    probs = _softmax(scaled.astype(np.float64))
    rng = rng or np.random.default_rng(cfg.seed or 0)
    return int(rng.choice(len(probs), p=probs))
