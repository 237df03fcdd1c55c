"""Generation / sampling configuration.

Copy of ``blazr_tpu/config/generation.py`` — the reference GenerationConfig
(src/config/generation.rs:9-146): the full sampler surface — temperature,
top-k/top-p/min-p, repetition/frequency/presence penalties, DRY, typical-p,
mirostat, dynamic temperature, logit bias, logprobs, stop sequences,
JSON mode, GBNF grammar and LoRA adapter selection — plus the named
presets (greedy/creative/balanced, src/config/generation.rs:229-256).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class GenerationConfig:
    max_tokens: int = 2048
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.05
    repeat_penalty: float = 1.1
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    stop_sequences: list[str] = field(default_factory=list)
    seed: Optional[int] = None
    logit_bias: dict[int, float] = field(default_factory=dict)
    logprobs: bool = False
    top_logprobs: int = 5          # clamped to <= 20 (OpenAI limit)

    # Mirostat v2 (target-entropy sampling; reference src/engine/mirostat.rs)
    mirostat: int = 0              # 0 off, 2 = mirostat v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1

    # Dynamic temperature from entropy (reference sampling.rs:41-86)
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0

    # DRY repetition penalty (reference sampling.rs:262-312)
    dry_multiplier: float = 0.0
    dry_base: float = 2.0
    dry_allowed_length: int = 2
    dry_sequence_breakers: list[str] = field(
        default_factory=lambda: ["\n", ":", '"', "*"]
    )

    # Typical-p filtering (reference sampling.rs:318-369)
    typical_p: float = 1.0

    # Structured output
    json_mode: bool = False
    grammar: Optional[str] = None          # GBNF source
    json_schema: Optional[dict] = None     # converted to GBNF

    # LoRA adapter name (hot-loadable registry)
    lora_adapter: Optional[str] = None

    def __post_init__(self) -> None:
        if self.top_logprobs > 20:
            self.top_logprobs = 20

    @property
    def is_greedy(self) -> bool:
        """temp == 0 means argmax decode (reference generation.rs:262)."""
        return self.temperature == 0.0

    def validate(self) -> None:
        if not (0.0 <= self.temperature <= 2.0):
            raise ValueError(f"temperature must be in [0, 2], got {self.temperature}")
        if not (0.0 <= self.top_p <= 1.0):
            raise ValueError(f"top_p must be in [0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 <= self.min_p <= 1.0):
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}")
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")

    # ---- presets (reference generation.rs:229-256) -----------------------
    @classmethod
    def greedy(cls) -> "GenerationConfig":
        return cls(temperature=0.0, top_k=1, min_p=0.0, repeat_penalty=1.0)

    @classmethod
    def creative(cls) -> "GenerationConfig":
        return cls(temperature=1.2, top_p=0.95, top_k=100, min_p=0.02)

    @classmethod
    def balanced(cls) -> "GenerationConfig":
        return cls(temperature=0.7, top_p=0.9, top_k=40, min_p=0.05)

    # ---- serde -----------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "GenerationConfig":
        d = dict(d)
        if "logit_bias" in d and d["logit_bias"]:
            d["logit_bias"] = {int(k): float(v) for k, v in d["logit_bias"].items()}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
