"""HTTP server configuration + latency SLOs.

Copy of ``blazr_tpu/config/server.py`` — the reference ServerConfig + LatencySlo
(src/config/server.rs:9-86).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class LatencySlo:
    """Latency SLO thresholds in milliseconds; any unset field is unchecked
    (reference src/config/server.rs LatencySlo + src/server/slo.rs)."""

    ttft_p50_ms: Optional[float] = None
    ttft_p95_ms: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    itl_p50_ms: Optional[float] = None
    itl_p95_ms: Optional[float] = None
    itl_p99_ms: Optional[float] = None
    e2e_p50_ms: Optional[float] = None
    e2e_p95_ms: Optional[float] = None
    e2e_p99_ms: Optional[float] = None

    def any_set(self) -> bool:
        return any(getattr(self, f.name) is not None for f in dataclasses.fields(self))


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8080
    max_concurrent_requests: int = 16
    request_timeout_secs: float = 300.0
    enable_cors: bool = True
    max_body_bytes: int = 10 * 1024 * 1024
    tls_cert: Optional[str] = None
    tls_key: Optional[str] = None
    api_keys: list[str] = field(default_factory=list)
    # Token-budget admission control: 503 + Retry-After once the sum of
    # in-flight (prompt + max_tokens) exceeds this (reference handlers.rs:72-103).
    max_inflight_tokens: Optional[int] = None
    slo: LatencySlo = field(default_factory=LatencySlo)
    # User-config hot-reload poll cadence (reference config_watch.rs:22).
    config_poll_interval: float = 5.0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServerConfig":
        d = dict(d)
        if isinstance(d.get("slo"), dict):
            known = {f.name for f in dataclasses.fields(LatencySlo)}
            d["slo"] = LatencySlo(**{k: v for k, v in d["slo"].items() if k in known})
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
