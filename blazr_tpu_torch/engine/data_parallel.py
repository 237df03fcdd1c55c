"""Data-parallel replica group.

Counterpart of ``blazr_tpu/engine/data_parallel.py``: requests spread over
replica engines, cache-aware (``cache_router.CacheAwareRouter``) when a
prompt is given, else round-robin, with each replica's active-request count
kept under a lock. A replica is any engine (two ``BatchEngine``s on one
card are a group of two). Nothing in the JAX package wires a group into the
server or the CLI, and neither does the port: a caller selects a replica,
submits to its engine and releases it when the request ends.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any

from .cache_router import CacheAwareRouter


@dataclass
class Replica:
    index: int
    engine: Any
    active: int = 0


class DataParallelGroup:
    """Round-robin or cache-aware replica selection."""

    def __init__(self, engines: list[Any], cache_aware: bool = True):
        if not engines:
            raise ValueError("need at least one replica")
        self.replicas = [Replica(i, e) for i, e in enumerate(engines)]
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self.router = CacheAwareRouter(len(engines)) if cache_aware else None

    def select(self, prompt: str = "") -> Replica:
        """Pick a replica and count the request as active on it."""
        with self._lock:
            if self.router is not None and prompt:
                idx = self.router.route(prompt, [r.active for r in self.replicas])
            else:
                idx = next(self._rr) % len(self.replicas)
            r = self.replicas[idx]
            r.active += 1
            return r

    def release(self, replica: Replica) -> None:
        with self._lock:
            replica.active = max(0, replica.active - 1)

    def stats(self) -> list[dict]:
        with self._lock:
            return [{"index": r.index, "active": r.active} for r in self.replicas]
