"""Cache-aware request router.

Counterpart of ``blazr_tpu/engine/cache_router.py``: an FNV-1a hash of the
prompt's first 512 characters (UTF-8) picks a sticky replica, so requests
that share a prefix land where their prefix cache is warm; when the sticky
replica holds more than ``overload_factor`` times the average load (and
more than one request), the least-loaded replica takes the request.
"""

from __future__ import annotations

PREFIX_CHARS = 512
FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3


def fnv1a(data: bytes) -> int:
    """64-bit FNV-1a."""
    h = FNV_OFFSET
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


class CacheAwareRouter:
    def __init__(self, num_replicas: int, overload_factor: float = 2.0):
        self.num_replicas = num_replicas
        self.overload_factor = overload_factor

    def route(self, prompt: str, loads: list[int]) -> int:
        """The replica for ``prompt`` given each replica's active count."""
        sticky = fnv1a(prompt[:PREFIX_CHARS].encode("utf-8")) % self.num_replicas
        if not loads:
            return sticky
        avg = sum(loads) / len(loads)
        if loads[sticky] <= max(1.0, avg * self.overload_factor):
            return sticky
        return min(range(len(loads)), key=lambda i: loads[i])
