"""Prometheus metrics in the text exposition format (0.0.4).

Counterpart of ``blazr_tpu/server/metrics.py`` (reference
src/server/metrics.rs): the same metric names (``blazr_tpu_*``), help
strings, label names and histogram buckets. The JAX package renders them
with ``prometheus_client``, which the card's machine lacks, so this module
holds the few metric types the server needs (counters, labelled counters,
gauges, histograms) and renders them itself. It leaves out the
``*_created`` samples that ``prometheus_client`` adds.
"""

from __future__ import annotations

import math
from typing import Optional

PREFIX = "blazr_tpu"


def _num(v: float) -> str:
    """A sample value or ``le`` label as ``prometheus_client`` writes it."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    s = repr(v)
    dot = s.find(".")
    if v > 0 and dot > 6:                   # Go switches to exponents sooner
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_help(doc: str) -> str:
    return doc.replace("\\", r"\\").replace("\n", r"\n")


def _labels(pairs: tuple) -> str:
    if not pairs:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace("\n", r"\n")
                         .replace('"', r'\"'))
        for k, v in pairs)
    return "{" + body + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, doc: str):
        self.name = name
        self.doc = doc

    def header(self) -> list[str]:
        return [f"# HELP {self.name} {_escape_help(self.doc)}",
                f"# TYPE {self.name} {self.kind}"]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, doc: str):
        super().__init__(name, doc)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def lines(self) -> list[str]:
        return self.header() + [f"{self.name} {_num(self.value)}"]


class _CounterChild:
    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        self.value += amount


class Counter(_Metric):
    """A counter (``name`` ends in ``_total``); with ``labelnames`` a
    family of children made by ``labels``, rendered in creation order."""

    kind = "counter"

    def __init__(self, name: str, doc: str, labelnames: tuple = ()):
        super().__init__(name, doc)
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _CounterChild] = {}
        self._own = None if self.labelnames else _CounterChild()

    def labels(self, **kw) -> _CounterChild:
        key = tuple(str(kw[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _CounterChild()
        return child

    def inc(self, amount: float = 1.0) -> None:
        self._own.inc(amount)

    def set_total(self, total: float) -> None:
        """Mirror a count kept elsewhere (it never decreases there)."""
        self._own.value = float(total)

    def lines(self) -> list[str]:
        out = self.header()
        if self._own is not None:
            out.append(f"{self.name} {_num(self._own.value)}")
        for key, child in self._children.items():
            out.append(f"{self.name}{_labels(tuple(zip(self.labelnames, key)))} "
                       f"{_num(child.value)}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, doc: str, buckets: tuple):
        super().__init__(name, doc)
        self.bounds = tuple(float(b) for b in buckets) + (math.inf,)
        self.counts = [0] * len(self.bounds)          # not cumulative
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.sum += v
        for i, le in enumerate(self.bounds):
            if v <= le:
                self.counts[i] += 1
                break

    def lines(self) -> list[str]:
        out = self.header()
        acc = 0
        for le, n in zip(self.bounds, self.counts):
            acc += n
            out.append(f'{self.name}_bucket{{le="{_num(le)}"}} {_num(acc)}')
        out.append(f"{self.name}_count {_num(acc)}")
        out.append(f"{self.name}_sum {_num(self.sum)}")
        return out


class Metrics:
    """The JAX server's metric set, in its order."""

    def __init__(self) -> None:
        self._all: list[_Metric] = []

        def add(m):
            self._all.append(m)
            return m

        c = lambda name, doc, labelnames=(): add(Counter(f"{PREFIX}_{name}", doc,
                                                         labelnames))
        g = lambda name, doc: add(Gauge(f"{PREFIX}_{name}", doc))
        h = lambda name, doc, buckets: add(Histogram(f"{PREFIX}_{name}", doc, buckets))

        lat_buckets = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
        self.requests_total = c("requests_total", "Total requests",
                                labelnames=("endpoint", "status"))
        self.requests_active = g("requests_active", "In-flight requests")
        self.request_duration = h("request_duration_seconds",
                                  "End-to-end request latency", lat_buckets)
        self.tokens_prompted = c("tokens_prompted_total", "Prompt tokens")
        self.tokens_generated = c("tokens_generated_total", "Generated tokens")
        self.ttft = h("ttft_seconds", "Time to first token", lat_buckets)
        self.itl = h("itl_seconds", "Inter-token latency",
                     (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0))
        self.tokens_per_second = h("tokens_per_second", "Decode throughput",
                                   (1, 5, 10, 25, 50, 100, 200, 400, 800))
        self.models_loaded = g("models_loaded", "Loaded model count")
        self.model_loads = c("model_loads_total", "Model load events")
        self.model_evictions = c("model_evictions_total", "Model evictions")
        # Autoscaling signals (reference metrics.rs:72-83)
        self.queue_depth = g("queue_depth", "Waiting sequences (HPA signal)")
        self.active_decode_slots = g("active_decode_slots",
                                     "Running sequences (HPA signal)")
        self.token_budget_utilization = g(
            "token_budget_utilization",
            "In-flight token budget fraction (KEDA signal)")
        self.kv_block_utilization = g("kv_block_utilization",
                                      "KV cache block pool utilization")
        self.prefix_cache_hits = c("prefix_cache_hits_total", "Prefix cache hits")
        self.prefix_cache_misses = c("prefix_cache_misses_total",
                                     "Prefix cache misses")
        self.slo_violations = c("slo_violations_total", "SLO violations",
                                labelnames=("metric",))
        self.hbm_used_bytes = g("hbm_used_bytes", "Device memory in use")
        # Speculative-decode + horizon telemetry, refreshed from the
        # engine's counters at render time.
        self.spec_drafted = g("spec_drafted_total", "Speculative tokens drafted")
        self.spec_accepted = g("spec_accepted_total", "Speculative tokens accepted")
        self.spec_acceptance_rate = g("spec_acceptance_rate",
                                      "Draft acceptance fraction")
        self.spec_depth = g("spec_depth", "Current (adaptive) speculation depth")
        self.horizon_steps_per_dispatch = g(
            "horizon_steps_per_dispatch",
            "Mean decode steps fused per horizon dispatch")
        self.moe_tokens_dropped = g(
            "moe_ep_tokens_dropped_total",
            "MoE tokens dropped at expert capacity (EP dispatch)")

    def render(self) -> bytes:
        lines: list[str] = []
        for m in self._all:
            lines += m.lines()
        return ("\n".join(lines) + "\n").encode("utf-8")


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def refresh(metrics: Metrics, scheduler, engine: Optional[object]) -> None:
    """The render-time gauge refresh of the JAX ``metrics_handler``
    (``blazr_tpu/server/app.py:275-304``), plus what it declares and never
    sets: the prefix cache's hits and misses from ``PrefixCache.stats`` and
    the device memory in use."""
    metrics.models_loaded.set(scheduler.num_loaded)
    if engine is not None:
        st = engine.scheduler.stats()
        metrics.queue_depth.set(st["waiting"])
        metrics.active_decode_slots.set(st["running"])
        bs = st["block_stats"]
        if bs["total_blocks"]:
            metrics.kv_block_utilization.set(bs["allocated_blocks"] / bs["total_blocks"])
        # The port does not speculate, and has no expert-parallel dispatch:
        # those gauges stay 0.
        if engine.horizon_dispatches:
            metrics.horizon_steps_per_dispatch.set(
                engine.horizon_steps / engine.horizon_dispatches)
        pc = engine.prefix_cache
        if pc is not None:
            metrics.prefix_cache_hits.set_total(pc.stats.hits)
            metrics.prefix_cache_misses.set_total(pc.stats.misses)
    dev = scheduler.device
    if dev.type == "cuda":
        import torch

        metrics.hbm_used_bytes.set(torch.cuda.memory_allocated(dev))
