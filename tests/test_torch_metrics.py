"""Port parity: blazr_tpu_torch's ``/metrics`` (its own text-format
renderer) and SLO tracker against blazr_tpu's (``prometheus_client``) on
the CPU.

The same recorded events give the same (name, labels) → value samples
(``prometheus_client``'s ``*_created`` samples aside), the same HELP and
TYPE lines, and the same SLO percentiles and violations. The port's server
answers ``/metrics`` without a key, counts what it served, and fills what
the JAX server declares and never sets (the prefix cache's hits and
misses, the device memory in use), a deviation these tests pin."""

import asyncio
import http.client
import json
import threading
import types

import numpy as np
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from blazr_tpu.config.server import LatencySlo as JSlo
from blazr_tpu.config.server import ServerConfig as JServerConfig
from blazr_tpu.server.app import STATE_KEY
from blazr_tpu.server.app import AppState as JAppState
from blazr_tpu.server.app import metrics_handler as jax_metrics_handler
from blazr_tpu.server.metrics import Metrics as JMetrics
from blazr_tpu.server.slo import SloTracker as JTracker
from blazr_tpu_torch.config.server import LatencySlo, ServerConfig
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
from blazr_tpu_torch.server import create_app, serve
from blazr_tpu_torch.server import metrics as port_metrics
from blazr_tpu_torch.server.metrics import Metrics
from blazr_tpu_torch.server.slo import SloTracker

from fixtures import write_byte_tokenizer_json, write_tiny_llama_checkpoint


def samples(text: str) -> dict:
    """(sample name, sorted labels) → value, parsed by prometheus_client."""
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def families(text: str) -> dict:
    return {f.name: (f.type, f.documentation) for f in text_string_to_metric_families(text)
            if not f.name.endswith("_created")}


def _record(m, rng):
    """Seeded events on any Metrics (the JAX one or the port's)."""
    for _ in range(int(rng.integers(1, 30))):
        r = rng.random()
        v = float(rng.choice([0.0005, 0.001, 0.0042, 0.05, 0.25, 1.0, 7.5, 61.0,
                              rng.exponential(0.3)]))
        if r < 0.15:
            m.requests_total.labels(endpoint=str(rng.choice(["chat", "completions"])),
                                    status="200").inc()
        elif r < 0.25:
            m.requests_active.inc()
        elif r < 0.3:
            m.requests_active.dec()
        elif r < 0.4:
            m.request_duration.observe(v)
        elif r < 0.5:
            m.tokens_prompted.inc(int(rng.integers(0, 500)))
            m.tokens_generated.inc(int(rng.integers(0, 64)))
        elif r < 0.6:
            m.ttft.observe(v)
        elif r < 0.7:
            m.itl.observe(v / 10)
        elif r < 0.75:
            m.tokens_per_second.observe(float(rng.integers(0, 1000)))
        elif r < 0.8:
            m.slo_violations.labels(metric=str(rng.choice(["ttft_p50", "itl_p99"]))).inc()
        else:
            for g in (m.queue_depth, m.active_decode_slots, m.kv_block_utilization,
                      m.token_budget_utilization, m.models_loaded,
                      m.horizon_steps_per_dispatch):
                g.set(float(rng.integers(0, 9)) / 3)


@pytest.mark.parametrize("seed", range(5))
def test_render_matches_prometheus_client(seed):
    jm, tm = JMetrics(), Metrics()
    _record(jm, np.random.default_rng(seed))
    _record(tm, np.random.default_rng(seed))
    jtext, ttext = jm.render().decode(), tm.render().decode()
    assert samples(ttext) == samples(jtext)
    assert families(ttext) == families(jtext)
    assert "_created" not in ttext


def test_render_of_a_fresh_registry_and_escapes():
    jtext, ttext = JMetrics().render().decode(), Metrics().render().decode()
    assert samples(ttext) == samples(jtext)
    names = [line.split()[2] for line in ttext.splitlines() if line.startswith("# TYPE")]
    assert names[0] == "blazr_tpu_requests_total" and len(names) == len(set(names)) == 25
    m = Metrics()
    m.slo_violations.labels(metric='a"b\\c\nd').inc(2)
    got = samples(m.render().decode())
    assert got[("blazr_tpu_slo_violations_total", (("metric", 'a"b\\c\nd'),))] == 2.0
    with pytest.raises(ValueError):
        m.tokens_generated.inc(-1)


@pytest.mark.parametrize("seed", range(3))
def test_slo_tracker_matches_jax(seed):
    rng = np.random.default_rng(seed)
    limits = dict(ttft_p50_ms=200.0, ttft_p99_ms=900.0, itl_p95_ms=40.0, e2e_p50_ms=3000.0)
    jm, tm = JMetrics(), Metrics()
    jt, tt = JTracker(JSlo(**limits), jm), SloTracker(LatencySlo(**limits), tm)
    for _ in range(300):
        kind = rng.integers(0, 3)
        v = float(rng.exponential([0.15, 0.02, 2.0][kind]))
        for t in (jt, tt):
            (t.record_ttft, t.record_itl, t.record_e2e)[kind](v)
    assert tt.snapshot() == jt.snapshot()
    assert tt.violations == jt.violations > 0
    assert samples(tm.render().decode()) == samples(jm.render().decode())


def test_rolling_window_keeps_the_last_1000():
    jt, tt = JTracker(), SloTracker()
    for i in range(2500):
        jt.record_ttft(i / 1000)
        tt.record_ttft(i / 1000)
    assert len(tt.ttft) == 1000
    assert tt.snapshot() == jt.snapshot()


def test_refresh_fills_prefix_and_device_memory(monkeypatch):
    """The gauges the JAX metrics_handler refreshes, and the pinned
    deviation: prefix-cache hits/misses from PrefixCache.stats and
    hbm_used_bytes from torch.cuda.memory_allocated, which the JAX server
    declares and never sets."""
    m = Metrics()
    engine = types.SimpleNamespace(
        scheduler=types.SimpleNamespace(stats=lambda: {
            "waiting": 3, "running": 5,
            "block_stats": {"total_blocks": 64, "allocated_blocks": 16}}),
        horizon_dispatches=4, horizon_steps=26,
        prefix_cache=types.SimpleNamespace(stats=types.SimpleNamespace(hits=7, misses=2)))
    sched = types.SimpleNamespace(num_loaded=1, device=torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 123456789)
    port_metrics.refresh(m, sched, engine)
    got = samples(m.render().decode())
    assert got[("blazr_tpu_queue_depth", ())] == 3
    assert got[("blazr_tpu_active_decode_slots", ())] == 5
    assert got[("blazr_tpu_kv_block_utilization", ())] == 0.25
    assert got[("blazr_tpu_horizon_steps_per_dispatch", ())] == 6.5
    assert got[("blazr_tpu_prefix_cache_hits_total", ())] == 7
    assert got[("blazr_tpu_prefix_cache_misses_total", ())] == 2
    assert got[("blazr_tpu_hbm_used_bytes", ())] == 123456789
    # The JAX handler refreshes the same gauges and leaves those at 0.
    jstate = JAppState(scheduler=sched, server_cfg=JServerConfig(), batch_engine=engine,
                       user_config=object())
    resp = asyncio.run(jax_metrics_handler(types.SimpleNamespace(app={STATE_KEY: jstate})))
    jgot = samples(resp.body.decode())
    for key in ("queue_depth", "active_decode_slots", "kv_block_utilization",
                "horizon_steps_per_dispatch"):
        assert jgot[(f"blazr_tpu_{key}", ())] == got[(f"blazr_tpu_{key}", ())]
    assert jgot[("blazr_tpu_prefix_cache_hits_total", ())] == 0
    assert jgot[("blazr_tpu_prefix_cache_misses_total", ())] == 0
    assert jgot[("blazr_tpu_hbm_used_bytes", ())] == 0


# ---------------------------------------------------------------------------
# the server's /metrics
# ---------------------------------------------------------------------------

CHAT = {"messages": [{"role": "system", "content": "you are a terse assistant " * 4},
                     {"role": "user", "content": "hello there"}],
        "max_tokens": 6, "temperature": 0}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_metrics_model")
    write_tiny_llama_checkpoint(path, np.random.default_rng(78))
    write_byte_tokenizer_json(path)
    return path


class _Server:
    def __init__(self, model_dir, **cfg):
        sched = ModelScheduler(model_dir, dtype="f32", device="cpu")
        ex = sched.get_executor("default")
        ex.app_cfg.inference.prefix_cache = True
        ex.app_cfg.inference.block_size = 16
        self.engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
        self.app = create_app(sched, ServerConfig(**cfg), batch_engine=self.engine)
        self.loop = asyncio.new_event_loop()
        self.stop = asyncio.Event()
        self.ready = threading.Event()

    def __enter__(self):
        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(serve(self.app, "127.0.0.1", 0, stop=self.stop,
                                               started=self._started))
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert self.ready.wait(30)
        return self

    def _started(self, port):
        self.port = port
        self.ready.set()

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.stop.set)
        self.thread.join(30)
        assert not self.thread.is_alive()

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, dict(resp.getheaders()), data


def test_server_metrics_count_what_was_served(model_dir):
    """Unauthenticated /metrics in the text format; the non-streamed and
    streamed chats' tokens (a streamed request is counted too: a pinned
    deviation), one TTFT a stream, requests by endpoint, and the prefix
    cache's hits once the same chat comes back."""
    auth = {"Authorization": "Bearer k"}
    with _Server(model_dir, api_keys=["k"]) as srv:
        st, headers, data = srv.request("GET", "/metrics")
        assert st == 200 and headers["Content-Type"].startswith("text/plain")
        assert samples(data.decode())[("blazr_tpu_requests_active", ())] == 0
        usage = [json.loads(srv.request("POST", "/v1/chat/completions", CHAT, auth)[2])
                 ["usage"] for _ in range(2)]
        st, _, data = srv.request("POST", "/v1/chat/completions",
                                  dict(CHAT, stream=True), auth)
        assert st == 200
        streamed = [json.loads(line[6:]) for line in data.decode().splitlines()
                    if line.startswith("data: {")]
        n_stream = streamed[-1]["usage"]["completion_tokens"]
        st, _, data = srv.request("GET", "/metrics")
        got = samples(data.decode())
        pc = srv.engine.prefix_cache.stats
    prompted = sum(u["prompt_tokens"] for u in usage)
    generated = sum(u["completion_tokens"] for u in usage)
    assert got[("blazr_tpu_tokens_prompted_total", ())] == prompted + usage[0]["prompt_tokens"]
    # The stream's usage counts its content deltas; an EOS token is generated too.
    assert got[("blazr_tpu_tokens_generated_total", ())] - generated in (n_stream,
                                                                          n_stream + 1)
    assert got[("blazr_tpu_requests_total", (("endpoint", "chat"), ("status", "200")))] == 3
    assert got[("blazr_tpu_request_duration_seconds_count", ())] == 3
    assert got[("blazr_tpu_ttft_seconds_count", ())] == 1
    assert got[("blazr_tpu_requests_active", ())] == 0
    assert got[("blazr_tpu_models_loaded", ())] == 1
    assert pc.hits > 0
    assert got[("blazr_tpu_prefix_cache_hits_total", ())] == pc.hits
    assert got[("blazr_tpu_prefix_cache_misses_total", ())] == pc.misses
    assert got[("blazr_tpu_hbm_used_bytes", ())] == 0          # no card here


MESSAGES = {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 6,
            "temperature": 0}


def test_streamed_messages_are_counted(model_dir, tmp_path, monkeypatch):
    """``/v1/messages``: the JAX server counts a non-streamed reply's tokens
    and e2e latency only; the port counts a streamed reply too, with its
    TTFT, as it does a streamed chat (a pinned deviation, ROADMAP §C)."""
    from aiohttp.test_utils import TestClient, TestServer

    from blazr_tpu.engine.model_scheduler import ModelScheduler as JScheduler
    from blazr_tpu.server import create_app as jax_create_app

    monkeypatch.setenv("BLAZR_TPU_HOME", str(tmp_path))
    with _Server(model_dir) as srv:
        plain = json.loads(srv.request("POST", "/v1/messages", MESSAGES)[2])
        st, _, data = srv.request("POST", "/v1/messages", dict(MESSAGES, stream=True))
        assert st == 200
        delta = [json.loads(line[6:]) for line in data.decode().splitlines()
                 if line.startswith("data: ") and '"message_delta"' in line][0]
        got = samples(srv.request("GET", "/metrics")[2].decode())
        e2e = len(srv.app.state.slo.e2e)

    async def jax_main():
        app = jax_create_app(JScheduler(model_dir, dtype="f32"), JServerConfig())
        async with TestClient(TestServer(app)) as c:
            await (await c.post("/v1/messages", json=MESSAGES)).read()
            await (await c.post("/v1/messages", json=dict(MESSAGES, stream=True))).read()
            text = await (await c.get("/metrics")).text()
            return text, len(app[STATE_KEY].slo.e2e)

    jtext, je2e = asyncio.run(jax_main())
    jgot = samples(jtext)
    n_in, n_out = plain["usage"]["input_tokens"], plain["usage"]["output_tokens"]
    assert delta["usage"]["output_tokens"] == n_out
    assert got[("blazr_tpu_tokens_prompted_total", ())] == 2 * n_in
    assert got[("blazr_tpu_tokens_generated_total", ())] == 2 * n_out
    assert got[("blazr_tpu_ttft_seconds_count", ())] == 1 and e2e == 2
    assert jgot[("blazr_tpu_tokens_prompted_total", ())] == n_in
    assert jgot[("blazr_tpu_tokens_generated_total", ())] == n_out
    assert jgot[("blazr_tpu_ttft_seconds_count", ())] == 0 and je2e == 1
    # Neither counts the messages route in requests_total.
    for g in (got, jgot):
        assert not any(k[0] == "blazr_tpu_requests_total" for k in g)
        assert g[("blazr_tpu_requests_active", ())] == 0
