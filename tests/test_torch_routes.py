"""Port parity: the routes of the JAX ``create_app`` that the port's stdlib
server took over from its 501s: Anthropic ``/v1/messages`` (plain and
streamed) and ``count_tokens``, ``/v1/responses``, ``/v1/infill``,
``/v1/embeddings``, ``/rerank``, chats with ``tools``, the audio stubs, the
slots and the Ollama-style management routes, ``/api/pull``, TLS and the
user config's hot reload.

Each route gets the same body on the port's server (CPU, f32, in a thread)
and on the JAX package's aiohttp server (``TestServer``) over the same tiny
checkpoint. Ids, timestamps and ``created`` differ; everything else must
agree: token ids, counts and greedy texts exactly, embedding and rerank
vectors to 1e-5 relative. Where the JAX handler is at fault, the test pins
the port's answer beside the JAX one (ROADMAP §C)."""

import asyncio
import base64
import http.client
import json
import os
import shutil
import ssl
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from blazr_tpu.config import ServerConfig as JaxServerConfig
from blazr_tpu.engine.model_scheduler import ModelScheduler as JaxScheduler
from blazr_tpu.server import create_app as jax_create_app
from blazr_tpu_torch.config.server import ServerConfig
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
from blazr_tpu_torch.server import create_app, serve

from fixtures import write_byte_tokenizer_json, write_tiny_llama_checkpoint

REPO = Path(__file__).resolve().parent.parent
ENGINES = pytest.mark.parametrize("engine", [False, True], ids=["executor", "batch_engine"])
MESSAGES = {"system": "be brief",
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "hello there, "},
                {"type": "text", "text": "tiny model"}]}],
            "max_tokens": 12, "temperature": 0}
FIM = ("<fim_prefix>", "<fim_suffix>", "<fim_middle>")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_routes_model")
    write_tiny_llama_checkpoint(path, np.random.default_rng(91))
    write_byte_tokenizer_json(path)
    return path


@pytest.fixture(scope="module")
def fim_dir(tmp_path_factory):
    """A tiny model whose tokenizer has the FIM special tokens (ids 257-259)."""
    path = tmp_path_factory.mktemp("port_routes_fim")
    write_tiny_llama_checkpoint(path, np.random.default_rng(92), {"vocab_size": 264})
    write_byte_tokenizer_json(path)
    tok = json.loads((path / "tokenizer.json").read_text())
    tok["added_tokens"] += [{"id": 257 + i, "content": t, "special": True}
                            for i, t in enumerate(FIM)]
    (path / "tokenizer.json").write_text(json.dumps(tok))
    return path


@pytest.fixture(autouse=True)
def _user_home(tmp_path, monkeypatch):
    """A user config directory of the test's own (both servers read it)."""
    monkeypatch.setenv("BLAZR_TPU_HOME", str(tmp_path / "home"))


class PortServer:
    """The port's server on a free port in a background thread."""

    def __init__(self, model_dir, engine: bool = False, **cfg):
        self.sched = ModelScheduler(model_dir, dtype="f32", device="cpu")
        self.engine = None
        if engine:
            ex = self.sched.get_executor("default")
            self.engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
        self.app = create_app(self.sched, ServerConfig(**cfg), batch_engine=self.engine)
        self.tls = bool(cfg.get("tls_cert"))
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

    def connection(self):
        if self.tls:
            return http.client.HTTPSConnection(
                "127.0.0.1", self.port, timeout=120,
                context=ssl._create_unverified_context())
        return http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)

    def request(self, method, path, body=None):
        conn = self.connection()
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, dict(resp.getheaders()), data

    def json(self, method, path, body=None):
        st, _, data = self.request(method, path, body)
        return st, json.loads(data)


def _jax(model_dir, requests):
    """Replies (status, bytes, content type) of the JAX server to
    ``requests`` [(method, path, body)], in order."""
    async def main():
        app = jax_create_app(JaxScheduler(model_dir, dtype="f32"), JaxServerConfig())
        out = []
        async with TestClient(TestServer(app)) as c:
            for method, path, body in requests:
                r = await c.request(method, path, json=body)
                out.append((r.status, await r.read(), r.headers.get("Content-Type", "")))
        return out
    return asyncio.run(main())


def _jax_json(model_dir, requests):
    return [(st, json.loads(data)) for st, data, _ in _jax(model_dir, requests)]


def _masked(obj, keys=("id", "created", "created_at")):
    """``obj`` without the keys that differ between any two runs: ``keys``
    and the timings (``*_ms``, ``*_per_second``)."""
    if isinstance(obj, dict):
        return {k: ("*" if k in keys or k.endswith(("_ms", "_per_second")) else
                    _masked(v, keys)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_masked(v, keys) for v in obj]
    return obj


def _events(data: bytes) -> list:
    """(event name, data) of an ``event:``/``data:`` stream."""
    out = []
    for block in data.decode().split("\n\n"):
        if not block.strip():
            continue
        lines = dict(line.split(": ", 1) for line in block.splitlines())
        out.append((lines["event"], json.loads(lines["data"])))
    return out


ANTHROPIC_ORDER = ["message_start", "content_block_start", "content_block_stop",
                   "message_delta", "message_stop"]


# ---------------------------------------------------------------------------
# /v1/messages, count_tokens
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_messages(model_dir):
    return _jax(model_dir, [
        ("POST", "/v1/messages", MESSAGES),
        ("POST", "/v1/messages/count_tokens", MESSAGES),
        ("POST", "/v1/messages", dict(MESSAGES, stream=True)),
        ("POST", "/v1/messages", dict(MESSAGES, max_tokens=None)),
        ("POST", "/v1/messages", {"max_tokens": 4, "messages": []})])


@ENGINES
def test_messages_match_jax(model_dir, jax_messages, engine):
    with PortServer(model_dir, engine=engine) as srv:
        got = [srv.json("POST", "/v1/messages", MESSAGES),
               srv.json("POST", "/v1/messages/count_tokens", MESSAGES),
               srv.json("POST", "/v1/messages", dict(MESSAGES, max_tokens=None)),
               srv.json("POST", "/v1/messages", {"max_tokens": 4, "messages": []})]
    ref = [(st, json.loads(data)) for st, data, _ in
           [jax_messages[i] for i in (0, 1, 3, 4)]]
    assert got[0][0] == 200 and _masked(got[0][1]) == _masked(ref[0][1])
    assert got[0][1]["usage"]["output_tokens"] > 0 and got[0][1]["content"][0]["text"]
    assert got[1] == ref[1] and got[1][1]["input_tokens"] == got[0][1]["usage"]["input_tokens"]
    assert got[2] == ref[2] and got[2][0] == 400
    assert got[3] == ref[3] and got[3][0] == 400


@ENGINES
def test_messages_stream_events(model_dir, jax_messages, engine):
    """The Anthropic event order, ``event:`` lines, deltas that concatenate
    to the plain reply, JAX's events but for ids."""
    with PortServer(model_dir, engine=engine) as srv:
        _, plain = srv.json("POST", "/v1/messages", MESSAGES)
        st, headers, data = srv.request("POST", "/v1/messages", dict(MESSAGES, stream=True))
    assert st == 200 and headers["Content-Type"] == "text/event-stream"
    events = _events(data)
    names = [n for n, _ in events]
    assert [n for n in names if n != "content_block_delta"] == ANTHROPIC_ORDER
    assert names[2:-3] == ["content_block_delta"] * (len(names) - 5)
    assert all(d["type"] == n for n, d in events)
    text = "".join(d["delta"]["text"] for n, d in events if n == "content_block_delta")
    assert text == plain["content"][0]["text"]
    delta = events[-2][1]
    assert delta["delta"]["stop_reason"] == plain["stop_reason"]
    assert delta["usage"]["output_tokens"] == plain["usage"]["output_tokens"]
    assert events[0][1]["message"]["usage"]["input_tokens"] == plain["usage"]["input_tokens"]
    st, jdata, jtype = jax_messages[2]
    assert st == 200 and jtype.startswith("text/event-stream")
    jevents = _events(jdata)
    assert _masked(jevents[:-2]) == _masked(events[:-2])
    # The JAX Executor path counts one more output token than it generated
    # when the reply stops at max_tokens (ROADMAP §C): its stream counts
    # every item of stream_generation, the closing one too.
    jcount = jevents[-2][1]["usage"]["output_tokens"]
    assert jcount == delta["usage"]["output_tokens"] + (plain["stop_reason"] == "max_tokens")
    assert jevents[-1] == events[-1]


def test_messages_disconnect_cancels_the_engine_sequence(model_dir):
    """A client gone after the first events: the stream cancels its engine
    sequence, which leaves the engine."""
    import socket

    with PortServer(model_dir, engine=True) as srv:
        eng = srv.engine
        cancelled, cancel = [], eng.cancel
        eng.cancel = lambda seq_id: (cancelled.append(seq_id), cancel(seq_id))[1]
        body = json.dumps(dict(MESSAGES, stream=True, max_tokens=400)).encode()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        sock.sendall(b"POST /v1/messages HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"application/json\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
        seen = b""
        while b"event: content_block_start" not in seen:
            seen += sock.recv(4096)
        assert seen.startswith(b"HTTP/1.1 200")
        sock.close()
        for _ in range(400):
            st = eng.scheduler.stats()
            if cancelled and st["running"] == 0 and st["waiting"] == 0:
                break
            threading.Event().wait(0.05)
        assert len(cancelled) == 1 and eng.scheduler.stats()["running"] == 0
        # The engine serves the next request.
        assert srv.json("POST", "/v1/messages", MESSAGES)[0] == 200


# ---------------------------------------------------------------------------
# /v1/responses, /v1/infill
# ---------------------------------------------------------------------------

RESPONSES = [
    {"input": "hello", "max_output_tokens": 6, "temperature": 0},
    {"instructions": "be brief", "max_output_tokens": 5, "temperature": 0,
     "input": [{"type": "message", "role": "user",
                "content": [{"type": "input_text", "text": "hi"}]},
               {"type": "function_call", "name": "x"}]},
    {"input": "hello", "stream": True},
    {},
    {"input": [{"type": "message", "role": "system", "content": "sys"}]},
    {"input": "hello", "temperature": 9},
]


@ENGINES
def test_responses_match_jax(model_dir, engine):
    ref = _jax_json(model_dir, [("POST", "/v1/responses", b) for b in RESPONSES])
    with PortServer(model_dir, engine=engine) as srv:
        got = [srv.json("POST", "/v1/responses", b) for b in RESPONSES]
    assert [g[0] for g in got] == [r[0] for r in ref] == [200, 200, 400, 400, 400, 400]
    for g, r in zip(got, ref):
        assert _masked(g[1]) == _masked(r[1])
    assert got[0][1]["output_text"] and got[0][1]["usage"]["output_tokens"] == 6


def test_responses_chat_and_messages_agree(model_dir):
    """Served alone, the three generating APIs give one greedy reply for
    one conversation."""
    with PortServer(model_dir, engine=True) as srv:
        _, chat = srv.json("POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello"}], "max_tokens": 6,
            "temperature": 0})
        _, msg = srv.json("POST", "/v1/messages", {
            "messages": [{"role": "user", "content": "hello"}], "max_tokens": 6,
            "temperature": 0})
        _, resp = srv.json("POST", "/v1/responses", RESPONSES[0])
    text = chat["choices"][0]["message"]["content"]
    assert msg["content"][0]["text"] == resp["output_text"] == text
    assert (msg["usage"]["input_tokens"], msg["usage"]["output_tokens"]) == \
        (chat["usage"]["prompt_tokens"], chat["usage"]["completion_tokens"])


INFILL = [{"input_prefix": "def add(a, b):\n    ", "input_suffix": "\n    return r",
           "max_tokens": 5, "temperature": 0},
          {"prefix": "x = ", "max_tokens": 3, "temperature": 0},
          {}]


@pytest.mark.parametrize("vocab", ["fim_tokens", "no_fim_tokens"])
def test_infill_matches_jax(model_dir, fim_dir, vocab):
    path = fim_dir if vocab == "fim_tokens" else model_dir
    ref = _jax_json(path, [("POST", "/v1/infill", b) for b in INFILL])
    with PortServer(path) as srv:
        got = [srv.json("POST", "/v1/infill", b) for b in INFILL]
        st, ids = srv.json("POST", "/tokenize", {"content": INFILL[0]["input_prefix"]})
    assert [g[0] for g in got] == [r[0] for r in ref] == [200, 200, 400]
    for g, r in zip(got, ref):
        assert _masked(g[1]) == _masked(r[1])
    prompt = got[0][1]["usage"]["prompt_tokens"]
    if vocab == "fim_tokens":           # <PRE> prefix <SUF> suffix <MID>
        assert prompt == ids["count"] + len("\n    return r") + 3
    else:                               # the prefix alone
        assert prompt == ids["count"]


# ---------------------------------------------------------------------------
# /v1/embeddings, /rerank
# ---------------------------------------------------------------------------

def _vectors(reply: dict) -> list:
    out = []
    for d in reply["data"]:
        e = d["embedding"]
        out.append(np.frombuffer(base64.b64decode(e), np.float32) if isinstance(e, str)
                   else np.asarray(e, np.float32))
    return out


EMBEDDINGS = [dict(input=["hello there", "x"], pooling=p) for p in ("mean", "cls", "last")]
EMBEDDINGS += [dict(input="hello there", encoding_format="base64", normalize=False),
               dict(input=[104, 105, 33]), dict(input=[[104, 105], [33]], pooling="last"),
               dict(input=""), dict(input=[]), dict(input="a", pooling="max"),
               dict(input="a", encoding_format="int8"), dict()]


def test_embeddings_match_jax(model_dir):
    ref = _jax_json(model_dir, [("POST", "/v1/embeddings", b) for b in EMBEDDINGS])
    with PortServer(model_dir) as srv:
        got = [srv.json("POST", "/v1/embeddings", b) for b in EMBEDDINGS]
    assert [g[0] for g in got] == [r[0] for r in ref] == [200] * 6 + [400] * 5
    for (_, g), (_, r), body in zip(got, ref, EMBEDDINGS):
        if "data" not in r:
            assert g == r
            continue
        assert {k: v for k, v in g.items() if k != "data"} == \
            {k: v for k, v in r.items() if k != "data"}
        assert [{k: v for k, v in d.items() if k != "embedding"} for d in g["data"]] == \
            [{k: v for k, v in d.items() if k != "embedding"} for d in r["data"]]
        for a, b in zip(_vectors(g), _vectors(r)):
            assert a.shape == b.shape == (64,)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
            if body.get("normalize", True):
                assert abs(np.linalg.norm(a) - 1.0) < 1e-5


def test_embeddings_are_the_scaled_embedding_rows(model_dir):
    """``get_embeddings`` is the model's token-embedding rows: the pooled
    vector of ids [104, 105] is the mean of those two rows."""
    sched = ModelScheduler(model_dir, dtype="f32", device="cpu")
    ex = sched.get_executor("default")
    rows = ex.get_embeddings([104, 105])
    table = ex.model.params["embed"].numpy()
    np.testing.assert_array_equal(rows, table[[104, 105]])
    assert rows.dtype == np.float32 and rows.shape == (2, 64)


def test_gguf_embeddings_match_jax(tmp_path):
    """A GGUF file's quantized (Q4_K) token_embd: the pooled vectors of the
    two packages' Executors agree to 1e-5 relative."""
    from blazr_tpu.engine.executor import Executor as JaxExecutor
    from blazr_tpu.loader import load_model as jax_load_model
    from blazr_tpu.server.pooling import pool as jax_pool
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.server.pooling import pool
    from blazr_tpu_torch.utils.synthetic import tiny_llama_config, write_gguf_checkpoint

    cfg = tiny_llama_config(vocab=320)
    cfg.hidden_size, cfg.intermediate_size = 256, 512
    cfg.attention.head_dim = 64
    kinds = write_gguf_checkpoint(tmp_path / "m.gguf", cfg, "Q4_K_M", llama_cpp_qk=False)
    assert kinds["token_embd.weight"] == "Q4_K"
    model, app_cfg = load_model(tmp_path / "m.gguf", dtype="f32", device="cpu")
    jmodel, japp = jax_load_model(tmp_path / "m.gguf", dtype="f32")
    ids = [1, 17, 99, 250, 319]
    got = Executor(model, None, app_cfg).get_embeddings(ids)
    ref = JaxExecutor(jmodel, None, japp).get_embeddings(ids)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for strategy in ("mean", "cls", "last"):
        np.testing.assert_allclose(pool(got, strategy), jax_pool(ref, strategy), rtol=1e-5)


RERANK = [{"query": "apple fruit", "documents": ["apple pie recipe", "quantum field theory",
                                                 {"text": "apple fruit nutrition"}, ""],
           "top_n": 3},
          {"query": "q", "documents": ["a"], "return_documents": False},
          {"query": "q"}, {"query": "", "documents": ["a"]}]


@pytest.mark.parametrize("path", ["/rerank", "/v1/rerank"])
def test_rerank_matches_jax(model_dir, path):
    ref = _jax_json(model_dir, [("POST", path, b) for b in RERANK])
    with PortServer(model_dir) as srv:
        got = [srv.json("POST", path, b) for b in RERANK]
    assert [g[0] for g in got] == [r[0] for r in ref] == [200, 200, 400, 400]
    for (_, g), (_, r) in zip(got[:2], ref[:2]):
        assert [x["index"] for x in g["results"]] == [x["index"] for x in r["results"]]
        assert [x.get("document") for x in g["results"]] == \
            [x.get("document") for x in r["results"]]
        np.testing.assert_allclose([x["relevance_score"] for x in g["results"]],
                                   [x["relevance_score"] for x in r["results"]], rtol=1e-5)
    assert len(got[0][1]["results"]) == 3 and got[2] == ref[2] and got[3] == ref[3]


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------

TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "the weather in a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]
TOOL_CHAT = {"messages": [{"role": "system", "content": "be brief"},
                          {"role": "user", "content": "weather in Paris?"}],
             "tools": TOOLS, "max_tokens": 8, "temperature": 0}


def test_chat_with_tools_matches_jax(model_dir):
    """The tools system prompt (``/apply-template``) and a chat with tools
    whose greedy reply, on random weights, is text and no tool call."""
    no_system = dict(TOOL_CHAT, messages=TOOL_CHAT["messages"][1:])
    reqs = [("POST", "/apply-template", TOOL_CHAT), ("POST", "/apply-template", no_system),
            ("POST", "/v1/chat/completions", TOOL_CHAT)]
    ref = _jax_json(model_dir, reqs)
    with PortServer(model_dir, engine=True) as srv:
        got = [srv.json(*r) for r in reqs]
    assert got[0] == ref[0] and got[1] == ref[1]
    assert "get_weather" in got[0][1]["prompt"] and "be brief" in got[0][1]["prompt"]
    assert got[2][0] == ref[2][0] == 200
    assert _masked(got[2][1]) == _masked(ref[2][1])


@pytest.fixture
def canned_reply(monkeypatch):
    """Every generation of both servers returns ``text`` (a tool call)."""
    from blazr_tpu.engine.types import FinishReason as JFin
    from blazr_tpu.engine.types import GenerationResult as JRes
    from blazr_tpu.server import app as jax_app
    from blazr_tpu_torch.engine.types import FinishReason, GenerationResult
    from blazr_tpu_torch.server import app as port_app

    text = 'Sure. ```json\n{"name": "get_weather", "arguments": {"city": "Paris"}}\n```'

    def port(executor, ids, cfg, *a):
        return GenerationResult(text=text, tokens=[1, 2], finish_reason=FinishReason.EOS,
                                prompt_tokens=len(ids), completion_tokens=2)

    def jax(executor, ids, cfg, *a):
        return JRes(text=text, tokens=[1, 2], finish_reason=JFin.EOS,
                    prompt_tokens=len(ids), completion_tokens=2)

    monkeypatch.setattr(port_app, "collect_generation", port)
    monkeypatch.setattr(jax_app, "collect_generation", jax)


def test_tool_call_reply_matches_jax(model_dir, canned_reply):
    """A reply that holds a tool call: content null, the call with its
    arguments as a JSON string, finish_reason "tool_calls"."""
    body = dict(TOOL_CHAT, n=2)
    (jst, ref), = _jax_json(model_dir, [("POST", "/v1/chat/completions", body)])
    with PortServer(model_dir) as srv:
        st, got = srv.json("POST", "/v1/chat/completions", body)
        _, plain = srv.json("POST", "/v1/chat/completions", dict(TOOL_CHAT, tools=None))
    assert st == jst == 200
    assert _masked(got) == _masked(ref)
    for choice in got["choices"]:
        assert choice["finish_reason"] == "tool_calls"
        assert choice["message"]["content"] is None
        call, = choice["message"]["tool_calls"]
        assert call["id"].startswith("call_") and call["type"] == "function"
        assert call["function"] == {"name": "get_weather", "arguments": '{"city": "Paris"}'}
    assert plain["choices"][0]["finish_reason"] == "stop"
    assert "tool_calls" not in plain["choices"][0]["message"]


# ---------------------------------------------------------------------------
# audio stubs, slots, lora
# ---------------------------------------------------------------------------

def test_audio_stubs_and_lora_routes(model_dir):
    """The audio routes answer the JAX stubs' 501 bodies; the LoRA routes
    answer as the JAX ones do with nothing loaded: a path that is not an
    adapter 400, an empty listing, an unknown name's DELETE 404 (their
    served path: tests/test_torch_lora.py)."""
    reqs = [("POST", "/v1/audio/speech", {"input": "hi"}),
            ("POST", "/v1/audio/transcriptions", {}),
            ("POST", "/v1/lora", {"path": "x"}), ("GET", "/v1/lora", None),
            ("DELETE", "/v1/lora/a", None)]
    ref = _jax_json(model_dir, reqs)
    with PortServer(model_dir) as srv:
        got = [srv.json(*r) for r in reqs]
    assert [g[0] for g in got] == [g[0] for g in ref] == [501, 501, 400, 200, 404]
    assert got[:2] == ref[:2] and got[3] == ref[3] == (200, {"adapters": []})
    assert got[0][1]["error"]["type"] == "not_implemented_error"
    assert got[4][1]["error"]["type"] == ref[4][1]["error"]["type"] == "not_found_error"


async def _slots_script(call):
    """Create a slot, a completion with its id_slot, list, delete twice,
    list; the replies with ids and times masked, and the completion's usage."""
    out = [await call("POST", "/api/slots", {"model": "m1"})]
    sid = out[0][1]["id"]
    _, comp = await call("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 3,
                                                     "temperature": 0, "id_slot": sid})
    for method, path in (("GET", "/api/slots"), ("DELETE", f"/api/slots/{sid}"),
                         ("DELETE", f"/api/slots/{sid}"), ("GET", "/api/slots")):
        out.append(await call(method, path, None))
    return _masked(out, ("id", "created_at", "last_access", "deleted", "message")), \
        comp["usage"]


def test_slots_lifecycle_matches_jax(model_dir):
    async def jax_main():
        app = jax_create_app(JaxScheduler(model_dir, dtype="f32"), JaxServerConfig())
        async with TestClient(TestServer(app)) as c:
            async def call(method, path, body):
                r = await c.request(method, path, json=body)
                return r.status, await r.json()
            return await _slots_script(call)

    ref, _ = asyncio.run(jax_main())
    with PortServer(model_dir) as srv:
        async def call(method, path, body):
            return await asyncio.to_thread(srv.json, method, path, body)
        got, usage = asyncio.run(_slots_script(call))
    assert got == ref
    assert [st for st, _ in got] == [201, 200, 200, 404, 200] and got[4][1] == {"slots": []}
    assert got[0][1] == {"id": "*", "model": "m1", "created_at": "*", "last_access": "*",
                         "prompt_tokens": 0, "generated_tokens": 0}
    slot, = got[1][1]["slots"]
    assert (slot["prompt_tokens"], slot["generated_tokens"]) == \
        (usage["prompt_tokens"], usage["completion_tokens"])


# ---------------------------------------------------------------------------
# management: tags, ps, show, copy, delete, pull
# ---------------------------------------------------------------------------

@pytest.fixture
def models_root(tmp_path, model_dir):
    root = tmp_path / "models"
    root.mkdir()
    shutil.copytree(model_dir, root / "alpha")
    (root / "notes").mkdir()                                 # not a model
    return root


MANAGEMENT = [("GET", "/api/tags", None), ("GET", "/api/ps", None),
              ("POST", "/api/show", {"name": "alpha"}), ("GET", "/api/ps", None),
              ("POST", "/api/copy", {"source": "alpha", "destination": "beta"}),
              ("POST", "/api/copy", {"source": "alpha", "destination": "beta"}),
              ("POST", "/api/copy", {"source": "nope", "destination": "gamma"}),
              ("POST", "/api/copy", {"source": "alpha", "destination": "a/b"}),
              ("POST", "/api/copy", {"source": "alpha"}),
              ("GET", "/api/tags", None),
              ("DELETE", "/api/delete", {"name": "alpha"}),
              ("DELETE", "/api/delete", {"name": "alpha"}),
              ("DELETE", "/api/delete", {}),
              ("GET", "/api/ps", None)]


def _mask_mgmt(replies):
    return [(st, _masked(body, ("modified_at", "expires_at"))) for st, body in replies]


def test_management_routes_match_jax(models_root, tmp_path):
    """The management routes on a models root, the same calls in order on
    both servers (each on its own copy of the root)."""
    jroot = tmp_path / "jax_models"
    shutil.copytree(models_root, jroot)
    ref = _mask_mgmt(_jax_json(jroot, MANAGEMENT))
    with PortServer(models_root) as srv:
        got = _mask_mgmt([srv.json(*r) for r in MANAGEMENT])
    assert got == ref
    assert [st for st, _ in got] == [200, 200, 200, 200, 200, 409, 404, 400, 400, 200,
                                     200, 200, 400, 200]
    tags = got[9][1]["models"]
    assert [m["name"] for m in tags] == ["alpha", "beta"] and tags[0]["size"] > 0
    assert tags[0]["size"] == sum(f.stat().st_size for f in (models_root / "alpha").iterdir())
    assert got[3][1]["models"][0]["name"] == "alpha"
    assert got[10][1] == {"unloaded": True} and got[11][1] == {"unloaded": False}
    assert got[13][1] == {"models": []}
    assert got[2][1]["model_info"]["num_kv_heads"] == 2
    assert (models_root / "beta" / "config.json").exists()


def test_management_routes_where_jax_is_at_fault(model_dir, models_root):
    """Pinned deviations (ROADMAP §C): ``/api/tags`` of a server whose model
    dir is the model reports its size and mtime (JAX: 0 and null), and
    ``/api/show`` of a model that is not there answers 404 (JAX: 500)."""
    (jst, jtags), = _jax_json(model_dir, [("GET", "/api/tags", None)])
    (sst, _), = _jax_json(models_root, [("POST", "/api/show", {"name": "nope"})])
    with PortServer(model_dir) as srv:
        st, tags = srv.json("GET", "/api/tags")
    with PortServer(models_root) as srv:
        show = srv.json("POST", "/api/show", {"name": "nope"})
    size = sum(f.stat().st_size for f in model_dir.iterdir())
    assert jtags["models"][0]["size"] == 0 and jtags["models"][0]["modified_at"] is None
    entry, = tags["models"]
    assert entry["name"] == model_dir.name and entry["size"] == size
    assert entry["modified_at"].endswith("Z")
    assert sst == 500 and show[0] == 404 and show[1]["error"]["type"] == "not_found_error"


def _pull_lines(data: bytes) -> list:
    return [json.loads(line) for line in data.decode().splitlines()]


@pytest.mark.parametrize("hub", ["missing", "stub", "failing"])
def test_api_pull_matches_jax(model_dir, tmp_path, monkeypatch, hub):
    """NDJSON status lines: without ``huggingface_hub`` the JAX error line;
    with a local stub (no network) the success line, or the failure line."""
    calls = []
    if hub == "missing":
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    else:
        def snapshot_download(repo_id, local_dir, allow_patterns, revision=None):
            calls.append((repo_id, Path(local_dir), tuple(allow_patterns)))
            if hub == "failing":
                raise OSError("no network")
            Path(local_dir).mkdir(parents=True, exist_ok=True)
            (Path(local_dir) / "config.json").write_text("{}")
        monkeypatch.setitem(sys.modules, "huggingface_hub",
                            types.SimpleNamespace(snapshot_download=snapshot_download))
    root = tmp_path / "root"
    root.mkdir()
    body = {"name": "org/some-model"}
    (jst, jdata, jtype), bad = _jax(root, [("POST", "/api/pull", body),
                                           ("POST", "/api/pull", {})])
    with PortServer(root) as srv:
        st, headers, data = srv.request("POST", "/api/pull", body)
        missing = srv.json("POST", "/api/pull", {})
    assert st == jst == 200
    assert headers["Content-Type"] == "application/x-ndjson" and jtype == "application/x-ndjson"
    lines = _pull_lines(data)
    assert lines == _pull_lines(jdata)
    assert lines[0] == {"status": "pulling manifest for org/some-model"}
    last = {"missing": {"error": "huggingface_hub is not installed"},
            "stub": {"status": "success", "path": str(root / "some-model")},
            "failing": {"error": "pull failed: no network"}}[hub]
    assert lines[-1] == last
    assert missing[0] == bad[0] == 400
    if hub != "missing":
        assert calls == [("org/some-model", root / "some-model",
                          ("*.safetensors", "*.json", "*.gguf", "*.model"))] * 2


# ---------------------------------------------------------------------------
# config hot reload, TLS
# ---------------------------------------------------------------------------

def test_config_watch(tmp_path):
    """The JAX package's ``test_config_watch`` on the port's watcher."""
    from blazr_tpu_torch.server.config_watch import watch_config

    cfg_file = tmp_path / "config.yaml"
    cfg_file.write_text("temperature: 0.5\n")
    seen = []

    async def main():
        stop = asyncio.Event()
        task = asyncio.create_task(watch_config(cfg_file, seen.append, poll_interval=0.05,
                                                stop_event=stop))
        await asyncio.sleep(0.15)
        cfg_file.write_text("temperature: 0.9\n")
        os.utime(cfg_file, (1e9, 2e9))     # force an mtime change
        await asyncio.sleep(0.3)
        stop.set()
        await asyncio.sleep(0.1)
        task.cancel()

    asyncio.run(main())
    assert seen and seen[-1]["temperature"] == 0.9


def test_server_config_hot_reload(model_dir, tmp_path):
    """The user config is read at start and reloaded while serving (the JAX
    ``test_server_config_hot_reload``); the JAX server reads the same file.
    The reloaded temperature and max_tokens are the defaults of the next
    request (the JAX server applies neither: a pinned deviation)."""
    from blazr_tpu.server.app import AppState as JaxAppState
    from blazr_tpu_torch.config.user import UserConfig

    cfg_path = Path(os.environ["BLAZR_TPU_HOME"]) / "config.yaml"
    cfg_path.parent.mkdir(parents=True)
    cfg_path.write_text("temperature: 0.5\nport: 9000\nunknown: 1\n")
    jstate = JaxAppState(scheduler=None, server_cfg=JaxServerConfig())
    with PortServer(model_dir, config_poll_interval=0.05) as srv:
        state = srv.app.state
        assert state.user_config == UserConfig(temperature=0.5, port=9000)
        assert vars(state.user_config) == vars(jstate.user_config)
        threading.Event().wait(0.1)
        cfg_path.write_text("temperature: 0.9\nmax_tokens: 7\n")
        os.utime(cfg_path, (1e9, 2e9))
        for _ in range(60):
            if state.user_config.temperature == 0.9:
                break
            threading.Event().wait(0.05)
        assert state.user_config == UserConfig(temperature=0.9, max_tokens=7)
        cfg_path.write_text("temperature: 0.0\nmax_tokens: 5\n")
        os.utime(cfg_path, (1e9, 3e9))
        for _ in range(60):
            if state.user_config.max_tokens == 5:
                break
            threading.Event().wait(0.05)
        chat = {"messages": [{"role": "user", "content": "hi"}]}
        usage = [srv.json("POST", path, dict(body))[1]["usage"] for path, body in (
            ("/v1/chat/completions", chat), ("/v1/completions", {"prompt": "hi"}),
            ("/v1/chat/completions", dict(chat, max_tokens=2)))]
        assert [u["completion_tokens"] for u in usage] == [5, 5, 2]
        # Greedy at the reloaded temperature 0: the same reply twice.
        a, b = (srv.json("POST", "/v1/completions", {"prompt": "hey"})[1] for _ in "ab")
        assert a["choices"][0]["text"] == b["choices"][0]["text"]


def _self_signed(tmp_path: Path) -> tuple[Path, Path]:
    if shutil.which("openssl") is None:
        pytest.skip("the openssl binary is needed to make a test certificate")
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
                    "-subj", "/CN=127.0.0.1", "-keyout", str(key), "-out", str(cert)],
                   check=True, capture_output=True, timeout=60)
    return cert, key


def test_tls_server_answers_https(model_dir, tmp_path):
    cert, key = _self_signed(tmp_path)
    with PortServer(model_dir, tls_cert=str(cert), tls_key=str(key)) as srv:
        assert srv.json("GET", "/health")[1]["status"] == "ok"
        st, body = srv.json("POST", "/v1/messages", MESSAGES)
        assert st == 200 and body["content"][0]["text"]
        plain = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        with pytest.raises((ConnectionError, http.client.HTTPException, OSError)):
            plain.request("GET", "/health")
            plain.getresponse().read()
    with pytest.raises(ValueError, match="both"):
        create_app(ModelScheduler(model_dir, device="cpu"), ServerConfig(tls_cert=str(cert)))


def test_cli_serve_over_tls(model_dir, tmp_path):
    """``cli serve --tls-cert --tls-key`` answers /health and a chat
    completion over https."""
    import socket
    import time

    cert, key = _self_signed(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "blazr_tpu_torch.cli", "--device", "cpu", "serve", "--model",
         str(model_dir), "--host", "127.0.0.1", "--port", str(port), "--dtype", "f32",
         "--no-warmup", "--tls-cert", str(cert), "--tls-key", str(key)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    ctx = ssl._create_unverified_context()
    try:
        for _ in range(240):
            assert proc.poll() is None, proc.stderr.read()
            try:
                conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=5, context=ctx)
                conn.request("GET", "/health")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                time.sleep(0.25)
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=60, context=ctx)
        conn.request("POST", "/v1/chat/completions", json.dumps({
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["usage"]["completion_tokens"] > 0
    finally:
        proc.terminate()
        proc.wait(30)
