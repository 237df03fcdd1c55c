"""Port parity: the OpenAI-compatible server of blazr_tpu_torch (stdlib
asyncio, CPU, f32, in a thread, spoken to with ``http.client``) against the
JAX package's aiohttp server (``TestServer``) on the same tiny checkpoint.

Greedy replies must be equal: text, finish_reason and usage. The port's
replies are the same through its Executor and through its continuous-
batching engine (f32 on the CPU: the two forwards agree, as
tests/test_torch_engine.py shows). The SSE stream's deltas concatenate to
the non-streamed text and the first chunk carries the role."""

import asyncio
import http.client
import json
import threading

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
from blazr_tpu_torch.server.app import UNPORTED_ROUTES

from fixtures import write_byte_tokenizer_json, write_tiny_llama_checkpoint

CHAT = {"messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hello there, tiny model"}],
        "max_tokens": 12, "temperature": 0}
COMPLETION = {"prompt": "The quick brown fox", "max_tokens": 10, "temperature": 0}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_server_model")
    write_tiny_llama_checkpoint(path, np.random.default_rng(77))
    write_byte_tokenizer_json(path)
    return path


class PortServer:
    """The port's server on a free port in a background thread."""

    def __init__(self, model_dir, engine: bool = False, **cfg):
        self.sched = ModelScheduler(model_dir, dtype="f32", device="cpu")
        eng = None
        if engine:
            ex = self.sched.get_executor("default")
            eng = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
        self.app = create_app(self.sched, ServerConfig(**cfg), batch_engine=eng)
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

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, dict(resp.getheaders()), data


def _jax(model_dir, requests):
    """Replies of the JAX server to ``requests`` [(path, body)], in order."""
    async def main():
        app = jax_create_app(JaxScheduler(model_dir, dtype="f32"), JaxServerConfig())
        out = []
        async with TestClient(TestServer(app)) as c:
            for path, body in requests:
                r = await c.post(path, json=body)
                out.append((r.status, await r.read()))
        return out
    return asyncio.run(main())


def _sse(data: bytes) -> list:
    events = [line[6:] for line in data.decode().splitlines() if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _core(reply: dict) -> tuple:
    """What must agree between the packages (ids and timings differ)."""
    choice = reply["choices"][0]
    text = choice["message"]["content"] if "message" in choice else choice["text"]
    usage = {k: reply["usage"][k] for k in ("prompt_tokens", "completion_tokens",
                                            "total_tokens")}
    return text, choice["finish_reason"], usage


@pytest.fixture(scope="module")
def jax_replies(model_dir):
    base = _jax(model_dir, [("/v1/chat/completions", CHAT),
                            ("/v1/completions", COMPLETION)])
    text = json.loads(base[0][1])["choices"][0]["message"]["content"]
    stop = text[3:5]
    stopped = _jax(model_dir, [("/v1/chat/completions", dict(CHAT, stop=[stop]))])
    return {"chat": base[0], "completion": base[1], "stop": stop, "stopped": stopped[0]}


@pytest.mark.parametrize("engine", [False, True], ids=["executor", "batch_engine"])
def test_greedy_replies_match_jax(model_dir, jax_replies, engine):
    with PortServer(model_dir, engine=engine) as srv:
        for key, path, body in (("chat", "/v1/chat/completions", CHAT),
                                ("completion", "/v1/completions", COMPLETION)):
            st, _, data = srv.request("POST", path, body)
            jst, jdata = jax_replies[key]
            assert st == jst == 200
            got, ref = json.loads(data), json.loads(jdata)
            assert _core(got) == _core(ref), key
            assert got["object"] == ref["object"]


@pytest.mark.parametrize("engine", [False, True], ids=["executor", "batch_engine"])
def test_stop_sequence_matches_jax(model_dir, jax_replies, engine):
    with PortServer(model_dir, engine=engine) as srv:
        st, _, data = srv.request("POST", "/v1/chat/completions",
                                  dict(CHAT, stop=[jax_replies["stop"]]))
        assert st == 200
        got = _core(json.loads(data))
        assert got == _core(json.loads(jax_replies["stopped"][1]))
        assert got[1] == "stop" and jax_replies["stop"] not in got[0]


@pytest.mark.parametrize("engine", [False, True], ids=["executor", "batch_engine"])
def test_sse_streams_concatenate_to_the_reply(model_dir, engine):
    with PortServer(model_dir, engine=engine) as srv:
        _, _, whole = srv.request("POST", "/v1/chat/completions", CHAT)
        st, headers, data = srv.request("POST", "/v1/chat/completions",
                                        dict(CHAT, stream=True))
        assert st == 200 and headers["Content-Type"] == "text/event-stream"
        events = _sse(data)
        assert events[0]["choices"][0]["delta"]["role"] == "assistant"
        deltas = [e["choices"][0]["delta"].get("content", "") for e in events[1:]]
        text, finish, usage = _core(json.loads(whole))
        assert "".join(deltas) == text
        assert events[-1]["choices"][0]["finish_reason"] == finish
        assert events[-1]["usage"]["completion_tokens"] == sum(1 for d in deltas if d)
        _, _, whole = srv.request("POST", "/v1/completions", COMPLETION)
        st, _, data = srv.request("POST", "/v1/completions", dict(COMPLETION, stream=True))
        events = _sse(data)
        pieces = "".join(e["choices"][0]["text"] for e in events)
        assert pieces == json.loads(whole)["choices"][0]["text"]
        assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_auth_budget_and_unported_routes(model_dir):
    with PortServer(model_dir, api_keys=["sekrit"], max_inflight_tokens=40) as srv:
        assert srv.request("GET", "/health")[0] == 200            # unprotected
        assert srv.request("POST", "/v1/completions", COMPLETION)[0] == 401
        auth = {"Authorization": "Bearer sekrit"}
        st, _, _ = srv.request("POST", "/v1/completions", COMPLETION, auth)
        assert st == 200
        st, headers, data = srv.request("POST", "/v1/completions",
                                        dict(COMPLETION, max_tokens=64), auth)
        assert st == 503 and headers["Retry-After"] == "1"
        assert json.loads(data)["error"]["type"] == "overloaded_error"
        assert srv.request("POST", "/v1/completions", COMPLETION,
                           {"x-api-key": "sekrit"})[0] == 200
        for method, path in UNPORTED_ROUTES:
            st, _, data = srv.request(method, path.replace("{slot_id}", "1")
                                      .replace("{name}", "a"), {}, auth)
            assert st == 501 and "item 9" in json.loads(data)["error"]["message"]
        assert srv.request("GET", "/nope", None, auth)[0] == 404


def test_models_tokenize_and_template_routes(model_dir):
    with PortServer(model_dir) as srv:
        st, _, data = srv.request("GET", "/v1/models")
        mid = json.loads(data)["data"][0]["id"]
        assert srv.request("GET", f"/v1/models/{mid}")[0] == 200
        assert srv.request("GET", "/v1/models/nope")[0] == 404
        _, _, data = srv.request("POST", "/tokenize", {"content": "hi!"})
        ids = json.loads(data)["tokens"]
        assert ids == [104, 105, 33]
        _, _, data = srv.request("POST", "/detokenize", {"tokens": ids})
        assert json.loads(data)["content"] == "hi!"
        _, _, data = srv.request("POST", "/apply-template", CHAT)
        assert "hello there" in json.loads(data)["prompt"]
        st, _, data = srv.request("POST", "/v1/chat/completions",
                                  dict(CHAT, temperature=5.0))
        assert st == 400 and "temperature" in json.loads(data)["error"]["message"]
        st, headers, _ = srv.request("OPTIONS", "/v1/chat/completions")
        assert st == 204 and headers["Access-Control-Allow-Origin"] == "*"
        # What the port does not serve yet answers 501, before any stream.
        for extra in ({"grammar": 'root ::= "a"'}, {"tools": [{"type": "function"}]},
                      {"lora_adapter": "x", "stream": True}):
            st, _, data = srv.request("POST", "/v1/chat/completions", dict(CHAT, **extra))
            assert st == 501, (extra, data)


def test_tls_raises_at_startup(model_dir):
    with pytest.raises(NotImplementedError, match="TLS"):
        create_app(ModelScheduler(model_dir, device="cpu"),
                   ServerConfig(tls_cert="c.pem", tls_key="k.pem"))
