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
from blazr_tpu.engine.batch_engine import BatchEngine as JaxEngine
from blazr_tpu.engine.model_scheduler import ModelScheduler as JaxScheduler
from blazr_tpu.server import create_app as jax_create_app
from blazr_tpu_torch.config.server import ServerConfig
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
from blazr_tpu_torch.server import create_app, serve

from fixtures import write_byte_tokenizer_json, write_tiny_llama_checkpoint
from test_torch_grammar import ensure_jax_pda


@pytest.fixture(autouse=True, scope="module")
def _jax_pda_loaded():
    """The JAX grammars here reach its PDA library: make sure it is loaded
    (``test_torch_grammar.ensure_jax_pda``)."""
    ensure_jax_pda()


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


def _jax(model_dir, requests, engine: bool = False):
    """Replies of the JAX server to ``requests`` [(path, body)], in order;
    through its BatchEngine with ``engine``."""
    async def main():
        sched = JaxScheduler(model_dir, dtype="f32")
        eng = None
        if engine:
            ex = sched.get_executor("default")
            eng = JaxEngine(ex.model, ex.tokenizer, ex.app_cfg)
        app = jax_create_app(sched, JaxServerConfig(), batch_engine=eng)
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


CONSTRAINED = [
    dict(CHAT, grammar='root ::= "a"'),
    dict(CHAT, response_format={"type": "json_object"}),
    dict(CHAT, max_tokens=24, response_format={"type": "json_schema", "json_schema": {
        "schema": {"type": "object", "properties": {"ok": {"enum": [True, False]}}}}}),
    dict(CHAT, temperature=0.9, seed=5, mirostat=2, typical_p=0.8),
]


@pytest.fixture(scope="module")
def jax_constrained(model_dir):
    reqs = [("/v1/chat/completions", b) for b in CONSTRAINED]
    return {engine: _jax(model_dir, reqs, engine) for engine in (False, True)}


@pytest.mark.parametrize("engine", [False, True], ids=["executor", "batch_engine"])
def test_constrained_replies_match_jax(model_dir, jax_constrained, engine):
    """A grammar, JSON mode, a JSON schema and the host samplers are served
    and their replies equal the JAX server's through the same entry (its
    Executor ends a reply at a token the grammar rejects, its BatchEngine
    does not)."""
    with PortServer(model_dir, engine=engine) as srv:
        for body, (jst, jdata) in zip(CONSTRAINED, jax_constrained[engine]):
            st, _, data = srv.request("POST", "/v1/chat/completions", body)
            assert st == jst == 200, data
            assert _core(json.loads(data)) == _core(json.loads(jdata)), body


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
        # No route is left unported: the LoRA routes are served behind the
        # key (POST without a path 400, the empty listing, an unknown name 404).
        for method, path, want in (("POST", "/v1/lora", 400), ("GET", "/v1/lora", 200),
                                   ("DELETE", "/v1/lora/a", 404)):
            assert srv.request(method, path, {}, auth)[0] == want
            assert srv.request(method, path, {})[0] == 401
        # /metrics is served, without a key (as /health), in the text format.
        st, headers, data = srv.request("GET", "/metrics")
        assert st == 200 and headers["Content-Type"].startswith("text/plain")
        assert b'blazr_tpu_requests_total{endpoint="completions",status="200"} 2.0' in data
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
        # A LoRA adapter that is not loaded answers 404, before any stream
        # (the JAX server's answer); a grammar is served, its reply inside
        # the grammar (this model's EOS lies past its vocabulary, so the
        # token after the complete "a" is one the grammar rejects, which
        # ends the reply, as in the JAX server), and one that does not parse
        # answers 400.
        st, _, data = srv.request("POST", "/v1/chat/completions",
                                  dict(CHAT, lora_adapter="x", stream=True))
        assert st == 404 and "not loaded" in json.loads(data)["error"]["message"], data
        st, _, data = srv.request("POST", "/v1/chat/completions",
                                  dict(CHAT, grammar='root ::= "a"'))
        assert st == 200 and json.loads(data)["choices"][0]["message"]["content"][0] == "a"
        for stream in (False, True):
            st, _, data = srv.request("POST", "/v1/chat/completions",
                                      dict(CHAT, grammar="::= x", stream=stream))
            assert st == 400 and "invalid grammar" in json.loads(data)["error"]["message"]
        # A chat with tools is served (tests/test_torch_routes.py holds it to JAX).
        st, _, data = srv.request("POST", "/v1/chat/completions",
                                  dict(CHAT, tools=[{"type": "function"}]))
        assert st == 200 and json.loads(data)["choices"][0]["finish_reason"] in (
            "stop", "length", "tool_calls")


def test_dry_and_dynatemp_fields_are_read():
    """llama.cpp's DRY and dynamic-temperature fields reach the request's
    GenerationConfig (the JAX server drops them, ROADMAP §C); the other
    fields parse as the JAX server parses them."""
    from blazr_tpu.config import GenerationConfig as JGen
    from blazr_tpu.server.api_types import gen_config_from_body as jax_parse
    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.server.api_types import gen_config_from_body

    extra = dict(dry_multiplier=0.8, dry_base=1.5, dry_allowed_length=3,
                 dry_sequence_breakers=["\n"], dynatemp_range=0.4, dynatemp_exponent=2.0)
    body = dict(CHAT, mirostat=2, typical_p=0.7, grammar='root ::= "a"',
                response_format={"type": "json_object"}, **extra)
    got = gen_config_from_body(body, GenerationConfig()).to_dict()
    want = jax_parse(body, JGen()).to_dict()
    assert all(got[k] == v for k, v in extra.items())
    assert all(want[k] == JGen().to_dict()[k] for k in extra)
    assert {k: v for k, v in got.items() if k not in extra} == \
        {k: v for k, v in want.items() if k not in extra}
