"""Port parity: image chats in blazr_tpu_torch (message content parts, media
decode, the LLaVA and mmproj loaders, the multimodal Executor, the chat
route, ``--mmproj``) against the JAX package on the CPU, on the tiny LLaVA
checkpoints of ``tests/fixtures.py`` (a 2-layer Llama, hidden 64, and a
2-layer tower, hidden 32, image 32, patch 8: 16 image rows).

Greedy rows with no penalty give the JAX package's tokens exactly. Where
the port departs from it on purpose (ROADMAP §C), the test pins the
departure: the Executor's sampling applies to an image chat (the JAX one
takes ``argmax``); audio, GIF and progressive JPEG answer 400."""

import asyncio
import base64
import io
import json
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.engine.executor_multimodal import MultimodalExecutor as JMultimodal
from blazr_tpu.formats.gguf import GgmlType, write_gguf
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.server import multimodal as jmm
from blazr_tpu_torch.cli.main import build_parser
from blazr_tpu_torch.config import GenerationConfig
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.engine.executor_multimodal import MultimodalExecutor
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.server import multimodal as tmm
from blazr_tpu_torch.tokenizer.byte_tok import ByteTokenizer

from fixtures import (write_byte_tokenizer_json, write_tiny_llama_checkpoint,
                      write_tiny_llava_checkpoint)
from test_multimodal import _mmproj_tensors, _wav_bytes
from test_torch_server import PortServer, _core, _jax, _sse
from tests_helpers import ByteTok

CPU = "cpu"
MMPROJ_META = {"clip.vision.image_size": 32, "clip.vision.patch_size": 8,
               "clip.vision.embedding_length": 32, "clip.vision.block_count": 2,
               "clip.vision.head_count": 4, "clip.vision.feed_forward_length": 64}


def _image(fmt: str, seed: int, size=(40, 30), **save) -> bytes:
    px = np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, fmt, **save)
    return buf.getvalue()


PNG, JPEG = _image("PNG", 1), _image("JPEG", 2, quality=90)


def _uri(data: bytes, mime: str = "image/png") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def _write_mmproj(path, seed: int = 9) -> None:
    write_gguf(path, MMPROJ_META, {k: (v, GgmlType.F32, v.shape) for k, v in
                                   _mmproj_tensors(np.random.default_rng(seed)).items()})


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """HF LLaVA; a Llama with an mmproj sidecar beside it; the same Llama
    with the sidecar elsewhere (``--mmproj``); a text Llama."""
    root = tmp_path_factory.mktemp("mm")
    write_tiny_llava_checkpoint(root / "llava", np.random.default_rng(3))
    write_tiny_llama_checkpoint(root / "sidecar", np.random.default_rng(4))
    _write_mmproj(root / "sidecar" / "mmproj-model-f32.gguf")
    shutil.copytree(root / "sidecar", root / "text")
    (root / "text" / "mmproj-model-f32.gguf").rename(root / "elsewhere.gguf")
    for d in ("llava", "sidecar", "text"):
        write_byte_tokenizer_json(root / d)
    return {"llava": (root / "llava", None), "sidecar": (root / "sidecar", None),
            "mmproj": (root / "text", root / "elsewhere.gguf"), "text": (root / "text", None)}


# ---------------------------------------------------------------------------
# content parts and media decode
# ---------------------------------------------------------------------------

CONTENTS = [
    "Hello world", None, 7,
    [{"type": "text", "text": "What is this?"},
     {"type": "image_url", "image_url": {"url": "https://x/img.png", "detail": "low"}}],
    [{"type": "text", "text": "Line 1"}, {"type": "text", "text": "Line 2"}, {"text": "x"}],
    [{"type": "image_url", "image_url": "data:image/png;base64,AAAA"},
     {"type": "input_audio", "input_audio": {"data": "AAAA", "format": "wav"}}],
]


@pytest.mark.parametrize("content", CONTENTS, ids=range(len(CONTENTS)))
def test_content_helpers_match_jax(content):
    for name in ("content_text", "has_images", "has_audio", "image_urls", "audio_inputs"):
        assert getattr(tmm, name)(content) == getattr(jmm, name)(content), name


@pytest.mark.parametrize("bad", [[{"type": "image_url", "image_url": {}}],
                                 [{"type": "input_audio", "input_audio": {"data": "x"}}]])
def test_malformed_parts_raise_like_jax(bad):
    fn = "image_urls" if bad[0]["type"] == "image_url" else "audio_inputs"
    with pytest.raises(jmm.MultimodalError):
        getattr(jmm, fn)(bad)
    with pytest.raises(tmm.MultimodalError):
        getattr(tmm, fn)(bad)


@pytest.mark.parametrize("url", [_uri(PNG), _uri(JPEG, "image/jpeg"),
                                 base64.b64encode(PNG).decode(),
                                 base64.urlsafe_b64encode(JPEG).decode().rstrip("=")],
                         ids=["png-uri", "jpeg-uri", "plain-b64", "urlsafe-unpadded"])
def test_decode_image_matches_jax(url):
    assert asyncio.run(tmm.decode_image(url)) == asyncio.run(jmm.decode_image(url))


@pytest.mark.parametrize("url,match", [("data:no-comma-here", "missing comma"),
                                       ("data:image/png;base64,&&&", "invalid base64"),
                                       ("http://127.0.0.1:9/x.png", "non-public address"),
                                       ("https://[::1]/x.png", "non-public address")])
def test_decode_image_refusals(url, match):
    """The guard refuses a loopback URL before any request is sent."""
    with pytest.raises(tmm.MultimodalError, match=match):
        asyncio.run(tmm.decode_image(url))


def test_fetch_checks_every_hop_and_connects_to_the_checked_address(monkeypatch):
    """A stub server on loopback stands in for a public host: its name is
    let through the guard as the first hop. A GET goes to the address the
    guard returned, with the name in the Host header (no second lookup);
    a 302 to a loopback URL is refused before that URL is requested. No
    name is looked up: any lookup but a numeric one raises."""
    import http.server
    import socket
    import threading

    seen = []

    class Stub(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append((self.path, self.headers["Host"]))
            if self.path == "/hop":
                self.send_response(302)
                self.send_header("Location", f"http://127.0.0.1:{port}/secret")
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(PNG)))
            self.end_headers()
            self.wfile.write(PNG)

        def log_message(self, *args):
            pass

    real_lookup, real_check = socket.getaddrinfo, tmm._public_address

    def numeric_only(host, *args, **kwargs):
        if host == "media.example":
            raise AssertionError("the name was looked up")
        return real_lookup(host, *args, **kwargs)

    monkeypatch.setattr(socket, "getaddrinfo", numeric_only)
    monkeypatch.setattr(tmm, "_public_address", lambda host, port: (
        "127.0.0.1" if host == "media.example" else real_check(host, port)))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        data, mime = asyncio.run(tmm.decode_image(f"http://media.example:{port}/img.png"))
        assert (data, mime) == (PNG, "image/png")
        assert seen == [("/img.png", f"media.example:{port}")]
        with pytest.raises(tmm.MultimodalError, match="non-public address 127.0.0.1"):
            asyncio.run(tmm.decode_image(f"http://media.example:{port}/hop"))
        assert [path for path, _ in seen] == ["/img.png", "/hop"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def test_mime_and_audio_decode_match_jax():
    for data in (PNG, JPEG, b"GIF89a", b"RIFF\0\0\0\0WEBPVP8 ", b"\0\1"):
        assert tmm.detect_image_mime(data) == jmm.detect_image_mime(data)
    for audio in ({"data": base64.b64encode(struct.pack("<hh", 256, 32767)).decode(),
                   "format": "pcm16"},
                  {"data": base64.b64encode(_wav_bytes([256, -100, 7])).decode(),
                   "format": "wav"}):
        np.testing.assert_array_equal(tmm.decode_audio(audio), jmm.decode_audio(audio))
    for bad, match in (({"data": "AAAA", "format": "mp3"}, "not yet supported"),
                       ({"data": "AAAA", "format": "aac"}, "Unsupported audio format"),
                       ({"data": base64.b64encode(b"\0" * 50).decode(), "format": "wav"},
                        "RIFF")):
        with pytest.raises(tmm.MultimodalError, match=match):
            tmm.decode_audio(bad)


# ---------------------------------------------------------------------------
# loading and generation
# ---------------------------------------------------------------------------

def _pair(ckpts, kind, max_seq_len: int = 128):
    d, mmproj = ckpts[kind]
    jm, ja = jax_load(d, dtype="f32", mmproj=None if mmproj is None else str(mmproj))
    tm, ta = load_model(d, dtype="f32", mmproj=mmproj, device=CPU)
    ja.inference.max_seq_len = ta.inference.max_seq_len = max_seq_len
    return (jm, ja), (tm, ta)


@pytest.mark.parametrize("kind", ["llava", "sidecar", "mmproj"])
def test_multimodal_greedy_matches_jax(ckpts, kind):
    """A PNG and a baseline JPEG before a 3-token prompt (32 image rows):
    the same config and tower, and the JAX package's greedy tokens."""
    (jm, ja), (tm, ta) = _pair(ckpts, kind)
    assert tm.is_multimodal and jm.is_multimodal
    assert tm.cfg.model_type == "llama" and tm.vision_cfg.projection_dim == tm.cfg.hidden_size
    assert {k: getattr(tm.vision_cfg, k) for k in ("hidden_size", "num_layers", "image_size")} \
        == {k: getattr(jm.vision_cfg, k) for k in ("hidden_size", "num_layers", "image_size")}
    prompt, images = [10, 20, 30], [PNG, JPEG]
    ref = [t.token_id for t in JMultimodal(JExecutor(jm, ByteTok(), ja), jm.vision_params,
                                           jm.vision_cfg).generate_multimodal(
        prompt, images=images, gen_cfg=JGen(max_tokens=8, temperature=0.0))]
    mm = MultimodalExecutor(Executor(tm, ByteTokenizer(), ta), tm.vision_params, tm.vision_cfg)
    hidden = mm.merged_embeddings(prompt, images)
    assert hidden.shape == (1, 2 * 16 + 3, 64)
    got = [t.token_id for t in mm.generate_multimodal(
        prompt, images=images, gen_cfg=GenerationConfig(max_tokens=8, temperature=0.0,
                                                        repeat_penalty=1.0))]
    assert got == ref and len(got) == 8


@pytest.mark.parametrize("form", ["llava", "mmproj"])
def test_written_llava_checkpoints_load_like_jax(tmp_path, form):
    """``utils/synthetic.py``'s LLaVA writers (the chip phase's checkpoints)
    cut to a tiny width: the HF LLaVA directory (AWQ-INT4 language model,
    an f16 tower with ``quick_gelu`` and feature layer −2) and a text
    checkpoint with an F16 ``mmproj`` sidecar of 2 of 3 blocks. Both
    packages attach the tower, and the greedy image chats agree."""
    import dataclasses

    from blazr_tpu_torch.config.model_config import VisionConfig
    from blazr_tpu_torch.utils.synthetic import (llava_1_5_7b_config, write_hf_checkpoint,
                                                 write_llava_checkpoint, write_mmproj_gguf)

    full = llava_1_5_7b_config()
    cfg = dataclasses.replace(
        full, vocab_size=256, hidden_size=64, num_layers=2, intermediate_size=128,
        attention=dataclasses.replace(full.attention, num_heads=4, num_kv_heads=4,
                                      head_dim=16),
        vision=VisionConfig(hidden_size=32, num_layers=3, num_heads=4, image_size=32,
                            patch_size=8, intermediate_size=64, projection_dim=64,
                            hidden_act="quick_gelu", feature_layer=-2))
    if form == "llava":
        write_llava_checkpoint(tmp_path, cfg, group_size=32, seed=1)
    else:
        write_hf_checkpoint(tmp_path, cfg, group_size=32, seed=1)
        write_mmproj_gguf(tmp_path / "mmproj-model-f16.gguf", cfg.vision, 64, seed=2,
                          blocks=2)
    jm, ja = jax_load(tmp_path, dtype="f32")
    tm, ta = load_model(tmp_path, dtype="f32", device=CPU)
    want = (("quick_gelu", -2, 3) if form == "llava" else ("gelu", None, 2))
    assert (tm.vision_cfg.hidden_act, tm.vision_cfg.feature_layer,
            tm.vision_cfg.num_layers) == want and jm.vision_cfg.num_layers == want[2]
    ref = [t.token_id for t in JMultimodal(JExecutor(jm, ByteTok(), ja), jm.vision_params,
                                           jm.vision_cfg).generate_multimodal(
        [1, 2, 3], images=[PNG], gen_cfg=JGen(max_tokens=4, temperature=0.0))]
    got = [t.token_id for t in MultimodalExecutor(
        Executor(tm, ByteTokenizer(), ta), tm.vision_params, tm.vision_cfg).generate_multimodal(
        [1, 2, 3], images=[PNG], gen_cfg=GenerationConfig(max_tokens=4, temperature=0.0,
                                                          repeat_penalty=1.0))]
    assert got == ref


def test_image_rows_count_against_the_capacity(ckpts):
    """16 image rows and 3 prompt tokens in a 20-token context leave one
    token, in both packages."""
    (jm, ja), (tm, ta) = _pair(ckpts, "llava", max_seq_len=20)
    ref = [t.token_id for t in JMultimodal(JExecutor(jm, ByteTok(), ja), jm.vision_params,
                                           jm.vision_cfg).generate_multimodal(
        [10, 20, 30], images=[PNG], gen_cfg=JGen(max_tokens=8, temperature=0.0))]
    ex = Executor(tm, ByteTokenizer(), ta)
    got = [t.token_id for t in MultimodalExecutor(ex, tm.vision_params, tm.vision_cfg)
           .generate_multimodal([10, 20, 30], images=[PNG],
                                gen_cfg=GenerationConfig(max_tokens=8, temperature=0.0,
                                                         repeat_penalty=1.0))]
    assert got == ref and len(got) == 1
    assert ex._session is None                # an image prefill is never a session


def test_sampling_applies_to_image_chats(ckpts):
    """The Executor's sampling decodes an image chat: a logit bias and a
    grammar hold (the JAX executor takes argmax and ignores both: ROADMAP
    §C), and a seeded sampled row repeats."""
    (jm, ja), (tm, ta) = _pair(ckpts, "llava")
    mm = MultimodalExecutor(Executor(tm, ByteTokenizer(), ta), tm.vision_params, tm.vision_cfg)

    def run(**cfg):
        return [t.token_id for t in mm.generate_multimodal(
            [10, 20, 30], images=[PNG], gen_cfg=GenerationConfig(max_tokens=6, **cfg))]

    greedy = run(temperature=0.0, repeat_penalty=1.0)
    assert run(temperature=0.0, logit_bias={65: 100.0}) == [65] * 6 != greedy
    assert bytes(run(temperature=0.0, grammar='root ::= "yes" | "no"')[:2]) in (b"ye", b"no")
    assert run(temperature=0.9, seed=5) == run(temperature=0.9, seed=5)
    ref = [t.token_id for t in JMultimodal(JExecutor(jm, ByteTok(), ja), jm.vision_params,
                                           jm.vision_cfg).generate_multimodal(
        [10, 20, 30], images=[PNG], gen_cfg=JGen(max_tokens=6, temperature=0.0,
                                                 logit_bias={65: 100.0}))]
    assert ref == greedy


def test_audio_is_refused_not_dropped(ckpts):
    (_, _), (tm, ta) = _pair(ckpts, "llava")
    mm = MultimodalExecutor(Executor(tm, ByteTokenizer(), ta), tm.vision_params, tm.vision_cfg)
    with pytest.raises(tmm.MultimodalError, match="audio"):
        mm.generate_multimodal([1, 2], images=[PNG], audio=[np.zeros(400, np.float32)])


def test_mmproj_flag_on_run_generate_and_serve():
    p = build_parser()
    for argv in (["run", "m", "--mmproj", "x.gguf"], ["generate", "m", "hi", "--mmproj",
                                                       "x.gguf"],
                 ["serve", "--model", "m", "--mmproj", "x.gguf"]):
        assert p.parse_args(argv).mmproj == "x.gguf"
    assert p.parse_args(["serve"]).mmproj is None


# ---------------------------------------------------------------------------
# the chat route
# ---------------------------------------------------------------------------

def _chat(url: str, stream: bool = False, text: str = "describe", **extra) -> dict:
    return {"messages": [{"role": "user", "content": [
        {"type": "text", "text": text}, {"type": "image_url", "image_url": {"url": url}}]}],
        "max_tokens": 6, "temperature": 0, "repeat_penalty": 1.0, "stream": stream, **extra}


def _port(ckpts, kind, requests, engine: bool = False):
    d, mmproj = ckpts[kind]
    with PortServer(d, engine=engine) as srv:
        srv.sched.mmproj = None if mmproj is None else str(mmproj)
        return [srv.request("POST", path, body) for path, body in requests]


def _stream_text(data: bytes) -> str:
    events = _sse(data)
    assert events[0]["choices"][0]["delta"].get("role") == "assistant"
    return "".join(e["choices"][0]["delta"].get("content") or "" for e in events)


@pytest.mark.parametrize("kind,engine", [("llava", False), ("sidecar", True)],
                         ids=["llava", "sidecar-engine"])
def test_server_image_chat_matches_jax(ckpts, kind, engine):
    """200 with the JAX server's greedy reply, streamed and not; with the
    batch engine on, image chats still go to the Executor (the JAX
    ``force_direct``); a text chat beside them is the JAX server's too.
    A bad base64 image answers the JAX server's 400."""
    chat = ("/v1/chat/completions", _chat(_uri(PNG)))
    reqs = [chat, ("/v1/chat/completions", _chat(_uri(PNG), stream=True)),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 6, "temperature": 0}),
            ("/v1/chat/completions", _chat("data:image/png;base64,&&&invalid"))]
    ref = _jax(ckpts[kind][0], reqs, engine=engine)
    got = _port(ckpts, kind, reqs, engine=engine)
    assert [st for st, _, _ in got] == [st for st, _ in ref] == [200, 200, 200, 400]
    assert _core(json.loads(got[0][2])) == _core(json.loads(ref[0][1]))
    assert _stream_text(got[1][2]) == _stream_text(ref[1][1]) == \
        json.loads(got[0][2])["choices"][0]["message"]["content"]
    assert _core(json.loads(got[2][2])) == _core(json.loads(ref[2][1]))
    assert json.loads(got[3][2]) == json.loads(ref[3][1])


def test_server_refusals(ckpts):
    """A text model answers the JAX server's 400 before any fetch; on an
    image model a GIF, a progressive JPEG and an audio part answer 400 (the
    JAX server decodes the first two through Pillow and drops the audio:
    ROADMAP §C); ``--mmproj`` serves the sidecar given."""
    text_req = ("/v1/chat/completions", _chat(_uri(PNG)))
    ref = _jax(ckpts["text"][0], [text_req])
    got = _port(ckpts, "text", [text_req])
    assert got[0][0] == ref[0][0] == 400
    assert json.loads(got[0][2]) == json.loads(ref[0][1])
    audio = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "hi"}, {"type": "image_url", "image_url": {"url": _uri(PNG)}},
        {"type": "input_audio", "input_audio": {"data": "AAAA", "format": "pcm16"}}]}],
        "max_tokens": 4}
    got = _port(ckpts, "mmproj", [
        ("/v1/chat/completions", _chat(_uri(_image("GIF", 3), "image/gif"))),
        ("/v1/chat/completions", _chat(_uri(_image("JPEG", 4, progressive=True)))),
        ("/v1/chat/completions", audio),
        ("/v1/chat/completions", _chat(_uri(JPEG, "image/jpeg")))])
    assert [st for st, _, _ in got] == [400, 400, 400, 200]
    msgs = [json.loads(b)["error"]["message"] for _, _, b in got[:3]]
    assert "GIF" in msgs[0] and "progressive" in msgs[1] and "audio" in msgs[2]


def test_image_chats_run_one_at_a_time_within_the_budget(ckpts, monkeypatch):
    """With the batch engine on, image chats queue for the Executor one at a
    time (each holds a whole-context cache outside the engine's pool) while
    a text chat runs beside them, and their replies are the same; an image
    chat's 16 image rows count in the token budget, so a budget the text
    alone fits answers 503 (the JAX server gates nothing and counts only
    the text)."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from blazr_tpu_torch.server.app import _build_prompt

    active, peak, lock = [0], [0], threading.Lock()
    generate = MultimodalExecutor._generate

    def tracked(self, *args, **kwargs):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            time.sleep(0.2)
            yield from generate(self, *args, **kwargs)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(MultimodalExecutor, "_generate", tracked)
    image = _chat(_uri(PNG))
    text = {"messages": [{"role": "user", "content": "describe"}], "max_tokens": 6,
            "temperature": 0}
    with PortServer(ckpts["llava"][0], engine=True) as srv:
        reqs = [image, _chat(_uri(PNG), stream=True), image, text]
        with ThreadPoolExecutor(len(reqs)) as pool:
            got = list(pool.map(lambda b: srv.request("POST", "/v1/chat/completions", b), reqs))
        assert [st for st, _, _ in got] == [200] * 4 and peak[0] == 1
        reply = json.loads(got[0][2])["choices"][0]["message"]["content"]
        assert json.loads(got[2][2])["choices"][0]["message"]["content"] == reply
        assert _stream_text(got[1][2]) == reply
        ex = srv.sched.get_executor("default")
        prompt = len(ex.tokenizer.encode(_build_prompt(image, ex.model.cfg)))
        srv.app.state.server_cfg.max_inflight_tokens = prompt + 6 + 15
        assert srv.request("POST", "/v1/chat/completions", text)[0] == 200
        assert srv.request("POST", "/v1/chat/completions", image)[0] == 503
        srv.app.state.server_cfg.max_inflight_tokens = prompt + 6 + 16
        assert srv.request("POST", "/v1/chat/completions", image)[0] == 200
