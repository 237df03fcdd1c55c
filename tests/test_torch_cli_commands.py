"""Port parity: the CLI commands the port took over from its exit-2 stubs
(``generate``, ``chat``, ``info``, ``list``, ``ps``, ``tokenize``,
``completions``, ``pull``), run in both packages on the same inputs. Their
stdout must be equal; greedy texts exactly. The JAX commands are called
through their ``cmd_*`` functions on the JAX parser's arguments, on the
CPU (the test session's JAX platform)."""

import importlib
import io
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from blazr_tpu_torch.cli.main import main as cli_main
from blazr_tpu_torch.utils.synthetic import tiny_llama_config, write_gguf_checkpoint

from fixtures import write_byte_tokenizer_json, write_tiny_llama_checkpoint

jax_cli = importlib.import_module("blazr_tpu.cli.main")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_cli_model")
    write_tiny_llama_checkpoint(path, np.random.default_rng(93))
    write_byte_tokenizer_json(path)
    return path


@pytest.fixture(scope="module")
def gguf_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_cli_gguf") / "tiny.gguf"
    cfg = tiny_llama_config(vocab=320)
    cfg.hidden_size, cfg.intermediate_size = 256, 512
    cfg.attention.head_dim = 64
    write_gguf_checkpoint(path, cfg, "Q4_K_M")
    return path


def _jax(argv: list, capsys) -> tuple[int, str, str]:
    args = jax_cli.build_parser().parse_args(argv)
    rc = {"generate": jax_cli.cmd_generate, "chat": jax_cli.cmd_chat,
          "info": jax_cli.cmd_info, "list": jax_cli.cmd_list,
          "tokenize": jax_cli.cmd_tokenize, "completions": jax_cli.cmd_completions,
          "pull": jax_cli.cmd_pull, "ps": jax_cli.cmd_ps}[args.command](args)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _port(argv: list, capsys) -> tuple[int, str, str]:
    rc = cli_main(["--device", "cpu", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("what", ["safetensors_dir", "gguf_file"])
def test_info_matches_jax(model_dir, gguf_file, capsys, what):
    path = str(model_dir if what == "safetensors_dir" else gguf_file)
    rc, out, _ = _port(["info", path], capsys)
    assert rc == 0 and (rc, out) == _jax(["info", path], capsys)[:2]
    info = json.loads(out)
    assert info["path"].startswith(path) and info["num_layers"] == 2
    if what == "gguf_file":
        assert info["format"] == "gguf" and info["dominant_quant"] in ("Q4_K", "F32")
        assert info["architecture"] == "llama" and info["is_moe"] is False
    else:
        assert info["architecture"] == "llama" and info["vocab_size"] == 256


@pytest.mark.parametrize("what", ["json_tokenizer", "gguf_tokenizer"])
def test_tokenize_matches_jax(model_dir, gguf_file, capsys, what):
    path = str(model_dir if what == "json_tokenizer" else gguf_file)
    text = "Hello world, naïve café"
    got = _port(["tokenize", path, text], capsys)
    assert got[0] == 0 and got[:2] == _jax(["tokenize", path, text], capsys)[:2]
    assert json.loads(got[1])["count"] > 3


def test_list_matches_jax(model_dir, gguf_file, tmp_path, capsys):
    import shutil

    root = tmp_path / "models"
    root.mkdir()
    shutil.copytree(model_dir, root / "b_dir")
    shutil.copy(gguf_file, root / "a.gguf")
    (root / "empty").mkdir()
    got = _port(["list", "--dir", str(root)], capsys)
    assert got[:2] == _jax(["list", "--dir", str(root)], capsys)[:2]
    # The root holds a GGUF file, so it is a model itself.
    assert got[1].split() == ["models", "a.gguf", "b_dir"]


@pytest.mark.parametrize("shell", ["bash", "zsh"])
def test_completions_match_jax(capsys, shell):
    """The JAX script for this package's names (``blazr-tpu-torch``,
    ``python -m blazr_tpu_torch.cli``)."""
    rc, out, _ = _port(["completions", shell], capsys)
    jrc, jout, _ = _jax(["completions", shell], capsys)
    assert rc == jrc == 0
    assert out == jout.replace("blazr_tpu", "blazr_tpu_torch").replace("blazr-tpu",
                                                                       "blazr-tpu-torch")
    assert "complete -F _blazr_tpu_torch blazr-tpu-torch" in out
    for cmd in ("generate", "chat", "info", "list", "ps", "tokenize", "pull"):
        assert cmd in out.split("cmds=")[1].split('"')[1].split()


def test_generate_matches_jax(model_dir, capsys):
    argv = ["generate", str(model_dir), "hello there", "-n", "10", "-t", "0", "--dtype",
            "f32"]
    rc, out, err = _port(argv, capsys)
    assert rc == 0 and "loaded llama" in err
    assert out == _jax(argv, capsys)[1]
    assert len(out) > 1


def test_chat_two_turns_match_jax(model_dir, capsys, monkeypatch):
    """A piped two-turn chat: both turns equal JAX's, and the second turn,
    which reuses the first turn's session cache, gives what a fresh cache
    gives."""
    from blazr_tpu_torch.config.generation import GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.generate_text import collect_generation
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.model_meta.chat_template import ChatMessage, ChatTemplate
    from blazr_tpu_torch.tokenizer import load_tokenizer

    argv = ["chat", str(model_dir), "--system", "be brief", "-n", "8", "-t", "0",
            "--dtype", "f32"]
    lines = "hello there\n\nwhat next?\n/exit\nnever read\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    rc, out, _ = _port(argv, capsys)
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    jrc, jout, _ = _jax(argv, capsys)
    assert rc == jrc == 0 and out == jout
    replies = [p.split("\n")[0] for p in out.split("assistant> ")[1:]]
    assert len(replies) == 2 and out.count("user> ") == 4
    model, app_cfg = load_model(model_dir, dtype="f32", device="cpu")
    fresh = Executor(model, load_tokenizer(model_dir), app_cfg)      # prefix cache off
    msgs = [ChatMessage("system", "be brief"), ChatMessage("user", "hello there"),
            ChatMessage("assistant", replies[0]), ChatMessage("user", "what next?")]
    prompt = ChatTemplate.detect(model_type="llama").apply(msgs)
    res = collect_generation(fresh, fresh.tokenizer.encode(prompt),
                             GenerationConfig(max_tokens=8, temperature=0.0))
    assert res.text == replies[1]


@pytest.mark.parametrize("hub", ["missing", "stub", "failing"])
def test_pull_matches_jax(tmp_path, capsys, monkeypatch, hub):
    """Without ``huggingface_hub``: exit 2; a download that fails: exit 1;
    a local stub (no network) that writes files: the success line."""
    calls = []
    if hub == "missing":
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    else:
        def snapshot_download(repo_id, revision, local_dir, allow_patterns):
            calls.append((repo_id, revision, Path(local_dir)))
            if hub == "failing":
                raise OSError("no network")
            Path(local_dir).mkdir(parents=True, exist_ok=True)
            (Path(local_dir) / "config.json").write_text("{}")
        monkeypatch.setitem(sys.modules, "huggingface_hub",
                            types.SimpleNamespace(snapshot_download=snapshot_download))
    dest = tmp_path / "dl"
    argv = ["pull", "org/some-model", "--dest", str(dest), "--revision", "r1"]
    got, ref = _port(argv, capsys), _jax(argv, capsys)
    assert got == ref
    assert got[0] == {"missing": 2, "stub": 0, "failing": 1}[hub]
    if hub == "stub":
        assert got[1] == f"pulled org/some-model -> {dest}\n"
        assert (dest / "config.json").exists()
    if hub != "missing":
        assert calls == [("org/some-model", "r1", dest)] * 2


def test_ps_prints_the_servers_api_ps(model_dir, capsys):
    """``cli ps`` against a running port server prints its /api/ps JSON, as
    the JAX command does."""
    import asyncio
    import threading

    from blazr_tpu_torch.config.server import ServerConfig
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
    from blazr_tpu_torch.server import create_app, serve

    sched = ModelScheduler(model_dir, dtype="f32", device="cpu")
    sched.get_executor("default", keep_alive=-1)
    app = create_app(sched, ServerConfig())
    loop, stop, ready, port = asyncio.new_event_loop(), asyncio.Event(), threading.Event(), []

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(serve(app, "127.0.0.1", 0, stop=stop,
                                      started=lambda p: (port.append(p), ready.set())))
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        assert ready.wait(30)
        argv = ["ps", "--host", "127.0.0.1", "--port", str(port[0])]
        got, ref = _port(argv, capsys), _jax(argv, capsys)
    finally:
        loop.call_soon_threadsafe(stop.set)
        thread.join(30)
    assert got == ref and got[0] == 0
    assert json.loads(got[1]) == {"models": [{"name": "default", "model": "default",
                                              "expires_at": "never", "size_vram": 0}]}


@pytest.mark.parametrize("flags", [["--grammar", 'root ::= "a" [b-d]+ "."'], ["--json"]],
                         ids=["grammar", "json"])
def test_run_with_a_grammar_matches_jax(model_dir, capsys, flags):
    """``cli run --grammar`` and ``--json``: the Executor's greedy reply under
    the grammar equals the JAX ``run``'s."""
    argv = ["run", str(model_dir), "--prompt", "hello there", "-n", "10", "-t", "0",
            "--dtype", "f32", "--no-warmup", *flags]
    rc, out, _ = _port(argv, capsys)
    jrc, jout, _ = _jax_run(argv, capsys)
    assert rc == jrc == 0 and out == jout
    if flags[0] == "--grammar":
        assert out.startswith("a")


def _jax_run(argv: list, capsys):
    args = jax_cli.build_parser().parse_args(argv)
    rc = jax_cli.cmd_run(args)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_run_with_mirostat(model_dir, capsys):
    """``cli run --mirostat 2`` (a flag the JAX CLI lacks) picks on the host
    with the seeded generator: the same seed gives the same reply."""
    argv = ["run", str(model_dir), "--prompt", "hello there", "-n", "8", "-t", "0.9",
            "--seed", "4", "--dtype", "f32", "--no-warmup", "--mirostat", "2"]
    first = _port(argv, capsys)
    assert first[0] == 0 and first[1].strip()
    assert _port(argv, capsys)[1] == first[1]
