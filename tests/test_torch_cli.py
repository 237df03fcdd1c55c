"""The port's CLI names, for each command of the JAX CLI it does not run,
the ROADMAP queue A item that ports it. These tests hold each pointer to
ROADMAP.md: the item's entry in queue A must name the command. Each runtime
message of what the engines and the loader do not serve yet names its item,
which must be an entry of queue A. Item 12 is served since its last part was
ported: the loader's docstring points layer offload at its modules, MoE
offload and streaming models pass the engines' checks, and the one refusal
left (``BatchEngine`` over a streaming model) names ROADMAP §C."""

import re
from pathlib import Path

import pytest

from blazr_tpu_torch.cli.main import NOT_PORTED
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.engine import batch_engine, executor
from blazr_tpu_torch.loader import api

ROADMAP = Path(__file__).resolve().parent.parent / "ROADMAP.md"


def _queue_a_entries() -> dict[str, str]:
    """Item number -> the text of its entry in ROADMAP.md queue A."""
    text = ROADMAP.read_text()
    queue = text[text.index("### A. "):text.index("### B. ")]
    entries = {}
    for head in re.finditer(r"^\d+\. \*\*Items? ([0-9a-z.]+)", queue, re.MULTILINE):
        end = re.search(r"^\d+\. \*\*", queue[head.end():], re.MULTILINE)
        body = queue[head.start():head.end() + (end.start() if end else len(queue))]
        entries[head.group(1).rstrip(".")] = body
    return entries


@pytest.mark.parametrize("command", ["disagg", "swarm"])
def test_not_ported_commands_point_at_their_queue_item(command):
    """The last two commands the CLI refused, ``swarm`` and ``disagg``, are
    served since item 13 was ported: no command is left in ``NOT_PORTED``,
    the parser takes their roles, and item 13's entry names them in code
    spans among what landed (tests/test_torch_distributed.py runs them)."""
    from blazr_tpu_torch.cli.main import build_parser

    assert NOT_PORTED == {}
    roles = {"swarm": ["leader", "worker"], "disagg": ["router", "prefill", "decode"]}
    for role in roles[command]:
        args = build_parser().parse_args([command, role, "--seed", "127.0.0.1:1"])
        assert (args.command, args.role) == (command, role)
    entries = _queue_a_entries()
    named = [n for n, body in entries.items()
             if re.search(rf"`[^`]*\b{command}\b[^`]*`", body)]       # in code spans
    assert "13" in named, f"ROADMAP queue A item 13 does not name `{command}`"


def test_loader_points_vision_and_offload_at_item_12():
    """Vision towers are served (``loader/vision.py``) and so is layer
    offload: the loader's docstring names the modules that serve it, no
    longer item 12, and the item-12 entry names ``loader/offloading.py``
    among what landed."""
    entry = _queue_a_entries()["12"]
    doc = " ".join(api.__doc__.split())
    assert "item 12" not in doc
    assert "loader/offloading.py" in doc and "engine/offload_stream.py" in doc
    assert "loader/vision.py" in doc
    assert "loader/offloading.py" in entry


# Grammars (5a.4), the host samplers (5a.3) and LoRA (5a.6) are served
# since they were ported: no request feature is refused any more. A request
# that names a LoRA adapter the engine's registry lacks fails as not loaded.
_REQUESTS = {"lora": dict(lora_adapter="a")}


@pytest.mark.parametrize("what", sorted(_REQUESTS))
def test_request_refusals_name_their_queue_item(what):
    assert not hasattr(batch_engine, "check_request")
    assert "5a.6" not in (batch_engine.__doc__ or "")
    model = _tiny_model()
    eng = batch_engine.BatchEngine(model, None, AppConfig(model=model.cfg))
    with pytest.raises(KeyError, match="not loaded"):
        eng.submit([1, 2], GenerationConfig(**_REQUESTS[what]))
    assert not eng.scheduler.has_work


def _tiny_model():
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_llama_params, tiny_llama_config

    cfg = tiny_llama_config()
    return Model(cfg, synth_llama_params(cfg, quant="dense", dtype=torch.float32,
                                         device="cpu"), torch.float32)


def _recurrent_model():
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_recurrent_params, tiny_recurrent_config

    cfg = tiny_recurrent_config("mamba2")
    return Model(cfg, synth_recurrent_params(cfg, quant="dense", dtype=torch.float32,
                                             device="cpu"), torch.float32)


@pytest.mark.parametrize("what,item", [("moe_offload", "12"), ("tp", "13"),
                                       ("offload", "12")])
def test_engine_config_refusals_name_their_queue_item(what, item):
    """Meshes are served (item 13, both entries done) and pass the check; a
    Mamba2 model under tp 2 passes the mesh check too and reaches the
    process group (without a world, the ``RuntimeError`` naming
    ``init_distributed``), and no message names item 13, whose entry says
    it is done. Of item 12, MoE offload is served and passes the check;
    layer offload raises naming ROADMAP §C, where the JAX engine's failure
    over a streaming model is pinned."""
    inf = AppConfig().inference
    if what == "moe_offload":
        inf.moe_offload = "hybrid"
        batch_engine.BatchEngine._check_config(inf)
        return
    if what == "tp":
        inf.tensor_parallel_size = 2
        batch_engine.BatchEngine._check_config(inf)
        with pytest.raises(RuntimeError, match="init_distributed") as e:
            batch_engine.BatchEngine(_recurrent_model(), None, AppConfig(inference=inf))
        assert "queue A" not in str(e.value)
        entry = _queue_a_entries()[item]
        assert "Mamba2" in entry and "done" in entry.split("\n")[0]
        return
    inf.num_device_layers = 1
    with pytest.raises(NotImplementedError) as e:
        batch_engine.BatchEngine._check_config(inf)
    assert "ROADMAP §C" in str(e.value) and "queue A" not in str(e.value)
    assert "Executor" in str(e.value)


@pytest.mark.parametrize("what,item", [("tp", "13"), ("moe_offload", "12"),
                                       ("stream", "12")])
def test_executor_refusals_name_their_queue_item(what, item):
    """Meshes pass the check (item 13 is served); a LoRA adapter under one
    raises the JAX Executor's ``ValueError``, and a streamed model under one
    is refused naming ROADMAP §C, neither naming a queue item; item 13's
    entry names LoRA among the two refusals kept. MoE offload and streaming
    models (item 12) are served and pass the check."""
    inf = AppConfig().inference
    if what == "tp":
        inf.expert_parallel_size = 2
    elif what == "moe_offload":
        inf.moe_offload = "hybrid"
    else:
        inf.num_device_layers = 2
    executor.Executor._check_config(inf)
    if what != "tp":
        return
    from blazr_tpu_torch.engine.lora import lora_under_mesh
    from blazr_tpu_torch.parallel.tp import check_mesh_model

    e = lora_under_mesh()
    assert isinstance(e, ValueError) and "queue A" not in str(e)
    assert "LoRA" in _queue_a_entries()[item]

    class Streamed:
        is_streaming = True

    with pytest.raises(NotImplementedError, match="ROADMAP §C") as err:
        check_mesh_model(Streamed())
    assert "queue A" not in str(err.value)


def test_loader_refusals_name_item_12(tmp_path):
    """Layer offload loads (item 12 is served): ``device_layers`` below the
    depth gives a streaming model with its layers split, at or above it the
    model itself; a family the streaming forward does not run (Mamba2)
    raises ``ValueError`` naming it."""
    from blazr_tpu_torch.engine.offload_stream import StreamingModel
    from blazr_tpu_torch.utils.synthetic import (tiny_llama_config, tiny_recurrent_config,
                                                 write_hf_checkpoint)

    write_hf_checkpoint(tmp_path / "l", tiny_llama_config(), quant="plain", dtype="float32")
    model, app = api.load_model(tmp_path / "l", device_layers=1, device="cpu")
    assert isinstance(model, StreamingModel) and model.is_streaming
    assert (model.num_device_layers, len(model.host_layers)) == (1, 1)
    assert len(model.params["layers"]) == 1 and app.inference.num_device_layers == 1
    model, app = api.load_model(tmp_path / "l", device_layers=2, device="cpu")
    assert not isinstance(model, StreamingModel) and app.inference.num_device_layers is None
    write_hf_checkpoint(tmp_path / "m", tiny_recurrent_config("mamba2"), quant="plain",
                        dtype="float32")
    with pytest.raises(ValueError, match="llama-forward families"):
        api.load_model(tmp_path / "m", device_layers=1, device="cpu")


def test_unported_routes_name_their_queue_item():
    """No route of the JAX server is left unported: the port's app serves
    every (method, path) of the JAX create_app, the /v1/lora routes too."""
    from blazr_tpu.config.server import ServerConfig as JServerConfig
    from blazr_tpu.engine.model_scheduler import ModelScheduler as JScheduler
    from blazr_tpu.server.app import create_app as jax_create_app
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
    from blazr_tpu_torch.server import app as port_app

    assert not hasattr(port_app, "UNPORTED_ROUTES") and not hasattr(port_app, "not_ported")
    jax = {(r.method, r.resource.canonical)
           for r in jax_create_app(JScheduler("."), JServerConfig()).router.routes()
           if r.method != "HEAD"}
    port = {(m, pat.pattern) for m, pat, _ in
            port_app.create_app(ModelScheduler(".", device="cpu"))._routes}
    assert {("POST", "/v1/lora"), ("GET", "/v1/lora"), ("DELETE", "/v1/lora/{name}")} <= jax
    assert {(m, "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", p) + "$")
            for m, p in jax} <= port
