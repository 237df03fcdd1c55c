"""The port's CLI names, for each command of the JAX CLI it does not run,
the ROADMAP queue A item that ports it. These tests hold each pointer to
ROADMAP.md: the item's entry in queue A must name the command. The loader's
docstring points layer offload at its item the same way (vision towers are
served since their part of item 12 was ported), and so does each runtime message of what the engines and the loader
do not serve yet: its item must be an entry of queue A."""

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


@pytest.mark.parametrize("command", sorted(NOT_PORTED))
def test_not_ported_commands_point_at_their_queue_item(command):
    item = NOT_PORTED[command]
    assert re.fullmatch(r"item \d+", item), item
    entries = _queue_a_entries()
    number = item.split()[1]
    assert number in entries, f"ROADMAP queue A has no item {number}"
    named = re.search(rf"`[^`]*\b{command}\b[^`]*`", entries[number])   # in code spans
    assert named, f"ROADMAP queue A item {number} does not name `{command}`"


def test_loader_points_vision_and_offload_at_item_12():
    """Vision towers are served (``loader/vision.py``); layer offload still
    names item 12, whose entry names ``loader/offloading.py``."""
    entry = _queue_a_entries()["12"]
    doc = " ".join(api.__doc__.split())
    assert "layer offload (item 12)" in doc
    assert "loader/offloading.py" in entry


def _item_of(message: str) -> str:
    m = re.search(r"ROADMAP queue A item ([0-9a-z.]+)\)", message)
    assert m, message
    return m.group(1)


def _in_queue_a(item: str) -> bool:
    """An entry's own number, or one an entry names in parentheses (item 8
    lists 5a.3-5a.6 so)."""
    entries = _queue_a_entries()
    return item in entries or any(f"({item})" in body for body in entries.values())


# Grammars (5a.4) and the host samplers (5a.3) are served since they were
# ported; LoRA is the one request feature left to refuse.
_REQUESTS = {"lora": dict(lora_adapter="a")}
_ITEMS = {"lora": "5a.6"}


@pytest.mark.parametrize("what", sorted(_REQUESTS))
def test_request_refusals_name_their_queue_item(what):
    with pytest.raises(NotImplementedError) as e:
        batch_engine.check_request(GenerationConfig(**_REQUESTS[what]))
    assert _item_of(str(e.value)) == _ITEMS[what] and _in_queue_a(_ITEMS[what])


@pytest.mark.parametrize("what,item", [("moe_offload", "12"), ("tp", "13"),
                                       ("offload", "12")])
def test_engine_config_refusals_name_their_queue_item(what, item):
    inf = AppConfig().inference
    if what == "moe_offload":
        inf.moe_offload = True
    elif what == "tp":
        inf.tensor_parallel_size = 2
    else:
        inf.num_device_layers = 1
    with pytest.raises(NotImplementedError) as e:
        batch_engine.BatchEngine._check_config(inf)
    assert _item_of(str(e.value)) == item and _in_queue_a(item)


@pytest.mark.parametrize("what,item", [("tp", "13"), ("moe_offload", "12"),
                                       ("stream", "12")])
def test_executor_refusals_name_their_queue_item(what, item):
    inf = AppConfig().inference
    if what == "tp":
        inf.expert_parallel_size = 2
    elif what == "moe_offload":
        inf.moe_offload = True
    else:
        inf.num_device_layers = 2
    with pytest.raises(NotImplementedError) as e:
        executor.Executor._check_config(inf)
    assert _item_of(str(e.value)) == item and _in_queue_a(item)


def test_loader_refusals_name_item_12():
    with pytest.raises(NotImplementedError) as e:
        api.load_model(".", device_layers=1, device="cpu")
    assert _item_of(str(e.value)) == "12"


def test_unported_routes_name_their_queue_item():
    """The server's 501 for the LoRA routes names the item that ports them."""
    import asyncio
    import types

    from blazr_tpu_torch.server.api_types import ApiError
    from blazr_tpu_torch.server.app import UNPORTED_ROUTES, not_ported

    for method, path in UNPORTED_ROUTES:
        with pytest.raises(ApiError) as e:
            asyncio.run(not_ported(types.SimpleNamespace(method=method, path=path)))
        assert e.value.status == 501
        assert _item_of(e.value.message) == "5a.6" and _in_queue_a("5a.6")
