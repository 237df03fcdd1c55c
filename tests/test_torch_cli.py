"""The port's CLI names, for each command of the JAX CLI it does not run,
the ROADMAP queue A item that ports it. These tests hold each pointer to
ROADMAP.md: the item's entry in queue A must name the command. The loader's
docstring points vision towers and layer offload at their item the same
way, and so does each runtime message of what the engines and the loader
do not serve yet: its item must be an entry of queue A."""

import re
from pathlib import Path

import pytest

from blazr_tpu_torch.cli.main import NOT_PORTED
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
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
    entry = _queue_a_entries()["12"]
    assert "vision towers and layer offload (item 12)" in " ".join(api.__doc__.split())
    assert "loader/vision.py" in entry and "loader/offloading.py" in entry


def _item_of(message: str) -> str:
    m = re.search(r"ROADMAP queue A item ([0-9a-z.]+)\)", message)
    assert m, message
    return m.group(1)


def _in_queue_a(item: str) -> bool:
    """An entry's own number, or one an entry names in parentheses (item 8
    lists 5a.3-5a.6 so)."""
    entries = _queue_a_entries()
    return item in entries or any(f"({item})" in body for body in entries.values())


_REQUESTS = {"grammar": dict(grammar="root ::= x"), "lora": dict(lora_adapter="a"),
             "mirostat": dict(mirostat=2)}
_ITEMS = {"grammar": "5a.4", "lora": "5a.6", "mirostat": "5a.3"}


@pytest.mark.parametrize("what", sorted(_REQUESTS))
def test_request_refusals_name_their_queue_item(what):
    with pytest.raises(NotImplementedError) as e:
        batch_engine.check_request(GenerationConfig(**_REQUESTS[what]))
    assert _item_of(str(e.value)) == _ITEMS[what] and _in_queue_a(_ITEMS[what])


@pytest.mark.parametrize("what,item", [("speculative", "5a.5"), ("tp", "13"),
                                       ("offload", "12")])
def test_engine_config_refusals_name_their_queue_item(what, item):
    inf = AppConfig().inference
    if what == "speculative":
        inf.speculative = SpeculativeDecodingConfig(num_speculative_tokens=2)
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
