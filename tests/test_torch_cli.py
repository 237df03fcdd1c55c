"""The port's CLI names, for each command of the JAX CLI it does not run,
the ROADMAP queue A item that ports it. These tests hold each pointer to
ROADMAP.md: the item's entry in queue A must name the command. The loader's
docstring points vision towers and layer offload at their item the same
way."""

import re
from pathlib import Path

import pytest

from blazr_tpu_torch.cli.main import NOT_PORTED
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
