"""Streaming execution over host-offloaded layers.

Counterpart of ``blazr_tpu/engine/offload_stream.py`` (``StreamingModel``,
``maybe_stream``): the first ``num_device_layers`` decoder layers stay on
the card; the others live in host RAM and are brought over, one at a time,
while the previous layer computes. The KV cache stays whole on the card.

On the card the host layers are pinned, and the copies run on a stream of
their own into two device slots (the layers' shapes, allocated once),
ordered by events both ways: a layer's compute waits for the copy of its
slot, and the copy of layer i+2 into that slot waits until layer i has
finished with it. The copies of the first two host layers are queued before
the device layers compute, so they overlap them too. On the CPU the same
schedule runs with plain copies into the slots.

The decode regime is bound by the copies: a Mistral-7B AWQ-INT4 layer is
~123 MB (int4 words and f32 scale/min planes), so 16 host layers move
~2.0 GB a token. The steps cannot be CUDA graphs (copies from host memory
that change per layer); both engines run a streaming model eagerly, and
``BatchEngine`` refuses one (ROADMAP §C: the JAX ``BatchEngine`` cannot be
built over a ``StreamingModel``). The llama-forward families (dense and
MoE) stream; the MLA, Mamba2 and hybrid forwards are refused, as their
layers are not the llama decoder layer the JAX streaming forward runs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

import torch

from ..loader.offloading import LayerDeviceMap
from ..models import llama
from ..models.registry import Model, resolve_paged_kind
from ..quant.qtensor import QuantTensor

logger = logging.getLogger(__name__)


def _map_tree(node, fn):
    """The param tree with every tensor (and QuantTensor plane) passed
    through ``fn``."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, QuantTensor):
        return dataclasses.replace(node, qweight=fn(node.qweight), scales=fn(node.scales),
                                   mins=fn(node.mins),
                                   perm=None if node.perm is None else fn(node.perm))
    if isinstance(node, dict):
        return {k: _map_tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_tree(v, fn) for v in node)
    return node


def _tensors(node) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map_tree(node, lambda t: out.append(t) or t)
    return out


def _signature(node) -> list:
    return [(tuple(t.shape), t.dtype) for t in _tensors(node)]


class _Layers:
    """``params["layers"]`` for ``forward_layers_range`` over one layer:
    every index gives ``layer`` (so the layer keeps its own index, and
    with it its sliding window)."""

    def __init__(self, layer: dict):
        self.layer = layer

    def __getitem__(self, i: int) -> dict:
        return self.layer


@dataclasses.dataclass
class StreamingModel(Model):
    """A ``Model`` whose last layers live in host RAM and stream to the card
    each forward. ``params`` holds the device part (embeddings, head, the
    first ``num_device_layers`` layers)."""

    host_layers: list = dataclasses.field(default_factory=list)
    num_device_layers: int = 0

    is_streaming = True

    def __post_init__(self) -> None:
        self.forward_fn = self._forward
        dev = self.device
        self._cuda = dev.type == "cuda"
        # Two device slots of a host layer's shapes (every host layer has them).
        sigs = {str(_signature(lp)) for lp in self.host_layers}
        if len(sigs) > 1:
            raise ValueError("streaming offload needs host layers of one shape")
        self._slots = [_map_tree(self.host_layers[0],
                                 lambda t: torch.empty_like(t, device=dev))
                       for _ in range(min(2, len(self.host_layers)))]
        self._copy_stream = torch.cuda.Stream(dev) if self._cuda else None
        self._ready = [None, None]        # copy of a slot done (copy stream)
        self._free = [None, None]         # compute done with a slot (compute stream)
        self.copied_bytes = 0             # host-to-device bytes of every forward
        self.layer_bytes = sum(t.numel() * t.element_size()
                               for t in _tensors(self.host_layers[0]))

    def _queue_copy(self, j: int) -> None:
        """Copy host layer ``j`` into slot j % 2, after the compute that last
        read the slot."""
        s = j % 2
        src, dst = _tensors(self.host_layers[j]), _tensors(self._slots[s])
        if not self._cuda:
            for d, h in zip(dst, src):
                d.copy_(h)
        else:
            with torch.cuda.stream(self._copy_stream):
                if self._free[s] is not None:
                    self._copy_stream.wait_event(self._free[s])
                for d, h in zip(dst, src):
                    d.copy_(h, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._copy_stream)
                self._ready[s] = ev
        self.copied_bytes += self.layer_bytes

    def run_layers(self, x: torch.Tensor, cache, positions: torch.Tensor,
                   seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every decoder layer over hidden states x [B, T, H]: the device
        layers, then the host layers through the slots."""
        n_host = len(self.host_layers)
        for j in range(min(2, n_host)):
            self._queue_copy(j)
        d = self.num_device_layers
        if d:
            x, _ = llama.forward_layers_range(self.params, self.cfg, x, cache, positions,
                                              0, d, seq_lens)
        compute = torch.cuda.current_stream(self.device) if self._cuda else None
        for j in range(n_host):
            s = j % 2
            if self._cuda:
                compute.wait_event(self._ready[s])
            li = d + j
            x, _ = llama.forward_layers_range({"layers": _Layers(self._slots[s])},
                                              self.cfg, x, cache, positions, li, li + 1,
                                              seq_lens, cache_layer_offset=li)
            if self._cuda:
                ev = torch.cuda.Event()
                ev.record(compute)
                self._free[s] = ev
            if j + 2 < n_host:
                self._queue_copy(j + 2)
        return x

    def _forward(self, params: dict[str, Any], cfg, tokens: torch.Tensor, cache,
                 positions: torch.Tensor, seq_lens: Optional[torch.Tensor] = None):
        x = llama.forward_embed(params, cfg, tokens)
        x = self.run_layers(x, cache, positions, seq_lens)
        return llama.forward_head(params, cfg, x), cache


def stream_model(model: Model, layer_map: LayerDeviceMap) -> StreamingModel:
    """Move the layers ``layer_map`` puts on the host to (pinned) host
    memory and wrap the model for streaming."""
    if resolve_paged_kind(model.cfg) != "llama":
        raise ValueError("streaming offload serves the llama-forward families, not "
                         f"{model.cfg.model_type!r}")
    d = layer_map.num_device_layers
    layers = model.params["layers"]
    pin = model.device.type == "cuda"

    def host(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().to("cpu")
        return t.pin_memory() if pin else t.clone()

    host_layers = [_map_tree(lp, host) for lp in layers[d:]]
    params = dict(model.params)
    params["layers"] = list(layers[:d])
    del layers[d:]                   # the device copies go
    logger.info("streaming offload: %d device + %d host layers", d, len(host_layers))
    return StreamingModel(model.cfg, params, model.dtype, vision_params=model.vision_params,
                          vision_cfg=model.vision_cfg, lora=model.lora,
                          host_layers=host_layers, num_device_layers=d)


def maybe_stream(model: Model, layer_map: Optional[LayerDeviceMap]) -> Model:
    """``model`` streamed when ``layer_map`` puts any layer on the host."""
    if layer_map is None or layer_map.fully_resident:
        return model
    return stream_model(model, layer_map)
