"""Swarm pipeline parallelism: layer stages across nodes.

Counterpart of ``blazr_tpu/distributed/swarm.py`` (the reference's swarm
mode):

  leader: register nodes → compute_layer_assignment → PipelineSchedule →
          send the model path → await WORKER_READY → drive generation;
  worker: connect → receive its assignment → load the checkpoint on its
          device (keeping only its layer range) → compute loop (receive an
          activation → ``forward_layers_range`` → send it on).

Activations hop over the TCP mesh (``transport.py``) as f32 arrays
(``kv_serialize.py``); within a stage the forward is the port's
``models/llama.py`` (``forward_embed``, ``forward_layers_range``,
``forward_head``), so every quantized projection runs kernel B1 on the card.
The first stage embeds the tokens; the last runs the LM head and returns the
last position's f32 logits to the leader.
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass
from typing import Optional

import torch

from .kv_serialize import deserialize_arrays, serialize_arrays
from .topology import (PipelineSchedule, PipelineStage, SwarmConfig, SwarmManager, SwarmNode,
                       SwarmRole)
from .transport import TcpMesh, tags

logger = logging.getLogger(__name__)


@dataclass
class StageRuntime:
    """One pipeline stage's model slice and cache."""

    model: object
    stage: object                 # PipelineStage
    cache: object
    capacity: int


def _stage_cache(model, stage, capacity: int):
    from ..kvcache.contiguous import init_kv_cache

    att = model.cfg.attention
    return init_kv_cache(stage.end_layer - stage.start_layer, 1, capacity, att.kv_heads(),
                         att.resolved_head_dim(model.cfg.hidden_size), dtype=model.dtype,
                         device=model.device)


def _build_stage(model_path: str, stage, capacity: int, dtype: str, device: str):
    from ..loader import load_model

    model, _ = load_model(model_path, dtype=dtype, device=device)
    # Only this stage's layers run here: free the others.
    layers = model.params["layers"]
    for i in range(len(layers)):
        if not stage.start_layer <= i < stage.end_layer:
            layers[i] = None
    return StageRuntime(model=model, stage=stage, cache=_stage_cache(model, stage, capacity),
                        capacity=capacity)


class SwarmWorker:
    """Compute-loop worker (reference SwarmWorker::run_compute_loop)."""

    def __init__(self, mesh: TcpMesh, capacity: int = 256, dtype: str = "f32",
                 device: str = "cuda"):
        self.mesh = mesh
        self.capacity = capacity
        self.dtype = dtype
        self.device = device
        self.sent_bytes = 0         # activations and logits sent since the last reset

    def receive_assignment(self):
        payload = self.mesh.recv(0, tags.ASSIGNMENT)
        start, end, has_emb, has_head = struct.unpack("<IIBB", payload[:10])
        self.stage = PipelineStage(rank=self.mesh.rank, start_layer=start,
                                   end_layer=end, has_embedding=bool(has_emb),
                                   has_lm_head=bool(has_head))
        return self.stage

    def send_ready(self) -> None:
        self.mesh.send(0, tags.WORKER_READY, b"ok")

    @torch.no_grad()
    def run_compute_loop(self) -> None:
        """recv → forward the layer range → send (reference run_compute_loop)."""
        from ..models.llama import forward_embed, forward_head, forward_layers_range

        model_path = self.mesh.recv(0, tags.MODEL_PATH).decode()
        rt = _build_stage(model_path, self.stage, self.capacity, self.dtype, self.device)
        self.send_ready()
        m = rt.model
        dev = m.device
        nxt = self.mesh.rank + 1 if not self.stage.has_lm_head else 0
        while True:
            # No timeout: a worker idles between requests.
            payload = self.mesh.recv(0 if self.stage.has_embedding
                                     else self.mesh.rank - 1, tags.ACTIVATION,
                                     timeout=None)
            if payload == b"__shutdown__":
                if not self.stage.has_lm_head:
                    self.mesh.send(nxt, tags.ACTIVATION, b"__shutdown__")
                return
            if payload == b"__reset__":
                # A new request: drop the previous one's K/V.
                rt.cache = _stage_cache(m, self.stage, self.capacity)
                self.sent_bytes = 0
                if not self.stage.has_lm_head:
                    self.mesh.send(nxt, tags.ACTIVATION, b"__reset__")
                continue
            arrays = deserialize_arrays(payload)
            positions = arrays[-1].to(dev)
            if self.stage.has_embedding:
                hidden = forward_embed(m.params, m.cfg, arrays[0].to(dev))
            else:
                hidden = arrays[0].to(dev).to(m.dtype)
            hidden, rt.cache = forward_layers_range(
                m.params, m.cfg, hidden, rt.cache, positions,
                self.stage.start_layer, self.stage.end_layer)
            if self.stage.has_lm_head:
                logits = forward_head(m.params, m.cfg, hidden[:, -1:])
                out, dst, tag = [logits[:, -1, :].to(torch.float32)], 0, tags.LOGITS
            else:
                out = [hidden.to(torch.float32), positions.to(torch.int32)]
                dst, tag = nxt, tags.ACTIVATION
            data = serialize_arrays(out)
            self.sent_bytes += len(data)
            self.mesh.send(dst, tag, data)


class SwarmLeader:
    """Leader: topology, the assignment broadcast, the generation driver."""

    def __init__(self, mesh: TcpMesh, model_path: str,
                 num_layers: int, weights: Optional[list[float]] = None):
        self.mesh = mesh
        self.model_path = model_path
        mgr = SwarmManager(SwarmConfig(world_size=mesh.world_size,
                                       model_path=model_path))
        for r in range(1, mesh.world_size):
            w = weights[r - 1] if weights else 1.0
            mgr.register_node(SwarmNode(rank=r, role=SwarmRole.WORKER, weight=w))
        self.schedule = PipelineSchedule.from_assignments(
            mgr.compute_layer_assignment(num_layers))
        self.hop_bytes = 0          # activation and logits bytes of the last request

    def start_workers(self) -> None:
        """Send assignments and the model path; await readiness."""
        for stage in self.schedule.stages:
            self.mesh.send(stage.rank, tags.ASSIGNMENT, struct.pack(
                "<IIBB", stage.start_layer, stage.end_layer,
                int(stage.has_embedding), int(stage.has_lm_head)))
        for stage in self.schedule.stages:
            self.mesh.send(stage.rank, tags.MODEL_PATH, self.model_path.encode())
        for stage in self.schedule.stages:
            ack = self.mesh.recv(stage.rank, tags.WORKER_READY, timeout=600)
            if ack != b"ok":
                raise RuntimeError(f"swarm stage {stage.rank} answered {ack!r}")
        logger.info("swarm ready: %d stages", len(self.schedule.stages))

    def generate_greedy(self, prompt_ids: list[int], max_tokens: int) -> list[int]:
        """Greedy pipeline generation: the prompt's prefill, then a hop
        through every stage a token."""
        first = self.schedule.stages[0].rank
        last = self.schedule.stages[-1].rank
        self.mesh.send(first, tags.ACTIVATION, b"__reset__")
        out: list[int] = []
        tokens = torch.tensor([prompt_ids], dtype=torch.int32)
        positions = torch.arange(len(prompt_ids), dtype=torch.int32)[None]
        self.hop_bytes = 0
        for _ in range(max_tokens):
            req = serialize_arrays([tokens, positions])
            self.mesh.send(first, tags.ACTIVATION, req)
            reply = self.mesh.recv(last, tags.LOGITS, timeout=600)
            self.hop_bytes += len(req) + len(reply)
            logits = deserialize_arrays(reply)[0]
            nxt = int(logits[0].argmax())
            out.append(nxt)
            pos = int(positions[0, -1]) + 1
            tokens = torch.tensor([[nxt]], dtype=torch.int32)
            positions = torch.tensor([[pos]], dtype=torch.int32)
        return out

    def shutdown(self) -> None:
        self.mesh.send(self.schedule.stages[0].rank, tags.ACTIVATION, b"__shutdown__")
