"""Swarm topology: node registry, layer assignment, pipeline schedule.

The port's own copy of ``blazr_tpu/distributed/topology.py`` (pure Python):
the leader registers nodes, splits the layer stack into contiguous weighted
stage ranges (``compute_layer_assignment``), and the ``PipelineSchedule``
marks which stage embeds tokens and which runs the LM head.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class SwarmRole(enum.Enum):
    LEADER = "leader"
    WORKER = "worker"


@dataclass
class SwarmNode:
    rank: int
    role: SwarmRole
    host: str = "127.0.0.1"
    # Optional relative compute weight (heterogeneous nodes).
    weight: float = 1.0


@dataclass
class SwarmConfig:
    world_size: int
    model_path: str = ""
    auth_token: Optional[str] = None


@dataclass
class LayerAssignment:
    rank: int
    start_layer: int
    end_layer: int            # exclusive

    @property
    def num_layers(self) -> int:
        return self.end_layer - self.start_layer


@dataclass
class PipelineStage:
    rank: int
    start_layer: int
    end_layer: int
    has_embedding: bool
    has_lm_head: bool


@dataclass
class PipelineSchedule:
    stages: list[PipelineStage]

    @classmethod
    def from_assignments(cls, assignments: list[LayerAssignment]
                         ) -> "PipelineSchedule":
        stages = []
        for i, a in enumerate(sorted(assignments, key=lambda a: a.start_layer)):
            stages.append(PipelineStage(
                rank=a.rank, start_layer=a.start_layer, end_layer=a.end_layer,
                has_embedding=(i == 0),
                has_lm_head=(i == len(assignments) - 1),
            ))
        return cls(stages)


class SwarmManager:
    """Node registry + layer assignment (reference SwarmManager)."""

    def __init__(self, config: SwarmConfig):
        self.config = config
        self.nodes: list[SwarmNode] = []

    def register_node(self, node: SwarmNode) -> None:
        self.nodes.append(node)

    @property
    def node_count(self) -> int:
        return len(self.nodes)

    def compute_layer_assignment(self, total_layers: int
                                 ) -> list[LayerAssignment]:
        """Split layers into contiguous weighted ranges
        (reference compute_layer_assignment)."""
        if not self.nodes:
            raise ValueError("no nodes registered")
        nodes = sorted(self.nodes, key=lambda n: n.rank)
        total_w = sum(n.weight for n in nodes)
        out = []
        start = 0
        for i, n in enumerate(nodes):
            if i == len(nodes) - 1:
                end = total_layers
            else:
                end = start + max(1, round(total_layers * n.weight / total_w))
                end = min(end, total_layers - (len(nodes) - 1 - i))
            out.append(LayerAssignment(rank=n.rank, start_layer=start,
                                       end_layer=end))
            start = end
        return out
