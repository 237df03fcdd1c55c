"""Distributed serving across processes and hosts.

Counterpart of ``blazr_tpu/distributed``: the lockstep op stream of a mesh's
ranks (``lockstep.py``), the tagged TCP transport (``transport.py``), the
swarm's topology and pipeline stages (``topology.py``, ``swarm.py``), the
disaggregated prefill/decode pools (``disagg.py``) and the wire format of
their tensors (``kv_serialize.py``).
"""

from .disagg import DecodeWorker, DisaggConfig, DisaggRouter, PrefillWorker
from .kv_serialize import (
    deserialize_arrays,
    deserialize_kv_cache,
    serialize_arrays,
    serialize_kv_cache,
)
from .lockstep import LockstepEngine
from .swarm import SwarmLeader, SwarmWorker
from .topology import (
    LayerAssignment,
    PipelineSchedule,
    SwarmConfig,
    SwarmManager,
    SwarmNode,
    SwarmRole,
)
from .transport import TcpMesh, tags
