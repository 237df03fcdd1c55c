"""The rank mesh.

Counterpart of ``blazr_tpu/parallel/mesh.py`` (:26-78). The JAX package
builds one ``Mesh`` over the device grid with axes (dp, ep, sp, tp) and runs
one SPMD program. The port runs one process per rank (``multihost.py``) and
gives each the process groups of its axes, with tp innermost as in
``make_mesh``'s reshape (:72-75): rank = (ep_i * sp + sp_i) * tp + tp_i.

  * ``tp``: tensor parallel (column/row-split projections, vocab-split
    embedding and head);
  * ``sp``: sequence parallel (ring-attention prefill);
  * ``ep``: expert parallel (each rank holds E/ep experts);
  * ``moe``: the ep×tp ranks of one sp index, over which a MoE layer's
    routed sum is reduced.

``dp`` (data parallel) is replica routing (``engine/data_parallel.py``), as
in the JAX package, and takes no axis (``blazr_tpu/parallel/tp.py:240-246``).
Every rank builds every group in one fixed order, as ``torch.distributed``
requires; the lockstep op stream has a group of its own (``control``, always
gloo), apart from the forwards' collectives.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Optional

import torch
import torch.distributed as dist

from .comm import Axis

logger = logging.getLogger(__name__)

AXES = ("ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    tp: int = 1
    ep: int = 1
    sp: int = 1          # sequence parallel (ring-attention prefill)

    @property
    def ranks(self) -> int:
        """Processes the mesh runs on."""
        return self.tp * self.ep * self.sp


def validate_tp_size(cfg, tp: int) -> None:
    """Divisibility validation (reference tensor_parallel.rs:76-103), with
    the JAX package's messages."""
    if tp <= 1:
        return
    att = cfg.attention
    if att is not None:
        if att.num_heads % tp != 0:
            raise ValueError(
                f"num_heads {att.num_heads} not divisible by tp={tp}")
        kv = att.kv_heads()
        if kv % tp != 0 and tp % kv != 0:
            raise ValueError(
                f"num_kv_heads {kv} not divisible by (or a divisor of) tp={tp}")
    inter = cfg.resolved_intermediate_size()
    if inter % tp != 0:
        raise ValueError(
            f"intermediate_size {inter} not divisible by tp={tp}")
    if cfg.vocab_size % tp != 0:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by tp={tp}")


def coords(rank: int, cfg: MeshConfig) -> dict[str, int]:
    """(ep, sp, tp) indices of a global rank, tp innermost."""
    return {"tp": rank % cfg.tp, "sp": rank // cfg.tp % cfg.sp,
            "ep": rank // (cfg.tp * cfg.sp)}


def rank_of(c: dict[str, int], cfg: MeshConfig) -> int:
    return (c["ep"] * cfg.sp + c["sp"]) * cfg.tp + c["tp"]


@dataclasses.dataclass
class RankMesh:
    """One rank's view of the mesh: its axes, the ``moe`` (ep×tp) group, the
    gloo ``control`` group of the lockstep op stream, and its device."""

    cfg: MeshConfig
    rank: int
    world: int
    device: torch.device
    backend: str
    axes: dict[str, Axis]
    control: Optional[object] = None

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def size(self, name: str) -> int:
        return self.axes[name].size

    def index(self, name: str) -> int:
        return self.axes[name].index

    def describe(self) -> str:
        return (f"rank {self.rank}/{self.world} on {self.device} over {self.backend} "
                f"(tp {self.cfg.tp}, sp {self.cfg.sp}, ep {self.cfg.ep})")


def _groups_along(cfg: MeshConfig, names: tuple[str, ...]) -> list[tuple[int, ...]]:
    """Every group whose ranks vary along ``names`` and agree elsewhere."""
    sizes = {"ep": cfg.ep, "sp": cfg.sp, "tp": cfg.tp}
    fixed = [a for a in AXES if a not in names]
    out = []
    for fv in itertools.product(*(range(sizes[a]) for a in fixed)):
        base = dict(zip(fixed, fv))
        ranks = []
        for vv in itertools.product(*(range(sizes[a]) for a in names)):
            ranks.append(rank_of({**base, **dict(zip(names, vv))}, cfg))
        out.append(tuple(ranks))
    return out


def make_mesh(cfg: MeshConfig, device: torch.device) -> RankMesh:
    """This rank's mesh over the initialized default group, whose world must
    be ``cfg.ranks``. Builds every group on every rank in one order."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {cfg.ranks} ranks needs torch.distributed: start the ranks with "
            "parallel.multihost.init_distributed (the CLI does so for --tp/--sp/--ep)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != cfg.ranks:
        raise ValueError(f"mesh needs {cfg.ranks} ranks (tp {cfg.tp} x sp {cfg.sp} x "
                         f"ep {cfg.ep}), the world has {world}")
    me = coords(rank, cfg)
    axes: dict[str, Axis] = {}
    for name, along in (("tp", ("tp",)), ("sp", ("sp",)), ("ep", ("ep",)),
                        ("moe", ("ep", "tp"))):
        for ranks in _groups_along(cfg, along):
            # new_group is collective over the world: every rank makes every
            # group, in this order, whether it belongs to it or not.
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                axes[name] = Axis(name, group, ranks.index(rank), ranks)
    control = dist.new_group(list(range(world)), backend="gloo") if world > 1 else None
    mesh = RankMesh(cfg, rank, world, device, dist.get_backend(), axes, control)
    logger.info("mesh: %s (coords %s)", mesh.describe(), me)
    return mesh
