"""Collectives between ranks, and which backend carries them.

The JAX package lets GSPMD insert its collectives (psum, all-gather,
ppermute over ICI). The port runs one process per rank and issues each
collective itself, through ``torch.distributed``:

  * ``all_reduce``: the row-parallel sums after ``o`` and ``down``, the
    vocab-parallel embedding, the expert-parallel MoE sum;
  * ``all_gather``: the column-parallel ``lm_head`` logits, gathered whole on
    every rank, and the K/V of a ring prefill;
  * ``shift``: one hop of the ring (send to the next rank, receive from the
    previous one);
  * ``broadcast``: a tensor from one rank of a group.

The backend rule (``choose_backend``) is fixed: NCCL where every rank has a
CUDA device of its own, gloo where ranks share a device or run on the CPU.
gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only, so under
gloo an all-gather or a point-to-point hop of a CUDA tensor goes through an
explicit host copy; every product still runs on the card.

``stats`` counts each kind of collective and, while ``stats.timed`` is set,
its wall ms (a device synchronize on each side: for measurement only).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Optional

import torch
import torch.distributed as dist


def choose_backend(device_type: str, world: int, device_count: int) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo (ranks
    sharing a card, or ranks on the CPU)."""
    if device_type == "cuda" and world <= device_count:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class Axis:
    """One axis of the rank mesh as this rank sees it: its process group
    (None when the axis has one rank), this rank's index along it, and the
    global ranks of the group in axis order."""

    name: str
    group: Optional[object]
    index: int
    ranks: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.ranks)


class _Stats:
    def __init__(self) -> None:
        self.calls: dict[str, int] = defaultdict(int)
        self.ms: dict[str, float] = defaultdict(float)
        self.timed = False

    def reset(self) -> None:
        self.calls.clear()
        self.ms.clear()

    def snapshot(self) -> dict:
        return {k: {"calls": self.calls[k], "ms": self.ms.get(k, 0.0)}
                for k in sorted(self.calls)}


stats = _Stats()


class _count:
    def __init__(self, kind: str, t: torch.Tensor) -> None:
        self.kind, self.t = kind, t

    def __enter__(self):
        stats.calls[self.kind] += 1
        if stats.timed:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if stats.timed:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            stats.ms[self.kind] += (time.perf_counter() - self.t0) * 1e3


def _host_path(t: torch.Tensor, group) -> bool:
    """A CUDA tensor under gloo: gathers and hops go through the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum ``x`` over the axis' ranks, in place; identity on one rank. Every
    rank gets the same bits (the backends reduce each chunk once)."""
    if axis is None or axis.size == 1:
        return x
    if x.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(axis.group) == "gloo":
        # gloo sums 16-bit floats in their own width on the host; sum in f32.
        return all_reduce(x.float(), axis).to(x.dtype)
    if not x.is_contiguous():
        x = x.contiguous()
    with _count("all_reduce", x):
        dist.all_reduce(x, group=axis.group)
    return x


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int = -1) -> torch.Tensor:
    """The axis' ranks' ``x`` concatenated along ``dim`` in axis order."""
    if axis is None or axis.size == 1:
        return x
    src = x.contiguous()
    host = _host_path(src, axis.group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    with _count("all_gather", x):
        dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


def broadcast(x: torch.Tensor, axis: Optional[Axis], src_index: int) -> torch.Tensor:
    """``x`` of the rank at ``src_index`` along the axis, on every rank of
    it (in place)."""
    if axis is None or axis.size == 1:
        return x
    x = x.contiguous()
    with _count("broadcast", x):
        dist.broadcast(x, src=axis.ranks[src_index], group=axis.group)
    return x


def shift(tensors: list[torch.Tensor], axis: Axis) -> list[torch.Tensor]:
    """One ring hop: send each tensor to the next rank of the axis and
    receive the previous rank's (same shapes), all at once."""
    nxt = axis.ranks[(axis.index + 1) % axis.size]
    prv = axis.ranks[(axis.index - 1) % axis.size]
    dev = tensors[0].device
    host = _host_path(tensors[0], axis.group)
    outs = [t.contiguous().cpu() if host else t.contiguous() for t in tensors]
    bufs = [torch.empty_like(t) for t in outs]
    with _count("shift", tensors[0]):
        works = []
        for t, b in zip(outs, bufs):
            works.append(dist.isend(t, dst=nxt, group=axis.group))
            works.append(dist.irecv(b, src=prv, group=axis.group))
        for w in works:
            w.wait()
    return [b.to(dev) for b in bufs] if host else bufs
