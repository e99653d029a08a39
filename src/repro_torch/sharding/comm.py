"""The collectives the reference calls inside ``shard_map``, over one
group of ranks of a mesh (``launch/mesh.py``).

    all_gather(x, grp, cls)          # (n, *x.shape): a new leading axis
    all_gather(x, grp, cls, dim=d)   # tiled along dim d
    psum(x, grp, cls), pmax(x, grp, cls)
    last_shard(x, grp, cls)          # the last rank's x, on every rank

A group of one rank returns x (a gather: x with its new axis) and sends
nothing.

Every call names the class of traffic it carries, and the mesh's
``Meter`` adds up the bytes this rank sends under a ring algorithm:
(n - 1)·|x| for a gather, 2·(n - 1)·|x| / n for a reduction, (n - 1)·|x|
from the source of a broadcast.  The classes:

  * ``exchange``      the prefill's exchange: Segment Means (PRISM) or
                      the partitions (Voltage), and the means a Voltage
                      prefill captures for prism decode;
  * ``combine``       the decode's cross-shard stats (pmax, psum), the
                      prism owner select, the last shard's rows;
  * ``param_gather``  the per-layer FSDP gathers;
  * ``tp``            the tensor-parallel activation psums and the q
                      gather, the vocab-parallel lookup and logits.

``gloo`` takes CUDA tensors for all three collectives called here
(all_gather, all_reduce, broadcast), passing them through the host.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import torch
import torch.distributed as dist

CLASSES = ("exchange", "combine", "param_gather", "tp")


class Meter:
    """What one rank sent, in bytes by class."""

    def __init__(self):
        self.sent: collections.Counter = collections.Counter()

    def reset(self) -> None:
        self.sent.clear()

    def snapshot(self) -> dict:
        return {"sent": {c: self.sent[c] for c in CLASSES}}


@dataclass(frozen=True)
class Group:
    """The ranks of a mesh that share every coordinate but those of
    ``axes``: ``ranks`` in the order of their coordinate over ``axes``
    (the first axis major), this rank at ``index``."""
    axes: tuple
    ranks: tuple
    index: int
    pg: object                 # a torch.distributed group; None for one rank
    meter: Meter

    @property
    def size(self) -> int:
        return len(self.ranks)


def _count(grp: Group, cls: str, n_bytes: int) -> None:
    if cls not in CLASSES:
        raise ValueError(f"traffic class {cls!r} not in {CLASSES}")
    grp.meter.sent[cls] += n_bytes


def all_gather(x: torch.Tensor, grp: Group, cls: str, *,
               dim: int | None = None) -> torch.Tensor:
    """Every rank's x, in the group's order: stacked on a new leading
    axis (``dim`` None), or tiled along ``dim``."""
    if grp.size == 1:
        return x[None] if dim is None else x
    _count(grp, cls, (grp.size - 1) * x.numel() * x.element_size())
    src = x.contiguous()
    out = torch.empty((grp.size, *src.shape), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=grp.pg)
    if dim is None:
        return out
    return torch.cat(out.unbind(0), dim=dim)


def _all_reduce(x: torch.Tensor, grp: Group, cls: str, op) -> torch.Tensor:
    if grp.size == 1:
        return x
    n_bytes = x.numel() * x.element_size()
    _count(grp, cls, 2 * (grp.size - 1) * n_bytes // grp.size)
    buf = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=grp.pg)
    return buf


def psum(x: torch.Tensor, grp: Group, cls: str) -> torch.Tensor:
    """The sum of every rank's x."""
    return _all_reduce(x, grp, cls, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, grp: Group, cls: str) -> torch.Tensor:
    """The elementwise max of every rank's x."""
    return _all_reduce(x, grp, cls, dist.ReduceOp.MAX)


def last_shard(x: torch.Tensor, grp: Group, cls: str) -> torch.Tensor:
    """The x of the group's last rank, on every rank: the value of the
    shard that owns the end of the sequence (the reference's psum of a
    one-hot-masked value, as one broadcast)."""
    if grp.size == 1:
        return x
    src = grp.ranks[-1]
    if grp.index == grp.size - 1:
        _count(grp, cls, (grp.size - 1) * x.numel() * x.element_size())
    buf = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(buf, src=src, group=grp.pg)
    return buf
