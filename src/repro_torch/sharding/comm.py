"""The collectives the reference calls inside ``shard_map``, over one
group of ranks of a mesh (``launch/mesh.py``).

    all_gather(x, grp, cls)          # (n, *x.shape): a new leading axis
    all_gather(x, grp, cls, dim=d)   # tiled along dim d
    psum(x, grp, cls), pmax(x, grp, cls)
    broadcast(x, grp, cls, src=i)    # the x of group index i, on every rank
    last_shard(x, grp, cls)          # the last rank's x, on every rank
    all_to_all(x, grp, cls, split_dim=s, concat_dim=c)
                                     # lax.all_to_all(tiled=True)
    ppermute(x, grp, cls, shift=h)   # x to group index i + h; zeros in
    ppermute(x, grp, cls, shift=h, ring=True)
                                     # x to group index (i + h) mod n
    pass_to(x, grp, cls, src=s, dst=d)
                                     # group index s's x, on index d

A group of one rank returns x (a gather: x with its new axis; a
ppermute: zeros, a ring: x) and sends nothing.

Every call names the class of traffic it carries, and the mesh's
``Meter`` adds up the bytes this rank sends under a ring algorithm:
(n - 1)·|x| for a gather, 2·(n - 1)·|x| / n for a reduction, (n - 1)·|x|
from the source of a broadcast, (n - 1)·|x| / n for an all_to_all (a
rank keeps its own block), |x| from each rank of a ppermute that has a
receiver, |x| from the source of a ``pass_to``.  The classes:

  * ``exchange``      the prefill's exchange: Segment Means (PRISM) or
                      the partitions (Voltage), and the means a Voltage
                      prefill captures for prism decode; a window
                      layer's ring halo, a recurrent layer's state
                      handoff, Mamba2's conv halo, the sLSTM's gathered
                      sequence;
  * ``combine``       the decode's cross-shard stats (pmax, psum), the
                      prism owner select, the last shard's rows;
  * ``param_gather``  the per-layer FSDP gathers;
  * ``tp``            the tensor-parallel activation psums and the q
                      gather, the vocab-parallel lookup and logits;
  * ``expert``        a MoE layer's dispatch and return (the all_to_all
                      pair over ``model``), and expert-TP's token gather
                      and partial sums over ``data``;
  * ``engine``        the serving engine's agreement over its ranks:
                      rank 0's clock reading and its choice of a request
                      to cancel or preempt, a dense cache's decode
                      logits and padded-flush rows gathered over the
                      batch axes;
  * ``replica``       the Segment-Means standby replicas of the degraded
                      mesh: each rank's cut of its own shard sent to its
                      ring neighbour at a capture, and the neighbour's
                      copy sent back to the lost shard's rank at a loss.

``gloo`` takes CUDA tensors for all_gather, all_reduce, broadcast and
all_to_all_single, passing them through the host, but not for send and
recv (its TCP pair writes the tensor's device pointer: "writev ... Bad
address", on an H100 with torch 2.11).  So one fixed rule: a
``ppermute`` of a CUDA tensor over a gloo group sends a host copy and
receives into host memory, then copies the result to the tensor's
device (``_stage_p2p``); it meters the same bytes.  Over nccl, or on the
CPU, the tensors go as they are.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import torch
import torch.distributed as dist

CLASSES = ("exchange", "combine", "param_gather", "tp", "expert", "engine",
           "replica")


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


def broadcast(x: torch.Tensor, grp: Group, cls: str, *,
              src: int = 0) -> torch.Tensor:
    """The x of the group's index ``src``, on every rank."""
    if grp.size == 1:
        return x
    if grp.index == src:
        _count(grp, cls, (grp.size - 1) * x.numel() * x.element_size())
    buf = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(buf, src=grp.ranks[src], group=grp.pg)
    return buf


def last_shard(x: torch.Tensor, grp: Group, cls: str) -> torch.Tensor:
    """The x of the group's last rank, on every rank: the value of the
    shard that owns the end of the sequence (the reference's psum of a
    one-hot-masked value, as one broadcast)."""
    return broadcast(x, grp, cls, src=grp.size - 1)


def all_to_all(x: torch.Tensor, grp: Group, cls: str, *, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled ``lax.all_to_all``: x cut into n equal blocks along
    ``split_dim``, block j sent to the group's rank j, and the blocks
    received laid side by side along ``concat_dim`` in the order of
    their senders."""
    if grp.size == 1:
        return x
    n = grp.size
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    _count(grp, cls, (n - 1) * x.numel() * x.element_size() // n)
    src = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=grp.pg)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _stage_p2p(x: torch.Tensor, grp: Group) -> bool:
    """The staging rule of ``ppermute``: a CUDA tensor over gloo."""
    return x.is_cuda and dist.get_backend(grp.pg) == "gloo"


def _p2p(x: torch.Tensor, grp: Group, cls: str, to, frm) -> torch.Tensor:
    """Send x to the group's index ``to`` and receive from ``frm`` (either
    None): the received tensor, zeros where nothing comes.  Over gloo a
    CUDA tensor goes through host memory (``_stage_p2p``)."""
    host = _stage_p2p(x, grp)
    out = torch.zeros(x.shape, dtype=x.dtype,
                      device="cpu" if host else x.device)
    ops = []
    if to is not None:
        _count(grp, cls, x.numel() * x.element_size())
        src = x.cpu() if host else x
        ops.append(dist.P2POp(dist.isend, src.contiguous(), grp.ranks[to],
                              grp.pg))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, out, grp.ranks[frm], grp.pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if host else out


def ppermute(x: torch.Tensor, grp: Group, cls: str, *, shift: int,
             ring: bool = False) -> torch.Tensor:
    """x sent to the group's index i + ``shift`` (shift >= 1); each rank
    returns what the rank ``shift`` below it sent, zeros where there is
    none (the first ``shift`` ranks), as ``lax.ppermute`` fills them.
    ``ring``: the indices wrap, x goes to (i + shift) mod n and every
    rank receives.  Over gloo a CUDA tensor goes through host memory
    (``_stage_p2p``)."""
    if shift < 1:
        raise ValueError(f"ppermute shifts up by 1 or more, not {shift}")
    i, n = grp.index, grp.size
    if ring:
        if n == 1:
            return x
        return _p2p(x, grp, cls, (i + shift) % n, (i - shift) % n)
    if n == 1:
        return torch.zeros_like(x)
    return _p2p(x, grp, cls, i + shift if i + shift < n else None,
                i - shift if i - shift >= 0 else None)


def pass_to(x: torch.Tensor, grp: Group, cls: str, *, src: int,
            dst: int):
    """The x of the group's index ``src``, on index ``dst`` (every rank
    calls it with a tensor of one shape); every other rank gets None.
    Over gloo a CUDA tensor goes through host memory."""
    i = grp.index
    if src == dst:
        return x if i == dst else None
    if i not in (src, dst):
        return None
    out = _p2p(x, grp, cls, dst if i == src else None,
               src if i == dst else None)
    return out if i == dst else None
