"""The collectives the reference calls inside ``shard_map``, over one
group of ranks of a mesh (``launch/mesh.py``).

    all_gather(x, grp, cls)          # (n, *x.shape): a new leading axis
    all_gather(x, grp, cls, dim=d)   # tiled along dim d
    psum(x, grp, cls), pmax(x, grp, cls)
    psum_scatter(x, grp, cls, dim=d) # lax.psum_scatter(tiled=True): the
                                     # sum's block of the group index
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

Under autograd (grad mode on and x requiring grad) every collective the
train step's forward issues carries a backward, the transpose JAX takes
under ``shard_map``: a gather's is a reduce-scatter (``psum_scatter``'s
a tiled gather), a psum's a psum, a ppermute by h one by -h (zeros where
nothing came), an all_to_all (s, c) one of (c, s), a broadcast's the
cotangents summed onto its source (a psum, then zeros elsewhere).
``pmax`` passes no gradient: the reference stops it.  ``pass_to`` has
none.  Every rank runs the same graph, so the autograd engine issues
the backward collectives in one order on all of them.

Every call names the class of traffic it carries, and the mesh's
``Meter`` adds up the bytes this rank sends under a ring algorithm:
(n - 1)·|x| for a gather, 2·(n - 1)·|x| / n for a reduction, (n - 1)·|x|
/ n for a reduce-scatter of x, (n - 1)·|x| from the source of a
broadcast, (n - 1)·|x| / n for an all_to_all (a rank keeps its own
block), |x| from each rank of a ppermute that has a receiver, |x| from
the source of a ``pass_to``.  A backward counts its own collective's
bytes.  The classes:

  * ``exchange``      the prefill's exchange: Segment Means (PRISM) or
                      the partitions (Voltage), and the means a Voltage
                      prefill captures for prism decode; a window
                      layer's ring halo, a recurrent layer's state
                      handoff, Mamba2's conv halo, the sLSTM's gathered
                      sequence;
  * ``combine``       the decode's cross-shard stats (pmax, psum), the
                      prism owner select, the last shard's rows;
  * ``param_gather``  the per-layer FSDP gathers (a remat's recompute
                      gathers again), and a train step's parameters
                      gathered back after AdamW over the axes its m/v
                      are cut over further;
  * ``tp``            the tensor-parallel activation psums and the q
                      gather, the vocab-parallel lookup and logits, the
                      vocab-parallel loss, a train step's metrics;
  * ``grad``          every collective of a train step's backward, the
                      gradient psums of ``GradReduce`` and the clip's
                      norm psum;
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

``gloo`` takes CUDA tensors for all_gather, all_reduce, broadcast,
reduce_scatter_tensor and all_to_all_single, passing them through the
host (torch 2.11 on an H100), but not for send and recv (its TCP pair
writes the tensor's device pointer: "writev ... Bad address").  So one
fixed rule: a ``ppermute`` of a CUDA tensor over a gloo group sends a
host copy and receives into host memory, then copies the result to the
tensor's device (``_stage_p2p``); it meters the same bytes.  Over nccl,
or on the CPU, the tensors go as they are.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import torch
import torch.distributed as dist

CLASSES = ("exchange", "combine", "param_gather", "tp", "grad", "expert",
           "engine", "replica")


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


class _Collective(torch.autograd.Function):
    """``fwd(x)``, whose backward is ``bwd(cotangent)``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()), None, None


def _with_grad(x: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """``fwd(x)``; where autograd records x, with ``bwd`` as its
    backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, fwd, bwd)
    return fwd(x)


def _gather(x: torch.Tensor, grp: Group, cls: str, dim) -> torch.Tensor:
    _count(grp, cls, (grp.size - 1) * x.numel() * x.element_size())
    src = x.contiguous()
    out = torch.empty((grp.size, *src.shape), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=grp.pg)
    if dim is None:
        return out
    return torch.cat(out.unbind(0), dim=dim)


def _scatter(x: torch.Tensor, grp: Group, cls: str, dim) -> torch.Tensor:
    """The sum over the group of x's block at the group index: x cut
    into n blocks along ``dim``, or x (n, ...) indexed on its leading
    axis (``dim`` None)."""
    n = grp.size
    blocks = x.unbind(0) if dim is None else x.chunk(n, dim=dim)
    if len(blocks) != n or x.shape[0 if dim is None else dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    _count(grp, cls, (n - 1) * x.numel() * x.element_size() // n)
    src = [b.contiguous() for b in blocks]
    out = torch.empty_like(src[0])
    dist.reduce_scatter(out, src, group=grp.pg)
    return out


def _reduce(x: torch.Tensor, grp: Group, cls: str, op) -> torch.Tensor:
    n_bytes = x.numel() * x.element_size()
    _count(grp, cls, 2 * (grp.size - 1) * n_bytes // grp.size)
    buf = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=grp.pg)
    return buf


def all_gather(x: torch.Tensor, grp: Group, cls: str, *,
               dim: int | None = None) -> torch.Tensor:
    """Every rank's x, in the group's order: stacked on a new leading
    axis (``dim`` None), or tiled along ``dim``.  Backward: the
    reduce-scatter."""
    if grp.size == 1:
        return x[None] if dim is None else x
    return _with_grad(x, lambda t: _gather(t, grp, cls, dim),
                      lambda g: _scatter(g, grp, "grad", dim))


def psum_scatter(x: torch.Tensor, grp: Group, cls: str, *,
                 dim: int) -> torch.Tensor:
    """The tiled ``lax.psum_scatter``: the sum over the group of x, cut
    into n blocks along ``dim``, this rank's block (its group index).
    Backward: the tiled gather."""
    if grp.size == 1:
        return x
    return _with_grad(x, lambda t: _scatter(t, grp, cls, dim),
                      lambda g: _gather(g, grp, "grad", dim))


def psum(x: torch.Tensor, grp: Group, cls: str) -> torch.Tensor:
    """The sum of every rank's x.  Backward: the psum."""
    if grp.size == 1:
        return x
    return _with_grad(
        x, lambda t: _reduce(t, grp, cls, dist.ReduceOp.SUM),
        lambda g: _reduce(g, grp, "grad", dist.ReduceOp.SUM))


def pmax(x: torch.Tensor, grp: Group, cls: str) -> torch.Tensor:
    """The elementwise max of every rank's x; no gradient (the
    reference stops it)."""
    if grp.size == 1:
        return x.detach()
    return _reduce(x, grp, cls, dist.ReduceOp.MAX)


def _broadcast(x: torch.Tensor, grp: Group, cls: str,
               src: int) -> torch.Tensor:
    if grp.index == src:
        _count(grp, cls, (grp.size - 1) * x.numel() * x.element_size())
    buf = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(buf, src=grp.ranks[src], group=grp.pg)
    return buf


def broadcast(x: torch.Tensor, grp: Group, cls: str, *,
              src: int = 0) -> torch.Tensor:
    """The x of the group's index ``src``, on every rank.  Backward: the
    cotangents summed onto ``src`` (a psum), zeros elsewhere."""
    if grp.size == 1:
        return x

    def back(g):
        s = _reduce(g, grp, "grad", dist.ReduceOp.SUM)
        return s if grp.index == src else torch.zeros_like(s)
    return _with_grad(x, lambda t: _broadcast(t, grp, cls, src), back)


def last_shard(x: torch.Tensor, grp: Group, cls: str) -> torch.Tensor:
    """The x of the group's last rank, on every rank: the value of the
    shard that owns the end of the sequence (the reference's psum of a
    one-hot-masked value, as one broadcast)."""
    return broadcast(x, grp, cls, src=grp.size - 1)


def _all_to_all(x: torch.Tensor, grp: Group, cls: str, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = grp.size
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    _count(grp, cls, (n - 1) * x.numel() * x.element_size() // n)
    src = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=grp.pg)
    return torch.cat(out.unbind(0), dim=concat_dim)


def all_to_all(x: torch.Tensor, grp: Group, cls: str, *, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled ``lax.all_to_all``: x cut into n equal blocks along
    ``split_dim``, block j sent to the group's rank j, and the blocks
    received laid side by side along ``concat_dim`` in the order of
    their senders.  Backward: the all_to_all with the two dims
    swapped."""
    if grp.size == 1:
        return x
    return _with_grad(
        x, lambda t: _all_to_all(t, grp, cls, split_dim, concat_dim),
        lambda g: _all_to_all(g, grp, "grad", concat_dim, split_dim))


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
        src = x.detach().cpu() if host else x.detach()
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
    (``_stage_p2p``).  Backward: the shift by -``shift``, zeros on the
    ranks whose x reached no one."""
    if shift < 1:
        raise ValueError(f"ppermute shifts up by 1 or more, not {shift}")
    i, n = grp.index, grp.size
    if ring:
        if n == 1:
            return x
        return _with_grad(
            x, lambda t: _p2p(t, grp, cls, (i + shift) % n,
                              (i - shift) % n),
            lambda g: _p2p(g, grp, "grad", (i - shift) % n,
                           (i + shift) % n))
    if n == 1:
        return torch.zeros_like(x)
    up = i + shift if i + shift < n else None
    down = i - shift if i - shift >= 0 else None
    return _with_grad(x, lambda t: _p2p(t, grp, cls, up, down),
                      lambda g: _p2p(g, grp, "grad", down, up))


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
