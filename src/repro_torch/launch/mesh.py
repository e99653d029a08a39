"""The mesh of ranks a distributed run serves over: the counterpart of
the reference's ``launch/mesh.py`` (``mesh_axes``, ``batch_axes``, the
host mesh).

The reference lays its devices out as a ("data", "model") mesh, or
("pod", "data", "model"), and runs each program under ``shard_map``.
The port runs one process a mesh position: rank r sits at the
coordinates ``np.unravel_index(r, shape)`` (the last axis fastest, as
``jax.make_mesh`` lays devices out) and exchanges over
``torch.distributed`` groups, one for every set of axes (``Mesh.group``):
the ranks that share every other coordinate, in the order of their
coordinate over the set, the first axis major (the reference's
``_index`` over combined axes).

Rank r runs on ``cuda:{r % device_count}``, or on the CPU where the
caller asks for it.  The backend is the caller's, never chosen here:
``nccl`` takes one rank a card; ``gloo`` any number of ranks a card, or
the CPU, its collectives going through the host (``sharding/comm.py``).
``device`` 'cuda' raises where there is no card.

``spawn`` starts the ranks of a mesh as processes (the ``spawn`` start
method), each initialised from a ``file://`` store in a temporary
directory (no TCP port to collide) with the caller's timeout, runs
``fn(mesh, *args)`` in each and returns what each returned.

``make_production_mesh`` is not ported: it names TPU pod shapes.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..sharding.comm import Group, Meter

AXES = ("data", "model")
BACKENDS = ("nccl", "gloo")
#: seconds every rank of a served run must end within (``spawn``)
MESH_TIMEOUT = 600.0


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``Mesh``, or of such a dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    """Axes the global batch is sharded over."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def check_backend(backend: str, world: int, device: str) -> None:
    """Raise for a backend the ranks cannot run: ``nccl`` off the card,
    or with two ranks on one card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("nccl runs on CUDA devices only; pass "
                         "backend='gloo' for ranks on the CPU")
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(
            f"nccl would put {world} ranks on {cards} card(s), two ranks on "
            "one card, which it refuses; pass backend='gloo' to run them "
            "over the host")


class Mesh:
    """This rank's place in a mesh of ``shape`` over ``axis_names``: its
    coordinates, its device, one ``comm.Group`` for every set of axes and
    the ``Meter`` of what it sends.  Needs the default process group
    initialised over prod(shape) ranks; every rank builds its mesh
    together (``new_group`` is collective)."""

    def __init__(self, shape, axis_names=AXES, *, backend: str,
                 device: str = "cuda"):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} for axes "
                             f"{self.axis_names}")
        world = math.prod(self.shape)
        check_backend(backend, world, device)
        device = resolve_device(device)
        if not dist.is_initialized() or dist.get_world_size() != world:
            raise RuntimeError(f"a mesh of {self.shape} needs the default "
                               f"process group over {world} ranks")
        self.backend = backend
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, (int(c) for c in
                           np.unravel_index(self.rank, self.shape))))
        if device.type == "cuda":
            self.device = torch.device(
                "cuda", self.rank % torch.cuda.device_count())
        else:
            self.device = torch.device("cpu")
        self.meter = Meter()
        self._groups = {}
        grid = np.arange(world).reshape(self.shape)
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[axes] = self._make_group(axes, grid)

    def _make_group(self, axes: tuple, grid) -> Group:
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.shape)) if d not in dims]
        # each block of ranks sharing the other coordinates, in the order
        # of their coordinate over ``axes``
        blocks = np.transpose(grid, rest + dims).reshape(
            -1, math.prod(self.shape[d] for d in dims))
        mine = None
        for block in blocks:
            ranks = tuple(int(r) for r in block)
            if len(ranks) == 1:
                pg = None
            elif len(ranks) == grid.size:
                pg = dist.group.WORLD
            else:
                pg = dist.new_group(list(ranks), backend=self.backend)
            if self.rank in ranks:
                mine = Group(axes, ranks, ranks.index(self.rank), pg,
                             self.meter)
        return mine

    def size(self, axes) -> int:
        return math.prod(self.shape[self.axis_names.index(a)] for a in axes)

    def group(self, axes) -> Group:
        """The group over ``axes`` (a name or a tuple, in mesh order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[tuple(a for a in self.axis_names if a in axes)]


def make_host_mesh(model: int = 4, data: int = 2, *, backend: str,
                   device: str) -> Mesh:
    """This rank's (data, model) mesh (the reference's host mesh), over a
    default process group already initialised (``spawn`` builds one for
    each of its ranks)."""
    return Mesh((data, model), AXES, backend=backend, device=device)


def _rank_main(fn, rank: int, shape: tuple, backend: str, device: str,
               timeout: float, tmp: str, args: tuple) -> None:
    """One rank of ``spawn``: the process group, the mesh, fn; its return
    value or its traceback written under ``tmp``."""
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=math.prod(shape), rank=rank,
            timeout=timedelta(seconds=timeout))
        try:
            out = fn(make_host_mesh(shape[1], shape[0], backend=backend,
                                    device=device), *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, data: int, model: int, *, backend: str, device: str,
          timeout: float, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on the data·model ranks of a (data, model)
    mesh, one process each, and return each rank's value (saved with
    ``torch.save``), by rank.  ``fn`` must be importable by name.  Every
    rank must end within ``timeout`` seconds, which also bounds each
    collective; a rank that fails or runs late fails the call: the
    others are killed and it raises, with the failed rank's traceback."""
    world = data * model
    check_backend(backend, world, device)
    resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, (data, model), backend, device,
                                   timeout, tmp, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = list(procs)
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {[procs.index(p) for p in pending]} of a "
                        f"({data}, {model}) mesh missed the {timeout} s "
                        "deadline")
                multiprocessing.connection.wait(
                    [p.sentinel for p in pending], timeout=left)
                for p in [p for p in pending if not p.is_alive()]:
                    pending.remove(p)
                    if p.exitcode != 0:
                        r = procs.index(p)
                        err = os.path.join(tmp, f"rank{r}.err")
                        why = (open(err).read() if os.path.exists(err)
                               else "no traceback")
                        raise RuntimeError(f"rank {r} of a ({data}, {model}) "
                                           f"mesh exited {p.exitcode}:\n"
                                           f"{why}")
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
