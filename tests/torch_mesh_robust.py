"""Helpers of the port's robustness tests over a mesh of ranks
(``test_torch_mesh_offload.py``, ``_faults``, ``_degraded``, ``_stream``
and ``_admission``), each of which holds the ranks to the reference's
runs of its single-process module.

Each file runs its single-process module as the reference's child
(``--jax-ref``: four fake host devices in the child's environment, the
reference's engine on a (1, 4) mesh with the jnp backend) and,
meanwhile, four gloo ranks on the CPU (``launch/mesh.py::spawn``, one
thread a rank, a deadline on every spawn) over the same weights: the
reference's ``transformer.init`` at ``PRNGKey(0)``, which every child
draws, drawn here too so that the ranks need not wait for the child
(``check_tree`` holds the two equal).  The (2, 2) runs are a second
``Mesh`` over the same four ranks.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_ticks as K  # noqa: E402

#: seconds every rank of a spawn must end within
SPAWN_TIMEOUT = 300.0


def start_reference(module, tmp):
    """Start ``module``'s ``--jax-ref`` child -> (process, its output
    file, its log file)."""
    out, log = tmp / "ref.npz", tmp / "child.log"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, module.__file__,
                                 "--jax-ref", str(out)], env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, out, log


def finish_reference(child, key: str, merge: bool = True) -> dict:
    """Wait for the child and load what it saved: its JSON record under
    ``key`` merged into the arrays (or kept under ``key``)."""
    proc, out, log = child
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.read_text()[-4000:]
    with np.load(out) as z:
        ref = dict(z)
    rec = json.loads(str(ref.pop(key)))
    if merge:
        ref.update(rec)
    else:
        ref[key] = rec
    return ref


def reference_tree() -> dict:
    """The reference's seeded weights of the reduced GPT-2, as a numpy
    tree: what every single-process module's child draws."""
    import jax
    from repro.configs import get_config
    from repro.models import transformer as T
    cfg = get_config("gpt2-small").reduced()
    return jax.tree.map(np.asarray, T.init(cfg, jax.random.PRNGKey(0)))


def check_tree(tree: dict, ref: dict) -> None:
    """The child drew the weights the ranks served."""
    flat = {}
    K._flatten(tree, "params", flat)
    assert flat and all(np.array_equal(v, ref[k]) for k, v in flat.items())


def port_cfg():
    from repro_torch.configs import get_config
    return get_config("gpt2-small").reduced()


def fold_params(tree: dict):
    """The reference's tree as the port's whole parameters."""
    from repro_torch.convert import from_jax_numpy
    return from_jax_numpy(port_cfg(), tree, device="cpu")


def run_ranks(fn, *args) -> list:
    """``fn(mesh, *args)`` on four gloo ranks of a (1, 4) mesh on the
    CPU -> each rank's value."""
    from repro_torch.launch.mesh import spawn
    return spawn(fn, 1, 4, backend="gloo", device="cpu",
                 timeout=SPAWN_TIMEOUT, args=args)


def meshes(mesh) -> dict:
    """The rank's (1, 4) mesh and a (2, 2) mesh over the same ranks, by
    shape (every rank builds it together)."""
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(1)
    return {(1, 4): mesh, (2, 2): Mesh((2, 2), backend=mesh.backend,
                                       device="cpu")}


def engine(params, mode: str, cr: float, kw: dict, *, n_seq=None,
           clock=None):
    """The port's engine over ``params`` (a rank's ``MeshParams``, or the
    whole parameters folded over ``n_seq`` shards)."""
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    extra = {} if n_seq is None else {"n_seq": n_seq}
    return ServingEngine(port_cfg(), params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=cr), **kw),
        clock=clock or (lambda: 0.0), **extra)


def audit(eng) -> None:
    """Leak-free after the drain: the refcounts hold, only prefix entries
    hold pages, no slot is bound, the store is empty, every slot free."""
    kv = eng.kv_cache
    if kv.paged:
        kv.check()
        held = ({p for e in kv.prefix.entries.values() for p in e.pages}
                if kv.prefix is not None else set())
        assert not kv.slot_pages and not kv.slot_state
        assert kv.table.free_pages + len(held) == kv.paging.n_pages
    if eng.kv_store is not None:
        assert len(eng.kv_store) == 0 and eng.kv_store.bytes_used == 0
    assert sorted(eng._sched.free_slots) == list(range(eng.n_slots))


def assert_ranks_agree(runs: list, what: str) -> None:
    """Every rank's digest of its host decisions (``trail``), then its
    tokens, equal rank 0's: a desynchronised rank shows in the digest."""
    for rank, run in enumerate(runs[1:], 1):
        assert run["trail"] == runs[0]["trail"], f"{what}: rank {rank}"
    for rank, run in enumerate(runs[1:], 1):
        assert run["tokens"] == runs[0]["tokens"], f"{what}: rank {rank}"
