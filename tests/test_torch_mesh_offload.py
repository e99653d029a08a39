"""The port's host offload tier, priority preemption and snapshots over
a mesh of ranks, against the reference's engine on a (1, 4) mesh, on the
CPU.

``test_torch_offload.py``'s engine, trace and runs (GPT-2 small reduced,
4 slots, prefill 32, cap 48, 16-token pages, chunks of 8, a token budget
of 11; ``forced``: every request preempted by hand once it has a token;
``pressure``: a pool of 6 pages, two late requests at priority 1), and
its ``--jax-ref`` child (the reference's engine on (1, 4), exact mode),
with four gloo ranks (``torch_mesh_robust.py``):

  * (1, 4), exact: every rank's host decisions (``ServingEngine.trail``),
    tokens, preemptions, restore hits and misses, spilled pages,
    out-of-pages blocks and store stats equal the reference's: a rank
    spills its shard of a slot's pages, and its store counts the whole
    payload's bytes, as the reference's counts the global array;
  * prism on (1, 4), where the reference's restore raises, and both
    modes on (2, 2): held to the port's folded engine driven alike and
    to the uninterrupted run on the same mesh;
  * a snapshot cut mid-run (one request spilled at the cut) on every
    rank and restored into a fresh engine on the same ranks gives the
    uninterrupted tokens, in both modes; a (2, 2) engine refuses the
    (1, 4) snapshot.
"""
from __future__ import annotations

import os
import sys

import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_offload as O  # noqa: E402
import torch_mesh_robust as R  # noqa: E402

MODES = ("exact", "prism")
# the mesh runs beyond (1, 4) exact: (shape, mode, run); run None is the
# uninterrupted engine without offload
HELD = (((1, 4), "prism", "forced"), ((1, 4), "prism", "pressure"),
        ((2, 2), "exact", "forced"), ((2, 2), "prism", "pressure"))
PLAIN = (((1, 4), "prism"), ((2, 2), "exact"), ((2, 2), "prism"))
SNAP_AT = 6                            # engine steps before the cut


def _drive(eng, run):
    """``test_torch_offload.drive`` and what the ranks must share: the
    tokens, the schedule, the store's stats, the digest and the
    audit's verdict."""
    tokens, schedule = O.drive(eng, run, R.port_cfg().vocab_size)
    try:
        R.audit(eng)
        leak = None
    except AssertionError as e:
        leak = repr(e)
    return {"tokens": tokens, "schedule": schedule,
            "store": (eng.kv_store.stats() if eng.kv_store is not None
                      else None),
            "trail": eng.trail, "leak": leak}


def _snapshot(mp, mode):
    """The forced run's engine cut after ``SNAP_AT`` steps with one
    request preempted into the store, driven on, and a fresh engine on
    the same ranks restored from the cut and driven to the end."""
    def make():
        return R.engine(mp, mode, O.CR, O._config_kw("forced"))
    eng = make()
    for p in O._prompts(R.port_cfg().vocab_size):
        eng.submit(p, max_new_tokens=O.NEW)
    for _ in range(SNAP_AT):
        eng.step()
    victim = next(st.req.rid for st in eng._sched.active.values()
                  if not st.prefilling)
    assert eng.preempt(victim)
    snap = eng.snapshot()
    after = {str(k): v for k, v in eng.run().items()}
    fresh = make()
    fresh.restore(snap)
    restored = {str(k): v for k, v in fresh.run().items()}
    R.audit(fresh)
    return {"tokens": after, "restored": restored, "spilled_at_cut":
            len(snap.store_entries), "mesh": snap.mesh}, snap


def _rank_main(mesh, tree):
    from repro_torch.runtime.serve import mesh_params
    ms = R.meshes(mesh)
    mps = {s: mesh_params(R.port_cfg(), tree, m) for s, m in ms.items()}
    res = {}
    for run in O.RUNS:
        res[((1, 4), "exact", run)] = _drive(
            R.engine(mps[(1, 4)], "exact", O.CR, O._config_kw(run)), run)
    for shape, mode, run in HELD:
        res[(shape, mode, run)] = _drive(
            R.engine(mps[shape], mode, O.CR, O._config_kw(run)), run)
    for shape, mode in PLAIN:
        res[(shape, mode, None)] = _drive(
            R.engine(mps[shape], mode, O.CR, O._config_kw(None)), None)
    snaps = {}
    for mode in MODES:
        res[("snapshot", mode)], snaps[mode] = _snapshot(mps[(1, 4)], mode)
    other = R.engine(mps[(2, 2)], "exact", O.CR, O._config_kw("forced"))
    try:
        other.restore(snaps["exact"])
        res["refused"] = None
    except ValueError as e:
        res["refused"] = str(e)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child, started first; meanwhile the ranks and the
    port's folded engines of the runs held to them: (reference, ranks,
    folds by (shape, mode, run))."""
    child = R.start_reference(O, tmp_path_factory.mktemp("jax_offload"))
    n = torch.get_num_threads()
    try:
        tree = R.reference_tree()
        ranks = R.run_ranks(_rank_main, tree)
        torch.set_num_threads(1)
        params = R.fold_params(tree)
        folds = {(shape, mode, run): _drive(R.engine(
                     params, mode, O.CR, O._config_kw(run),
                     n_seq=shape[1]), run)
                 for shape, mode, run in HELD}
    finally:
        torch.set_num_threads(n)
        ref = R.finish_reference(child, "ref")
    R.check_tree(tree, ref)
    return ref, ranks, folds


@pytest.mark.parametrize("run", O.RUNS)
def test_exact_ranks_match_reference(runs, run):
    """(1, 4), exact: every rank's digest of its host decisions, then its
    tokens, agree; the tokens, schedule (preemptions, restore hits and
    misses, spilled pages, out-of-pages blocks, prefix hits) and store
    stats (bytes of the whole payload, puts, evictions, hits) equal the
    JAX engine's on the same mesh, and nothing leaks."""
    ref, ranks, _ = runs
    got = [r[((1, 4), "exact", run)] for r in ranks]
    R.assert_ranks_agree(got, run)
    want_tokens, want_schedule = ref["engine"][run]
    for rank, g in enumerate(got):
        assert g["tokens"] == want_tokens, rank
        assert g["schedule"] == want_schedule, rank
        assert g["store"] == ref["engine_store"][run], rank
        assert g["leak"] is None, g["leak"]
    assert want_schedule["preemptions"] >= (6 if run == "forced" else 1)
    assert want_schedule["restore_hits"] == want_schedule["preemptions"]


@pytest.mark.parametrize("cell", HELD, ids=lambda c: f"{c[0][0]}x{c[0][1]}-"
                         f"{c[1]}-{c[2]}")
def test_ranks_match_fold_and_uninterrupted(runs, cell):
    """Prism on (1, 4) and both modes on (2, 2): the ranks agree, and give
    the port's folded engine's tokens and schedule and store stats, and
    the tokens of the uninterrupted engine on the same mesh; nothing
    leaks."""
    _, ranks, folds = runs
    shape, mode, run = cell
    got = [r[cell] for r in ranks]
    R.assert_ranks_agree(got, str(cell))
    plain = ranks[0][(shape, mode, None)]["tokens"]
    for rank, g in enumerate(got):
        assert g["tokens"] == folds[cell]["tokens"] == plain, rank
        assert g["schedule"] == folds[cell]["schedule"], rank
        assert g["store"] == folds[cell]["store"], rank
        assert g["leak"] is None, g["leak"]
    assert got[0]["schedule"]["preemptions"] >= 1
    assert (got[0]["schedule"]["restore_hits"]
            == got[0]["schedule"]["preemptions"])


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_restores_on_the_same_ranks(runs, mode):
    """A snapshot cut on every rank of (1, 4) mid-run, one request in the
    store at the cut: the engine driven on and a fresh engine restored
    from the cut on the same ranks give the uninterrupted tokens (exact:
    the JAX engine's; prism: the uninterrupted mesh run's); each rank's
    snapshot names its mesh shape and rank."""
    ref, ranks, _ = runs
    want = (ref["engine"]["forced"][0] if mode == "exact"
            else ranks[0][((1, 4), "prism", None)]["tokens"])
    for rank, r in enumerate(ranks):
        got = r[("snapshot", mode)]
        assert got["spilled_at_cut"] == 1
        assert got["tokens"] == got["restored"] == want, rank
        assert got["mesh"] == ((1, 4), rank)


def test_snapshot_refused_on_another_mesh(runs):
    """A (2, 2) engine refuses a (1, 4) rank's snapshot: its payloads are
    another rank's shard of the pages."""
    _, ranks, _ = runs
    for r in ranks:
        assert r["refused"] is not None and "mesh shape" in r["refused"]
