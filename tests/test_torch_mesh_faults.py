"""The port's fault injection, deadlines, NaN quarantine and snapshots
over a mesh of ranks, against the reference's engine on a (1, 4) mesh,
on the CPU.

``test_torch_faults.py``'s engine, trace, plans and ``--jax-ref`` child
(the reference's engine on (1, 4), exact mode, 4 slots, prefill 32, cap
48, the prefix cache off), with four gloo ranks
(``torch_mesh_robust.py``), exact on (1, 4):

  * ``FaultPlan.chaos`` seeds 0 and 1 (``shard_loss`` off) and the plan
    that fires every kind at a fixed opportunity, every request preempted
    by hand once it has a token: every rank's injector draws (the
    injector's ``trail``), then its digest of host decisions, then its
    tokens agree; the tokens, failures and fault and recovery counters
    equal the reference's; nothing leaks;
  * the snapshot run (three requests over two slots, one spilled at the
    cut, restored into two fresh engines on the same ranks): the
    reference's tokens and the restored engine's counters;
  * deadlines in every lifecycle state with a clock that reads
    differently on every rank and client calls that name other requests
    off rank 0: rank 0's readings and choices rule, and every rank
    expires and reclaims as the port's folded engine does.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_faults as F  # noqa: E402
import torch_mesh_robust as R  # noqa: E402


def _make(mp, clock=None, **over):
    return R.engine(mp, "exact", F.CR, F._kw(**over), clock=clock)


def _chaos(mp, name):
    from repro_torch.runtime import faults
    eng = _make(mp, offload=True, max_restarts=8,
                faults=F.chaos_plan(faults, name))
    out = F.run_chaos(eng, R.port_cfg().vocab_size)
    try:
        R.audit(eng)
        leak = None
    except AssertionError as e:
        leak = repr(e)
    return {"result": list(out), "tokens": out[0], "draws":
            eng._injector.trail, "trail": eng.trail, "leak": leak}


class _RankClock:
    """A logical clock read at a rank's own offset: only rank 0's
    readings may count."""

    def __init__(self, rank: int):
        self.t, self.offset = 0.0, 1000.0 * rank

    def __call__(self):
        return self.t + self.offset


def deadlines(eng, clk, rank: int):
    """``test_torch_faults.py``'s every-state deadline case: four doomed
    requests, active, spilled, suspended and queued when the clock passes
    their deadline; the preempt and suspend name other requests off rank
    0.  Returns the failures, the misses by class and the audit."""
    vocab = R.port_cfg().vocab_size
    rng = np.random.default_rng(0)
    p = lambda n: rng.integers(1, vocab, size=n).tolist()   # noqa: E731
    a = eng.submit(p(6), max_new_tokens=8, deadline=500.0, priority=1)
    b = eng.submit(p(6), max_new_tokens=8, deadline=500.0)
    d = eng.submit(p(5), max_new_tokens=8, deadline=500.0)
    for _ in range(100):
        clk.t += 1.0
        eng.step()
        if all(st is not None and st.generated
               for st in map(eng._find_active, (a, b, d))):
            break
    other = -1 if rank else 0          # what another rank would name
    assert eng.preempt(b if not rank else a + other)
    assert eng.suspend(d if not rank else b + other)
    c = eng.submit(p(4), max_new_tokens=4, deadline=500.0)
    clk.t = 500.0
    kind = eng.step()
    R.audit(eng)
    return {"kind": kind, "failed": eng.failed(),
            "by_class": dict(eng.stats.deadline_miss_by_class),
            "ids": (a, b, c, d), "trail": eng.trail, "tokens": eng.run()}


def _rank_main(mesh, tree):
    from repro_torch.runtime.serve import mesh_params
    torch.set_num_threads(1)
    mp = mesh_params(R.port_cfg(), tree, mesh)
    res = {"chaos": {name: _chaos(mp, name) for name in F.CHAOS}}
    outs, counters = F.run_snapshot(
        lambda: _make(mp, offload=True, n_slots=2), R.port_cfg().vocab_size)
    res["snapshot"] = [outs, counters]
    clk = _RankClock(mesh.rank)
    res["deadlines"] = deadlines(_make(mp, clock=clk, offload=True,
                                       n_slots=3), clk, mesh.rank)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child, started first; meanwhile the ranks and the
    folded deadline case."""
    child = R.start_reference(F, tmp_path_factory.mktemp("jax_faults"))
    n = torch.get_num_threads()
    try:
        tree = R.reference_tree()
        ranks = R.run_ranks(_rank_main, tree)
        torch.set_num_threads(1)
        clk = _RankClock(0)
        fold = deadlines(_make(R.fold_params(tree), clock=clk,
                               offload=True, n_slots=3), clk, 0)
    finally:
        torch.set_num_threads(n)
        ref = R.finish_reference(child, "ref")
    R.check_tree(tree, ref)
    return ref, ranks, fold


@pytest.mark.parametrize("name", F.CHAOS)
def test_chaos_ranks_match_reference(runs, name):
    """(1, 4), exact, the chaos plan with forced preemptions: every rank's
    injector draws, then host decisions, then tokens agree; tokens,
    failures and every fault and recovery counter equal the JAX engine's
    on the same mesh; under the "at" plan every kind fires and the
    poisoned page (its shard on every rank) is quarantined; nothing
    leaks."""
    from repro_torch.runtime import faults
    ref, ranks, _ = runs
    got = [r["chaos"][name] for r in ranks]
    for rank, g in enumerate(got[1:], 1):
        assert g["draws"] == got[0]["draws"], rank
    R.assert_ranks_agree(got, name)
    for rank, g in enumerate(got):
        assert g["result"] == ref["chaos"][name], rank
        assert g["leak"] is None, g["leak"]
    counters = got[0]["result"][2]
    assert counters["faults_injected"] > 0
    if name == "at":
        assert all(counters["faults_by_kind"][k] == 1
                   for k in faults.KINDS if k != "shard_loss")
        assert counters["quarantined"] == 1


def test_snapshot_ranks_match_reference(runs):
    """The snapshot run on every rank: the run driven on after the cut
    and two fresh engines restored from it on the same ranks give the
    JAX engine's tokens, and the restored engine its counters."""
    ref, ranks, _ = runs
    for rank, r in enumerate(ranks):
        assert r["snapshot"] == ref["snapshot"], rank
    outs = ranks[0]["snapshot"][0]
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) == 3


def test_deadlines_follow_rank_zero(runs):
    """Deadlines in every lifecycle state, each rank's clock reading
    1000 s apart and the preempt and suspend naming other requests off
    rank 0: every rank expires the four requests in the same tick as
    the folded engine (misses by class, failures), reclaims everything,
    and the ranks agree."""
    _, ranks, fold = runs
    got = [r["deadlines"] for r in ranks]
    R.assert_ranks_agree(got, "deadlines")
    a, b, c, d = fold["ids"]
    assert fold["failed"] == {r: "deadline" for r in (a, b, c, d)}
    assert fold["by_class"] == {0: 3, 1: 1} and fold["kind"] == "idle"
    for rank, g in enumerate(got):
        for k in ("kind", "failed", "by_class", "ids", "tokens"):
            assert g[k] == fold[k], (rank, k)
