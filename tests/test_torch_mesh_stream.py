"""The port's streaming loop over a mesh of ranks, against the
reference's ``StreamingEngine`` on a (1, 4) mesh, on the CPU.

``test_torch_streaming.py``'s engine, trace and ``--jax-ref`` child (the
reference's engine and streaming loop on (1, 4), overlap on and off,
exact and prism), with four gloo ranks (``torch_mesh_robust.py``):

  * (1, 4), overlap on and off, exact and prism: every rank's digest of
    its host decisions, then its tokens, agree; the streamed tokens,
    every stream's delivered tokens and finish reason, and the tick
    counts equal the reference's; the result pack is made from the
    gathered logits, so every rank streams rank 0's tokens;
  * a cancel in flight, named on rank 0 alone (the other ranks name no
    request): every rank drains and cancels the same request at the same
    tick, the other streams keep the port's folded engine's tokens, and
    nothing leaks;
  * (2, 2), prism, overlap on: held to the folded loop at P = 2.
"""
from __future__ import annotations

import os
import sys

import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_streaming as S  # noqa: E402
import torch_mesh_robust as R  # noqa: E402

OVERLAP = (True, False)


def _loop(params, mode, overlap, n_seq=None, **over):
    from repro_torch.serving import StreamingEngine
    eng = R.engine(params, mode, S.CR, {**S.ENGINE, **over}, n_seq=n_seq)
    return StreamingEngine(eng, overlap=overlap)


def _streamed(seng):
    got = S._stream(seng, R.port_cfg().vocab_size)
    R.audit(seng.engine)
    return {"result": list(got), "tokens": got[0],
            "trail": seng.engine.trail, "overlap": seng.overlap,
            "idle": not seng._pipe}


def cancel_in_flight(seng, rank: int):
    """``test_torch_streaming.py``'s cancel mid-flight, the victim named
    on rank 0 alone -> the victim, the step it was cancelled at, the
    streams, the results and what the engine holds after."""
    eng = seng.engine
    streams = dict(seng.submit_stream(p, max_new_tokens=S.NEW)
                   for p in S._prompts(R.port_cfg().vocab_size))
    for step in range(40):
        seng.step()
        victim = next((st.req.rid for st in eng._sched.active.values()
                       if not st.prefilling and st.generated), None)
        if victim is not None and seng._pipe:
            break
    assert seng.cancel(victim if rank == 0 else -1)
    drained = not seng._pipe
    out = seng.run_sync()
    R.audit(eng)
    return {"victim": victim, "at": step, "drained": drained,
            "finished": {rid: s.finished for rid, s in streams.items()},
            "streams": {rid: s.drain() for rid, s in streams.items()},
            "tokens": out, "failed": eng.failed(), "trail": eng.trail,
            "cancelled": eng.stats.cancelled}


def _rank_main(mesh, tree):
    from repro_torch.runtime.serve import mesh_params
    ms = R.meshes(mesh)
    mps = {s: mesh_params(R.port_cfg(), tree, m) for s, m in ms.items()}
    res = {}
    for mode in S.MODES:
        for overlap in OVERLAP:
            res[(mode, overlap)] = _streamed(_loop(mps[(1, 4)], mode,
                                                   overlap))
    res["cancel"] = cancel_in_flight(
        _loop(mps[(1, 4)], "exact", True, prefix_cache=False), mesh.rank)
    res["2x2"] = _streamed(_loop(mps[(2, 2)], "prism", True))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child, started first; meanwhile the ranks and the
    folded loops."""
    child = R.start_reference(S, tmp_path_factory.mktemp("jax_streaming"))
    n = torch.get_num_threads()
    try:
        tree = R.reference_tree()
        ranks = R.run_ranks(_rank_main, tree)
        torch.set_num_threads(1)
        params = R.fold_params(tree)
        fold = {"cancel": cancel_in_flight(_loop(
                    params, "exact", True, n_seq=S.P, prefix_cache=False), 0),
                "2x2": _streamed(_loop(params, "prism", True, n_seq=2))}
    finally:
        torch.set_num_threads(n)
        ref = R.finish_reference(child, "runs")
    R.check_tree(tree, ref)
    return ref, ranks, fold


@pytest.mark.parametrize("overlap", OVERLAP)
@pytest.mark.parametrize("mode", S.MODES)
def test_stream_ranks_match_reference(runs, mode, overlap):
    """(1, 4): the ranks agree; the streamed tokens, each stream's
    delivered tokens and finish reason, and the tick counts equal the
    JAX streaming loop's on the same mesh (and its synchronous engine's
    tokens); the pipeline drains and nothing leaks."""
    ref, ranks, _ = runs
    got = [r[(mode, overlap)] for r in ranks]
    R.assert_ranks_agree(got, f"{mode} {overlap}")
    want = ref[f"{mode}/{overlap}"]
    for rank, g in enumerate(got):
        assert g["overlap"] is overlap and g["idle"], rank
        assert g["result"] == want, rank
    assert got[0]["tokens"] == ref[f"{mode}/sync"]


def test_cancel_in_flight_on_every_rank(runs):
    """A cancel with ticks in flight, named on rank 0 alone: every rank
    cancels rank 0's request at the same step, drains first, closes its
    stream as 'cancelled' and leaks nothing; the other streams give the
    folded loop's tokens."""
    _, ranks, fold = runs
    got = [r["cancel"] for r in ranks]
    R.assert_ranks_agree(got, "cancel")
    want = fold["cancel"]
    for rank, g in enumerate(got):
        for k in ("victim", "at", "finished", "streams", "tokens", "failed",
                  "cancelled"):
            assert g[k] == want[k], (rank, k)
        assert g["drained"]
    assert want["finished"][want["victim"]] == "cancelled"
    assert want["failed"] == {want["victim"]: "cancelled"}


def test_stream_2x2_matches_fold(runs):
    """(2, 2), prism, overlap on: the ranks agree and give the folded
    loop's tokens, streams and tick counts at P = 2."""
    _, ranks, fold = runs
    got = [r["2x2"] for r in ranks]
    R.assert_ranks_agree(got, "2x2")
    for rank, g in enumerate(got):
        assert g["result"] == fold["2x2"]["result"], rank
