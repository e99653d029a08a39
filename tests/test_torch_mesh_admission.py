"""The port's padded admission flush and gang admission over a mesh of
ranks, against the reference's engine on a (1, 4) mesh, on the CPU.

``test_torch_admission.py``'s engine, trace and ``--jax-ref`` child (the
reference's engine on (1, 4) with ``prefill_mode='padded'`` on the dense
cache and with ``gang=True``, exact and prism, and its prefill at decode
capacity, ``make_prefill_step(..., cap=48)``, over the first flush's
padded batch), with four gloo ranks (``torch_mesh_robust.py``):

  * (1, 4): every rank's digest of its host decisions, then its tokens,
    agree; tokens and schedule (flushes, prompt tokens, packed ticks,
    decode steps) equal the reference's; after the first flush each
    rank's dense cache leaves are its rows and sequence shard of the
    reference's prefill at decode capacity (the means leaves whole), and
    its tokens are the reference's padded ones, pad columns averaged in
    prism mode (the reference's wart);
  * (2, 2), the padded flush in both modes: the slots split over
    ``data``, so each rank takes every prefill row (one ``engine``
    gather) and splices the slots of its block; held to the port's
    folded engine at P = 2, its first flush's rows and shard included.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_admission as A  # noqa: E402
import torch_mesh_robust as R  # noqa: E402


def _run(params, mode, run, n_seq=None):
    """``test_torch_admission.py``'s drive -> what the ranks share, and
    the cache's leaves right after the first padded flush."""
    eng = R.engine(params, mode, A.CR, {**A.ENGINE, **A.RUNS[run]},
                   n_seq=n_seq)
    first = []
    if run == "padded":
        flush = eng._padded_flush

        def kept():
            kind = flush()
            if not first:
                first.append([{k: t.clone().numpy() for k, t in c.items()}
                              for c in eng.kv_cache.storage])
            return kind
        eng._padded_flush = kept
    tokens, schedule = A._drive(eng, R.port_cfg().vocab_size)
    R.audit(eng)
    return {"tokens": tokens, "schedule": schedule, "trail": eng.trail,
            "first": first[0] if first else None,
            "first_row": eng.kv_cache.first_row, "lay": eng.layout}


def _rank_main(mesh, tree):
    from repro_torch.runtime.serve import mesh_params
    ms = R.meshes(mesh)
    mps = {s: mesh_params(R.port_cfg(), tree, m) for s, m in ms.items()}
    res = {"coords": {s: m.coords for s, m in ms.items()}}
    for mode in A.MODES:
        for run in A.RUNS:
            res[((1, 4), run, mode)] = _run(mps[(1, 4)], mode, run)
        res[((2, 2), "padded", mode)] = _run(mps[(2, 2)], mode, "padded")
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child, started first; meanwhile the ranks and the
    folded (2, 2) runs."""
    child = R.start_reference(A, tmp_path_factory.mktemp("jax_admission"))
    n = torch.get_num_threads()
    try:
        tree = R.reference_tree()
        ranks = R.run_ranks(_rank_main, tree)
        torch.set_num_threads(1)
        params = R.fold_params(tree)
        fold = {mode: _run(params, mode, "padded", n_seq=2)
                for mode in A.MODES}
    finally:
        torch.set_num_threads(n)
        ref = R.finish_reference(child, "runs")
    R.check_tree(tree, ref)
    return ref, ranks, fold


def _shard(leaf, name, n_seq, seq, rows):
    """The rows and, for k and v, the sequence shard ``seq`` of a whole
    dense leaf laid (B, cap, ...) or (B, P, cap_l, ...)."""
    leaf = leaf[rows]
    if name in ("k", "v"):
        leaf = leaf.reshape(leaf.shape[0], n_seq, -1,
                            *leaf.shape[-2:])[:, seq:seq + 1]
    return leaf


@pytest.mark.parametrize("run", list(A.RUNS))
@pytest.mark.parametrize("mode", A.MODES)
def test_ranks_match_reference(runs, mode, run):
    """(1, 4): the ranks agree; the padded and the gang engines' tokens
    and schedule equal the JAX engine's on the same mesh."""
    ref, ranks, _ = runs
    got = [r[((1, 4), run, mode)] for r in ranks]
    R.assert_ranks_agree(got, f"{run} {mode}")
    for rank, g in enumerate(got):
        assert g["tokens"] == ref[f"{run}/{mode}"][0], rank
        assert g["schedule"] == ref[f"{run}/{mode}"][1], rank
    assert len(got[0]["tokens"]) == 6
    if run == "padded":
        assert got[0]["schedule"]["prefills"] >= 2


@pytest.mark.parametrize("mode", A.MODES)
def test_first_flush_leaves_match_reference(runs, mode):
    """(1, 4): after the first flush (the first 4 prompts into slots
    0-3) each rank's dense cache is its sequence shard of the reference's
    prefill at decode capacity (k, v), and the means leaves whole."""
    ref, ranks, _ = runs
    leaves = A.LEAVES if mode == "prism" else A.LEAVES[:2]
    for rank, r in enumerate(ranks):
        got = r[((1, 4), "padded", mode)]
        for layer, c in enumerate(got["first"]):
            for name in leaves:
                want = _shard(ref[f"{mode}/prefill/{name}"][layer], name,
                              A.P, rank, slice(None))
                np.testing.assert_allclose(
                    c[name], want, atol=1e-5, rtol=1e-4,
                    err_msg=f"{mode} {name} {layer} rank {rank}")


@pytest.mark.parametrize("mode", A.MODES)
def test_padded_2x2_matches_fold(runs, mode):
    """(2, 2): the ranks agree; tokens and schedule are the folded
    engine's at P = 2, and after the first flush each rank holds its
    block of the fold's slot rows and its sequence shard of them."""
    _, ranks, fold = runs
    got = [r[((2, 2), "padded", mode)] for r in ranks]
    R.assert_ranks_agree(got, f"2x2 {mode}")
    want = fold[mode]
    for rank, (g, r) in enumerate(zip(got, ranks)):
        assert g["tokens"] == want["tokens"], rank
        assert g["schedule"] == want["schedule"], rank
        assert g["lay"].ba == ("data",) and g["lay"].n_seq == 2
        coords = r["coords"][(2, 2)]
        for layer, c in enumerate(g["first"]):
            for name, t in c.items():
                rows = slice(g["first_row"], g["first_row"] + t.shape[0])
                w = want["first"][layer][name]
                if name in ("k", "v"):
                    w = w.reshape(w.shape[0], -1, *w.shape[-2:])
                np.testing.assert_allclose(
                    t, _shard(w, name, 2, coords["model"], rows), atol=1e-5,
                    rtol=1e-4, err_msg=f"{mode} {name} {layer} rank {rank}")
