"""The port's degraded mesh over a mesh of ranks: a lost sequence shard
served through Segment-Means standbys that its ring neighbour hosts,
against the reference's on a (1, 4) mesh, on the CPU.

``test_torch_degraded.py``'s cases and ``--jax-ref`` child, with four
gloo ranks (``torch_mesh_robust.py``):

  * the degraded step (the chunked prefill into permuted pages, the
    rewind and 2 teacher-forced steps, shard 1 lost; exact mode with the
    seeded random standby, prism mode with none) on (1, 4): every rank's
    logits within (1e-5, 1e-5) of the reference's; its shard of the
    pools and the whole state pool equal the reference's (the writes to
    the lost shard dropped); with the lost rank's pool filled with NaN
    the logits are bit-identical (the lost rank reads no K/V of its own);
  * the engine under ``shard_loss`` of shard 1 at the 6th opportunity on
    (1, 4), exact and prism, the lost rank's pages of the live slots
    filled with NaN at the loss: tokens, ``shard_lost``,
    ``degraded_ticks``, restarts, replica captures and tick kinds equal
    the JAX engine's; the ranks agree; the ``replica`` bytes are exact:
    each capture a rank's L columns of K and V over every layer to its
    ring neighbour (exact mode), the host of shard 1's standby its copy
    of every live slot back to rank 1 once, none in prism mode;
  * what the degraded ticks served, which the recovery throws away:
    every rank's logits rows of those ticks within (1e-5, 1e-5) of the
    JAX engine's, and (exact) the lost rank's standby columns, back from
    its ring neighbour, within (1e-5, 1e-5) of the reference's cut.  The
    NaN fill shows only that the lost rank reads none of its own K/V;
    these show that what it serves in its place is shard 1's standby;
  * (2, 2), exact: held to the port's folded engine at P = 2, its
    degraded rows and standby columns too.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_degraded as D  # noqa: E402
import torch_mesh_robust as R  # noqa: E402

LOST_SHARD = 1


def _steps(mesh, tree, mode, nan_lost=False):
    """The degraded step on the rank: the chunked prefill of
    ``test_torch_degraded.py`` into the rank's shard of the pools, then
    the steps with shard 1 lost -> per step the logits over the whole
    vocabulary and the rank's cache leaves."""
    from repro_torch.runtime.paging import PagedLayout
    from repro_torch.runtime.serve import (ServeHParams, gather_logits,
                                           init_cache, make_layout,
                                           mesh_params, paged_placement,
                                           serve_step)
    from repro_torch.runtime.ticks import chunk_prefill_step
    pg, tk = D._load("test_torch_paging"), D._load("test_torch_ticks")
    cs = D._chip_smoke()
    cfg = R.port_cfg()
    mp = mesh_params(cfg, tree, mesh)
    pm, sm = pg._maps()
    paging = PagedLayout(page_cols=pg.PAGE_TOKENS // D.P, n_seq=D.P,
                         pages_per_row=pm.shape[1], n_pages=pg.N_PAGES,
                         n_state_pages=pg.N_STATE)
    maps = (torch.as_tensor(pm), torch.as_tensor(sm))
    hp = ServeHParams(decode_mode=mode, means_cr=D.CR)
    lay = make_layout(mesh, pg.CAP, hp, prefill_len=pg.N,
                      placement=paged_placement(hp, paging), batch=pg.B)
    prompts, forced = tk._inputs(cfg.vocab_size)
    cache = init_cache(cfg, lay, pg.B, hp, "cpu", paging)
    for call in cs.plan_chunks(prompts, pg.CHUNK, pg.JOIN):
        chunk_prefill_step(cfg, mp, cache, *map(torch.as_tensor, call), lay,
                           hp, *maps)
    if nan_lost and mesh.coords["model"] == LOST_SHARD:
        for c in cache:
            c["k"].fill_(float("nan"))
            c["v"].fill_(float("nan"))
    rep = None
    if mode == "exact":
        rep = [{k: torch.as_tensor(v) for k, v in t.items()}
               for t in D._replica_tree(cfg, lay, pg.B)]
    tok = torch.as_tensor([p[-1] for p in prompts])
    pos = torch.as_tensor([len(p) - 1 for p in prompts])
    run = {"lay": lay}
    for k in range(D.STEPS):
        logits, cache = serve_step(cfg, mp, cache, tok, pos + k, lay, hp,
                                   *maps, lost=torch.as_tensor(D.LOST),
                                   rep=rep)
        run[f"step{k}/logits"] = gather_logits(logits, mp).numpy()
        run[f"step{k}"] = [{n: t.clone().numpy() for n, t in c.items()}
                           for c in cache]
        if k + 1 < D.STEPS:
            tok = torch.as_tensor(forced[:, k])
    return run


def _shard_loss(mp, mesh, mode, n_seq=None):
    """``test_torch_degraded.py``'s engine run under a shard loss, the
    lost rank's pages of the live slots filled with NaN at the loss; the
    meter read over the run -> what the ranks must share, the replica's
    counters and the bytes it sent."""
    eng = D._engine(mp, mode, D._shard_loss()) if n_seq is None else \
        R.engine(mp, mode, D.CR, {**D.ENGINE, "faults": D._shard_loss()},
                 n_seq=n_seq)
    kv, lose = eng.kv_cache, eng._lose_shard
    filled = []

    def lose_and_fill(shard):
        lose(shard)
        if mesh is not None and mesh.coords["model"] == shard:
            pages = sorted({p for s in eng._sched.active
                            for p in kv.slot_pages[s]})
            for c in kv.storage:
                for name in ("k", "v"):
                    c[name][pages] = float("nan")
            filled.append(len(pages))
    eng._lose_shard = lose_and_fill
    kept = D._keep_degraded(eng, D._port_standby)
    if mesh is not None:
        mesh.meter.reset()
    got = D._drive(eng, R.port_cfg().vocab_size)
    R.audit(eng)
    return {"result": list(got), "tokens": got[0], "trail": eng.trail,
            "degraded": kept, "lost": (mesh is not None and
                                       mesh.coords["model"] == LOST_SHARD),
            "replica": eng._replica.stats(), "filled": filled,
            "sent": None if mesh is None else mesh.meter.snapshot()["sent"],
            "L": eng.layout.L}


def _rank_main(mesh, tree):
    from repro_torch.runtime.serve import mesh_params
    ms = R.meshes(mesh)
    res = {}
    for mode in D.MODES:
        res[("steps", mode)] = _steps(mesh, tree, mode)
        nan = _steps(mesh, tree, mode, nan_lost=True)
        res[("steps-nan", mode)] = [nan[f"step{k}/logits"]
                                    for k in range(D.STEPS)]
    mps = {s: mesh_params(R.port_cfg(), tree, m) for s, m in ms.items()}
    for mode in D.MODES:
        res[("engine", mode)] = _shard_loss(mps[(1, 4)], mesh, mode)
    res[("engine-2x2", "exact")] = _shard_loss(mps[(2, 2)], ms[(2, 2)],
                                               "exact")
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child, started first; meanwhile the ranks and the
    folded (2, 2) run."""
    child = R.start_reference(D, tmp_path_factory.mktemp("jax_degraded"))
    n = torch.get_num_threads()
    try:
        tree = R.reference_tree()
        ranks = R.run_ranks(_rank_main, tree)
        torch.set_num_threads(1)
        fold = _shard_loss(R.fold_params(tree), None, "exact", n_seq=2)
    finally:
        torch.set_num_threads(n)
        ref = R.finish_reference(child, "runs", merge=False)
    R.check_tree(tree, ref)
    return ref, ranks, fold


@pytest.mark.parametrize("mode", D.MODES)
def test_degraded_step_ranks_match_reference(runs, mode):
    """Every degraded step's logits on every rank within (1e-5, 1e-5) of
    the JAX ``make_serve_step(degraded=True)``'s, shard 1 lost, finite;
    and bit-identical with the lost rank's pool NaN."""
    ref, ranks, _ = runs
    for rank, r in enumerate(ranks):
        run = r[("steps", mode)]
        for k in range(D.STEPS):
            got = run[f"step{k}/logits"]
            assert np.isfinite(got).all()
            np.testing.assert_allclose(
                got, ref[f"{mode}/step{k}/logits"], atol=1e-5, rtol=1e-5,
                err_msg=f"{mode} step {k} rank {rank}")
            assert np.array_equal(r[("steps-nan", mode)][k], got), (rank, k)


@pytest.mark.parametrize("mode", D.MODES)
def test_degraded_step_drops_writes_to_the_lost_shard(runs, mode):
    """After every degraded step each rank's shard of the pools, and the
    state pool every rank holds whole, equal the reference's: the lost
    shard's columns never take the new tokens."""
    ref, ranks, _ = runs
    pg = D._load("test_torch_paging")
    leaves = pg.LEAVES if mode == "prism" else pg.LEAVES[:2]
    for rank, r in enumerate(ranks):
        run = r[("steps", mode)]
        for k in range(D.STEPS):
            for layer, c in enumerate(run[f"step{k}"]):
                for name in leaves:
                    w = ref[f"{mode}/step{k}/{name}"][layer]
                    got = c[name]
                    if name in ("k", "v"):
                        w = w.reshape(pg.N_PAGES, D.P, pg.PAGE_TOKENS // D.P,
                                      *w.shape[2:])[:, rank:rank + 1]
                    else:
                        got = got[:pg.N_STATE]
                    np.testing.assert_allclose(
                        got, w, atol=1e-5, rtol=1e-4,
                        err_msg=f"{mode} step {k} {name} {layer} r{rank}")


@pytest.mark.parametrize("mode", D.MODES)
def test_engine_shard_loss_ranks_match_reference(runs, mode):
    """Shard 1 lost at the 6th opportunity on (1, 4), its rank's pages of
    the live slots NaN: the ranks agree; tokens, counters, replica
    captures and tick kinds equal the JAX engine's (two degraded ticks,
    then the recovery); nothing leaks."""
    ref, ranks, _ = runs
    got = [r[("engine", mode)] for r in ranks]
    R.assert_ranks_agree(got, mode)
    for rank, g in enumerate(got):
        assert g["result"] == ref["runs"][mode], rank
        assert bool(g["filled"]) == (rank == LOST_SHARD), rank
    counters, kinds = got[0]["result"][1], got[0]["result"][3]
    assert counters["shard_lost"] == 1 and counters["degraded_ticks"] == 2
    assert "recovered" in kinds


@pytest.mark.parametrize("mode", D.MODES)
def test_engine_degraded_ticks_serve_the_standby(runs, mode):
    """What the degraded ticks served, which the recovery's re-prefill
    throws away: on every rank each decoding slot's logits within (1e-5,
    1e-5) of the JAX engine's; in exact mode the lost rank's standby
    columns, back from the ring neighbour that hosted them, within
    (1e-5, 1e-5) of the reference's cut of shard 1, and the counts
    equal.  A ring shifted the wrong way, a host sending its own columns
    or a block of the wrong shard fails here."""
    ref, ranks, _ = runs
    for rank, r in enumerate(ranks):
        g = r[("engine", mode)]
        D.check_degraded(g["degraded"], ref, mode,
                         (LOST_SHARD,) if g["lost"] else (), g["L"])
    assert sum(r[("engine", mode)]["lost"] for r in ranks) == 1


@pytest.mark.parametrize("mode", D.MODES)
def test_replica_bytes_are_exact(runs, mode):
    """The ``replica`` bytes each rank sent: in exact mode every capture
    ships the rank's L means columns of K and V of every layer (Hkv x hd
    f32) to its ring neighbour, and at the loss the host of shard 1's
    standby, rank 2, sends its copy of every live slot back to rank 1
    once; in prism mode nothing (the state pool is the standby)."""
    _, ranks, _ = runs
    cfg = R.port_cfg()
    for rank, r in enumerate(ranks):
        g = r[("engine", mode)]
        col = cfg.n_layers * 2 * g["L"] * cfg.n_kv_heads * cfg.hd * 4
        rep = g["replica"]
        want = 0
        if mode == "exact":
            want = rep["captures"] * col
            if rank == (LOST_SHARD + 1) % D.P:
                assert rep["returned"] >= 1
                want += rep["returned"] * col
            else:
                assert rep["returned"] == 0
        assert g["sent"]["replica"] == want, (rank, g["sent"], rep)
    assert ranks[0][("engine", mode)]["replica"]["captures"] >= 1


def test_engine_shard_loss_2x2_matches_fold(runs):
    """(2, 2), exact, shard 1 lost (a 'model' index; its standby hosted
    by the other rank of its data replica): the ranks agree, and give
    the port's folded engine's tokens, counters, captures and tick kinds
    at P = 2, its degraded rows, and on the two lost ranks its standby
    columns of shard 1, within (1e-5, 1e-5)."""
    _, ranks, fold = runs
    got = [r[("engine-2x2", "exact")] for r in ranks]
    R.assert_ranks_agree(got, "2x2")
    served = {f"exact/degraded/{k}": v
              for k, v in D._kept_arrays(fold["degraded"]).items()}
    for rank, g in enumerate(got):
        assert g["result"] == fold["result"], rank
        D.check_degraded(g["degraded"], served, "exact",
                         (LOST_SHARD,) if g["lost"] else (), g["L"])
    assert fold["result"][1]["shard_lost"] == 1
    assert sum(g["lost"] for g in got) == 2
