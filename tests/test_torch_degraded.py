"""The port's degraded mesh (a lost sequence shard served through
Segment-Means standby replicas) against the JAX reference, on the CPU.

Replica: the exact-mode cut (``MeansReplica._cut_means``) and the prism
copy of a slot's standby, over seeded random pages under both
placements, equal the reference's on the same payload.

Degraded step: GPT-2 small reduced (2 layers, d_model 256, 4 heads of
64), 4 rows, prefill length 32 with one 5-token prompt, cap 40, P = 4
sequence shards, CR 4, pages of 2 columns a shard over a permuted page
map (``tests/test_torch_paging.py``'s); the chunked prefill, then the
rewind and 2 teacher-forced decode steps with shard 1 lost, in exact
mode with a seeded random standby replica and in prism mode.  Logits
within (1e-5, 1e-5) of the reference's, pools as the paged tests hold
them.

Engine: 4 slots, prefill 32, cap 48, chunks of 8, a token budget of 11,
6 prompts of 8-32 tokens, 8 greedy tokens each, ``shard_loss`` on shard
1 at the 6th opportunity; its tokens, ``shard_lost``,
``degraded_ticks``, restarts and replica captures equal the JAX
engine's in both modes, and the drained engine leaks nothing.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's programs and engine on a (1, 4) mesh with
the jnp backend.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
P, CR, MODES = 4, 4.0, ("exact", "prism")
LOST = (0.0, 1.0, 0.0, 0.0)          # shard 1 lost
STEPS = 3                            # the rewind and 2 forced steps
ENGINE = dict(n_slots=4, prefill_len=32, max_cache=48, chunk_len=8,
              token_budget=11)
NEW, SHARD_AT = 8, 6
COUNTERS = ("shard_lost", "degraded_ticks", "restarts", "requests",
            "failed_requests")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name, path=None):
    spec = importlib.util.spec_from_file_location(
        name, path or os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    return _load("chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=int(rng.integers(8, 33))).tolist()
            for _ in range(6)]


def _replica_tree(cfg, lay, batch):
    """A seeded random standby replica: per layer kz, vz (B, m, Hkv, hd)
    and counts gz (B, m), some columns dead (gz = 0)."""
    rng = np.random.default_rng(11)
    m = lay.n_seq * lay.L
    out = []
    for _ in range(cfg.n_layers):
        gz = rng.integers(0, 4, size=(batch, m)).astype(np.float32)
        out.append({"kz": rng.standard_normal(
                        (batch, m, cfg.n_kv_heads, cfg.hd)).astype(np.float32),
                    "vz": rng.standard_normal(
                        (batch, m, cfg.n_kv_heads, cfg.hd)).astype(np.float32),
                    "gz": gz})
    return out


def _drive(eng, vocab):
    """The trace through an engine step by step; returns {rid: tokens},
    the counters, the replica's captures and the tick kinds."""
    for p in _prompts(vocab):
        eng.submit(p, max_new_tokens=NEW)
    kinds = []
    for _ in range(600):
        if not eng._sched.has_work:
            break
        kinds.append(eng.step())
    s = eng.stats.summary()
    return ({str(k): v for k, v in eng.results().items()},
            {k: s[k] for k in COUNTERS},
            eng._replica.stats()["captures"], kinds)


def _keep_degraded(eng, stacked):
    """Wrap an engine's degraded tick (the reference's or the port's) to
    keep what it served: each decoding slot's logits row by (rid,
    position), and in exact mode the first assembled standby, its
    layers stacked by ``stacked`` -> the dict they go to."""
    kept = {"keys": [], "rows": [], "standby": None}
    advance = eng._advance_degraded

    def advanced(st, row, now):
        kept["keys"].append((st.req.rid, st.pos))
        kept["rows"].append(np.array(row, np.float32))
        advance(st, row, now)
    eng._advance_degraded = advanced
    if eng.config.hp.decode_mode == "exact":
        assemble = eng._replica.assemble

        def assembled(*args, **kw):
            rep = assemble(*args, **kw)
            if kept["standby"] is None:
                kept["standby"] = {k: np.array(v)
                                   for k, v in stacked(rep).items()}
            return rep
        eng._replica.assemble = assembled
    return kept


def _port_standby(rep):
    """The port's assembled standby, its layers stacked as the
    reference's scan stack."""
    return {k: torch.stack([d[k] for d in rep]).cpu()
            for k in ("kz", "vz", "gz")}


def _kept_arrays(kept):
    """What ``_keep_degraded`` kept, as flat arrays."""
    out = {"keys": np.asarray(kept["keys"], np.int64),
           "rows": np.stack(kept["rows"])}
    for k, v in (kept["standby"] or {}).items():
        out[f"standby/{k}"] = v
    return out


def check_degraded(kept, ref, mode, shards=None, L=None):
    """What a port engine's degraded ticks served against the reference
    engine's: the same (rid, position) rows, their logits within (1e-5,
    1e-5); in exact mode the standby's counts, and its kz/vz columns of
    the ``shards`` it holds (of L columns each; all by default, a mesh's
    lost rank its own shard's, which come back from the ring neighbour,
    any other rank none) within (1e-5, 1e-5)."""
    got = _kept_arrays(kept)
    want = {k[len(mode) + 10:]: v for k, v in ref.items()
            if k.startswith(f"{mode}/degraded/")}
    assert len(got["keys"]) >= 1
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_allclose(got["rows"], want["rows"], atol=1e-5,
                               rtol=1e-5, err_msg=f"{mode} degraded rows")
    if mode != "exact":
        assert kept["standby"] is None
        return
    np.testing.assert_array_equal(got["standby/gz"], want["standby/gz"])
    blocks = ([slice(None)] if shards is None
              else [slice(s * L, (s + 1) * L) for s in shards])
    for cols in blocks:
        assert (want["standby/gz"][:, :, cols] > 0).any()
        for k in ("kz", "vz"):
            np.testing.assert_allclose(
                got[f"standby/{k}"][:, :, cols],
                want[f"standby/{k}"][:, :, cols], atol=1e-5, rtol=1e-5,
                err_msg=f"standby {k} {cols}")


def jax_reference(out_path):
    """Child process: the reference's degraded step and engine on a
    (1, 4) mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.runtime.faults import FaultPlan, FaultSpec
    from repro.runtime.paging import PagedLayout
    from repro.runtime.serve import (ServeHParams, init_cache,
                                     make_chunk_prefill_step,
                                     make_serve_step)
    from repro.serving import EngineConfig, ServingEngine
    pg, tk = _load("test_torch_paging"), _load("test_torch_ticks")
    cs = _chip_smoke()
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out, runs = {}, {}
    tk._flatten(jax.tree.map(np.asarray, params), "params", out)
    prompts, forced = tk._inputs(cfg.vocab_size)
    pm, sm = pg._maps()
    paging = PagedLayout(page_cols=pg.PAGE_TOKENS // P, n_seq=P,
                         pages_per_row=pm.shape[1], n_pages=pg.N_PAGES,
                         n_state_pages=pg.N_STATE)
    maps = (jnp.asarray(pm), jnp.asarray(sm))
    i32 = lambda a: jnp.asarray(a, jnp.int32)                 # noqa: E731
    kw = dict(batch=pg.B, cap=pg.CAP, prefill_len=pg.N, paging=paging)
    lost = jnp.asarray(LOST, jnp.float32)
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp")
        step, lay, _ = make_chunk_prefill_step(
            cfg, mesh, params, chunk_len=pg.CHUNK, hp=hp, **kw)
        cache = init_cache(cfg, lay, pg.B, hp, paging=paging)
        for call in cs.plan_chunks(prompts, pg.CHUNK, pg.JOIN):
            cache = step(params, cache, *map(i32, call), *maps)
        dec, _, _, _ = make_serve_step(cfg, mesh, params, hp=hp,
                                       degraded=True, **kw)
        extra = (lost,)
        if mode == "exact":
            tree = _replica_tree(cfg, lay, pg.B)
            extra += ({"scan": [{k: jnp.asarray(np.stack(
                [t[k] for t in tree])) for k in ("kz", "vz", "gz")}],
                "tail": []},)
        tok = i32([p[-1] for p in prompts])
        pos = i32([len(p) - 1 for p in prompts])
        for k in range(STEPS):
            logits, cache = dec(params, cache, tok, pos + k, *maps, *extra)
            out[f"{mode}/step{k}/logits"] = np.asarray(logits)
            tk._flatten(cache["scan"][0], f"{mode}/step{k}", out)
            if k + 1 < STEPS:
                tok = i32(forced[:, k])
        # the engine under a shard loss, what its degraded ticks served
        eng = ServingEngine(cfg, mesh, params, EngineConfig(
            hp=ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp"),
            faults=FaultPlan(shard_loss=FaultSpec(at=(SHARD_AT,), shard=1)),
            **ENGINE), clock=lambda: 0.0)
        kept = _keep_degraded(eng, lambda a: a["scan"][0])
        runs[mode] = _drive(eng, cfg.vocab_size)
        out.update({f"{mode}/degraded/{k}": v
                    for k, v in _kept_arrays(kept).items()})
    np.savez(out_path, runs=np.array(json.dumps(runs)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_degraded") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--jax-ref", str(out)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(out) as z:
        ref = dict(z)
    ref["runs"] = json.loads(str(ref["runs"]))
    return ref


def _port(params_np=None):
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.models import transformer as T
    cfg = get_config("gpt2-small").reduced()
    params = (from_jax_numpy(cfg, params_np, device="cpu")
              if params_np is not None
              else T.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return cfg, params


@pytest.fixture(scope="module")
def ref_params(jax_ref):
    return _port(_load("test_torch_ticks")._unflatten(jax_ref, "params"))[1]


def _engine(params, mode, faults=None, **over):
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = get_config("gpt2-small").reduced()
    return ServingEngine(cfg, params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR), faults=faults,
        **{**ENGINE, **over}), n_seq=P, clock=lambda: 0.0)


def _shard_loss(at=SHARD_AT, shard=1):
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    return FaultPlan(shard_loss=FaultSpec(at=(at,), shard=shard))


def _audit(eng):
    kv = eng.kv_cache
    kv.check()
    assert not kv.slot_pages and not kv.slot_state
    held = ({p for e in kv.prefix.entries.values() for p in e.pages}
            if kv.prefix is not None else set())
    assert kv.table.free_pages + len(held) == kv.paging.n_pages
    assert sorted(eng._sched.free_slots) == list(range(ENGINE["n_slots"]))


# --------------------------------------------------------------------------
# MeansReplica: the cut and the copy against the reference's
# --------------------------------------------------------------------------

PC, N_POOL, HKV, HD = 2, 12, 3, 8


def _lay(placement, L=3):
    return SimpleNamespace(n_seq=P, L=L, prefill_len=32, n_loc0=8,
                           cap_l=12, placement=placement)


@pytest.mark.parametrize("placement", ["rr", "aligned"])
@pytest.mark.parametrize("covered", [1, 2, 3, 9, 21, 33, 47])
def test_replica_cut_matches_reference(placement, covered):
    """The exact-mode cut of a slot's pages (its pages a permutation of
    the pool) gives the reference's shard-major columns and counts, on
    two layers (the reference's scan stack)."""
    from repro.runtime.replica import MeansReplica as RefReplica
    from repro_torch.runtime.replica import MeansReplica
    lay = _lay(placement)
    rng = np.random.default_rng(covered)
    pages = [int(p) for p in rng.permutation(N_POOL)[:6]]
    pools = [{n: rng.standard_normal((N_POOL, P, PC, HKV, HD)
                                     ).astype(np.float32) for n in "kv"}
             for _ in range(2)]
    # the reference's payload: the slot's pages, pool column s·pc + t
    payload = {"scan": [{n: np.stack([pl[n][pages].reshape(
        len(pages), P * PC, HKV, HD) for pl in pools]) for n in "kv"}],
        "tail": []}
    paging = SimpleNamespace(page_cols=PC)
    hp = SimpleNamespace(decode_mode="exact")
    ref = RefReplica(None, lay, hp, paging, 4)._cut_means(payload, covered)
    kv = SimpleNamespace(
        storage=[{n: torch.as_tensor(pl[n]) for n in "kv"} for pl in pools],
        slot_pages={2: pages})
    got = MeansReplica(None, lay, hp, paging, 4)._cut_means(kv, 2, covered)
    for layer, g in enumerate(got):
        for key in ("kz", "vz", "gz"):
            np.testing.assert_allclose(
                g[key].numpy(), ref["scan"][0][key][layer], atol=1e-6,
                rtol=1e-5, err_msg=f"{key} layer {layer}")


@pytest.mark.parametrize("placement", ["rr", "aligned"])
def test_filled_columns_are_the_positions_written(placement):
    """``_filled_local_cols`` and ``_local_positions`` equal the
    reference's, and agree: a shard's filled columns are exactly its
    local columns whose position lies in [0, covered)."""
    from repro.runtime import replica as ref
    from repro_torch.runtime import replica as port
    lay = _lay(placement)
    for s in range(P):
        pos = port._local_positions(lay, s, lay.cap_l)
        np.testing.assert_array_equal(
            pos, ref._local_positions(lay, s, lay.cap_l))
        for covered in range(0, 49):
            n = port._filled_local_cols(lay, s, covered)
            assert n == ref._filled_local_cols(lay, s, covered)
            assert n == int((pos < covered).sum())
            np.testing.assert_array_equal(port._seg_counts(n, lay.L),
                                          ref._seg_counts(n, lay.L))


def test_replica_copy_and_staleness_match_reference():
    """Prism mode: the standby is the slot's state row (kz, vz, gz);
    ``has``/``staleness``/``tick`` (captures, at most one refresh a tick)
    and ``lost_mask`` follow the reference's rules."""
    from repro_torch.runtime.replica import MeansReplica
    lay = _lay("aligned")
    rng = np.random.default_rng(0)
    m = lay.n_seq * lay.L
    storage = [{"kz": torch.as_tensor(rng.standard_normal((5, m, HKV, HD)),
                                      dtype=torch.float32),
                "vz": torch.as_tensor(rng.standard_normal((5, m, HKV, HD)),
                                      dtype=torch.float32),
                "gz": torch.as_tensor(rng.integers(0, 5, (5, m)),
                                      dtype=torch.float32)}
               for _ in range(2)]
    kv = SimpleNamespace(storage=storage, slot_state={0: 3, 1: 1},
                         slot_pages={0: [0], 1: [1]})
    rep = MeansReplica(None, lay, SimpleNamespace(decode_mode="prism"),
                       SimpleNamespace(page_cols=PC), 2, refresh_every=4)

    def state(slot, rid, pos, epoch=0):
        return SimpleNamespace(slot=slot, pos=pos, epoch=epoch,
                               req=SimpleNamespace(rid=rid))
    a, b = state(0, 10, 20), state(1, 11, 30)
    assert rep.tick(kv, [a, b], 0) == 2 and rep.captures == 2
    for layer, c in enumerate(storage):
        for key in ("kz", "vz", "gz"):
            assert torch.equal(rep._slots[0].layers[layer][key], c[key][3])
            assert torch.equal(rep._slots[1].layers[layer][key], c[key][1])
    a.pos, b.pos = 25, 36                 # staleness 5 and 6
    assert rep.staleness(0, a) == 5 and rep.staleness(1, b) == 6
    assert rep.tick(kv, [a, b], 1) == 1 and rep.refreshes == 1
    assert rep._slots[1].covered == 37 and rep._slots[0].covered == 21
    b.epoch += 1                          # a rewound request re-captures
    assert not rep.has(1, b) and rep.staleness(1, b) == 1 << 30
    assert rep.tick(kv, [a, b], 2) == 2   # b fresh, a refreshed
    rep.drop(0)
    assert rep.stats()["slots"] == 1
    rep.drop_all()
    assert rep.stats()["slots"] == 0 and rep.stats()["bytes"] == 0
    np.testing.assert_array_equal(rep.lost_mask({1, 6}), [0, 1, 1, 0])


# --------------------------------------------------------------------------
# the degraded step against the reference's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_steps(jax_ref):
    """The port's chunked prefill into the pools, then the degraded
    steps, with the reference's weights, plans, maps and replica."""
    from repro_torch.runtime.paging import PagedLayout
    from repro_torch.runtime.serve import (init_cache, make_layout,
                                           paged_placement, serve_step)
    from repro_torch.runtime.ticks import chunk_prefill_step
    pg, tk = _load("test_torch_paging"), _load("test_torch_ticks")
    cs = _chip_smoke()
    params_np = tk._unflatten(jax_ref, "params")
    pm, sm = pg._maps()
    paging = PagedLayout(page_cols=pg.PAGE_TOKENS // P, n_seq=P,
                         pages_per_row=pm.shape[1], n_pages=pg.N_PAGES,
                         n_state_pages=pg.N_STATE)
    maps = (torch.as_tensor(pm), torch.as_tensor(sm))
    lost = torch.as_tensor(LOST)
    runs = {}
    for mode in MODES:
        cfg, params, hp, _ = tk._setup(mode, params_np)
        lay = make_layout(P, pg.CAP, hp, prefill_len=pg.N,
                          placement=paged_placement(hp, paging))
        prompts, forced = tk._inputs(cfg.vocab_size)
        cache = init_cache(cfg, lay, pg.B, hp, "cpu", paging)
        for call in cs.plan_chunks(prompts, pg.CHUNK, pg.JOIN):
            chunk_prefill_step(cfg, params, cache,
                               *map(torch.as_tensor, call), lay, hp, *maps)
        rep = None
        if mode == "exact":
            rep = [{k: torch.as_tensor(v) for k, v in t.items()}
                   for t in _replica_tree(cfg, lay, pg.B)]
        tok = torch.as_tensor([p[-1] for p in prompts])
        pos = torch.as_tensor([len(p) - 1 for p in prompts])
        run = {}
        for k in range(STEPS):
            logits, cache = serve_step(cfg, params, cache, tok, pos + k,
                                       lay, hp, *maps, lost=lost, rep=rep)
            run[f"step{k}/logits"] = logits.numpy()
            run[f"step{k}"] = [{n: t.clone().numpy() for n, t in c.items()}
                               for c in cache]
            if k + 1 < STEPS:
                tok = torch.as_tensor(forced[:, k])
        runs[mode] = run
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_degraded_step_logits_match_reference(jax_ref, port_steps, mode):
    """Every degraded step's logits within (1e-5, 1e-5) of the JAX
    ``make_serve_step(degraded=True)``'s, shard 1 lost, and finite."""
    for k in range(STEPS):
        got = port_steps[mode][f"step{k}/logits"]
        want = jax_ref[f"{mode}/step{k}/logits"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{mode} step {k}")


@pytest.mark.parametrize("mode", MODES)
def test_degraded_step_drops_writes_to_the_lost_shard(jax_ref, port_steps,
                                                      mode):
    """The pools after every degraded step equal the reference's: the
    lost shard's columns never take the new tokens."""
    pg = _load("test_torch_paging")
    for k in range(STEPS):
        pg._assert_leaves(port_steps[mode][f"step{k}"], jax_ref,
                          f"{mode}/step{k}", mode)


def test_degraded_step_validates():
    """The degraded step needs the paged cache and takes the replica in
    exact mode only."""
    from repro_torch.runtime.serve import (ServeHParams, init_cache,
                                           make_layout, serve_step)
    cfg, params = _port()
    lost = torch.as_tensor(LOST)
    tok = torch.zeros(2, dtype=torch.long)
    pos = torch.full((2,), 3, dtype=torch.long)
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR)
        lay = make_layout(P, 16, hp, prefill_len=8)
        cache = init_cache(cfg, lay, 2, hp, "cpu")
        with pytest.raises(ValueError, match="paged"):
            serve_step(cfg, params, cache, tok, pos, lay, hp, lost=lost)
        pm = torch.zeros((2, 2), dtype=torch.int32)
        bad = None if mode == "exact" else [{}] * cfg.n_layers
        with pytest.raises(ValueError, match="replica"):
            serve_step(cfg, params, cache, tok, pos, lay, hp, pm,
                       torch.zeros(2, dtype=torch.int32), lost=lost, rep=bad)


# --------------------------------------------------------------------------
# the engine under a shard loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_engine_shard_loss_matches_reference(jax_ref, ref_params, mode):
    """Shard 1 lost at the 6th opportunity: two degraded ticks, then the
    recovery; the tokens, counters and replica captures equal the JAX
    engine's, the tokens are the clean run's, and nothing leaks."""
    from repro_torch.configs import get_config
    vocab = get_config("gpt2-small").reduced().vocab_size
    eng = _engine(ref_params, mode, _shard_loss())
    assert eng._replica is not None
    kept = _keep_degraded(eng, _port_standby)
    got = _drive(eng, vocab)
    want = jax_ref["runs"][mode]
    check_degraded(kept, jax_ref, mode)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[1]["shard_lost"] == 1 and got[1]["degraded_ticks"] == 2
    assert "recovered" in got[3]
    clean = _engine(ref_params, mode)
    for p in _prompts(vocab):
        clean.submit(p, max_new_tokens=NEW)
    assert {str(k): v for k, v in clean.run().items()} == got[0]
    _audit(eng)


def test_snapshot_refused_while_degraded():
    """The snapshot's gather reads every shard: refused while one is
    lost, fine after the recovery."""
    cfg, params = _port()
    eng = _engine(params, "exact", _shard_loss(at=4, shard=0),
                  degraded_grace=50)
    for p in _prompts(cfg.vocab_size)[:2]:
        eng.submit(p, max_new_tokens=NEW)
    for _ in range(200):
        if eng.step() == "degraded":
            break
    else:
        raise AssertionError("never entered the degraded window")
    with pytest.raises(ValueError, match="degraded"):
        eng.snapshot()
    while eng._sched.has_work:
        eng.step()
    assert eng.snapshot() is not None
    _audit(eng)


@pytest.mark.parametrize("mode", MODES)
def test_degraded_tokens_stay_out_of_results(mode):
    """A request that finishes inside the degraded window is held in its
    slot: with a grace longer than its tokens, the window closes when
    nothing can decode, every request is prefilled again, and the
    results are the clean run's; the standby layer was used."""
    cfg, params = _port()
    clean = _engine(params, mode)
    for p in _prompts(cfg.vocab_size)[:3]:
        clean.submit(p, max_new_tokens=4)
    want = clean.run()
    eng = _engine(params, mode, _shard_loss(at=5, shard=2),
                  degraded_grace=20)
    for p in _prompts(cfg.vocab_size)[:3]:
        eng.submit(p, max_new_tokens=4)
    kinds = []
    while eng._sched.has_work:
        kinds.append(eng.step())
    assert eng.run() == want and not eng.failed()
    assert "degraded" in kinds and "recovered" in kinds
    assert eng.stats.restarts >= 1 and eng._replica.captures >= 1
    _audit(eng)


def test_engine_accepts_shard_loss_plans():
    """``EngineConfig`` takes a plan with ``shard_loss`` on (the chaos
    plan included) and the degraded mesh's knobs with the reference's
    validation; the standby replica is armed only on the paged cache
    with a schedulable shard loss; the launcher's plan pins the shard
    and the opportunity."""
    from repro_torch.launch.serve import fault_plan
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    from repro_torch.serving import EngineConfig
    base = dict(n_slots=2, prefill_len=8, max_cache=16)
    for plan in (FaultPlan.chaos(0), FaultPlan(shard_loss=FaultSpec(at=(1,)))):
        assert EngineConfig(faults=plan, **base).faults is plan
    cfg = EngineConfig(**base)
    assert (cfg.degraded_grace, cfg.replica_refresh) == (2, 16)
    for bad in (dict(degraded_grace=-1), dict(replica_refresh=0)):
        with pytest.raises(ValueError):
            EngineConfig(**{**base, **bad})
    _, params = _port()
    assert _engine(params, "exact", _shard_loss())._replica is not None
    assert _engine(params, "exact")._replica is None
    assert _engine(params, "exact", _shard_loss(),
                   paged=False)._replica is None
    plan = fault_plan(None, 1, 6)
    assert plan.spec("shard_loss").at == (6,)
    assert plan.spec("shard_loss").shard == 1
    assert not plan.spec("page_poison").enabled
    assert fault_plan(0, 2, 3).spec("page_poison").enabled
    assert fault_plan(None, None, 6) is None


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        sys.path.insert(0, HERE)
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
