"""The port's serving engine over a mesh of ranks against the reference's
engine under ``shard_map``, on the CPU.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's ``ServingEngine`` with the jnp backend on a
(1, 4) and a (2, 2) mesh and saves each request's tokens and the stats
that define the schedule (``test_torch_engine.py``'s ``SCHEDULE``).  The
cells:

  * GPT-2 small reduced (d_model 128, 2 layers, vocab 512, so the tied
    table is vocab-parallel), ``test_torch_engine.py``'s ``stagger``
    trace (4 slots, prompts of 8-32 tokens, two arriving after 4 steps)
    in exact / prism x packed / chunked x paged / dense on both meshes,
    16 cells, and its ``prefix`` trace (6 prompts behind one 16-token
    prefix, 2 slots) in exact decode on the paged cache, packed and
    chunked, on both meshes;
  * reduced OLMoE (4 experts, top-2, capacity factor 1.25, so tokens
    drop), packed prism on (1, 4);
  * the reduced Yi of ``test_torch_llama.py`` (8 query heads over 2 KV
    heads), packed exact on (2, 2).

The child also runs the reference's ``make_chunk_prefill_step`` and
``make_packed_step`` on both meshes, prism decode on the dense cache,
over ``test_torch_ticks.py``'s plans, and saves every cache leaf after
every call and the packed logits.

The port runs the same as four gloo ranks of one process each
(``launch/mesh.py::spawn``, a deadline on every spawn), the weights cut
by ``mesh_params`` from the reference's tree.  Each rank's tokens and
schedule must be the reference's; the engine's digest of the host
decisions after every tick (``ServingEngine.trail``: the tick's kind,
the slots' requests, the page and state maps) must be the same on every
rank; every rank's page accounting must hold;
each rank's cache leaves (its rows and sequence shard of the reference's
global leaves) and the packed logits must match the reference's at
``test_torch_ticks.py``'s tolerances.  The port's folded one-process
engine (``n_seq`` the mesh's sequence shards) must give the same tokens.
The same spawns record what an engine on a mesh still refuses.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_engine as E  # noqa: E402
import test_torch_ticks as K  # noqa: E402
from test_torch_mesh import _message, _served  # noqa: E402

CR = E.CR
SHAPES = ((1, 4), (2, 2))
ARCHS = ("gpt2-small", "olmoe-1b-7b", "yi-6b")
# cell -> (arch, mesh shape, trace, decode mode, prefill mode, paged)
CELLS = {
    **{f"gpt2-{d}x{m}-stagger-{mode}-{pre}-{'paged' if paged else 'dense'}":
       ("gpt2-small", (d, m), "stagger", mode, pre, paged)
       for d, m in SHAPES for mode in E.MODES for pre in E.PREFILL
       for paged in (True, False)},
    **{f"gpt2-{d}x{m}-prefix-exact-{pre}-paged":
       ("gpt2-small", (d, m), "prefix", "exact", pre, True)
       for d, m in SHAPES for pre in E.PREFILL},
    "olmoe-1x4-stagger-prism-packed-paged":
        ("olmoe-1b-7b", (1, 4), "stagger", "prism", "packed", True),
    "yi-2x2-stagger-exact-packed-paged":
        ("yi-6b", (2, 2), "stagger", "exact", "packed", True),
}
# the tick programs: test_torch_ticks.py's shapes and plans, prism decode
# on the dense cache (the packed tick's combine over the batch axes too)
TICK_MODE = "prism"
SPAWN_TIMEOUT = 300.0


def config(get_config, arch):
    """A case's config from either package's registry."""
    if arch == "yi-6b":
        return dataclasses.replace(get_config(arch).reduced(d_model=256),
                                   n_heads=8, n_kv_heads=2, head_dim=32)
    return get_config(arch).reduced(d_model=128)


def _engine_config(EngineConfig, ServeHParams, trace, mode, prefill, paged,
                   backend="auto"):
    hp = ServeHParams(decode_mode=mode, means_cr=CR, backend=backend)
    return EngineConfig(hp=hp, paged=paged,
                        **E._config_kw(trace, mode, prefill))


def jax_reference(params_path, out_path):
    """Child process: the reference's engine and tick programs on host
    meshes, over the weights the port drew (``params_path``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.runtime.serve import (ServeHParams, init_cache,
                                     make_chunk_prefill_step,
                                     make_packed_step)
    from repro.serving import EngineConfig, ServingEngine
    cs = K._chip_smoke()
    with np.load(params_path) as z:
        flat = dict(z)
    params = {}
    for arch in ARCHS:
        tree = K._unflatten(flat, arch)
        tree.setdefault("tail", [])          # no tail layer flattens to none
        params[arch] = jax.tree.map(jnp.asarray, tree)
    out, runs = {}, {}
    for cell, (arch, shape, trace, mode, pre, paged) in CELLS.items():
        cfg = config(get_config, arch)
        mesh = jax.make_mesh(shape, ("data", "model"))
        eng = ServingEngine(cfg, mesh, params[arch], _engine_config(
            EngineConfig, ServeHParams, trace, mode, pre, paged,
            backend="jnp"), clock=lambda: 0.0)
        runs[cell] = E._drive(eng, trace, cfg.vocab_size)
    cfg = config(get_config, "gpt2-small")
    prompts, forced = K._inputs(cfg.vocab_size)
    i32 = lambda a: jnp.asarray(a, jnp.int32)                 # noqa: E731
    hp = ServeHParams(decode_mode=TICK_MODE, means_cr=CR, backend="jnp")
    p = params["gpt2-small"]
    for shape in SHAPES:
        mesh = jax.make_mesh(shape, ("data", "model"))
        key = _shape_key(shape)
        step, lay, _ = make_chunk_prefill_step(
            cfg, mesh, p, batch=K.B, cap=K.CAP, prefill_len=K.N,
            chunk_len=K.CHUNK, hp=hp)
        cache = init_cache(cfg, lay, K.B, hp)
        for i, call in enumerate(cs.plan_chunks(prompts, K.CHUNK, K.JOIN)):
            cache = step(p, cache, *map(i32, call))
            K._flatten(cache["scan"][0], f"{key}/chunk{i}", out)
        step, lay, _, _ = make_packed_step(
            cfg, mesh, p, batch=K.B, cap=K.CAP, prefill_len=K.N,
            token_budget=K.BUDGET, hp=hp)
        cache = init_cache(cfg, lay, K.B, hp)
        for i, t in enumerate(cs.plan_packed(prompts, K.GEN, K.BUDGET,
                                             forced)):
            logits, cache = step(p, cache, *(i32(t[k]) for k in (
                "tok", "slot", "pos", "off", "pre")))
            out[f"{key}/tick{i}/logits"] = np.asarray(logits)
            K._flatten(cache["scan"][0], f"{key}/tick{i}", out)
    np.savez(out_path, runs=np.array(json.dumps(runs)), **out)


def _shape_key(shape):
    return f"ticks/{shape[0]}x{shape[1]}"


# --------------------------------------------------------------------------
# what each rank runs
# --------------------------------------------------------------------------

def _refusals(mp):
    """What an engine on a (1, 4) mesh still refuses (decode_tp in the
    tick programs), and what it once refused and now serves
    (``_served``): the padded flush, gang admission, a snapshot and its
    restore, the cache's moves to and from the host (the streaming loop,
    offload and chaos: ``test_torch_mesh.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.offload import KVStore
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = config(get_config, "gpt2-small")
    kw = dict(n_slots=2, prefill_len=E.N, max_cache=E.CAP)

    def engine(**over):
        return ServingEngine(cfg, mp, EngineConfig(**kw, **over),
                             clock=lambda: 0.0)

    def busy(eng):
        eng.submit(list(range(1, 9)), max_new_tokens=2)
        eng.step()
        return eng

    def finished(eng):
        out = busy(eng).run()
        return f"finished {len(out)} with {sum(map(len, out.values()))} tokens"
    eng = busy(engine())
    snap = eng.snapshot()
    want = eng.run()

    def restore():
        fresh = engine()
        fresh.restore(snap)
        return f"restored, tokens equal: {fresh.run() == want}"

    def spill():
        e, store = busy(engine()), KVStore()
        n = e.kv_cache.spill(0, 0, store)
        return f"spilled {n} pages, {store.bytes_used} bytes"

    def extract():
        payload = busy(engine()).kv_cache.extract_slot(0)
        return f"the rank's shard: k {tuple(payload[0]['k'].shape)}"
    return {"padded": _served(lambda: finished(engine(prefill_mode="padded"))),
            "gang": _served(lambda: finished(engine(gang=True))),
            "snapshot": _served(lambda: f"{len(snap.active)} live slot, "
                                        f"cut on {snap.mesh[0]}"),
            "restore": _served(restore),
            "spill": _served(spill),
            "extract_slot": _served(extract),
            "decode_tp": _message(lambda: busy(engine(
                hp=ServeHParams(decode_tp=True))))}


def _ticks(mesh, tree):
    """The tick programs on the rank: every chunk call of
    ``test_torch_ticks.py``'s plan, then every packed tick, the cache's
    leaves after each and the ticks' logits over the whole vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import (ServeHParams, gather_logits,
                                           make_kv_cache, make_layout,
                                           mesh_params)
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    cs = K._chip_smoke()
    cfg = config(get_config, "gpt2-small")
    mp = mesh_params(cfg, tree, mesh)
    hp = ServeHParams(decode_mode=TICK_MODE, means_cr=CR)
    lay = make_layout(mesh, K.CAP, hp, prefill_len=K.N, batch=K.B)
    prompts, forced = K._inputs(cfg.vocab_size)

    def leaves(cache):
        return [{k: t.clone().numpy() for k, t in c.items()} for c in cache]
    out = {"lay": lay}
    cache = make_kv_cache(cfg, lay, K.B, hp, device="cpu", mesh=mesh).storage
    for i, call in enumerate(cs.plan_chunks(prompts, K.CHUNK, K.JOIN)):
        chunk_prefill_step(cfg, mp, cache, *map(torch.as_tensor, call), lay,
                           hp)
        out[f"chunk{i}"] = leaves(cache)
    cache = make_kv_cache(cfg, lay, K.B, hp, device="cpu", mesh=mesh).storage
    for i, t in enumerate(cs.plan_packed(prompts, K.GEN, K.BUDGET, forced)):
        logits, cache = packed_step(cfg, mp, cache, *(
            torch.as_tensor(t[k]) for k in ("tok", "slot", "pos", "off",
                                             "pre")), lay, hp)
        out[f"tick{i}/logits"] = gather_logits(logits, mp).numpy()
        out[f"tick{i}"] = leaves(cache)
    return out


def _rank_main(mesh, trees):
    """One rank: every engine cell of its mesh shape (its tokens,
    schedule, digest of host decisions, the shape of its cache, the page accounting
    checked), the tick programs and, on (1, 4), the refusals."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import ServeHParams, mesh_params
    from repro_torch.serving import EngineConfig, ServingEngine
    res, mps = {}, {}
    for cell, (arch, shape, trace, mode, pre, paged) in CELLS.items():
        if shape != mesh.shape:
            continue
        cfg = config(get_config, arch)
        if arch not in mps:
            mps[arch] = mesh_params(cfg, trees[arch], mesh)
        eng = ServingEngine(cfg, mps[arch], _engine_config(
            EngineConfig, ServeHParams, trace, mode, pre, paged),
            clock=lambda: 0.0)
        tokens, schedule = E._drive(eng, trace, cfg.vocab_size)
        st = eng.stats
        if paged:
            eng.kv_cache.check()
        res[cell] = {"tokens": tokens, "schedule": schedule,
                     "trail": eng.trail,
                     "ticks": st.packed_ticks + st.decode_steps
                     + st.prefills,
                     "n_seq": eng.layout.n_seq,
                     "k_shape": tuple(eng.kv_cache.storage[0]["k"].shape)}
    res["ticks"] = _ticks(mesh, trees["gpt2-small"])
    if mesh.shape == (1, 4):
        res["refusals"] = _refusals(mps["gpt2-small"])
    return res


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's seeded weights of each case, as the reference's numpy
    tree, and the file the JAX child reads them from."""
    from repro_torch.configs import get_config
    from repro_torch.convert import to_jax_numpy
    from repro_torch.models import transformer as T
    trees, flat = {}, {}
    for arch in ARCHS:
        cfg = config(get_config, arch)
        trees[arch] = to_jax_numpy(cfg, T.init(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        K._flatten(trees[arch], arch, flat)
    path = tmp_path_factory.mktemp("mesh_engine_weights") / "params.npz"
    np.savez(path, **flat)
    return trees, path


def _fold_runs(trees):
    """The port's folded engine of every cell, at the cell's sequence
    shard count."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.runtime.serve import ServeHParams, seq_shards
    from repro_torch.serving import EngineConfig, ServingEngine
    out = {}
    for cell, (arch, shape, trace, mode, pre, paged) in CELLS.items():
        cfg = config(get_config, arch)
        ecfg = _engine_config(EngineConfig, ServeHParams, trace, mode, pre,
                              paged)
        p = seq_shards(dict(zip(("data", "model"), shape)), ecfg.n_slots)
        eng = ServingEngine(cfg, from_jax_numpy(cfg, trees[arch],
                                                device="cpu"),
                            ecfg, n_seq=p, clock=lambda: 0.0)
        out[cell] = E._drive(eng, trace, cfg.vocab_size)
    return out


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The reference's child, started first, and meanwhile every rank of
    both meshes and the port's folded engines: (reference, ranks by mesh
    shape, folded runs by cell)."""
    from repro_torch.launch.mesh import spawn
    trees, params_path = weights
    tmp = tmp_path_factory.mktemp("jax_mesh_engine")
    out = tmp / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    n_threads = torch.get_num_threads()
    with open(tmp / "child.log", "w") as log:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--jax-ref",
             str(params_path), str(out)], env=env, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            ranks = {shape: spawn(_rank_main, *shape, backend="gloo",
                                  device="cpu", timeout=SPAWN_TIMEOUT,
                                  args=(trees,))
                     for shape in SHAPES}
            torch.set_num_threads(1)
            fold = _fold_runs(trees)
            child.wait(timeout=600)
        finally:
            torch.set_num_threads(n_threads)
            if child.poll() is None:
                child.kill()
                child.wait()
    assert child.returncode == 0, (tmp / "child.log").read_text()[-4000:]
    with np.load(out) as z:
        ref = dict(z)
    ref.update(json.loads(str(ref.pop("runs"))))
    return ref, ranks, fold


def _rank_rows(shape, rank, lay):
    """The block of batch rows and the sequence shard the rank holds."""
    data, model = divmod(rank, shape[1])
    return (data if lay.ba else 0), model


# --------------------------------------------------------------------------
# the engine on a mesh against the reference's, and the fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(CELLS))
def test_engine_matches_reference(runs, cell):
    """Every rank's tokens per request and schedule (prefix hits and
    tokens saved, packed ticks, chunk calls, prompt tokens, out-of-pages
    blocks) equal the reference engine's on the same mesh; each rank
    holds its sequence shard of the cache (and, dense, its block of the
    slots)."""
    ref, ranks, _ = runs
    arch, shape, trace, mode, pre, paged = CELLS[cell]
    tokens, schedule = ref[cell]
    for rank, res in enumerate(ranks[shape]):
        got = res[cell]
        assert got["tokens"] == tokens, rank
        assert got["schedule"] == schedule, rank
        k = got["k_shape"]
        assert k[1] == 1 and got["n_seq"] == shape[1], k
        if not paged:
            assert k[0] == E.TRACES[trace]["n_slots"] // shape[0], k
    if trace == "prefix":
        assert schedule["prefix_hits"] == 4


@pytest.mark.parametrize("cell", list(CELLS))
def test_plans_agree_on_every_rank(runs, cell):
    """The engine's digest of the host decisions after every tick
    (``ServingEngine.trail``: the tick's kind, the slots' requests, page
    and state maps, the counters) is the same on every rank: the SPMD
    engine never lets two ranks enter different collectives."""
    _, ranks, _ = runs
    shape = CELLS[cell][1]
    got = [r[cell] for r in ranks[shape]]
    assert got[0]["ticks"] > 4 and len(got[0]["trail"]) == 32
    assert all(g["trail"] == got[0]["trail"] for g in got[1:])


@pytest.mark.parametrize("cell", list(CELLS))
def test_fold_matches_reference(runs, cell):
    """The port's folded one-process engine at the mesh's sequence shard
    count gives the reference engine's tokens and schedule on the
    mesh."""
    ref, _, fold = runs
    assert fold[cell][0] == ref[cell][0]
    assert fold[cell][1] == ref[cell][1]


@pytest.mark.parametrize("kind", ["chunk", "tick"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tick_leaves_match_reference(runs, shape, kind):
    """Each rank's cache leaves after every chunk call and packed tick of
    ``test_torch_ticks.py``'s plans, prism decode on the dense cache: its
    rows and sequence shard of the reference's global k, v; its rows of
    the means leaves, every shard's (atol 1e-5, rtol 1e-4)."""
    ref, ranks, _ = runs
    key = _shape_key(shape)
    for rank, res in enumerate(ranks[shape]):
        got = res["ticks"]
        lay = got["lay"]
        brow, seq = _rank_rows(shape, rank, lay)
        n = sum(1 for k in got if k.startswith(kind) and "/" not in k)
        assert n > 10
        for i in range(n):
            for layer, c in enumerate(got[f"{kind}{i}"]):
                assert set(c) == set(K.LEAVES)
                for name in K.LEAVES:
                    w = ref[f"{key}/{kind}{i}/{name}"][layer]
                    nb = c[name].shape[0]
                    w = w[brow * nb:(brow + 1) * nb]
                    if name in ("k", "v"):
                        w = w.reshape(nb, lay.n_seq, lay.cap_l,
                                      *w.shape[2:])[:, seq:seq + 1]
                    np.testing.assert_allclose(
                        c[name], w, atol=1e-5, rtol=1e-4,
                        err_msg=f"{kind}{i} {name} {layer} rank {rank}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_packed_logits_match_reference(runs, shape):
    """Every packed tick's min(B, T) logit rows over the whole vocabulary,
    on every rank: the reference's within 1e-4 of its largest |logit|."""
    ref, ranks, _ = runs
    key = _shape_key(shape)
    for rank, res in enumerate(ranks[shape]):
        got = res["ticks"]
        n = sum(1 for k in got if k.endswith("/logits"))
        assert n > 10
        for i in range(n):
            want = ref[f"{key}/tick{i}/logits"]
            mine = got[f"tick{i}/logits"]
            assert mine.shape == want.shape == (K.B, 512)
            err = np.abs(mine - want).max() / max(1e-6, np.abs(want).max())
            assert err <= 1e-4, (rank, i, err)


REFUSED = {
    # what a mesh once refused and now serves
    "padded": ("served", "finished 1 with 2 tokens"),
    "gang": ("served", "finished 1 with 2 tokens"),
    "snapshot": ("served", "1 live slot, cut on (1, 4)"),
    "restore": ("served", "tokens equal: True"),
    # one page, 4 columns on the rank's shard (16 positions over 4
    # ranks); the store counts the whole payload's bytes, every shard's:
    # 2 layers x (k, v) x 4 shards x 4 columns x 4 heads x 32 x 4 bytes
    "spill": ("served", "spilled 1 pages, 32768 bytes"),
    "extract_slot": ("served", "k (1, 1, 4, 4, 32)"),
    "decode_tp": ("ValueError", "decode_tp"),
}


@pytest.mark.parametrize("what", REFUSED)
def test_engine_on_a_mesh_refuses(runs, what):
    """The tick programs refuse decode_tp on a mesh, as the reference's
    packed step does.  What a mesh once refused serves: the padded flush
    and gang admission finish a request, a snapshot is cut on the rank
    and restores into a fresh engine with the uninterrupted tokens, and
    the cache spills and extracts the rank's shard of a slot's
    pages."""
    _, ranks, _ = runs
    got = ranks[(1, 4)][0]["refusals"][what]
    kind, words = REFUSED[what]
    assert got is not None, what
    assert got[0] == kind and words in got[1], got


def test_launcher_engine_over_a_mesh(capsys):
    """``launch.serve --engine --mesh 1x4 --backend gloo``: every rank's
    host decisions and tokens equal (the launcher checks them), rank 0's
    stats and robustness counters and each rank's meter printed; the
    robustness flags serve over the mesh too: the streaming loop,
    offload with two priority classes, a chaos run and a lost shard
    (each audited for leaks), gang admission and the padded flush."""
    from repro_torch.launch.serve import main
    argv = ["--reduced", "--engine", "--device", "cpu", "--requests", "4",
            "--rate", "50", "--batch", "4", "--prompt-len", "32", "--gen",
            "4", "--mesh", "1x4", "--backend", "gloo"]
    main(argv)
    out = capsys.readouterr().out
    assert "every rank's tokens equal" in out and "(P=4)" in out
    assert out.count("[meter] rank") == 4
    stats = dict(line.split()[1:3] for line in out.splitlines()
                 if line.startswith("[engine] ") and len(line.split()) == 3)
    assert stats["requests"] == "4" and stats["failed_requests"] == "0"
    for flag, words in ((["--stream"], "[stream] 4 streams closed"),
                        (["--offload", "--priority", "2", "--n-pages", "18"],
                         "[robust] rank 0: preemptions"),
                        (["--chaos", "0"], "[chaos] zero-leak audits OK"),
                        (["--shard-loss", "1", "--shard-loss-at", "4"],
                         "[degraded] shard_lost 1"),
                        (["--gang"], "gang (static) admission"),
                        (["--prefill-mode", "padded"], "padded prefill")):
        main(argv + flag)
        out = capsys.readouterr().out
        assert "every rank's tokens equal" in out and words in out, flag


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2], sys.argv[3])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref PARAMS.npz OUT.npz")
