"""Serving over a mesh of ranks against the reference's ``shard_map``
programs, on the CPU.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's ``make_prefill_step`` / ``make_serve_step``
with the jnp backend on a (1, 4) and a (2, 2) mesh, and saves the
parameters, the prefill logits, each teacher-forced step's logits and
every cache leaf after prefill and after the last step.  The cases:

  * GPT-2 small reduced (d_model 128, 2 layers, vocab 512, so the tied
    table is vocab-parallel and the MLP and position table are FSDP), B
    2, prompt 32, CR 4, 4 steps, in the three pairings;
  * Yi-6B reduced (d_model 128, 4 heads of 32, d_ff 344) with
    ``decode_tp``: prism prefill, exact decode over column-parallel wq
    and up/gate and row-parallel wo and down;
  * the long_500k rule: GPT-2 at B 1 on (2, 2), the batch replicated and
    the sequence over all four ranks, voltage + exact and prism + prism.

The port runs the same cases as four gloo ranks of one process each
(``launch/mesh.py::spawn``, one thread a rank, a deadline on every
spawn), the weights carried across by ``mesh_params`` from the
reference's tree.  Each rank's logits, over its batch rows and gathered
over the vocabulary, and its cache leaves (its rows and sequence shard
of the reference's global leaves) must match the reference at
``test_torch_serve.py``'s tolerances, and the port's folded one-process
path within 1e-6 of the largest |logit|.  A decode_tp step splits the
sums of wo and down over the ranks, which reorders them in f32 (its
logits lie 1.2e-6 from the fold's at (2, 2), as the reference's own TP
and non-TP logits lie 1.2e-6 apart): its fold check runs a float64 twin
of both, where the split changes nothing an f32 logit can show.  The
same spawns hold each
collective of ``sharding/comm.py`` to the fold's reshape or reduction,
the meter's exchange bytes to ``comm_elements_per_device_per_layer``,
and the refusals of what a mesh does not serve (the other families:
``test_torch_mesh_moe.py`` and ``test_torch_mesh_families.py``; the
engine over a mesh: ``test_torch_mesh_engine.py``).
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_serve import _flatten, _unflatten  # noqa: E402

N, STEPS, CR = 32, 4, 4.0
PAIRINGS = (("voltage", "exact"), ("prism", "prism"), ("voltage", "prism"))
LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")
SHAPES = ((1, 4), (2, 2))
# case -> (arch, mesh shape, batch, pairings, decode_tp)
CASES = {
    **{f"gpt2-{d}x{m}": ("gpt2-small", (d, m), 2, PAIRINGS, False)
       for d, m in SHAPES},
    **{f"yi-tp-{d}x{m}": ("yi-6b", (d, m), 2, (("prism", "exact"),), True)
       for d, m in SHAPES},
    "gpt2-long-2x2": ("gpt2-small", (2, 2), 1, PAIRINGS[:2], False),
}
ARCHS = ("gpt2-small", "yi-6b")
SPAWN_TIMEOUT = 240.0


def _runs():
    return [(case, pairing) for case, spec in CASES.items()
            for pairing in spec[3]]


def _id(run):
    case, (pre, dec) = run
    return f"{case}-{pre}-{dec}"


def _cap(n_seq):
    return N + STEPS + (-(N + STEPS)) % n_seq


def _inputs(vocab, b):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, vocab, size=(b, N)).astype(np.int32)
    forced = rng.integers(1, vocab, size=(b, STEPS)).astype(np.int32)
    return prompts, forced


def jax_reference(out_path):
    """Child process: the reference's serve path on host meshes."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, make_prefill_step,
                                     make_serve_step, seq_shards)

    out = {}
    params = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced(d_model=128)
        params[arch] = T.init(cfg, jax.random.PRNGKey(0))
        _flatten(jax.tree.map(np.asarray, params[arch]), f"params/{arch}",
                 out)
    for case, (arch, shape, b, pairings, tp) in CASES.items():
        cfg = get_config(arch).reduced(d_model=128)
        mesh = jax.make_mesh(shape, ("data", "model"))
        cap = _cap(seq_shards(mesh, b))
        prompts, forced = _inputs(cfg.vocab_size, b)
        for pre, dec in pairings:
            key = f"{case}/{pre}-{dec}"
            hp = ServeHParams(decode_mode=dec, means_cr=CR, backend="jnp",
                              decode_tp=tp)
            prism = PrismConfig(P=shape[1], cr=CR, mode=pre)
            step_pre, _, _, _ = make_prefill_step(
                cfg, mesh, params[arch], prism, batch=b, n=N, hp=hp, cap=cap)
            logits, cache = step_pre(params[arch],
                                     {"tokens": jnp.asarray(prompts)})
            out[f"{key}/logits0"] = np.asarray(logits)
            _flatten(cache, f"{key}/cache_prefill", out)
            step, _, _, _ = make_serve_step(cfg, mesh, params[arch],
                                            batch=b, cap=cap, prefill_len=N,
                                            hp=hp)
            for i in range(STEPS):
                pos = jnp.full((b,), N + i, jnp.int32)
                logits, cache = step(params[arch], cache,
                                     jnp.asarray(forced[:, i]), pos)
                out[f"{key}/logits{i + 1}"] = np.asarray(logits)
            _flatten(cache, f"{key}/cache_final", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh_ref") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--jax-ref", str(out)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


# --------------------------------------------------------------------------
# what each rank runs
# --------------------------------------------------------------------------

def _message(fn):
    """The (type name, message) of what ``fn`` raises, or None."""
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def _served(fn):
    """("served", the words ``fn`` returns), or the (type name, message)
    of what it raises: a call a mesh once refused, now served."""
    try:
        return "served", fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)


def _collectives(mesh):
    """Each collective over each group on rank-tagged inputs, with the
    meter's count of each call."""
    from repro_torch.sharding import comm
    x = torch.arange(6.0).reshape(2, 3) + 10.0 * mesh.rank
    out = {}
    for axes in (("data",), ("model",), ("data", "model")):
        grp = mesh.group(axes)
        name = "+".join(axes)
        for op, fn in (("gather", lambda: comm.all_gather(x, grp, "tp")),
                       ("tiled", lambda: comm.all_gather(x, grp, "tp",
                                                          dim=1)),
                       ("psum", lambda: comm.psum(x, grp, "tp")),
                       ("pmax", lambda: comm.pmax(-x, grp, "tp")),
                       ("last", lambda: comm.last_shard(x, grp, "tp"))):
            mesh.meter.reset()
            out[f"{name}/{op}"] = fn()
            out[f"{name}/{op}/sent"] = mesh.meter.sent["tp"]
        out[f"{name}/ranks"] = grp.ranks
        out[f"{name}/index"] = grp.index
    return out


def _refusals(mesh, tree):
    """What a (1, 4) mesh refuses, each refusal's (type, message), and
    what it once refused and now serves (``_served``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime import serve as S
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.paging import make_paged_layout
    from repro_torch.serving import StreamingEngine
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.sharding.context import ShardedPrismContext
    hp = S.ServeHParams(means_cr=CR)
    out = {}
    cfg = get_config("gpt2-small").reduced(d_model=128)
    mp = S.mesh_params(cfg, tree, mesh)
    lay = S.make_layout(mesh, 64, hp, prefill_len=N, batch=2)

    def engine(**over):
        return ServingEngine(cfg, mp, EngineConfig(
            n_slots=2, prefill_len=N, max_cache=64, **over),
            clock=lambda: 0.0)

    def stream():
        seng = StreamingEngine(engine())
        _, st = seng.submit_stream(list(range(1, 9)), max_new_tokens=2)
        seng.run_sync()
        return f"streamed {st.drain()} ({st.finished})"

    def offload():
        eng = engine(offload=True)
        rid = eng.submit(list(range(1, 9)), max_new_tokens=3)
        while not any(st.generated for st in eng._sched.active.values()):
            eng.step()
        eng.preempt(rid)
        eng.run()
        s = eng.stats
        return f"preempted {s.preemptions}, restored {s.restore_hits}"

    def chaos():
        eng = engine(faults=FaultPlan.chaos(0))
        for i in range(3):
            eng.submit(list(range(1 + i, 9 + i)), max_new_tokens=3)
        eng.run()
        return (f"finished {len(eng.results())} + failed "
                f"{len(eng.failed())} of 3")

    def degraded():
        # the degraded step on the rank's shard of a paged pool, shard 1
        # lost, its standby columns zero (gz = 0)
        paging = make_paged_layout(lay, page_tokens=16, n_pages=8,
                                   n_slots=2)
        cache = S.init_cache(cfg, lay, 2, hp, "cpu", paging)
        pm = torch.arange(8, dtype=torch.int32).view(2, 4)
        m = lay.n_seq * lay.L
        rep = [{"kz": torch.zeros(2, m, cfg.n_kv_heads, cfg.hd),
                "vz": torch.zeros(2, m, cfg.n_kv_heads, cfg.hd),
                "gz": torch.zeros(2, m)} for _ in range(cfg.n_layers)]
        tok = torch.ones(2, dtype=torch.long)
        logits, _ = S.serve_step(cfg, mp, cache, tok, tok * 5, lay, hp,
                                 pm, torch.arange(2, dtype=torch.int32),
                                 lost=torch.tensor([0.0, 1.0, 0.0, 0.0]),
                                 rep=rep)
        logits = S.gather_logits(logits, mp)
        return (f"finite logits {tuple(logits.shape)}: "
                f"{bool(torch.isfinite(logits).all())}")
    out["stream"] = _served(stream)
    out["offload"] = _served(offload)
    out["chaos"] = _served(chaos)
    out["degraded"] = _served(degraded)
    one = torch.zeros(1, dtype=torch.long)
    for mode in ("prism_nodup", "duplicate", "single"):
        out[mode] = _message(lambda: ShardedPrismContext(
            PrismConfig(P=4, mode=mode), n_shards=4, mesh=mesh))
    out["uneven"] = _message(lambda: ShardedPrismContext(
        PrismConfig(P=4), n_shards=4, n=30, mesh=mesh))
    out["tp_rules"] = _message(lambda: S.serve_step(
        cfg, mp, [], one, one, lay, S.ServeHParams(decode_tp=True)))
    return out


def _expert_tp_refusal(mesh):
    """On a (2, 2) mesh: reduced arctic's expert d_ff of 87 does not split
    over ``data``, so expert-TP is refused, with the decode-TP rule's cut
    of ``down/w`` across d_model named."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serve as S
    cfg = get_config("arctic-480b").reduced(d_model=128)
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    hp = S.ServeHParams(means_cr=CR, decode_tp=True)
    lay = S.make_layout(mesh, 64, hp, prefill_len=N, batch=2)
    return {"arctic-tp": _message(lambda: S.prefill(
        cfg, S.mesh_params(cfg, params, mesh), torch.ones(2, N,
                                                          dtype=torch.long),
        PrismConfig(P=2, cr=CR), lay, hp))}


def _forced_run(cfg, mesh, tree, b, pre, dec, tp):
    """Prefill and STEPS teacher-forced steps on the mesh from the whole
    ``tree``: each step's logits (the rank's rows, the whole
    vocabulary), the caches after prefill and after the last step, the
    meter after prefill and at the end, the layout."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime import serve as S
    mp = S.mesh_params(cfg, tree, mesh)
    dp = S.mesh_params(cfg, tree, mesh, decode_tp=True) if tp else mp
    prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                       for a in _inputs(cfg.vocab_size, b))
    hp = S.ServeHParams(decode_mode=dec, means_cr=CR, decode_tp=tp)
    lay = S.make_layout(mesh, _cap(S.seq_shards(mesh, b)), hp,
                        prefill_len=N, batch=b)
    prism = PrismConfig(P=lay.n_seq, cr=CR, mode=pre)
    mesh.meter.reset()
    logits, cache = S.prefill(cfg, mp, prompts, prism, lay, hp)
    run = {"meter_prefill": mesh.meter.snapshot(),
           "logits0": S.gather_logits(logits, mp),
           "cache_prefill": [{k: t.clone() for k, t in c.items()}
                             for c in cache],
           "lay": lay}
    rows = S.batch_rows(forced, lay, mesh)
    for i in range(STEPS):
        pos = torch.full((rows.shape[0],), N + i, dtype=torch.long)
        logits, cache = S.serve_step(cfg, dp, cache, rows[:, i], pos, lay,
                                     hp)
        run[f"logits{i + 1}"] = S.gather_logits(logits, dp)
    run["cache_final"] = cache
    run["meter"] = mesh.meter.snapshot()
    return run


def _rank_main(mesh, trees):
    """One rank: every case of its mesh shape (a decode_tp case's
    float64 twin too), then the collectives and the refusals of its
    shape."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.sharding.rules import tree_map
    shape = mesh.shape
    res = {"collectives": _collectives(mesh)}
    res["refusals"] = (_refusals(mesh, trees["gpt2-small"])
                       if shape == (1, 4) else _expert_tp_refusal(mesh))
    for case, (arch, cshape, b, pairings, tp) in CASES.items():
        if cshape != shape:
            continue
        cfg = get_config(arch).reduced(d_model=128)
        for pre, dec in pairings:
            res[(case, (pre, dec))] = _forced_run(cfg, mesh, trees[arch], b,
                                                  pre, dec, tp)
            if tp:
                tree = tree_map(lambda t: t.double(), from_jax_numpy(
                    cfg, trees[arch], device="cpu"))
                res[(case, (pre, dec), "f64")] = _forced_run(
                    cfg, mesh, tree, b, pre, dec, tp)
    return res


@pytest.fixture(scope="module")
def mesh_runs(jax_ref):
    """Every rank's results, by mesh shape."""
    from repro_torch.launch.mesh import spawn
    trees = {arch: _unflatten(jax_ref, f"params/{arch}") for arch in ARCHS}
    return {shape: spawn(_rank_main, *shape, backend="gloo", device="cpu",
                         timeout=SPAWN_TIMEOUT, args=(trees,))
            for shape in SHAPES}


@pytest.fixture(scope="module")
def fold_runs(jax_ref):
    """The port's folded one-process path on the same weights, each
    case at its P (and in float64 where the case decodes with TP)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime import serve as S
    from repro_torch.runtime.serve import layout_axes
    from repro_torch.sharding.rules import tree_map
    out = {}
    for case, (arch, shape, b, pairings, tp) in CASES.items():
        cfg = get_config(arch).reduced(d_model=128)
        params = from_jax_numpy(cfg, _unflatten(jax_ref, f"params/{arch}"),
                                device="cpu")
        axes = dict(zip(("data", "model"), shape))
        p = int(np.prod([axes[a] for a in layout_axes(axes, b)[1]]))
        prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                           for a in _inputs(cfg.vocab_size, b))
        for pre, dec in pairings:
            hp = S.ServeHParams(decode_mode=dec, means_cr=CR)
            lay = S.make_layout(p, _cap(p), hp, prefill_len=N)
            key = (case, (pre, dec)) + (("f64",) if tp else ())
            tree = tree_map(lambda t: t.double(), params) if tp else params
            _, logits, _ = S.generate(cfg, tree, prompts, gen=STEPS + 1,
                                      prism=PrismConfig(P=p, cr=CR, mode=pre),
                                      lay=lay, hp=hp, forced=forced)
            out[key] = logits.numpy()
    return out


def _rank_rows(run, rank, shape):
    """The batch rows and the sequence shard the rank holds."""
    lay = run["lay"]
    data, model = divmod(rank, shape[1])
    seq = rank if len(lay.seq_axes) == 2 else model
    return (data if lay.ba else 0), seq


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


# --------------------------------------------------------------------------
# the mesh against the reference and against the fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", _runs(), ids=_id)
def test_logits_match_reference_and_fold(jax_ref, mesh_runs, fold_runs,
                                         run):
    """Every rank's prefill and step logits, its batch rows over the
    whole vocabulary: the reference's within 1e-4 of its largest |logit|
    (``test_torch_serve.py``'s rule), the fold's within 1e-6 (a decode_tp
    case's in float64, beside its float64 fold)."""
    case, (pre, dec) = run
    _, shape, b, _, tp = CASES[case]
    twin = run + (("f64",) if tp else ())
    for rank, res in enumerate(mesh_runs[shape]):
        got = res[run]
        brow, _ = _rank_rows(got, rank, shape)
        nb = got["logits0"].shape[0]
        rows = slice(brow * nb, (brow + 1) * nb)
        for i in range(STEPS + 1):
            ref = jax_ref[f"{case}/{pre}-{dec}/logits{i}"]
            assert _rel_err(got[f"logits{i}"].numpy(), ref[rows]) <= 1e-4, \
                (rank, i)
            mine = res[twin][f"logits{i}"].numpy()
            assert _rel_err(mine, fold_runs[twin][i][rows]) <= 1e-6, \
                (rank, i)


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("run", _runs(), ids=_id)
def test_cache_leaves_match_reference(jax_ref, mesh_runs, run, stage):
    """Each rank's leaves are its block of the reference's global ones:
    k, v (B_loc, 1, cap_l, ...) its rows and sequence shard; the means
    leaves its rows, every shard's."""
    case, (pre, dec) = run
    _, shape, _, _, _ = CASES[case]
    leaves = LEAVES if dec == "prism" else LEAVES[:2]
    for rank, res in enumerate(mesh_runs[shape]):
        got = res[run]
        lay = got["lay"]
        brow, seq = _rank_rows(got, rank, shape)
        for name in leaves:
            want = jax_ref[f"{case}/{pre}-{dec}/cache_{stage}/scan/0/{name}"]
            for layer, c in enumerate(got[f"cache_{stage}"]):
                assert set(c) == set(leaves)
                mine = c[name].numpy()
                nb = mine.shape[0]
                w = want[layer][brow * nb:(brow + 1) * nb]
                if name in ("k", "v"):
                    w = w.reshape(nb, lay.n_seq, lay.cap_l,
                                  *w.shape[2:])[:, seq:seq + 1]
                np.testing.assert_allclose(mine, w, atol=1e-5, rtol=1e-4,
                                           err_msg=f"{name} {layer} {rank}")


@pytest.mark.parametrize("run", _runs(), ids=_id)
def test_exchange_bytes_match_protocol(mesh_runs, run):
    """A prefill's exchange bytes on every rank: B_loc x
    comm_elements_per_device_per_layer x 4 a layer, exactly (PRISM's
    means, Voltage's partitions; a Voltage prefill for prism decode
    gathers the means too)."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import (PrismConfig,
                                           comm_elements_per_device_per_layer)
    case, (pre, dec) = run
    arch, shape, _, _, _ = CASES[case]
    cfg = get_config(arch).reduced(d_model=128)
    for res in mesh_runs[shape]:
        got = res[run]
        lay = got["lay"]
        nb = got["logits0"].shape[0]
        prism = PrismConfig(P=lay.n_seq, cr=CR, mode=pre)
        elems = comm_elements_per_device_per_layer(N, cfg.d_model, prism)
        if pre == "voltage" and dec == "prism":
            elems += (lay.n_seq - 1) * lay.L * cfg.d_model
        want = nb * elems * 4 * cfg.n_layers
        assert got["meter_prefill"]["sent"]["exchange"] == want


def test_exchange_cut_at_cr4(mesh_runs):
    """PRISM's exchange at CR 4 over 4 shards is a quarter of Voltage's
    on the same rank: the 75% cut."""
    res = mesh_runs[(1, 4)][0]
    prism = res[("gpt2-1x4", ("prism", "prism"))]["meter_prefill"]
    volt = res[("gpt2-1x4", ("voltage", "exact"))]["meter_prefill"]
    assert 4 * prism["sent"]["exchange"] == volt["sent"]["exchange"]


def test_decode_tp_gathers_no_parameter(mesh_runs):
    """decode_tp's steps gather no weight and send tensor-parallel
    activations; the FSDP decode gathers every step."""
    res = mesh_runs[(1, 4)][0]
    tp = res[("yi-tp-1x4", ("prism", "exact"))]
    assert tp["meter"]["sent"]["param_gather"] == \
        tp["meter_prefill"]["sent"]["param_gather"]
    assert tp["meter"]["sent"]["tp"] > tp["meter_prefill"]["sent"]["tp"]
    fsdp = res[("gpt2-1x4", ("voltage", "exact"))]
    assert fsdp["meter"]["sent"]["param_gather"] > \
        fsdp["meter_prefill"]["sent"]["param_gather"] > 0


def test_long_500k_layout():
    """B 1 on a (2, 2) mesh: the batch is replicated and the sequence
    splits over all four ranks, data major; B 2 splits the batch over
    data and the sequence over model (the reference's _layout_axes).
    The B 1 run is held to the reference's programs, which run it on jax
    0.9, in the tests above (case gpt2-long-2x2)."""
    from repro_torch.runtime.serve import layout_axes, seq_shards
    axes = {"data": 2, "model": 2}
    assert layout_axes(axes, 1) == ((), ("data", "model"))
    assert seq_shards(axes, 1) == 4
    assert layout_axes(axes, 2) == (("data",), ("model",))
    assert seq_shards(axes, 2) == 2


# --------------------------------------------------------------------------
# the collectives against the fold's reshapes and reductions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_collectives_match_fold(mesh_runs, shape):
    """all_gather (a new axis, tiled), psum, pmax and last_shard over
    every group: the stacked inputs of the group's ranks, reshaped or
    reduced as the fold does; the meter counts what each rank sends."""
    res = mesh_runs[shape]
    inputs = [torch.arange(6.0).reshape(2, 3) + 10.0 * r
              for r in range(len(res))]
    for rank, r in enumerate(res):
        c = r["collectives"]
        for name in ("data", "model", "data+model"):
            ranks = c[f"{name}/ranks"]
            n = len(ranks)
            assert ranks[c[f"{name}/index"]] == rank
            stack = torch.stack([inputs[q] for q in ranks])
            nbytes = inputs[0].numel() * 4
            assert torch.equal(c[f"{name}/gather"], stack)
            assert torch.equal(c[f"{name}/tiled"],
                               stack.permute(1, 0, 2).reshape(2, 3 * n))
            assert torch.equal(c[f"{name}/psum"], stack.sum(0))
            assert torch.equal(c[f"{name}/pmax"], (-stack).amax(0))
            assert torch.equal(c[f"{name}/last"], stack[-1])
            gathered = (n - 1) * nbytes
            assert c[f"{name}/gather/sent"] == gathered
            assert c[f"{name}/tiled/sent"] == gathered
            assert c[f"{name}/psum/sent"] == 2 * (n - 1) * nbytes // n
            last = c[f"{name}/index"] == n - 1
            assert c[f"{name}/last/sent"] == (gathered if last else 0)


def _launcher_rank(mesh, forced):
    """One rank of the launcher's run (``launch.serve.mesh_rank``)."""
    torch.set_num_threads(1)
    from repro_torch.launch.serve import mesh_rank
    r = mesh_rank(mesh, "gpt2-small", batch=2, prompt_len=N, gen=STEPS + 1,
                  decode_mode="prism", cr=CR, reduced=True, forced=forced)
    return {"logits": r["logits"], "lay": r["lay"]}


def test_launcher_rank_matches_setup_fold():
    """``launch.serve.mesh_rank`` (the rank of the launcher's ``--mesh``,
    of the example and of chip_smoke's phase 20) is ``setup``'s run laid
    over the mesh: teacher-forced on the greedy tokens of ``setup``'s
    folded run, each rank's logits on a (1, 4) mesh match the fold's
    within 1e-6 of the largest |logit|."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import setup
    fold = setup("gpt2-small", batch=2, prompt_len=N, gen=STEPS + 1,
                 seq_shards=4, decode_mode="prism", cr=CR, reduced=True,
                 device="cpu")
    tokens, logits, _ = fold.run()
    ranks = spawn(_launcher_rank, 1, 4, backend="gloo", device="cpu",
                  timeout=SPAWN_TIMEOUT, args=(tokens[:, :-1],))
    for r in ranks:
        assert r["lay"].seq_axes == ("model",) and r["lay"].n_seq == 4
        assert _rel_err(r["logits"].numpy(), logits.numpy()) < 1e-6


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_nccl_refuses_two_ranks_on_one_card():
    """nccl with more ranks than cards (here: none), or on the CPU, is
    refused before any rank starts, and the message names gloo."""
    from repro_torch.launch.mesh import check_backend, spawn
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="gloo"):
        spawn(_rank_main, 1, n_cards + 1, backend="nccl", device="cuda",
              timeout=10.0)
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", 2, "cpu")
    with pytest.raises(ValueError, match="backend"):
        check_backend("mpi", 2, "cpu")


REFUSED = {
    # what a mesh once refused and now serves
    "stream": ("served", "(length)"),
    "offload": ("served", "preempted 1, restored 1"),
    "chaos": ("served", "of 3"),
    "degraded": ("served", "finite logits (2, 512): True"),
    "prism_nodup": ("NotImplementedError", "reference's mesh serves"),
    "duplicate": ("NotImplementedError", "reference's mesh serves"),
    "single": ("NotImplementedError", "reference's mesh serves"),
    "uneven": ("NotImplementedError", "shard_map takes N a multiple"),
    "tp_rules": ("ValueError", "decode-TP rules"),
    "arctic-tp": ("NotImplementedError", "down/w across d_model"),
}


@pytest.mark.parametrize("what", REFUSED)
def test_mesh_refuses(mesh_runs, what):
    """The Table II modes and Alg. 1's uneven split on a mesh (the
    reference's mesh has neither); decode_tp over FSDP-cut parameters;
    expert-TP over an expert d_ff that does not split over ``data``
    (reduced arctic's 87 on (2, 2)): each raises and names why.  The
    engine's streaming loop, offload tier and preemption, fault
    injection and the degraded step, which a mesh once refused, serve:
    a request streamed to its length, one preempted and restored, a
    chaos run whose requests all finish or fail, the degraded step's
    finite logits with shard 1 lost."""
    got = next(r[0]["refusals"][what] for r in mesh_runs.values()
               if what in r[0]["refusals"])
    kind, words = REFUSED[what]
    assert got is not None, what
    assert got[0] == kind and words in got[1], got


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-ref"]:
    jax_reference(sys.argv[2])
