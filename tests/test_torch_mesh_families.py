"""Every other decoder family served over a mesh of ranks against the
reference's ``shard_map`` programs, on the CPU: sliding-window layers,
recurrent blocks, a shared attention block, an image prefix and a frame
prompt.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's ``make_prefill_step`` / ``make_serve_step``
with the jnp backend and saves the parameters, the prefill logits, each
teacher-forced step's logits and every cache leaf after prefill and
after the last step.  The cases, each at CR 4 with the inputs of the
family's own test file:

  * Gemma 3 1B reduced to d_model 256 with a window of 8 (``test_torch_
    gemma.py``: the reference's window prefill takes a window a shard),
    prompt 32, cache 40, 8 steps (the 8-slot ring wraps), on (1, 4) at B
    2 and at B 1 on (2, 2), the sequence over all four ranks: the ring
    halo (one ``ppermute`` a hop), the ring captured from the last shard
    and decoded alike on every rank;
  * Zamba2 2.7B at 4 layers, head dim 80, prompt 64, recurrence chunks
    of 8 (``test_torch_zamba2.py``): the conv halo, the state handoff, the
    shared attention block;
  * xLSTM 1.3B reduced to d_model 256, prompt 64, chunks of 8
    (``test_torch_xlstm.py``), voltage + exact: the state handoff and the
    sLSTM's gathered sequence;
  * PaliGemma 3B reduced to d_model 256 with its image ``embeds`` (an 8
    row prefix, attended bidirectionally across the shards), and
    MusicGen-medium reduced to d_model 256 over its frames, with
    sinusoids at each rank's start.

The port runs the same cases as gloo ranks of one process each
(``launch/mesh.py::spawn``, a deadline on every spawn).  Each rank's
logits and cache leaves must match the reference at
``test_torch_serve.py``'s tolerances (widened as the family's own file
widens them), and the port's folded one-process path
within 1e-6 of the largest |logit|.  A replicated leaf (a ring, a
state) is compared on every rank.  The same spawns hold ``ppermute`` and
``all_to_all`` over every group to the fold's reshapes.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_mesh import _rank_rows, _rel_err  # noqa: E402
from test_torch_serve import _flatten, _unflatten  # noqa: E402

CR, CHUNK = 4.0, 8
BOTH = (("prism", "prism"), ("voltage", "exact"))
# case -> (arch, mesh shape, batch, prompt, cache, steps, pairings)
CASES = {
    "gemma3-1x4": ("gemma3-1b", (1, 4), 2, 32, 40, 8, BOTH),
    "gemma3-long-2x2": ("gemma3-1b", (2, 2), 1, 32, 40, 8, BOTH),
    "zamba2-1x4": ("zamba2-2.7b", (1, 4), 2, 64, 72, 8, BOTH[:1]),
    "xlstm-1x4": ("xlstm-1.3b", (1, 4), 2, 64, 72, 8, BOTH[1:]),
    "paligemma-1x4": ("paligemma-3b", (1, 4), 2, 32, 36, 4, BOTH[:1]),
    "musicgen-1x4": ("musicgen-medium", (1, 4), 2, 32, 36, 4, BOTH[:1]),
}
ARCHS = ("gemma3-1b", "zamba2-2.7b", "xlstm-1.3b", "paligemma-3b",
         "musicgen-medium")
SHAPES = ((1, 4), (2, 2))
GLOBAL = ("attn", "moe", "shared_attn")
# each family's own file's widening of a cache leaf's absolute tolerance
# to a share of its largest |value| (1e-5 stands under it): Zamba2's
# ``CELL_ATOL`` on every leaf (each layer after the first reads rows
# through an SSM cell, whose sums are exact to their summands' scale);
# PaliGemma's 1e-6 (image rows at sqrt(d) times unit scale)
ATOL_REL = {"zamba2-2.7b": 1e-5, "paligemma-3b": 1e-6}
# the cases whose mesh sums a Mamba2 layer's rows in another f32 order
# than its fold (B = 2 rows a matmul against the fold's B·P = 8; two
# plain f32 Zamba2 forwards lie 2.0e-3 apart on the card): their fold
# check runs a float64 twin of both, as a decode_tp case's does in
# ``test_torch_mesh.py``
F64 = ("zamba2-1x4",)
SPAWN_TIMEOUT = 240.0


def family_config(get_config, arch):
    """The test's config from either package's registry, as the family's
    own test file builds it."""
    if arch == "zamba2-2.7b":
        return dataclasses.replace(get_config(arch).reduced(n_layers=4),
                                   head_dim=80)
    cfg = get_config(arch).reduced(d_model=256)
    if arch == "gemma3-1b":
        return dataclasses.replace(cfg, window=8)
    return cfg


def _runs():
    return [(case, pairing) for case, spec in CASES.items()
            for pairing in spec[6]]


def _id(run):
    case, (pre, dec) = run
    return f"{case}-{pre}-{dec}"


def _inputs(cfg, b, n, steps):
    """(prompts (B, n) int32 or None, embeds or None, forced (B, steps)):
    a vlm's image (B, prefix_len, D) beside its tokens, an audio model's
    frames (B, n, D) in their place."""
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, cfg.vocab_size, size=(b, n)).astype(np.int32)
    forced = rng.integers(1, cfg.vocab_size, size=(b, steps)).astype(
        np.int32)
    embeds = None
    if cfg.arch_type == "vlm":
        embeds = rng.standard_normal((b, cfg.prefix_len, cfg.d_model))
    elif cfg.arch_type == "audio":
        embeds, prompts = rng.standard_normal((b, n, cfg.d_model)), None
    return prompts, (None if embeds is None
                     else embeds.astype(np.float32)), forced


def jax_reference(out_path):
    """Child process: the reference's serve path on host meshes."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, make_prefill_step,
                                     make_serve_step, seq_shards)

    out, params = {}, {}
    for arch in ARCHS:
        cfg = family_config(get_config, arch)
        params[arch] = T.init(cfg, jax.random.PRNGKey(0))
        _flatten(jax.tree.map(np.asarray, params[arch]), f"params/{arch}",
                 out)
    for case, (arch, shape, b, n, cap, steps, pairings) in CASES.items():
        cfg = family_config(get_config, arch)
        mesh = jax.make_mesh(shape, ("data", "model"))
        prompts, embeds, forced = _inputs(cfg, b, n, steps)
        batch = {} if prompts is None else {"tokens": jnp.asarray(prompts)}
        if embeds is not None:
            batch["embeds"] = jnp.asarray(embeds)
        for pre, dec in pairings:
            key = f"{case}/{pre}-{dec}"
            hp = ServeHParams(decode_mode=dec, means_cr=CR, backend="jnp",
                              ssm_chunk=CHUNK)
            prism = PrismConfig(P=seq_shards(mesh, b), cr=CR, mode=pre)
            step_pre, _, _, _ = make_prefill_step(
                cfg, mesh, params[arch], prism, batch=b, n=n, hp=hp, cap=cap)
            logits, cache = step_pre(params[arch], batch)
            out[f"{key}/logits0"] = np.asarray(logits)
            _flatten(cache, f"{key}/cache_prefill", out)
            step, _, _, _ = make_serve_step(cfg, mesh, params[arch], batch=b,
                                            cap=cap, prefill_len=n, hp=hp)
            for i in range(steps):
                pos = jnp.full((b,), n + i, jnp.int32)
                logits, cache = step(params[arch], cache,
                                     jnp.asarray(forced[:, i]), pos)
                out[f"{key}/logits{i + 1}"] = np.asarray(logits)
            _flatten(cache, f"{key}/cache_final", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh_families_ref") / "ref.npz"
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

def _params_tree(cfg, flat, prefix):
    """The reference's parameter pytree from its flattened leaves: a
    ``shared_attn`` unit position holds no leaf, so its ``{}`` is put
    back in the scan list (``test_torch_zamba2.py``)."""
    tree = _unflatten(flat, prefix)
    scan = iter(tree["scan"])
    tree["scan"] = [{} if kind == "shared_attn" else next(scan)
                    for kind in cfg.block_kinds[:cfg.scan_split[0]]]
    return tree


def _tensors(cfg, b, n, steps, dtype=torch.float32):
    """``_inputs`` as the port's tensors, the embeds in ``dtype``."""
    prompts, embeds, forced = _inputs(cfg, b, n, steps)
    return (None if prompts is None
            else torch.as_tensor(prompts, dtype=torch.long),
            None if embeds is None else torch.as_tensor(embeds, dtype=dtype),
            torch.as_tensor(forced, dtype=torch.long))


def _forced_run(case, mesh, tree, pairing, dtype=torch.float32):
    """Prefill and the case's teacher-forced steps on the mesh from the
    whole ``tree``: each step's logits (the rank's rows, the whole
    vocabulary), the caches after prefill and after the last step, the
    layout, the meter after prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime import serve as S
    arch, _, b, n, cap, steps, _ = CASES[case]
    cfg = family_config(get_config, arch)
    mp = S.mesh_params(cfg, tree, mesh)
    prompts, embeds, forced = _tensors(cfg, b, n, steps, dtype)
    hp = S.ServeHParams(decode_mode=pairing[1], means_cr=CR,
                        ssm_chunk=CHUNK)
    lay = S.make_layout(mesh, cap, hp, prefill_len=n, batch=b)
    prism = PrismConfig(P=lay.n_seq, cr=CR, mode=pairing[0])
    mesh.meter.reset()
    logits, cache = S.prefill(cfg, mp, prompts, prism, lay, hp, embeds)
    run = {"meter_prefill": mesh.meter.snapshot(),
           "logits0": S.gather_logits(logits, mp),
           "cache_prefill": [{k: t.clone() for k, t in c.items()}
                             for c in cache], "lay": lay}
    rows = S.batch_rows(forced, lay, mesh)
    for i in range(steps):
        pos = torch.full((rows.shape[0],), n + i, dtype=torch.long)
        logits, cache = S.serve_step(cfg, mp, cache, rows[:, i], pos, lay,
                                     hp)
        run[f"logits{i + 1}"] = S.gather_logits(logits, mp)
    run["cache_final"] = cache
    return run


def _collectives(mesh):
    """ppermute at every shift and all_to_all over each group on
    rank-tagged inputs, with the meter's count of each call."""
    from repro_torch.sharding import comm
    out = {}
    for axes in (("data",), ("model",), ("data", "model")):
        grp = mesh.group(axes)
        name = "+".join(axes)
        x = torch.arange(6.0 * grp.size).reshape(2 * grp.size, 3) \
            + 100.0 * mesh.rank
        for shift in range(1, grp.size):
            mesh.meter.reset()
            out[f"{name}/ppermute{shift}"] = comm.ppermute(
                x, grp, "exchange", shift=shift)
            out[f"{name}/ppermute{shift}/sent"] = mesh.meter.sent["exchange"]
        mesh.meter.reset()
        out[f"{name}/a2a"] = comm.all_to_all(x, grp, "expert", split_dim=0,
                                             concat_dim=1)
        out[f"{name}/a2a/sent"] = mesh.meter.sent["expert"]
        out[f"{name}/ranks"] = grp.ranks
    return out


def _rank_main(mesh, trees):
    """One rank: every case of its mesh shape (an ``F64`` case's float64
    twin too), then the collectives."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.sharding.rules import tree_map
    res = {"collectives": _collectives(mesh)}
    for case, spec in CASES.items():
        if spec[1] != mesh.shape:
            continue
        for pairing in spec[6]:
            res[(case, pairing)] = _forced_run(case, mesh, trees[spec[0]],
                                               pairing)
            if case in F64:
                cfg = family_config(get_config, spec[0])
                tree = tree_map(lambda t: t.double(), from_jax_numpy(
                    cfg, trees[spec[0]], device="cpu"))
                res[(case, pairing, "f64")] = _forced_run(
                    case, mesh, tree, pairing, torch.float64)
    return res


@pytest.fixture(scope="module")
def mesh_runs(jax_ref):
    """Every rank's results, by mesh shape."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    trees = {arch: _params_tree(family_config(get_config, arch), jax_ref,
                                f"params/{arch}") for arch in ARCHS}
    return {shape: spawn(_rank_main, *shape, backend="gloo", device="cpu",
                         timeout=SPAWN_TIMEOUT, args=(trees,))
            for shape in SHAPES}


@pytest.fixture(scope="module")
def fold_runs(jax_ref):
    """The port's folded one-process path on the same weights and
    inputs, at each case's shard count (an ``F64`` case in float64)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime import serve as S
    from repro_torch.sharding.rules import tree_map
    out = {}
    for case, (arch, shape, b, n, cap, steps, pairings) in CASES.items():
        cfg = family_config(get_config, arch)
        params = from_jax_numpy(
            cfg, _params_tree(cfg, jax_ref, f"params/{arch}"), device="cpu")
        dtype = torch.float64 if case in F64 else torch.float32
        params = tree_map(lambda t: t.to(dtype), params)
        p = S.seq_shards(dict(zip(("data", "model"), shape)), b)
        prompts, embeds, forced = _tensors(cfg, b, n, steps, dtype)
        for pre, dec in pairings:
            hp = S.ServeHParams(decode_mode=dec, means_cr=CR,
                                ssm_chunk=CHUNK)
            lay = S.make_layout(p, cap, hp, prefill_len=n)
            _, logits, _ = S.generate(
                cfg, params, prompts, gen=steps + 1,
                prism=PrismConfig(P=p, cr=CR, mode=pre), lay=lay, hp=hp,
                forced=forced, embeds=embeds)
            key = (case, (pre, dec)) + (("f64",) if case in F64 else ())
            out[key] = logits.numpy()
    return out


# --------------------------------------------------------------------------
# the mesh against the reference and against the fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", _runs(), ids=_id)
def test_logits_match_reference_and_fold(jax_ref, mesh_runs, fold_runs,
                                         run):
    """Every rank's prefill and step logits over its batch rows: the
    reference's within 1e-4 of its largest |logit|, the fold's within
    1e-6 (an ``F64`` case's in float64, beside its float64 fold)."""
    case, (pre, dec) = run
    shape, steps = CASES[case][1], CASES[case][5]
    twin = run + (("f64",) if case in F64 else ())
    for rank, res in enumerate(mesh_runs[shape]):
        got = res[run]
        brow, _ = _rank_rows(got, rank, shape)
        nb = got["logits0"].shape[0]
        rows = slice(brow * nb, (brow + 1) * nb)
        for i in range(steps + 1):
            ref = jax_ref[f"{case}/{pre}-{dec}/logits{i}"]
            mine = got[f"logits{i}"].numpy()
            assert _rel_err(mine, ref[rows]) <= 1e-4, (rank, i)
            mine = res[twin][f"logits{i}"].numpy()
            assert _rel_err(mine, fold_runs[twin][i][rows]) <= 1e-6, \
                (rank, i)


def _ref_leaf(jax_ref, prefix, cfg, layer, name):
    """The reference's leaf of a layer: unit position j of its scanned
    units as ``scan/j`` (the unit index leading), a remainder layer as
    ``tail/t``."""
    u, n_units, _ = cfg.scan_split
    if layer < u * n_units:
        return jax_ref[f"{prefix}/scan/{layer % u}/{name}"][layer // u]
    return jax_ref[f"{prefix}/tail/{layer - u * n_units}/{name}"]


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("run", _runs(), ids=_id)
def test_cache_leaves_match_reference(jax_ref, mesh_runs, run, stage):
    """Each rank's leaves are its block of the reference's global ones: a
    global attention layer's k, v its rows and sequence shard; a ring, a
    recurrent state or conv tail and the means leaves its rows, on every
    rank alike (the replicated decode state); at each family's own
    tolerance (``ATOL_REL``)."""
    from repro_torch.configs import get_config
    case, (pre, dec) = run
    arch, shape = CASES[case][:2]
    cfg = family_config(get_config, arch)
    for rank, res in enumerate(mesh_runs[shape]):
        got = res[run]
        lay = got["lay"]
        brow, seq = _rank_rows(got, rank, shape)
        for layer, (kind, c) in enumerate(zip(cfg.block_kinds,
                                              got[f"cache_{stage}"])):
            for name, t in c.items():
                mine = t.numpy()
                nb = mine.shape[0]
                w = _ref_leaf(jax_ref, f"{case}/{pre}-{dec}/cache_{stage}",
                              cfg, layer, name)[brow * nb:(brow + 1) * nb]
                if kind in GLOBAL and name in ("k", "v"):
                    w = w.reshape(nb, lay.n_seq, lay.cap_l,
                                  *w.shape[2:])[:, seq:seq + 1]
                atol = max(1e-5, ATOL_REL.get(arch, 0.0)
                           * float(np.abs(w).max()))
                np.testing.assert_allclose(
                    mine, w, atol=atol, rtol=1e-4,
                    err_msg=f"{name} {layer} rank {rank}")


def test_window_halo_bytes(mesh_runs):
    """A Gemma 3 prism prefill on (1, 4): each local layer's halo is one
    hop, the rank's (B, n_loc, D) f32 rows sent to the next rank (the
    last rank sends none), beside its global layer's gathered means."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import (PrismConfig,
                                           comm_elements_per_device_per_layer)
    cfg = family_config(get_config, "gemma3-1b")
    b, n = CASES["gemma3-1x4"][2:4]
    n_local = cfg.block_kinds.count("attn_local")
    means = b * comm_elements_per_device_per_layer(
        n, cfg.d_model, PrismConfig(P=4, cr=CR)) * 4
    for rank, res in enumerate(mesh_runs[(1, 4)]):
        sent = res[("gemma3-1x4", ("prism", "prism"))]["meter_prefill"]
        halo = b * (n // 4) * cfg.d_model * 4 if rank < 3 else 0
        assert sent["sent"]["exchange"] == \
            n_local * halo + (cfg.n_layers - n_local) * means, rank


# --------------------------------------------------------------------------
# the collectives against the fold's reshapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ppermute_and_all_to_all_match_fold(mesh_runs, shape):
    """Over every group: ppermute by each shift is the fold's shard axis
    shifted up with zeros in front (the window halo's and the conv
    halo's reshape); the tiled all_to_all is block i of every rank's x
    side by side (the expert exchange's).  The meter counts |x| from each
    rank with a receiver, and (n - 1) / n of |x| for the all_to_all."""
    res = mesh_runs[shape]
    for rank, r in enumerate(res):
        c = r["collectives"]
        for name in ("data", "model", "data+model"):
            ranks = c[f"{name}/ranks"]
            n = len(ranks)
            i = ranks.index(rank)
            stack = torch.stack([
                torch.arange(6.0 * n).reshape(2 * n, 3) + 100.0 * q
                for q in ranks])                               # (n, 2n, 3)
            nbytes = stack[0].numel() * 4
            for shift in range(1, n):
                want = (stack[i - shift] if i >= shift
                        else torch.zeros_like(stack[0]))
                assert torch.equal(c[f"{name}/ppermute{shift}"], want)
                assert c[f"{name}/ppermute{shift}/sent"] == (
                    nbytes if i + shift < n else 0)
            blocks = stack.view(n, n, 2, 3)[:, i]             # (n, 2, 3)
            assert torch.equal(c[f"{name}/a2a"],
                               torch.cat(blocks.unbind(0), dim=1))
            assert c[f"{name}/a2a/sent"] == (n - 1) * nbytes // n


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-1.3b"])
def test_decode_tp_refuses_rings_and_cells(arch):
    """decode_tp over sliding-window layers or mLSTM / sLSTM cells is
    refused, naming why: the decode-TP rules cut their ``wq`` (or a
    cell's projections) column-parallel, and the reference's decode
    fails on them too; Zamba2's Mamba2 cells and shared block serve."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import ServeHParams, check_mesh_serving
    hp = ServeHParams(decode_tp=True)
    axes = {"data": 1, "model": 4}
    with pytest.raises(NotImplementedError, match="decode-TP rules cut"):
        check_mesh_serving(get_config(arch), hp, axes)
    check_mesh_serving(get_config("zamba2-2.7b"), hp, axes)


# --------------------------------------------------------------------------
# the example
# --------------------------------------------------------------------------

def test_example_serves_gemma3_over_four_ranks():
    """``examples/serve_batched_torch.py`` serves its default, Gemma 3 1B
    reduced (the JAX example's model), over 4 gloo ranks on the CPU in
    both decode modes and exits 0; every rank reports its bytes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    r = subprocess.run([sys.executable, os.path.join(
        HERE, "..", "examples", "serve_batched_torch.py"), "--mesh", "1x4",
        "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    for rank in range(4):
        assert f"[meter] rank {rank} " in r.stdout


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-ref"]:
    jax_reference(sys.argv[2])
