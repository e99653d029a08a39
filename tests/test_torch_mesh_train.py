"""The train step over a mesh of ranks against the reference's
``make_train_step`` under ``shard_map``, on the CPU.

GPT-2 small reduced (d_model 256, 2 layers, vocabulary 512, so the tied
table is vocab-parallel and the layers' matrices are FSDP over both
axes), B 4 x 32, CR 4, remat, 4 loss chunks, 3 steps with the reference
launcher's schedule (lr 3e-4, warm-up 1, cosine over 3), in ``prism``
and ``voltage`` on a (1, 4) and a (2, 2) mesh.  The port draws the
weights; a JAX child with four fake host devices runs the reference's
step from them (``--jax-ref``), and, beside it, the port runs four gloo
ranks (``launch/mesh.py::spawn``, a deadline on every spawn).  Every
rank is held to the reference at its runner's limits
(``tests/shard_equiv_runner.py``): loss within 2e-4, gnorm within 2e-4
relative, lr within 1e-9, the first step's gradient (m / 0.1, gathered
whole) within 5e-3 of max(1e-6, each leaf's largest |grad|); and to the
port's one-card step at the same P over the whole batch (the fold) at
the card's limits: loss 1e-5 and gnorm 1e-4 relative, the gradient and
the last step's m and v within 1e-4 of each leaf's largest |value|.  Its
bytes a step by class equal ``chip_smoke.py::train_step_bytes``.

The same spawns hold each collective's backward (``sharding/comm.py``)
to autograd of its one-process fold and meter it as ``grad``, and the
mesh step's refusals.  The child also computes the reference's
``GradReduce`` axes (read from the psums of its ``shard_map`` program)
and ``opt_state_specs`` on every registry config's reduced parameters at
(1, 4) and (2, 2), which the port's must equal, and serves a checkpoint
the port's mesh launcher wrote (``launch/train.py --mesh 2x2``): the
port's ``launch/serve.py`` serves it too, its logits within 1e-4 of the
reference's largest |logit| and its greedy tokens equal where the
reference's top-2 gap exceeds 1e-3 (``test_torch_serve.py``'s rule).
The example ``examples/train_char_lm_torch.py`` runs 2 steps at d_model
64 on (2, 2).  The other families: ``test_torch_mesh_train_families.py``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_serve import _flatten, _unflatten  # noqa: E402

ARCH = "gpt2-small"
B, N, STEPS, CR = 4, 32, 3, 4.0
SHAPES = ((1, 4), (2, 2))
MODES = ("prism", "voltage")
SPAWN_TIMEOUT = 240.0
# the reference runner's limits: the loss absolutely, gnorm relatively,
# each gradient leaf relative to max(1e-6, its largest |grad|)
LOSS_TOL, GNORM_TOL, LR_TOL, GRAD_TOL = 2e-4, 2e-4, 1e-9, 5e-3
# the fold's, as on the card
FOLD_LOSS, FOLD_GNORM, FOLD_TREE = 1e-5, 1e-4, 1e-4
# the registry's names, the reference's order
ALL_ARCHS = ("yi-6b", "gemma3-1b", "gemma-7b", "olmoe-1b-7b",
             "paligemma-3b", "command-r-35b", "musicgen-medium",
             "xlstm-1.3b", "zamba2-2.7b", "arctic-480b", "bert-base",
             "vit-b16", "gpt2-small")
# the served checkpoint: B 2 x 32, 4 tokens, prism prefill and decode
SERVE_B, SERVE_N, SERVE_GEN = 2, 32, 4
OPS = ("gather", "tiled", "psum", "psum_scatter", "last_shard", "ppermute",
       "ring", "all_to_all")
GROUPS = (("data",), ("model",), ("data", "model"))


def _shape_id(shape):
    return f"{shape[0]}x{shape[1]}"


def hparams():
    from repro_torch.runtime.train import TrainHParams
    return TrainHParams(lr=3e-4, total_steps=STEPS, warmup=1, loss_chunks=4)


def batches(vocab):
    """STEPS (tokens, labels) int32 (B, N), seeded."""
    rng = np.random.default_rng(1)
    return [(rng.integers(0, vocab, (B, N)).astype(np.int32),
             rng.integers(0, vocab, (B, N)).astype(np.int32))
            for _ in range(STEPS)]


def model():
    """The config and the port's seeded weights (the launcher's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(ARCH).reduced()
    return cfg, T.init(cfg, torch.Generator().manual_seed(0), "cpu")


# --------------------------------------------------------------------------
# the JAX child
# --------------------------------------------------------------------------

def _grad_axes(rules, shapes, mesh):
    """The axes the reference's ``GradReduce.apply`` psums each leaf
    over, read from its ``shard_map`` program: {path: axes}."""
    import jax
    from repro.compat import shard_map
    from repro.sharding.rules import (GradReduce, ParamRule, _path_str,
                                      spec_tree)
    specs = spec_tree(rules)
    body = shard_map(lambda g: GradReduce.apply(g, rules, mesh), mesh=mesh,
                     in_specs=(specs,), out_specs=specs, check_vma=False)
    jaxpr = jax.make_jaxpr(body)(shapes).jaxpr
    inner = next(e for e in jaxpr.eqns if "jaxpr" in e.params).params["jaxpr"]
    inner = getattr(inner, "jaxpr", inner)
    where = {v: i for i, v in enumerate(inner.invars)}
    axes = [()] * len(inner.invars)
    for e in inner.eqns:
        if e.primitive.name.startswith("psum"):
            for v in e.invars:
                axes[where[v]] = tuple(e.params["axes"])
    paths = [_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        rules, is_leaf=lambda x: isinstance(x, ParamRule))[0]]
    assert len(paths) == len(axes)
    return dict(zip(paths, axes))


def jax_reference(out_path, weights_path, ckpt_dir):
    """Child process: the reference's step from the port's weights on
    (1, 4) and (2, 2) in both modes; the rules' gradient axes and m/v
    specs of every registry config; the served checkpoint."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.checkpoint.io import latest_step, restore_checkpoint
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.optim import adamw_init
    from repro.runtime.serve import (ServeHParams, make_prefill_step,
                                     make_serve_step)
    from repro.runtime.train import TrainHParams as JHP
    from repro.runtime.train import make_train_step
    from repro.sharding.rules import opt_state_specs, param_specs, _path_str
    with np.load(weights_path) as z:
        tree = _unflatten(dict(z), "params")
    tree.setdefault("tail", [])             # an empty list saves no leaf
    # numpy leaves: each device_put copies them (the step donates its
    # inputs)
    params = jax.tree.map(np.asarray, tree)
    cfg = get_config(ARCH).reduced()
    out = {}
    for shape in SHAPES:
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape),
                    ("data", "model"))
        for mode in MODES:
            key = f"{_shape_id(shape)}/{mode}"
            hp = JHP(lr=3e-4, total_steps=STEPS, warmup=1, loss_chunks=4)
            step, _, psh, osh, bsh = make_train_step(
                cfg, mesh, params, PrismConfig(P=shape[1], cr=CR, mode=mode),
                hp)
            p = jax.device_put(params, psh)
            o = jax.device_put(adamw_init(params), osh)
            for i, (x, y) in enumerate(batches(cfg.vocab_size)):
                p, o, m = step(p, o, jax.device_put(
                    {"tokens": x, "labels": y}, bsh))
                for k, v in m.items():
                    out[f"{key}/{k}/{i}"] = np.asarray(v)
                if i == 0:
                    for path, leaf in jax.tree_util.tree_flatten_with_path(
                            jax.device_get(o["m"]))[0]:
                        out[f"{key}/grad/{_path_str(path)}"] = (
                            np.asarray(leaf) / 0.1)
    specs = {}
    for arch in ALL_ARCHS:
        acfg = get_config(arch).reduced()
        shapes = jax.eval_shape(lambda: T.init(acfg, jax.random.PRNGKey(0)))
        for shape in SHAPES:
            mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape),
                        ("data", "model"))
            rules = param_specs(shapes, mesh, acfg.vocab_size)
            ospecs = opt_state_specs(rules, shapes, mesh)
            flat = jax.tree_util.tree_flatten_with_path(
                ospecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]
            axes = _grad_axes(rules, shapes, mesh)
            specs[f"{arch}/{_shape_id(shape)}"] = {
                _path_str(path): [list(axes[_path_str(path)]),
                                  list(spec) + [None] * (
                                      len(_leaf(shapes, path).shape)
                                      - len(spec))]
                for path, spec in flat}
    out["specs"] = np.array(json.dumps(specs))
    # the port's mesh launcher's checkpoint, served: prism prefill, then
    # greedy prism decode
    template = T.init(cfg, jax.random.PRNGKey(0))
    served = restore_checkpoint(ckpt_dir, latest_step(ckpt_dir), template)
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    cap = SERVE_N + SERVE_GEN + (-(SERVE_N + SERVE_GEN)) % 4
    hp = ServeHParams(decode_mode="prism", means_cr=CR, backend="jnp")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(SERVE_B, SERVE_N)).astype(np.int32)
    pre, _, _, _ = make_prefill_step(cfg, mesh, served,
                                     PrismConfig(P=4, cr=CR, mode="prism"),
                                     batch=SERVE_B, n=SERVE_N, hp=hp, cap=cap)
    logits, cache = pre(served, {"tokens": jnp.asarray(prompts)})
    step, _, _, _ = make_serve_step(cfg, mesh, served, batch=SERVE_B,
                                    cap=cap, prefill_len=SERVE_N, hp=hp)
    toks, all_logits = [], []
    for i in range(SERVE_GEN):
        all_logits.append(np.asarray(logits))
        toks.append(np.asarray(logits).argmax(-1).astype(np.int32))
        if i < SERVE_GEN - 1:
            pos = jnp.full((SERVE_B,), SERVE_N + i, jnp.int32)
            logits, cache = step(served, cache, jnp.asarray(toks[-1]), pos)
    out["serve/tokens"] = np.stack(toks, axis=1)
    out["serve/logits"] = np.stack(all_logits)
    np.savez(out_path, **out)


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", k))]
    return tree


# --------------------------------------------------------------------------
# what each rank runs
# --------------------------------------------------------------------------

def _collective_run(mesh):
    """Each collective over each group on rank-tagged f64 inputs, under
    autograd: its output, the input's gradient of sum(out · w_rank) and
    the ``grad`` bytes of the backward."""
    from repro_torch.sharding import comm
    out = {}
    for axes in GROUPS:
        grp = mesh.group(axes)
        name = "+".join(axes)
        out[f"{name}/ranks"] = grp.ranks
        out[f"{name}/index"] = grp.index
        for op in OPS:
            x = (torch.arange(8.0, dtype=torch.float64).reshape(2, 4)
                 + 10.0 * mesh.rank).requires_grad_(True)
            call = {
                "gather": lambda: comm.all_gather(x, grp, "tp"),
                "tiled": lambda: comm.all_gather(x, grp, "tp", dim=1),
                "psum": lambda: comm.psum(x, grp, "tp"),
                "psum_scatter": lambda: comm.psum_scatter(x, grp, "tp",
                                                          dim=1),
                "last_shard": lambda: comm.last_shard(x, grp, "tp"),
                "ppermute": lambda: comm.ppermute(x, grp, "tp", shift=1),
                "ring": lambda: comm.ppermute(x, grp, "tp", shift=1,
                                              ring=True),
                "all_to_all": lambda: comm.all_to_all(
                    x, grp, "tp", split_dim=1, concat_dim=0)}[op]
            y = call()
            mesh.meter.reset()
            _backward((y * _weight(y.shape, mesh.rank)).sum())
            out[f"{name}/{op}"] = (y.detach(), _grad(x),
                                   mesh.meter.sent["grad"],
                                   mesh.meter.sent["tp"])
    return out


def _backward(loss):
    """loss.backward(), where the loss depends on an input at all (a
    ppermute over one rank returns zeros)."""
    if loss.requires_grad:
        loss.backward()


def _grad(x):
    return torch.zeros_like(x) if x.grad is None else x.grad


def _weight(shape, rank):
    n = int(np.prod(shape))
    return torch.cos(torch.arange(n, dtype=torch.float64)
                     + 7.0 * rank).reshape(shape)


def _message(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def _refusals(mesh, params):
    """What a mesh step refuses, each refusal's (type, message)."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.train import (make_train_step,
                                           shard_train_state, train_layout)
    cfg = get_config(ARCH).reduced()
    hp = hparams()
    out = {}
    for mode in ("prism_nodup", "duplicate", "single"):
        out[mode] = _message(lambda: make_train_step(
            cfg, PrismConfig(P=mesh.shape[1], mode=mode), hp, mesh=mesh,
            params=params))
    prism = PrismConfig(P=mesh.shape[1], cr=CR)
    out["no_params"] = _message(lambda: make_train_step(cfg, prism, hp,
                                                        mesh=mesh))
    out["n_shards"] = _message(lambda: make_train_step(
        cfg, prism, hp, mesh=mesh, params=params, n_shards=3))
    step = make_train_step(cfg, prism, hp, mesh=mesh, params=params)
    p, o = shard_train_state(step.layout, params)
    odd = np.ones((B, N - 1), dtype=np.int32)
    out["uneven"] = _message(lambda: step(p, o, {"tokens": odd,
                                                 "labels": odd}))
    out["encoder"] = _message(lambda: make_train_step(
        get_config("bert-base").reduced(), prism, hp, mesh=mesh,
        params=params))
    arctic = get_config("arctic-480b").reduced()
    out["depth_cut"] = _message(lambda: train_layout(
        arctic, T.init(arctic, torch.Generator().manual_seed(0), "cpu"),
        mesh))
    return out


def _rank_main(mesh, params):
    """One rank: 3 steps in each mode (metrics, bytes a step, the first
    step's gradient and the last step's m and v gathered whole), and
    again on a float64 twin of the weights (``<mode>/f64``); the
    collectives' backwards and the refusals."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.train import (gather_train_state,
                                           make_train_step,
                                           shard_train_state)
    cfg = get_config(ARCH).reduced()
    res = {}
    for mode, tree in [(m, params) for m in MODES] + [
            (f"{m}/f64", tree_map(lambda t: t.double(), params))
            for m in MODES]:
        step = make_train_step(cfg, PrismConfig(
            P=mesh.shape[1], cr=CR, mode=mode.split("/")[0]), hparams(),
            mesh=mesh, params=tree)
        p, o = shard_train_state(step.layout, tree)
        run = {"hist": [], "sent": []}
        for i, (x, y) in enumerate(batches(cfg.vocab_size)):
            mesh.meter.reset()
            p, o, m = step(p, o, {"tokens": x, "labels": y})
            run["sent"].append(mesh.meter.snapshot()["sent"])
            run["hist"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                _, whole = gather_train_state(step.layout, p, o)
                run["grad"] = tree_map(lambda t: t / 0.1, whole["m"])
        _, whole = gather_train_state(step.layout, p, o)
        run["m"], run["v"] = whole["m"], whole["v"]
        run["local"] = tree_map(lambda t: tuple(t.shape), p)
        res[mode] = run
    res["collectives"] = _collective_run(mesh)
    res["refusals"] = _refusals(mesh, params)
    return res


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    return model()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The port's mesh launcher: GPT-2 reduced, 2 steps on (2, 2), the
    whole parameters saved by rank 0 in the reference's layout."""
    from repro_torch.launch import train as TL
    d = str(tmp_path_factory.mktemp("mesh_ckpt"))
    TL.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh",
             "2x2", "--backend", "gloo", "--steps", "2", "--batch", "4",
             "--seq", "64", "--checkpoint", d])
    return d


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory, weights, checkpoint):
    """The JAX child, started: it runs beside the ranks."""
    from repro_torch.convert import to_jax_numpy
    cfg, params = weights
    d = tmp_path_factory.mktemp("jax_mesh_train")
    flat = {}
    _flatten(to_jax_numpy(cfg, params), "params", flat)
    np.savez(d / "weights.npz", **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--jax-ref",
         str(d / "ref.npz"), str(d / "weights.npz"), checkpoint], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, d / "ref.npz"


@pytest.fixture(scope="module")
def mesh_runs(jax_child, weights):
    """Every rank's results, by mesh shape."""
    from repro_torch.launch.mesh import spawn
    _, params = weights
    return {shape: spawn(_rank_main, *shape, backend="gloo", device="cpu",
                         timeout=SPAWN_TIMEOUT, args=(params,))
            for shape in SHAPES}


@pytest.fixture(scope="module")
def jax_ref(jax_child, mesh_runs):
    proc, out = jax_child
    so, se = proc.communicate(timeout=600)
    assert proc.returncode == 0, so[-2000:] + se[-4000:]
    with np.load(out) as z:
        ref = dict(z)
    ref["specs"] = json.loads(str(ref["specs"]))
    return ref


@pytest.fixture(scope="module")
def folds(weights):
    """The port's one-card step at P = the model size over the whole
    batch, each (shape, mode), on the float64 twin of the weights:
    metrics, the first step's gradient, the last step's m and v."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.runtime.train import make_train_step
    cfg, params = weights
    params = tree_map(lambda t: t.double(), params)
    out = {}
    for shape in SHAPES:
        for mode in MODES:
            step = make_train_step(cfg, PrismConfig(P=shape[1], cr=CR,
                                                    mode=mode), hparams(),
                                   n_shards=shape[1], device="cpu")
            p, o = params, adamw_init(params)
            run = {"hist": []}
            for i, (x, y) in enumerate(batches(cfg.vocab_size)):
                p, o, m = step(p, o, {"tokens": x, "labels": y})
                run["hist"].append({k: float(v) for k, v in m.items()})
                if i == 0:
                    run["grad"] = tree_map(lambda t: t / 0.1, o["m"])
            run["m"], run["v"] = o["m"], o["v"]
            out[(shape, mode)] = run
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaf_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _tree_err(got, want):
    """The largest of the leaves' errors (``_leaf_err``), and its leaf."""
    from repro_torch.sharding.rules import tree_paths
    w = dict(tree_paths(want))
    errs = {path: _leaf_err(t.numpy(), w[path].numpy())
            for path, t in tree_paths(got)}
    assert set(errs) == set(w)
    at = max(errs, key=errs.get)
    return errs[at], at


# --------------------------------------------------------------------------
# the step against the reference and the fold
# --------------------------------------------------------------------------

RUNS = [(shape, mode) for shape in SHAPES for mode in MODES]


def _run_id(run):
    return f"{_shape_id(run[0])}-{run[1]}"


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_mesh_step_matches_reference(jax_ref, mesh_runs, weights, run):
    """Every rank's metrics equal each other's and the reference's
    within the runner's limits, 3 steps; the first step's gradient (m /
    0.1, gathered whole) within 5e-3 of each leaf's largest |grad|."""
    import jax
    from repro_torch.convert import to_jax_numpy
    cfg, _ = weights
    shape, mode = run
    key = f"{_shape_id(shape)}/{mode}"
    ranks = [r[mode] for r in mesh_runs[shape]]
    for rank, got in enumerate(ranks):
        assert got["hist"] == ranks[0]["hist"], rank
        for i, h in enumerate(got["hist"]):
            assert abs(h["loss"] - float(jax_ref[f"{key}/loss/{i}"])) \
                < LOSS_TOL, (rank, i)
            assert abs(h["gnorm"] / float(jax_ref[f"{key}/gnorm/{i}"])
                       - 1) < GNORM_TOL, (rank, i)
            assert abs(h["lr"] - float(jax_ref[f"{key}/lr/{i}"])) < LR_TOL
            assert h["moe_aux"] == float(jax_ref[f"{key}/moe_aux/{i}"]) \
                == 0.0
        grads = to_jax_numpy(cfg, got["grad"])
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        assert len(flat) == sum(k.startswith(f"{key}/grad/")
                                for k in jax_ref)
        for path, g in flat:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            assert _leaf_err(g, jax_ref[f"{key}/grad/{name}"]) < GRAD_TOL, \
                (rank, name)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_mesh_step_matches_fold(folds, mesh_runs, run):
    """Every rank against the one-card step at the same P over the whole
    batch, both on the float64 twin of the weights: loss within 1e-5 and
    gnorm within 1e-4 (relative), lr equal, the first step's gradient and
    the last step's m and v within 1e-4 of max(1e-6, each leaf's largest
    |value|).  In float64, because the key projection's bias has a
    gradient of exactly 0 (the softmax does not see a shift of every
    score in a row): in f32 it is noise of about 1e-10 on both sides,
    which the 1e-6 floor puts at up to 2e-4 (the card, where the same
    rule holds GPT-2 small in f32, saw 2.2e-5 there)."""
    shape, mode = run
    fold = folds[run]
    for rank, res in enumerate(mesh_runs[shape]):
        got = res[f"{mode}/f64"]
        for h, f in zip(got["hist"], fold["hist"]):
            assert abs(h["loss"] / f["loss"] - 1) < FOLD_LOSS, rank
            assert abs(h["gnorm"] / f["gnorm"] - 1) < FOLD_GNORM, rank
            assert h["lr"] == f["lr"]
        for name in ("grad", "m", "v"):
            err, at = _tree_err(got[name], fold[name])
            assert err < FOLD_TREE, (rank, name, at, err)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_step_bytes_match_rules(weights, mesh_runs, run):
    """Each rank's bytes a step by class equal the rules' count
    (``chip_smoke.py::train_step_bytes``, which phase 20's run (l)
    holds the card's ranks to), every step alike; nothing else sent."""
    from repro_torch.core.protocol import PrismConfig
    cfg, params = weights
    shape, mode = run
    want = _chip_smoke().train_step_bytes(
        cfg, params, shape, B, N, PrismConfig(P=shape[1], cr=CR, mode=mode),
        hparams())
    assert all(v > 0 for v in want.values())
    for rank, res in enumerate(mesh_runs[shape]):
        for sent in res[mode]["sent"]:
            assert {k: sent[k] for k in want} == want, rank
            assert not any(v for k, v in sent.items() if k not in want)


def test_layout_cuts_the_leaves_by_rule(weights, mesh_runs):
    """On (2, 2) a rank holds a quarter of each fsdp2d matrix, half the
    vocab-parallel table's rows, and whole the 1-D leaves."""
    from repro_torch.sharding.rules import tree_paths
    _, params = weights
    whole = dict(tree_paths(params))
    for res in mesh_runs[(2, 2)]:
        local = dict(tree_paths(res["prism"]["local"]))
        assert local["embed/table"] == (whole["embed/table"].shape[0] // 2,
                                        whole["embed/table"].shape[1])
        w = whole["layers/0/mlp/up/w"].shape
        assert local["layers/0/mlp/up/w"] == (w[0] // 2, w[1] // 2)
        assert local["final_norm/scale"] == tuple(
            whole["final_norm/scale"].shape)


# --------------------------------------------------------------------------
# the collectives' backward against the fold
# --------------------------------------------------------------------------

def _fold_op(op, xs, i):
    """Group index i's output of ``op`` in one process over the group's
    inputs ``xs``."""
    n = len(xs)
    if op == "gather":
        return torch.stack(xs)
    if op == "tiled":
        return torch.cat(xs, dim=1)
    if op == "psum":
        return sum(xs)
    if op == "psum_scatter":
        return sum(xs).chunk(n, dim=1)[i]
    if op == "last_shard":
        return xs[-1]
    if op == "ppermute":
        return xs[i - 1] if i else torch.zeros_like(xs[0])
    if op == "ring":
        return xs[(i - 1) % n]
    return torch.cat([x.chunk(n, dim=1)[i] for x in xs], dim=0)


def _grad_bytes(op, n, i, x_bytes):
    """The bytes group index i sends in the backward of ``op`` over n
    ranks of an input of ``x_bytes``: the transpose's collective."""
    if n == 1:
        return 0
    return {"gather": (n - 1) * x_bytes, "tiled": (n - 1) * x_bytes,
            "psum": 2 * (n - 1) * x_bytes // n,
            "psum_scatter": (n - 1) * x_bytes // n,
            "last_shard": 2 * (n - 1) * x_bytes // n,
            "ppermute": x_bytes if i else 0, "ring": x_bytes,
            "all_to_all": (n - 1) * x_bytes // n}[op]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_collective_backward_matches_fold(mesh_runs, shape, op):
    """Each collective's output and its input's gradient on every rank,
    over every group, equal the fold's (its one-process form, autograd
    over the group's inputs) in float64 within 1e-12; the backward sends
    its transpose's bytes, metered ``grad``."""
    runs = mesh_runs[shape]
    for axes in GROUPS:
        name = "+".join(axes)
        for rank, res in enumerate(runs):
            c = res["collectives"]
            ranks, i = c[f"{name}/ranks"], c[f"{name}/index"]
            xs = [(torch.arange(8.0, dtype=torch.float64).reshape(2, 4)
                   + 10.0 * r).requires_grad_(True) for r in ranks]
            loss = sum((_fold_op(op, xs, j) * _weight(
                _fold_op(op, xs, j).shape, r)).sum()
                for j, r in enumerate(ranks))
            _backward(loss)
            y, g, sent, _ = c[f"{name}/{op}"]
            torch.testing.assert_close(y, _fold_op(op, xs, i).detach(),
                                       rtol=0, atol=1e-12)
            torch.testing.assert_close(g, _grad(xs[i]), rtol=0, atol=1e-12)
            assert sent == _grad_bytes(op, len(ranks), i, 64), (name, rank)


def test_pmax_passes_no_gradient(mesh_runs):
    """The loss's max is stopped, as the reference's: a pmax of a tensor
    that requires grad gives one that does not."""
    from repro_torch.sharding import comm
    x = torch.ones(3, requires_grad=True)
    grp = comm.Group(("model",), (0,), 0, None, comm.Meter())
    assert not comm.pmax(x, grp, "tp").requires_grad
    assert "grad" in comm.CLASSES


# --------------------------------------------------------------------------
# GradReduce and opt_state_specs against the reference
# --------------------------------------------------------------------------

def _reference_path(cfg, path):
    """The reference's leaf path of the port's: a scanned layer's
    ``scan/<j>/...``, a tail layer's ``tail/<t>/...``."""
    if not path.startswith("layers/"):
        return path
    _, layer, rest = path.split("/", 2)
    u, n_units, _ = cfg.scan_split
    layer = int(layer)
    if layer < u * n_units:
        return f"scan/{layer % u}/{rest}"
    return f"tail/{layer - u * n_units}/{rest}"


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_grad_reduce_and_opt_specs_match_reference(jax_ref, arch, shape):
    """On every registry config's reduced parameters: the axes
    ``GradReduce`` psums each leaf over and its m/v spec (a scanned
    layer's over the stacked leaf, depth entry first) equal the
    reference's, leaf by leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import (GradReduce, opt_state_specs,
                                            param_specs, tree_paths)
    cfg = get_config(arch).reduced()
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    axes = dict(zip(("data", "model"), shape))
    rules = param_specs(params, axes, cfg.vocab_size)
    red = dict(tree_paths(GradReduce.axes(rules, axes)))
    specs = dict(tree_paths(opt_state_specs(rules, params, axes,
                                            cfg.scan_split)))
    want = jax_ref["specs"][f"{arch}/{_shape_id(shape)}"]
    seen = set()
    for path, got in red.items():
        ref = _reference_path(cfg, path)
        w_axes, w_spec = want[ref]
        assert got == tuple(w_axes), path
        assert specs[path] == tuple(w_spec), path
        seen.add(ref)
    assert seen == set(want)


# --------------------------------------------------------------------------
# refusals, the checkpoint, the example
# --------------------------------------------------------------------------

def test_mesh_train_refusals(mesh_runs):
    """A mesh step refuses the Table II modes other than prism and
    voltage (the reference's mesh serves them as prism), a sequence that
    does not split over ``model``, a shard count other than the mesh's,
    no parameters to compute the rules on, an encoder, and m/v cut over
    the depth of the reference's stacked layers (reduced arctic's dense
    residual on (2, 2), which one dict a layer cannot hold)."""
    for shape in SHAPES:
        got = mesh_runs[shape][0]["refusals"]
        for mode in ("prism_nodup", "duplicate", "single"):
            kind, msg = got[mode]
            assert kind == "NotImplementedError" and mode in msg
        assert got["uneven"][0] == "ValueError"
        assert "does not split" in got["uneven"][1]
        assert got["n_shards"][0] == "ValueError"
        assert got["no_params"][0] == "ValueError"
        assert got["encoder"][0] == "ValueError"
        assert "encoder" in got["encoder"][1]
    kind, msg = mesh_runs[(2, 2)][0]["refusals"]["depth_cut"]
    assert kind == "NotImplementedError" and "depth" in msg
    assert mesh_runs[(1, 4)][0]["refusals"]["depth_cut"] is None


def test_mesh_checkpoint_served_by_both(jax_ref, checkpoint):
    """The checkpoint the port's mesh launcher wrote (2 steps on (2,
    2)), served by the port's launcher code (``setup(...,
    checkpoint=)``, prism prefill and decode at P 4) teacher-forced on
    the reference's greedy tokens over the same checkpoint: logits
    within 1e-4 of the reference's largest |logit|, greedy tokens equal
    where its top-2 gap exceeds 1e-3; and not the seeded weights."""
    from repro_torch.launch.serve import setup
    run = setup(ARCH, reduced=True, batch=SERVE_B, prompt_len=SERVE_N,
                gen=SERVE_GEN, seq_shards=4, decode_mode="prism",
                prefill="prism", cr=CR, device="cpu", checkpoint=checkpoint)
    fresh = setup(ARCH, reduced=True, batch=SERVE_B, prompt_len=SERVE_N,
                  gen=SERVE_GEN, seq_shards=4, decode_mode="prism",
                  prefill="prism", cr=CR, device="cpu")
    want_toks = jax_ref["serve/tokens"]
    forced = torch.as_tensor(want_toks[:, :-1], dtype=torch.long)
    _, logits, _ = run.run(forced=forced)
    _, seeded, _ = fresh.run(forced=forced)
    want = jax_ref["serve/logits"]
    got = logits.numpy()
    assert _leaf_err(got, want) < 1e-4
    assert _leaf_err(seeded.numpy(), want) > 1e-2
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    assert clear.sum() > 0
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_example_trains_char_lm_on_a_2x2_mesh(tmp_path):
    """``examples/train_char_lm_torch.py``: 2 steps at d_model 64 over 2
    layers on (2, 2), gloo ranks on the CPU, then the held-out bpc and
    the checkpoint, gathered whole."""
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "..", "examples",
                                      "train_char_lm_torch.py"),
         "--device", "cpu", "--steps", "2", "--layers", "2", "--d-model",
         "64", "--seq", "64", "--batch", "4", "--mesh", "2x2",
         "--eval-batches", "1", "--ckpt-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src")),
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = r.stdout.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 2
    bpc = [ln for ln in lines if ln.startswith("held-out bpc")]
    assert len(bpc) == 1 and np.isfinite(float(bpc[0].split()[3]))
    from repro_torch.checkpoint.io import latest_step
    assert latest_step(str(tmp_path)) == 2


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(*sys.argv[2:])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz WEIGHTS.npz CKPT")
