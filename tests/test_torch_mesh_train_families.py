"""The train step over a (1, 4) mesh of ranks for the families the
reference's own runner trains on its mesh (``tests/shard_equiv_
runner.py``), against the reference's ``make_train_step``, on the CPU.

At the reduced size, B 2 x 32, 3 steps with the reference launcher's
schedule (lr 3e-4, warm-up 1, cosine over 3) and no weight decay
(``hparams``), 4 loss chunks, recurrent chunks of 8, remat: Gemma 3 1B
(a sliding window of 16 over shards of 8 rows: the ring halo of two
hops), xLSTM 1.3B (the mLSTM state handoff,
the sLSTM's gathered sequence), Zamba2 2.7B (Mamba2's conv halo and
state handoff, the shared attention block) in Voltage, as
``test_torch_train_families.py`` runs them, and OLMoE-1B-7B (the expert
all_to_all pair over ``model``) in PRISM at CR 4; then, in PRISM,
PaliGemma 3B's image prefix (256 rows over the first 8 of each reduced
sequence's positions, replicated over ``model``) and MusicGen-medium's
frames (the whole input, cut like the tokens).  The port draws the
weights; a JAX child with four fake host devices runs the reference's
step from them beside the port's four gloo ranks.  Every rank is held to
the reference at its runner's limits (loss 2e-4, gnorm 2e-4 relative, lr
1e-9, the first step's gradient, m / 0.1 gathered whole, within 5e-3 of
max(1e-6, each leaf's largest |grad|)), and, on a float64 twin of the
weights, to the port's one-card step at P 4 over the whole batch (loss
1e-5 and gnorm 1e-4 relative, the gradient and the last step's m and v
within 1e-4 of each leaf's largest |value|).
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
from test_torch_mesh_train import (FOLD_GNORM, FOLD_LOSS,  # noqa: E402
                                   FOLD_TREE, GNORM_TOL, GRAD_TOL,
                                   LOSS_TOL, LR_TOL, _leaf_err, _tree_err)

B, N, STEPS, CR = 2, 32, 3, 4.0
SHAPE = (1, 4)
# the reference's runner families, then a vlm's prefix and an audio
# model's frames
ARCHS = ("gemma3-1b", "xlstm-1.3b", "zamba2-2.7b", "olmoe-1b-7b",
         "paligemma-3b", "musicgen-medium")
SPAWN_TIMEOUT = 240.0


def mode_of(arch: str) -> str:
    return "voltage" if arch in ("xlstm-1.3b", "zamba2-2.7b") else "prism"


def hparams():
    """The launcher's schedule with no weight decay: the reference decays
    every leaf of its stacked scan, the 1-D norm scales and biases too
    (each is 2-D stacked; ROADMAP queue 3), which the port does not; on
    Gemma 3's norms that parts the third step's losses by 3.4e-4, and
    with no decay the two agree to 1e-6.  The port's decay is held by
    ``test_torch_train.py`` and, on GPT-2, by
    ``test_torch_mesh_train.py``."""
    from repro_torch.runtime.train import TrainHParams
    return TrainHParams(lr=3e-4, total_steps=STEPS, warmup=1, loss_chunks=4,
                        ssm_chunk=8, weight_decay=0.0)


def batches(cfg):
    """STEPS batches: tokens and labels (B, N) int32, a vlm's image (B,
    prefix_len, D) and an audio model's frames (B, N, D) in place of its
    tokens, seeded."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        b = {"labels": rng.integers(0, cfg.vocab_size, (B, N)).astype(
            np.int32)}
        if cfg.frontend == "encodec_stub":
            b["embeds"] = rng.standard_normal((B, N, cfg.d_model)).astype(
                np.float32)
        else:
            b["tokens"] = rng.integers(0, cfg.vocab_size, (B, N)).astype(
                np.int32)
            if cfg.arch_type == "vlm":
                b["embeds"] = rng.standard_normal(
                    (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def model(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    return cfg, T.init(cfg, torch.Generator().manual_seed(0), "cpu")


def jax_reference(out_path, weights_path):
    """Child process: the reference's step on (1, 4) for each of
    ``ARCHS``, from the port's weights: metrics and the first step's
    gradient."""
    import jax
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.optim import adamw_init
    from repro.runtime.train import TrainHParams as JHP
    from repro.runtime.train import make_train_step
    from repro.sharding.rules import _path_str
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(SHAPE),
                ("data", "model"))
    with np.load(weights_path) as z:
        flat = dict(z)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        tree = _unflatten(flat, arch)
        # a layer without weights (Zamba2's shared_attn: {}) and an empty
        # tail saved no leaf
        u, _, n_tail = cfg.scan_split
        for key, n in (("scan", u), ("tail", n_tail)):
            have = tree.get(key, [])
            tree[key] = have + [{}] * (n - len(have))
        params = jax.tree.map(np.asarray, tree)
        hp = JHP(lr=3e-4, total_steps=STEPS, warmup=1, loss_chunks=4,
                 ssm_chunk=8, weight_decay=0.0)
        step, _, psh, osh, bsh = make_train_step(
            cfg, mesh, params, PrismConfig(P=SHAPE[1], cr=CR,
                                           mode=mode_of(arch)), hp)
        p = jax.device_put(params, psh)
        o = jax.device_put(adamw_init(params), osh)
        for i, batch in enumerate(batches(cfg)):
            p, o, m = step(p, o, jax.device_put(batch, bsh))
            for k, v in m.items():
                out[f"{arch}/{k}/{i}"] = np.asarray(v)
            if i == 0:
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        jax.device_get(o["m"]))[0]:
                    out[f"{arch}/grad/{_path_str(path)}"] = (
                        np.asarray(leaf) / 0.1)
    np.savez(out_path, **out)


def _run(mesh, arch, params, *, f64: bool):
    """STEPS steps of ``arch`` on the rank: metrics, the first step's
    gradient and the last step's m and v, gathered whole."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.train import (gather_train_state,
                                           make_train_step,
                                           shard_train_state)
    cfg, _ = model(arch)
    if f64:
        params = tree_map(lambda t: t.double(), params)
    step = make_train_step(cfg, PrismConfig(P=SHAPE[1], cr=CR,
                                            mode=mode_of(arch)), hparams(),
                           mesh=mesh, params=params)
    p, o = shard_train_state(step.layout, params)
    run = {"hist": []}
    for i, batch in enumerate(batches(cfg)):
        if f64:
            batch = {k: v.astype(np.float64) if k == "embeds" else v
                     for k, v in batch.items()}
        p, o, m = step(p, o, batch)
        run["hist"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            _, whole = gather_train_state(step.layout, p, o)
            run["grad"] = tree_map(lambda t: t / 0.1, whole["m"])
    _, whole = gather_train_state(step.layout, p, o)
    run["m"], run["v"] = whole["m"], whole["v"]
    return run


def _rank_main(mesh, trees):
    torch.set_num_threads(1)
    res = {}
    for arch in ARCHS:
        res[arch] = _run(mesh, arch, trees[arch], f64=False)
        res[f"{arch}/f64"] = _run(mesh, arch, trees[arch], f64=True)
    return res


@pytest.fixture(scope="module")
def weights():
    return {arch: model(arch)[1] for arch in ARCHS}


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory, weights):
    from repro_torch.convert import to_jax_numpy
    d = tmp_path_factory.mktemp("jax_mesh_train_families")
    flat = {}
    for arch in ARCHS:
        cfg, _ = model(arch)
        _flatten(to_jax_numpy(cfg, weights[arch]), arch, flat)
    np.savez(d / "weights.npz", **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--jax-ref",
         str(d / "ref.npz"), str(d / "weights.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, d / "ref.npz"


@pytest.fixture(scope="module")
def mesh_runs(jax_child, weights):
    from repro_torch.launch.mesh import spawn
    return spawn(_rank_main, *SHAPE, backend="gloo", device="cpu",
                 timeout=SPAWN_TIMEOUT, args=(weights,))


@pytest.fixture(scope="module")
def jax_ref(jax_child, mesh_runs):
    proc, out = jax_child
    so, se = proc.communicate(timeout=600)
    assert proc.returncode == 0, so[-2000:] + se[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def folds(weights):
    """The one-card step at P 4 over the whole batch, on the float64
    twin of the weights."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.runtime.train import make_train_step
    out = {}
    for arch in ARCHS:
        cfg, _ = model(arch)
        p = tree_map(lambda t: t.double(), weights[arch])
        o = adamw_init(p)
        step = make_train_step(cfg, PrismConfig(P=SHAPE[1], cr=CR,
                                                mode=mode_of(arch)),
                               hparams(), n_shards=SHAPE[1], device="cpu")
        run = {"hist": []}
        for i, batch in enumerate(batches(cfg)):
            batch = {k: v.astype(np.float64) if k == "embeds" else v
                     for k, v in batch.items()}
            p, o, m = step(p, o, batch)
            run["hist"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                run["grad"] = tree_map(lambda t: t / 0.1, o["m"])
        run["m"], run["v"] = o["m"], o["v"]
        out[arch] = run
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference(jax_ref, mesh_runs, arch):
    """Every rank's metrics equal each other's and the reference's at
    the runner's limits over 3 steps (``moe_aux`` too); the first step's
    gradient within 5e-3 of each leaf's largest |grad|."""
    import jax
    from repro_torch.convert import to_jax_numpy
    cfg, _ = model(arch)
    ranks = [r[arch] for r in mesh_runs]
    for rank, got in enumerate(ranks):
        assert got["hist"] == ranks[0]["hist"], rank
        for i, h in enumerate(got["hist"]):
            assert abs(h["loss"] - float(jax_ref[f"{arch}/loss/{i}"])) \
                < LOSS_TOL, (rank, i)
            assert abs(h["moe_aux"] - float(jax_ref[f"{arch}/moe_aux/{i}"])) \
                < LOSS_TOL, (rank, i)
            assert abs(h["gnorm"] / float(jax_ref[f"{arch}/gnorm/{i}"])
                       - 1) < GNORM_TOL, (rank, i)
            assert abs(h["lr"] - float(jax_ref[f"{arch}/lr/{i}"])) < LR_TOL
        if cfg.n_experts:
            assert got["hist"][0]["moe_aux"] > 0
        flat = jax.tree_util.tree_flatten_with_path(
            to_jax_numpy(cfg, got["grad"]))[0]
        assert len(flat) == sum(k.startswith(f"{arch}/grad/")
                                for k in jax_ref)
        for path, g in flat:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            assert _leaf_err(g, jax_ref[f"{arch}/grad/{name}"]) < GRAD_TOL, \
                (rank, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_fold(folds, mesh_runs, arch):
    """Every rank against the one-card step at P 4 over the whole batch,
    both on the float64 twin: loss within 1e-5 and gnorm within 1e-4
    (relative), lr equal, the first step's gradient and the last step's
    m and v within 1e-4 of max(1e-6, each leaf's largest |value|)."""
    fold = folds[arch]
    for rank, res in enumerate(mesh_runs):
        got = res[f"{arch}/f64"]
        for h, f in zip(got["hist"], fold["hist"]):
            assert abs(h["loss"] / f["loss"] - 1) < FOLD_LOSS, rank
            assert abs(h["gnorm"] / f["gnorm"] - 1) < FOLD_GNORM, rank
            assert abs(h["moe_aux"] - f["moe_aux"]) < FOLD_LOSS, rank
            assert h["lr"] == f["lr"]
        for name in ("grad", "m", "v"):
            err, at = _tree_err(got[name], fold[name])
            assert err < FOLD_TREE, (rank, name, at, err)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(*sys.argv[2:])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz WEIGHTS.npz")
