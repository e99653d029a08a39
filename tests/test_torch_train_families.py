"""The port's train step over every assigned family against the JAX
reference's ``make_train_step``, on the CPU, at the reduced size.

Two JAX children with four fake host devices run, side by side, the
reference's step at lr 0 with clipping off (``tests/shard_equiv_
runner.py``'s way: the first moment after one step is 0.1 × the
gradient) on a (1, 1) mesh (P 1) and on a (1, 4) mesh (P 4): PRISM at
CR 4 for the attention and MoE families, Voltage for xLSTM and Zamba2,
whose recurrent state is handed across the shards exactly.  Gemma 3's
reduced window (16) spans two of its shards of 8 rows: both packages
take the halo of two shards.  Each case holds the port's LM loss and
``moe_aux`` within 1e-5 of the reference's and every gradient leaf
within the runner's 5e-3 of max(1e-6, the leaf's largest |grad|).
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
# repro.configs.ASSIGNED_ARCHS, as the reference's smoke tests train them
ARCHS = ("command-r-35b", "musicgen-medium", "gemma-7b", "paligemma-3b",
         "xlstm-1.3b", "olmoe-1b-7b", "yi-6b", "zamba2-2.7b", "gemma3-1b",
         "arctic-480b")
B, N, CR = 2, 32, 4.0
LOSS_TOL, GRAD_TOL = 1e-5, 5e-3


def mode_of(arch: str, p: int) -> str:
    return "voltage" if p > 1 and arch in ("xlstm-1.3b",
                                           "zamba2-2.7b") else "prism"


def batch_of(cfg):
    """Tokens and labels (B, N), or an audio model's frames (B, N, D)
    and a vlm's image (B, prefix_len, D): numpy, seeded."""
    rng = np.random.default_rng(1)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, N)).astype(
        np.int32)}
    if cfg.frontend == "encodec_stub":
        batch["embeds"] = rng.standard_normal((B, N, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, N)).astype(
            np.int32)
        if cfg.arch_type == "vlm":
            batch["embeds"] = rng.standard_normal(
                (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def jax_reference(out_path, p):
    """The child: every family's reference step at P ``p``; the numpy
    parameters, the metrics and the gradients (m / 0.1)."""
    import jax
    from jax.sharding import Mesh
    from repro.configs import ASSIGNED_ARCHS, get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as JT
    from repro.optim import adamw_init
    from repro.runtime.train import TrainHParams, make_train_step
    assert tuple(ASSIGNED_ARCHS) == ARCHS
    mesh = Mesh(np.array(jax.devices()[:p]).reshape(1, p),
                ("data", "model"))
    hp = TrainHParams(lr=0.0, grad_clip=1e9, loss_chunks=4, ssm_chunk=8,
                      remat=False)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = JT.init(cfg, jax.random.PRNGKey(0))
        step, _, psh, osh, bsh = make_train_step(
            cfg, mesh, params, PrismConfig(P=p, cr=CR, mode=mode_of(arch, p)),
            hp)
        tree = jax.tree.map(np.asarray, params)
        _, opt, m = step(jax.device_put(params, psh),
                         jax.device_put(adamw_init(params), osh),
                         jax.device_put(batch_of(cfg), bsh))
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{arch}/param{jax.tree_util.keystr(path)}"] = leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(opt["m"]))[0]:
            out[f"{arch}/grad{jax.tree_util.keystr(path)}"] = (
                np.asarray(leaf) / 0.1)
        for k in ("loss", "moe_aux"):
            out[f"{arch}/{k}"] = np.asarray(m[k])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Both children at once; {P: their results}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    outs, procs = {}, {}
    for p in (1, 4):
        outs[p] = tmp_path_factory.mktemp(f"train_p{p}") / "ref.npz"
        procs[p] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--jax-ref",
             str(outs[p]), str(p)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    res = {}
    for p, proc in procs.items():
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0, so[-2000:] + se[-4000:]
        with np.load(outs[p]) as z:
            res[p] = dict(z)
    return res


def _tree(ref, prefix):
    """The reference's flattened leaves under ``prefix`` back to its
    nested layout (dicts and the scan / tail lists)."""
    root: dict = {}
    for key, leaf in ref.items():
        if not key.startswith(prefix + "["):
            continue
        parts = [k.strip("'") for k in key[len(prefix) + 1:-1].split("][")]
        node = root
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node.get(str(i), {}))
                    for i in range(max(map(int, node)) + 1)]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(jax_ref, arch, p):
    import jax
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy, to_jax_numpy
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime.train import (TrainHParams, loss_and_grads,
                                           to_batch)
    from repro_torch.sharding.context import ShardedPrismContext
    ref = jax_ref[p]
    cfg = get_config(arch).reduced()
    tree = _tree(ref, f"{arch}/param")
    # a layer without weights (Zamba2's shared_attn: {}) saved no leaf
    u, _, n_tail = cfg.scan_split
    for key, n in (("scan", u), ("tail", n_tail)):
        have = tree.get(key, [])
        tree[key] = have + [{}] * (n - len(have))
    params = from_jax_numpy(cfg, tree, device="cpu")
    ctx = ShardedPrismContext(PrismConfig(P=p, cr=CR, mode=mode_of(arch, p)),
                              n_shards=p, backend="plain")
    nll, aux, grads = loss_and_grads(
        cfg, params, to_batch(batch_of(cfg), "cpu"), ctx,
        TrainHParams(loss_chunks=4, ssm_chunk=8))
    assert abs(float(nll) - float(ref[f"{arch}/loss"])) < LOSS_TOL
    assert abs(float(aux) - float(ref[f"{arch}/moe_aux"])) < LOSS_TOL
    if cfg.n_experts:
        assert float(aux) > 0
    flat = jax.tree_util.tree_flatten_with_path(to_jax_numpy(cfg, grads))[0]
    assert len(flat) == sum(k.startswith(f"{arch}/grad") for k in ref)
    for path, g in flat:
        want = ref[f"{arch}/grad{jax.tree_util.keystr(path)}"]
        err = np.abs(g.astype(np.float64) - want).max()
        assert err / max(1e-6, np.abs(want).max()) < GRAD_TOL, path


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2], int(sys.argv[3]))
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz P")
