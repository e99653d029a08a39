"""Mixture-of-Experts serving over a mesh of ranks against the
reference's ``shard_map`` programs, on the CPU.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's ``make_prefill_step`` / ``make_serve_step``
with the jnp backend and saves the parameters, the prefill logits, each
teacher-forced step's logits and every cache leaf after prefill and
after the last step.  The cases, each at B 2, prompt 32, CR 4, 4 steps:

  * OLMoE-1B-7B reduced (d_model 128, 2 layers, 4 experts of d_ff 64,
    top-2) on a (1, 4) mesh, one expert a rank, and on a (2, 2) mesh,
    two experts a rank and the batch over ``data``, in the three
    pairings: each rank routes its own B_loc·n_loc prefill tokens as one
    group and exchanges them by the ``all_to_all`` pair over ``model``;
  * OLMoE on (2, 2) with ``decode_tp``: expert-TP, each expert's d_ff
    over ``data`` (the tokens gathered over ``data``, the down partials
    psummed), prism + exact;
  * arctic reduced with its expert and dense d_ff set to 88 (the reduced
    87 is odd, and the reference's decode-TP rule then cuts ``down/w``
    across d_model and fails: ``test_torch_mesh.py`` holds its refusal)
    on (2, 2) with ``decode_tp``: the dense residual MLP Megatron-cut over
    ``model``, psummed there (``ffn_reduce``).

The port runs the same cases as gloo ranks of one process each
(``launch/mesh.py::spawn``, a deadline on every spawn).  Each rank's
logits and cache leaves must match the reference at
``test_torch_serve.py``'s tolerances, and the port's folded one-process
path within 1e-6 of the largest |logit|.  A rank's routing group is its
own tokens, so the fold it is held to routes the same groups: on (1, 4)
the fold over the whole batch (its P = 4 shards are the ranks' groups,
its decode group the 8 tokens every rank holds), on (2, 2) the fold of
each data rank's batch row at P 2.  A decode_tp case reorders f32 sums
over its ranks: its fold check runs a float64 twin of both, as
``test_torch_mesh.py`` does.  The same spawns hold the ``expert`` bytes
each rank sends to the all_to_all's formula and the exchange's slot
order to the fold's (E, G·cap, D) layout.
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
from test_torch_mesh import (CR, N, PAIRINGS, STEPS, _cap,  # noqa: E402
                             _forced_run, _inputs, _rank_rows, _rel_err)
from test_torch_serve import _flatten, _unflatten  # noqa: E402

B = 2
LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")
SHAPES = ((1, 4), (2, 2))
TP = (("prism", "exact"),)
# case -> (arch, mesh shape, pairings, decode_tp)
CASES = {
    "olmoe-1x4": ("olmoe-1b-7b", (1, 4), PAIRINGS, False),
    "olmoe-2x2": ("olmoe-1b-7b", (2, 2), PAIRINGS, False),
    "olmoe-tp-2x2": ("olmoe-1b-7b", (2, 2), TP, True),
    "arctic-tp-2x2": ("arctic-480b", (2, 2), TP, True),
}
ARCHS = ("olmoe-1b-7b", "arctic-480b")
SPAWN_TIMEOUT = 240.0


def moe_config(get_config, arch):
    """The test's config from either package's registry: reduced to
    d_model 128; arctic's d_ff made even (88) so that expert-TP splits it
    over ``data``."""
    cfg = get_config(arch).reduced(d_model=128)
    if arch == "arctic-480b":
        cfg = dataclasses.replace(cfg, expert_d_ff=88, moe_dense_d_ff=88,
                                  d_ff=88)
    return cfg


def _runs():
    return [(case, pairing) for case, spec in CASES.items()
            for pairing in spec[2]]


def _id(run):
    case, (pre, dec) = run
    return f"{case}-{pre}-{dec}"


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
        cfg = moe_config(get_config, arch)
        params[arch] = T.init(cfg, jax.random.PRNGKey(0))
        _flatten(jax.tree.map(np.asarray, params[arch]), f"params/{arch}",
                 out)
    for case, (arch, shape, pairings, tp) in CASES.items():
        cfg = moe_config(get_config, arch)
        mesh = jax.make_mesh(shape, ("data", "model"))
        cap = _cap(seq_shards(mesh, B))
        prompts, forced = _inputs(cfg.vocab_size, B)
        for pre, dec in pairings:
            key = f"{case}/{pre}-{dec}"
            hp = ServeHParams(decode_mode=dec, means_cr=CR, backend="jnp",
                              decode_tp=tp)
            prism = PrismConfig(P=shape[1], cr=CR, mode=pre)
            step_pre, _, _, _ = make_prefill_step(
                cfg, mesh, params[arch], prism, batch=B, n=N, hp=hp, cap=cap)
            logits, cache = step_pre(params[arch],
                                     {"tokens": jnp.asarray(prompts)})
            out[f"{key}/logits0"] = np.asarray(logits)
            _flatten(cache, f"{key}/cache_prefill", out)
            step, _, _, _ = make_serve_step(cfg, mesh, params[arch],
                                            batch=B, cap=cap, prefill_len=N,
                                            hp=hp)
            for i in range(STEPS):
                pos = jnp.full((B,), N + i, jnp.int32)
                logits, cache = step(params[arch], cache,
                                     jnp.asarray(forced[:, i]), pos)
                out[f"{key}/logits{i + 1}"] = np.asarray(logits)
            _flatten(cache, f"{key}/cache_final", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh_moe_ref") / "ref.npz"
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

def _tagged_buffer(rank, e=4, cap=3):
    """A (1, E, cap, 2) dispatch buffer whose every slot names its
    sender, expert and slot."""
    r = torch.arange(e)[:, None] * 10 + torch.arange(cap)[None, :]
    return torch.stack([r + 1000.0 * rank, torch.full((e, cap), float(rank))],
                       dim=-1)[None].float()


def _rank_main(mesh, trees):
    """One rank: every case of its mesh shape (a decode_tp case's
    float64 twin too), then the expert all_to_all on a tagged buffer."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.sharding.context import expert_all_to_all
    from repro_torch.sharding.rules import tree_map
    res = {}
    for case, (arch, shape, pairings, tp) in CASES.items():
        if shape != mesh.shape:
            continue
        cfg = moe_config(get_config, arch)
        for pre, dec in pairings:
            res[(case, (pre, dec))] = _forced_run(cfg, mesh, trees[arch], B,
                                                  pre, dec, tp)
            if tp:
                tree = tree_map(lambda t: t.double(), from_jax_numpy(
                    cfg, trees[arch], device="cpu"))
                res[(case, (pre, dec), "f64")] = _forced_run(
                    cfg, mesh, tree, B, pre, dec, tp)
    buf = _tagged_buffer(mesh.rank)
    out, back = expert_all_to_all(buf, mesh.group("model"))
    res["a2a"] = {"out": out, "back": back(out),
                  "group": mesh.group("model").ranks}
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
    """The port's folded one-process path on the same weights: on (1, 4)
    over the whole batch at P 4; on (2, 2) over each data rank's batch
    row at P 2 (its routing groups are the rank's); a decode_tp case in
    float64.  -> logits (STEPS + 1, B, V), the rows of each data rank
    stacked in batch order."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime import serve as S
    from repro_torch.sharding.rules import tree_map
    out = {}
    for case, (arch, shape, pairings, tp) in CASES.items():
        cfg = moe_config(get_config, arch)
        params = from_jax_numpy(cfg, _unflatten(jax_ref, f"params/{arch}"),
                                device="cpu")
        if tp:
            params = tree_map(lambda t: t.double(), params)
        data, p = shape
        prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                           for a in _inputs(cfg.vocab_size, B))
        for pre, dec in pairings:
            hp = S.ServeHParams(decode_mode=dec, means_cr=CR)
            lay = S.make_layout(p, _cap(p), hp, prefill_len=N)
            parts = []
            for rows in torch.arange(B).chunk(data):
                _, logits, _ = S.generate(
                    cfg, params, prompts[rows], gen=STEPS + 1,
                    prism=PrismConfig(P=p, cr=CR, mode=pre), lay=lay, hp=hp,
                    forced=forced[rows])
                parts.append(logits)
            key = (case, (pre, dec)) + (("f64",) if tp else ())
            out[key] = torch.cat(parts, dim=1).numpy()
    return out


# --------------------------------------------------------------------------
# the mesh against the reference and against the fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", _runs(), ids=_id)
def test_logits_match_reference_and_fold(jax_ref, mesh_runs, fold_runs,
                                         run):
    """Every rank's prefill and step logits over its batch rows: the
    reference's within 1e-4 of its largest |logit|, the fold's (routing
    the rank's groups) within 1e-6 (a decode_tp case's in float64)."""
    case, (pre, dec) = run
    _, shape, _, tp = CASES[case]
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
    k, v its rows and sequence shard, the means leaves its rows."""
    case, (pre, dec) = run
    shape = CASES[case][1]
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
def test_expert_bytes_match_all_to_all(mesh_runs, run):
    """The ``expert`` bytes every rank sends: per layer the dispatch and
    the return, each (M - 1) / M of the (E, cap, D) f32 buffer over the
    M ranks of ``model``, at the prefill's capacity of the rank's
    B_loc·n_loc tokens and at a step's of its B_loc; with expert-TP also
    a step's gather of the (E / M, M·cap, D) slots over ``data`` and the
    psum of their partials there."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    case, _ = run
    arch, shape, _, tp = CASES[case]
    cfg = moe_config(get_config, arch)
    data, m = shape
    e, d = cfg.n_experts, cfg.d_model
    for res in mesh_runs[shape]:
        got = res[run]
        lay = got["lay"]
        nb = got["logits0"].shape[0]

        def buf(tokens):
            return e * capacity(tokens, cfg.top_k, e,
                                cfg.capacity_factor) * d * 4
        pre = cfg.n_layers * 2 * (m - 1) * buf(nb * N // lay.n_seq) // m
        step = 2 * (m - 1) * buf(nb) // m
        if tp:
            step += (data - 1) * buf(nb) + 2 * (data - 1) * buf(nb)
        assert got["meter_prefill"]["sent"]["expert"] == pre
        assert got["meter"]["sent"]["expert"] == \
            pre + STEPS * cfg.n_layers * step


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_all_to_all_slot_order_matches_fold(mesh_runs, shape):
    """The tiled all_to_all hands each rank its E / M experts with every
    sender's cap slots side by side in sender order: the fold's
    (E, G·cap, D) exchange of the stacked buffers, sliced to the rank's
    experts; the return gives each rank its own buffer back."""
    from repro_torch.models.context import SeqContext
    res = mesh_runs[shape]
    for rank, r in enumerate(res):
        a2a = r["a2a"]
        grp = a2a["group"]
        stack = torch.cat([_tagged_buffer(q) for q in grp])
        fold, _ = SeqContext().expert_exchange(stack)       # (E, M·cap, D)
        e_loc = fold.shape[0] // len(grp)
        i = grp.index(rank)
        assert torch.equal(a2a["out"], fold[i * e_loc:(i + 1) * e_loc])
        assert torch.equal(a2a["back"], _tagged_buffer(rank))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_serves_olmoe_over_four_ranks():
    """``launch/serve.py --mesh 1x4 --backend gloo`` serves OLMoE-1B-7B
    reduced on the CPU and exits 0; every rank sends ``expert`` bytes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "olmoe-1b-7b", "--reduced", "--batch", "8",
                        "--prompt-len", "64", "--gen", "6", "--mesh", "1x4",
                        "--backend", "gloo", "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    meters = [line for line in r.stdout.splitlines()
              if line.startswith("[meter]")]
    assert len(meters) == 4
    assert all("'expert': 0}" not in line for line in meters)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-ref"]:
    jax_reference(sys.argv[2])
