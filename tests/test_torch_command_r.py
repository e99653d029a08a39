"""The port's Command-R against the JAX reference, on the CPU.

Command-R 35B (the parallel block: x + attn(ln1 x) + mlp(ln1 x), one
LayerNorm and no ``ln2``; SwiGLU with no bias, RoPE at theta 8e6, a tied
head) reduced to 2 layers and d_model 256, GQA kept: ``reduced()``
clamps the 8 KV heads to the 4 query heads, so both sides build
``replace(command-r-35b.reduced(d_model=256), n_kv_heads=2)``, 4 query
heads of 64 over 2 KV heads.  P = 4 sequence shards, CR 4, on the four
serving paths: the static path in the three prefill/decode pairings
with every cache leaf, the chunk and packed programs in both decode
modes with every leaf after every call, and the paged engine in packed
exact, packed prism and chunked exact.

The shapes, plans, helpers and the JAX child are
``test_torch_moe.py``'s (``FAMILY_OVERRIDES`` keeps the GQA): a module
fixture here runs that file's child for ``command-r-35b`` (a process of
its own, on a (1, 4) host mesh with the jnp backend).  One block is also
held to the reference's ``block_apply`` in process.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_moe as M  # noqa: E402

ARCH = "command-r-35b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return M.run_child(tmp_path_factory, "jax_command_r", ARCH)


@pytest.fixture(scope="module")
def port(jax_ref):
    return M.port_params(jax_ref, ARCH)


@pytest.fixture(scope="module")
def serve_runs(port):
    return M.serve_runs_of(*port)


@pytest.fixture(scope="module")
def tick_runs(port):
    return M.tick_runs_of(*port)


def test_config_is_command_r():
    """The full config the card runs (its depth cut there, its widths
    not), and the reduced one here: GQA 2:1, the parallel block,
    LayerNorm, theta 8e6."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (40, 8192, 64, 8, 128, 22528,
                                           256000)
    assert cfg.parallel_block and cfg.norm_kind == "layernorm"
    assert cfg.rope_theta == 8e6 and not cfg.attn_bias and cfg.tie_embeddings
    small = M.family_config(get_config, ARCH)
    assert (small.n_heads, small.n_kv_heads, small.hd) == (4, 2, 64)


def test_convert_round_trip(jax_ref, port):
    """A parallel block has one norm (``ln1``, with LayerNorm's bias) and
    no ``ln2``, on both sides; ``init`` builds the same tree."""
    from repro_torch.models import transformer as T
    K, _ = M._helpers()
    cfg, params = port
    tree = K._unflatten(jax_ref, "params")
    assert set(tree["scan"][0]) == {"ln1", "attn", "mlp"}
    for layer in params["layers"]:
        assert set(layer) == {"ln1", "attn", "mlp"}
        assert set(layer["ln1"]) == {"scale", "bias"}
    np.testing.assert_array_equal(
        params["layers"][1]["attn"]["wk"]["w"].numpy(),
        tree["scan"][0]["attn"]["wk"]["w"][1])
    assert params["layers"][0]["attn"]["wk"]["w"].shape == (
        cfg.d_model, cfg.n_kv_heads * cfg.hd)
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(mine) == set(params)
    assert all(set(a) == set(b) for a, b in zip(mine["layers"],
                                                params["layers"]))


def test_parallel_block_matches_reference(port):
    """One block in process against ``repro.models.transformer.
    block_apply``: both branches off the one norm, summed as the
    reference sums them; the sequential rule on the same weights gives
    another answer."""
    import dataclasses
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro.models.context import FullContext as JFull
    from repro_torch.models import transformer as T
    from repro_torch.models.context import FullContext
    cfg, params = port
    p = params["layers"][0]
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    got = T.block_apply(cfg, "attn", p, torch.as_tensor(x), FullContext())
    pj = {k: {kk: ({kkk: jnp.asarray(t.numpy()) for kkk, t in vv.items()}
                   if isinstance(vv, dict) else jnp.asarray(vv.numpy()))
              for kk, vv in v.items()} for k, v in p.items()}
    want, _ = JT.block_apply(M.family_config(jget, ARCH), "attn", pj, None,
                             jnp.asarray(x), JFull())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    seq = dataclasses.replace(cfg, parallel_block=False)
    other = T.block_apply(seq, "attn", {**p, "ln2": p["ln1"]},
                          torch.as_tensor(x), FullContext())
    assert float((other - got).abs().max()) > 1e-3


def test_forward_matches_reference(jax_ref, serve_runs):
    err = M.rel_err(serve_runs["full_forward"], jax_ref["forward"])
    assert err <= 1e-5, err


@pytest.mark.parametrize("pairing", M.PAIRINGS, ids=M._case)
def test_prefill_and_decode_logits_match_reference(jax_ref, serve_runs,
                                                   pairing):
    case = M._case(pairing)
    run = serve_runs[case]
    for key in ["prefill_logits"] + [f"step{i}_logits"
                                     for i in range(M.STEPS)]:
        err = M.rel_err(run[key], jax_ref[f"{case}/{key}"])
        assert err <= 1e-4, (key, err)


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("pairing", M.PAIRINGS, ids=M._case)
def test_cache_leaves_match_reference(jax_ref, serve_runs, pairing, stage):
    case = M._case(pairing)
    M.assert_leaves(serve_runs[case][f"cache_{stage}"], jax_ref,
                    f"{case}/cache_{stage}", pairing[1], M.B,
                    serve_runs["lay"])


def test_exact_decode_matches_full_forward(serve_runs):
    """Exact decode, teacher-forced, equals the plain causal forward."""
    run = serve_runs[M._case(("voltage", "exact"))]
    full = serve_runs["full_forward"]
    for i in range(-1, M.STEPS):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = M.rel_err(got, full[:, M.N + i])
        assert err <= 1e-4, (i, err)


@pytest.mark.parametrize("kind", ["chunk", "tick"])
@pytest.mark.parametrize("mode", M.MODES)
def test_tick_caches_match_reference(jax_ref, tick_runs, mode, kind):
    """Every cache leaf after every chunk call and every packed tick."""
    run = tick_runs[mode]
    n = sum(1 for k in run if k.startswith(kind) and "/" not in k)
    assert n > 10
    for i in range(n):
        M.assert_leaves(run[f"{kind}{i}"], jax_ref, f"{mode}/{kind}{i}",
                        mode, M.TB, run["lay"])


@pytest.mark.parametrize("mode", M.MODES)
def test_packed_logits_match_reference(jax_ref, tick_runs, mode):
    run = tick_runs[mode]
    n = sum(1 for k in run if k.startswith("tick") and k.endswith("logits"))
    assert n > 10
    for i in range(n):
        got, want = run[f"tick{i}/logits"], jax_ref[f"{mode}/tick{i}/logits"]
        assert got.shape == want.shape
        assert M.rel_err(got, want) <= 1e-4, i


@pytest.mark.parametrize("run", M.ENGINE_RUNS, ids=lambda r: "-".join(r))
def test_engine_tokens_match_reference(jax_ref, port, run):
    got, eng = M.engine_run(*port, *run)
    want = jax_ref["engine"]["/".join(run)]
    assert got[0] == want[0]
    assert got[1] == want[1]
    eng.kv_cache.check()
