"""The port's Gemma 7B against the JAX reference, on the CPU.

Gemma 7B (GeGLU, RMSNorm, RoPE, sqrt(d_model) input scaling, a tied
head, multi-head attention: as many KV heads as query heads) reduced to
2 layers and d_model 256 (4 heads of 64), P = 4 sequence shards, CR 4,
on the four serving paths: the static path in the three prefill/decode
pairings with every cache leaf, the chunk and packed programs in both
decode modes, and the paged engine in packed exact, packed prism and
chunked exact.

The shapes, plans, helpers and the JAX child are
``test_torch_moe.py``'s: a module fixture here runs that file's child
for ``gemma-7b`` (a process of its own, on a (1, 4) host mesh with the
jnp backend; no routing to record).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_moe as M  # noqa: E402

ARCH = "gemma-7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return M.run_child(tmp_path_factory, "jax_gemma7b", ARCH)


@pytest.fixture(scope="module")
def port(jax_ref):
    return M.port_params(jax_ref, ARCH)


@pytest.fixture(scope="module")
def serve_runs(port):
    return M.serve_runs_of(*port)


@pytest.fixture(scope="module")
def tick_runs(port):
    return M.tick_runs_of(*port)


def test_config_is_gemma_7b():
    """The full config the card runs, and the reduced one here: MHA at
    head dim 256 (wider than d_model / heads), GeGLU, a tied head."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (28, 3072, 16, 16, 256, 24576,
                                           256000)
    assert cfg.mlp_kind == "geglu" and cfg.embed_scale and cfg.tie_embeddings
    small = M.family_config(get_config, ARCH)
    assert small.n_heads == small.n_kv_heads and small.block_kinds == (
        "attn", "attn")


def test_convert_round_trip(jax_ref, port):
    """A tied head (no ``lm_head``), no learned positions, GeGLU's gate;
    ``init`` builds the same tree."""
    from repro_torch.models import transformer as T
    K, _ = M._helpers()
    cfg, params = port
    tree = K._unflatten(jax_ref, "params")
    assert "lm_head" not in params and "pos_embed" not in params
    np.testing.assert_array_equal(
        params["layers"][1]["mlp"]["gate"]["w"].numpy(),
        tree["scan"][0]["mlp"]["gate"]["w"][1])
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(mine) == set(params)
    assert all(set(a) == set(b) for a, b in zip(mine["layers"],
                                                params["layers"]))


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
