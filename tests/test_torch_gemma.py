"""The port's Gemma 3 decoder against the JAX reference, on the CPU.

Gemma 3 1B (sliding-window local layers beside global ones, a RoPE
theta for each kind, qk-norm, GeGLU, MQA, sqrt(d) input scaling, tied
head) reduced to 2 layers and d_model 256: one ``attn_local`` and one
``attn`` layer, 4 query heads over 1 KV head of 64.  ``reduced()`` keeps
a window of 16, which the reference's window prefill refuses at 8 rows a
shard (each shard must hold a window), so both sides build the config as
``replace(gemma3-1b.reduced(d_model=256), window=8)``.  P = 4 sequence
shards, CR 4, B 2, prompt 32, cache capacity 40, 8 teacher-forced decode
steps: the 8-slot ring wraps completely.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: on a
(1, 4) mesh with the jnp backend the child runs the reference's full
forward, ``make_prefill_step(cap=40)`` / ``make_serve_step`` in the three
prefill/decode pairings, the exact pairing again at capacity 36, the
window augment under ``shard_map``, and records the refusals of its
chunked-prefill and packed programs.  The port must match the forward,
the logits and every cache leaf at the tolerances of
``test_torch_serve.py``; its layers are held to ``repro.models.layers``
in process.

Capacity 36 (not a multiple of the window apart from the prompt
length): the reference's prefill places the ring by ``cap - W``
(``src/repro/runtime/serve.py:1260``), right only when cap = prompt
length mod W, and its decode there is wrong; the port places by the
prompt length and stays exact.  ``test_ring_placement_caveat`` shows
both.
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
P, CR = 4, 4.0
B, N, STEPS, W = 2, 32, 8, 8
CAP = 40                         # = N mod W: the reference is right here
CAP_SKEW, STEPS_SKEW = 36, 4     # != N mod W: the reference's ring caveat
PAIRINGS = [("voltage", "exact"), ("prism", "prism"), ("voltage", "prism")]
GLOBAL_LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ticks():
    """test_torch_ticks.py's pytree flattening (both processes)."""
    sys.path.insert(0, HERE)
    import test_torch_ticks as K
    return K


def gemma_config(get_config):
    """The test's config from either package's registry."""
    return dataclasses.replace(get_config("gemma3-1b").reduced(d_model=256),
                               window=W)


def _case(pairing):
    return f"{pairing[0]}-{pairing[1]}"


def _serve_inputs(vocab):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, vocab, size=(B, N)).astype(np.int32)
    forced = rng.integers(1, vocab, size=(B, STEPS)).astype(np.int32)
    return prompts, forced


def _augment_input(d):
    return np.random.default_rng(1).standard_normal(
        (B, N, d)).astype(np.float32)


def jax_reference(out_path):
    """Child process: the reference on a (1, 4) host mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from repro.compat import shard_map
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, make_chunk_prefill_step,
                                     make_packed_step, make_prefill_step,
                                     make_serve_step)
    from repro.sharding.context import ShardedPrismContext
    K = _ticks()
    cfg = gemma_config(get_config)
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    K._flatten(jax.tree.map(np.asarray, params), "params", out)

    prompts, forced = _serve_inputs(cfg.vocab_size)
    logits, _ = T.forward(cfg, params, jnp.asarray(
        np.concatenate([prompts, forced], axis=1)))
    out["forward"] = np.asarray(logits)
    runs = [(_case(p), p, CAP, STEPS) for p in PAIRINGS]
    runs.append(("skew", PAIRINGS[0], CAP_SKEW, STEPS_SKEW))
    for case, pairing, cap, steps in runs:
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR, backend="jnp")
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism, batch=B,
                                         n=N, hp=hp, cap=cap)
        logits, cache = pre(params, {"tokens": jnp.asarray(prompts)})
        out[f"{case}/prefill_logits"] = np.asarray(logits)
        K._flatten(cache["scan"], f"{case}/cache_prefill", out)
        step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B, cap=cap,
                                        prefill_len=N, hp=hp)
        for i in range(steps):
            pos = jnp.full((B,), N + i, jnp.int32)
            logits, cache = step(params, cache, jnp.asarray(forced[:, i]),
                                 pos)
            out[f"{case}/step{i}_logits"] = np.asarray(logits)
        K._flatten(cache["scan"], f"{case}/cache_final", out)

    # the window augment of a local layer, per shard
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="voltage"),
                              axis="model", n_shards=P)
    spec = T.attn_spec(cfg, "attn_local")

    def body(x):
        _, akv = ctx.augment(x, spec)
        return akv.x_hat, akv.col_pos[None], akv.mask[None]
    aug = shard_map(body, mesh=mesh, in_specs=PS(None, "model"),
                    out_specs=(PS(None, "model"), PS("model"), PS("model")),
                    check_vma=False)
    x_hat, col_pos, mask = jax.jit(aug)(jnp.asarray(
        _augment_input(cfg.d_model)))
    out["augment/x_hat"] = np.asarray(x_hat)
    out["augment/col_pos"] = np.asarray(col_pos)
    out["augment/mask"] = np.asarray(mask)

    refusals = {}
    hp = ServeHParams(backend="jnp")
    for name, make in (
            ("chunk", lambda: make_chunk_prefill_step(
                cfg, mesh, params, batch=B, cap=CAP, prefill_len=N,
                chunk_len=4, hp=hp)),
            ("packed", lambda: make_packed_step(
                cfg, mesh, params, batch=B, cap=CAP, prefill_len=N,
                token_budget=6, hp=hp))):
        try:
            make()
        except ValueError as e:
            refusals[name] = str(e)
    np.savez(out_path, refusals=np.array(json.dumps(refusals)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_gemma") / "ref.npz"
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
    ref["refusals"] = json.loads(str(ref["refusals"]))
    return ref


@pytest.fixture(scope="module")
def port(jax_ref):
    """The port's config and the reference's weights on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    cfg = gemma_config(get_config)
    return cfg, from_jax_numpy(cfg, _ticks()._unflatten(jax_ref, "params"),
                               device="cpu")


def _serve(cfg, params, pairing, cap, steps):
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)
    prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                       for a in _serve_inputs(cfg.vocab_size))
    hp = ServeHParams(decode_mode=pairing[1], means_cr=CR)
    lay = make_layout(P, cap, hp, prefill_len=N)
    prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
    logits, cache = prefill(cfg, params, prompts, prism, lay, hp)
    run = {"prefill_logits": logits.numpy(), "lay": lay,
           "cache_prefill": [{k: t.clone().numpy() for k, t in c.items()}
                             for c in cache]}
    for i in range(steps):
        pos = torch.full((B,), N + i, dtype=torch.long)
        logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                   lay, hp)
        run[f"step{i}_logits"] = logits.numpy()
    run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                          for c in cache]
    return run


@pytest.fixture(scope="module")
def serve_runs(port):
    """prefill + 8 teacher-forced serve_steps in every pairing at CAP,
    the exact pairing at CAP_SKEW, and the plain full forward over
    prompt + forced tokens."""
    from repro_torch.models import transformer as T
    cfg, params = port
    runs = {_case(p): _serve(cfg, params, p, CAP, STEPS) for p in PAIRINGS}
    runs["skew"] = _serve(cfg, params, PAIRINGS[0], CAP_SKEW, STEPS_SKEW)
    prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                       for a in _serve_inputs(cfg.vocab_size))
    runs["full_forward"] = T.forward(
        cfg, params, torch.cat([prompts, forced], dim=1)).numpy()
    return runs


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _assert_leaves(port_cache, want, prefix, mode, lay):
    """Layer 0 (local): the ring k, v (B, W, Hkv, hd); layer 1 (global):
    every leaf, the reference's (B, cap, ...) K/V viewed as the port's
    (B, P, cap_l, ...).  The reference stores unit position j of its
    one scanned unit as ``scan/j`` with a leading axis of 1."""
    assert set(port_cache[0]) == {"k", "v"}
    leaves = GLOBAL_LEAVES if mode == "prism" else GLOBAL_LEAVES[:2]
    assert set(port_cache[1]) == set(leaves)
    for layer, names in ((0, ("k", "v")), (1, leaves)):
        for name in names:
            w = want[f"{prefix}/{layer}/{name}"][0]
            if layer == 1 and name in ("k", "v"):
                w = w.reshape(B, P, lay.cap_l, *w.shape[2:])
            np.testing.assert_allclose(port_cache[layer][name], w,
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"{prefix} {name} {layer}")


# --------------------------------------------------------------------------
# the layers, in process, against repro.models.layers / transformer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["attn", "attn_local"])
def test_qk_norm_projections_match_reference(kind):
    """q and k RMSNormed over the head dim before RoPE, at the kind's
    theta (1e6 global, 1e4 local), per-shard (P, n) positions."""
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro_torch.configs import get_config
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as TT
    spec = TT.attn_spec(gemma_config(get_config), kind)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        JT.attn_spec(gemma_config(jax_config), kind))
    assert spec.qk_norm and spec.n_kv_heads == 1
    rng = np.random.default_rng(6)
    d, hq, hkv = spec.d_model, spec.n_heads * spec.head_dim, spec.head_dim
    p = {"wq": {"w": rng.standard_normal((d, hq)) * d ** -0.5},
         "wk": {"w": rng.standard_normal((d, hkv)) * d ** -0.5},
         "wv": {"w": rng.standard_normal((d, hkv)) * d ** -0.5},
         "qnorm": {"scale": 1 + 0.1 * rng.standard_normal(spec.head_dim)},
         "knorm": {"scale": 1 + 0.1 * rng.standard_normal(spec.head_dim)}}
    p = {k: {n: a.astype(np.float32) for n, a in v.items()}
         for k, v in p.items()}
    x = rng.standard_normal((P, 6, d)).astype(np.float32)
    pos = np.arange(P)[:, None] * 6 + np.arange(6)
    tp = {k: {n: torch.as_tensor(a) for n, a in v.items()}
          for k, v in p.items()}
    jp = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in p.items()}
    got_q = TL.attn_project_q(tp, spec, torch.as_tensor(x),
                              torch.as_tensor(pos))
    want_q = JL.attn_project_q(jp, spec, jnp.asarray(x), jnp.asarray(pos))
    got_k, got_v = TL.attn_project_kv(tp, spec, torch.as_tensor(x),
                                      torch.as_tensor(pos))
    want_k, want_v = JL.attn_project_kv(jp, spec, jnp.asarray(x),
                                        jnp.asarray(pos))
    for got, want in ((got_q, want_q), (got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    init = TL.attn_init(torch.Generator().manual_seed(0), spec, "cpu")
    assert tuple(init["qnorm"]["scale"].shape) == (spec.head_dim,)
    assert set(init) == {"wq", "wk", "wv", "wo", "qnorm", "knorm"}


def test_geglu_matches_reference():
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(7)
    m = {name: {"w": (rng.standard_normal(shape) * 0.25).astype(np.float32)}
         for name, shape in (("up", (16, 40)), ("gate", (16, 40)),
                             ("down", (40, 16)))}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    got = TL.mlp({k: {"w": torch.as_tensor(d["w"])} for k, d in m.items()},
                 torch.as_tensor(x), "geglu")
    want = JL.mlp(m, jnp.asarray(x), "geglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    init = TL.mlp_init(torch.Generator().manual_seed(0), 16, 40, "geglu",
                       device="cpu")
    assert set(init) == {"up", "gate", "down"}


def test_embed_scale_matches_reference():
    """Token embeddings times sqrt(d_model), rounded to the activations'
    dtype, in the prefill embedding and the decode one alike."""
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.runtime.serve import embed_tokens
    cfg = gemma_config(get_config)
    assert cfg.embed_scale
    rng = np.random.default_rng(8)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7))
    got = TT.embed_inputs(cfg, {"embed": {"table": torch.as_tensor(table)}},
                          torch.as_tensor(tokens))
    want = JT.embed_inputs(gemma_config(jax_config),
                           {"embed": {"table": jnp.asarray(table)}},
                           jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    dec = embed_tokens(cfg, {"embed": {"table": torch.as_tensor(table)}},
                       torch.as_tensor(tokens), torch.as_tensor(tokens))
    np.testing.assert_array_equal(dec.numpy(), got.numpy())


def test_convert_round_trip_over_scan_and_tail():
    """Fourteen layers of Gemma 3's pattern (five local, a global, five
    local, a global, two local) are stored as two scanned units of 6 and
    a tail of 2, as the full model's 26 are four units and a tail of 2:
    every layer, its qnorm / knorm included, comes across as a plain copy
    in layer order, and ``init`` builds the same tree."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.models import transformer as TT

    def small(get):
        full = get("gemma3-1b")
        return dataclasses.replace(full.reduced(d_model=64, vocab=64),
                                   n_layers=14, blocks=full.blocks[:14],
                                   window=8)
    cfg = small(get_config)
    assert cfg.scan_split == (6, 2, 2)
    assert get_config("gemma3-1b").scan_split == (6, 4, 2)
    tree = jax.tree.map(np.asarray,
                        JT.init(small(jax_config), jax.random.PRNGKey(1)))
    params = from_jax_numpy(cfg, tree, device="cpu")
    assert len(params["layers"]) == 14

    def leaf(i, *path):
        """Layer i's leaf in the reference's tree."""
        node = tree["scan"][i % 6] if i < 12 else tree["tail"][i - 12]
        for key in path:
            node = node[key]
        return node[i // 6] if i < 12 else node
    for i, layer in enumerate(params["layers"]):
        for path in (("attn", "qnorm", "scale"), ("attn", "knorm", "scale"),
                     ("attn", "wq", "w"), ("mlp", "gate", "w")):
            got = layer
            for key in path:
                got = got[key]
            np.testing.assert_array_equal(got.numpy(), leaf(i, *path),
                                          err_msg=f"{i} {path}")
    assert "lm_head" not in params                       # tied head
    mine = TT.init(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(mine) == shapes(params)


def test_forward_matches_reference(jax_ref, serve_runs):
    err = _rel_err(serve_runs["full_forward"], jax_ref["forward"])
    assert err <= 1e-5, err


# --------------------------------------------------------------------------
# the window augment
# --------------------------------------------------------------------------

def test_window_augment_matches_reference(jax_ref, port):
    """Each shard's x_hat is the previous shard's rows (zeros before
    shard 0), then its own; its RoPE positions are max(col, 0); g is 0
    exactly on the halo columns before position 0, and with the window
    applied from the positions it reproduces the reference's mask."""
    from repro_torch.core.masks import visibility
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models.transformer import attn_spec
    from repro_torch.sharding.context import ShardedPrismContext
    cfg, _ = port
    spec = attn_spec(cfg, "attn_local")
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="voltage"),
                              n_shards=P, backend="plain")
    n_loc = N // P
    x = torch.as_tensor(_augment_input(cfg.d_model)).reshape(
        B * P, n_loc, cfg.d_model)
    xq, akv = ctx.augment(x, spec)
    assert xq is x and ctx.window_hops(W, n_loc) == 1
    m = 2 * n_loc
    want = jax_ref["augment/x_hat"].reshape(B, P, m, cfg.d_model)
    np.testing.assert_array_equal(akv.x_hat.numpy(),
                                  want.reshape(B * P, m, cfg.d_model))
    np.testing.assert_array_equal(akv.col_pos.numpy(),
                                  jax_ref["augment/col_pos"])
    assert akv.col_lo.shape == akv.g.shape == (P, m)
    assert (akv.g.numpy() == (akv.col_lo.numpy() >= 0)).all()
    assert akv.g[0, :n_loc].sum() == 0 and akv.g[1:].min() == 1
    vis = visibility(akv.row_pos, akv.col_lo, akv.col_hi, causal=True,
                     window=spec.window) & (akv.g > 0)[:, None, :]
    np.testing.assert_array_equal(vis.numpy(), jax_ref["augment/mask"])


# --------------------------------------------------------------------------
# static serving: prefill + decode in every pairing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_prefill_and_decode_logits_match_reference(jax_ref, serve_runs,
                                                   pairing):
    case = _case(pairing)
    run = serve_runs[case]
    for key in ["prefill_logits"] + [f"step{i}_logits"
                                     for i in range(STEPS)]:
        err = _rel_err(run[key], jax_ref[f"{case}/{key}"])
        assert err <= 1e-4, (key, err)


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_cache_leaves_match_reference(jax_ref, serve_runs, pairing, stage):
    """The local layer's ring and every leaf of the global layer after
    prefill and after the last decode step (the ring wrapped once)."""
    case = _case(pairing)
    _assert_leaves(serve_runs[case][f"cache_{stage}"], jax_ref,
                   f"{case}/cache_{stage}", pairing[1],
                   serve_runs[case]["lay"])


@pytest.mark.parametrize("cap,steps", [(CAP, STEPS),
                                       (CAP_SKEW, STEPS_SKEW)])
def test_exact_decode_matches_full_forward(serve_runs, cap, steps):
    """Exact decode, teacher-forced, equals the port's own plain causal
    forward at every step, the ring wrapping, at both capacities."""
    run = serve_runs[_case(PAIRINGS[0]) if cap == CAP else "skew"]
    full = serve_runs["full_forward"]
    for i in range(-1, steps):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = _rel_err(got, full[:, N + i])
        assert err <= 1e-4, (i, err)


def test_ring_placement_caveat(jax_ref, serve_runs):
    """At capacity 36 (36 mod 8 = 4, the prompt 32 mod 8 = 0) the
    reference's prefill puts the ring's positions 4 slots off, and its
    decode leaves the full forward by far more than the tolerance; the
    port's stays within it.  The prefill logits do not read the ring."""
    full = serve_runs["full_forward"]
    assert _rel_err(jax_ref["skew/prefill_logits"], full[:, N - 1]) <= 1e-4
    ref_err = max(_rel_err(jax_ref[f"skew/step{i}_logits"], full[:, N + i])
                  for i in range(STEPS_SKEW))
    port_err = max(_rel_err(serve_runs["skew"][f"step{i}_logits"],
                            full[:, N + i]) for i in range(STEPS_SKEW))
    assert port_err <= 1e-4 < 100 * 1e-4 < ref_err, (port_err, ref_err)


# --------------------------------------------------------------------------
# the paths that refuse the kind, as the reference's do
# --------------------------------------------------------------------------

def test_tick_programs_refuse_local_layers(jax_ref, port):
    """The chunked-prefill and packed programs refuse a sliding-window
    layer with the reference's words; the paged cache refuses its
    ring."""
    from repro_torch.runtime.paging import make_paged_layout
    from repro_torch.runtime.serve import (ServeHParams, init_cache,
                                           layer_cache_shape, make_layout)
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    cfg, params = port
    hp = ServeHParams()
    lay = make_layout(P, CAP, hp, prefill_len=N)
    cache = init_cache(cfg, lay, B, hp, "cpu")
    assert cache[0]["k"].shape == (B, W, 1, cfg.hd)
    z = torch.zeros(B, dtype=torch.long)
    with pytest.raises(ValueError) as chunk:
        chunk_prefill_step(cfg, params, cache, torch.zeros(B, 4,
                                                           dtype=torch.long),
                           z, z, lay, hp)
    with pytest.raises(ValueError) as packed:
        packed_step(cfg, params, cache, *(torch.zeros(6, dtype=torch.long)
                                          for _ in range(5)), lay, hp)
    assert str(chunk.value) == jax_ref["refusals"]["chunk"]
    assert str(packed.value) == jax_ref["refusals"]["packed"]
    paging = make_paged_layout(lay, page_tokens=8, n_pages=None,
                               n_slots=B)
    with pytest.raises(ValueError, match="attn_local"):
        layer_cache_shape(cfg, lay, B, hp, paging, kind="attn_local")


def test_engine_refuses_local_layers(port):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params = port
    with pytest.raises(ValueError, match="attn_local.*queue 3"):
        ServingEngine(cfg, params, EngineConfig(
            n_slots=B, prefill_len=N, max_cache=CAP, hp=ServeHParams()),
            n_seq=P)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
