"""The port's Llama-family decoder against the JAX reference, on the CPU.

Yi-6B (RoPE with theta 5e6, RMSNorm, SwiGLU, GQA, untied head) reduced
to 2 layers and d_model 256, with GQA brought back: ``reduced()`` clamps
the KV heads to the query heads (4 and 4), so both sides build the
config as ``replace(yi-6b.reduced(d_model=256), n_heads=8, n_kv_heads=2,
head_dim=32)``, a group of 4.  P = 4 sequence shards, CR 4.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: on a
(1, 4) mesh with the jnp backend the child runs the reference's full
forward, ``make_prefill_step`` / ``make_serve_step`` in the three
prefill/decode pairings (B 2, prompt 32, 4 teacher-forced steps), the
unpaged ``make_chunk_prefill_step`` and ``make_packed_step`` in both
decode modes (``test_torch_ticks.py``'s plans: chunks of 3, ticks of 7,
a 5-token prompt, staggered rows), and the ``ServingEngine`` on
``test_torch_engine.py``'s staggered trace in packed exact and packed
prism, and saves the parameters and every result.  The port must match
them at the tolerances of those files; its layers are held to
``repro.models.layers`` in process.
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
# static serving: prefill 32, 4 decode steps
B, N, STEPS = 2, 32, 4
CAP = N + STEPS + (-(N + STEPS)) % P
PAIRINGS = [("voltage", "exact"), ("prism", "prism"), ("voltage", "prism")]
LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")
# the tick programs: test_torch_ticks.py's shapes and plans
TB, TN, TCAP, TGEN, CHUNK, BUDGET = 4, 32, 40, 4, 3, 7
JOIN = [0, 1, 1, 3]
SHORT = 2
MODES = ("exact", "prism")
# the engine: test_torch_engine.py's staggered trace, packed ticks
ENGINE_MODES = ("exact", "prism")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once, and each would otherwise start a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _helpers():
    """test_torch_ticks.py's pytree flattening and chip_smoke.py loader,
    test_torch_engine.py's ``_drive`` (both processes use them)."""
    sys.path.insert(0, HERE)
    import test_torch_engine as E
    import test_torch_ticks as K
    return K, E


def llama_config(get_config):
    """The test's config from either package's registry."""
    return dataclasses.replace(get_config("yi-6b").reduced(d_model=256),
                               n_heads=8, n_kv_heads=2, head_dim=32)


def _case(pairing):
    return f"{pairing[0]}-{pairing[1]}"


def _serve_inputs(vocab):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, vocab, size=(B, N)).astype(np.int32)
    forced = rng.integers(1, vocab, size=(B, STEPS)).astype(np.int32)
    return prompts, forced


def _tick_inputs(vocab):
    """Prompts (lists of ids; row SHORT has 5 tokens) and the forced
    decode tokens (TB, TGEN - 1)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, vocab, size=5 if i == SHORT else TN).tolist()
               for i in range(TB)]
    forced = rng.integers(1, vocab, size=(TB, TGEN - 1))
    return prompts, forced


def jax_reference(out_path):
    """Child process: the reference on a (1, 4) host mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, init_cache,
                                     make_chunk_prefill_step,
                                     make_packed_step, make_prefill_step,
                                     make_serve_step)
    from repro.serving import EngineConfig, ServingEngine
    K, E = _helpers()
    cs = K._chip_smoke()
    cfg = llama_config(get_config)
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    K._flatten(jax.tree.map(np.asarray, params), "params", out)
    i32 = lambda a: jnp.asarray(a, jnp.int32)                 # noqa: E731

    prompts, forced = _serve_inputs(cfg.vocab_size)
    logits, _ = T.forward(cfg, params, jnp.asarray(
        np.concatenate([prompts, forced], axis=1)))
    out["forward"] = np.asarray(logits)
    for pairing in PAIRINGS:
        case = _case(pairing)
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR, backend="jnp")
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism, batch=B,
                                         n=N, hp=hp, cap=CAP)
        logits, cache = pre(params, {"tokens": jnp.asarray(prompts)})
        out[f"{case}/prefill_logits"] = np.asarray(logits)
        K._flatten(cache["scan"][0], f"{case}/cache_prefill", out)
        step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B, cap=CAP,
                                        prefill_len=N, hp=hp)
        for i in range(STEPS):
            pos = jnp.full((B,), N + i, jnp.int32)
            logits, cache = step(params, cache, jnp.asarray(forced[:, i]),
                                 pos)
            out[f"{case}/step{i}_logits"] = np.asarray(logits)
        K._flatten(cache["scan"][0], f"{case}/cache_final", out)

    prompts, forced = _tick_inputs(cfg.vocab_size)
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp")
        step, lay, _ = make_chunk_prefill_step(
            cfg, mesh, params, batch=TB, cap=TCAP, prefill_len=TN,
            chunk_len=CHUNK, hp=hp)
        cache = init_cache(cfg, lay, TB, hp)
        for i, call in enumerate(cs.plan_chunks(prompts, CHUNK, JOIN)):
            cache = step(params, cache, *map(i32, call))
            K._flatten(cache["scan"][0], f"{mode}/chunk{i}", out)
        step, lay, _, _ = make_packed_step(
            cfg, mesh, params, batch=TB, cap=TCAP, prefill_len=TN,
            token_budget=BUDGET, hp=hp)
        cache = init_cache(cfg, lay, TB, hp)
        for i, t in enumerate(cs.plan_packed(prompts, TGEN, BUDGET,
                                             forced)):
            logits, cache = step(params, cache, *(i32(t[k]) for k in (
                "tok", "slot", "pos", "off", "pre")))
            out[f"{mode}/tick{i}/logits"] = np.asarray(logits)
            K._flatten(cache["scan"][0], f"{mode}/tick{i}", out)

    runs = {}
    for mode in ENGINE_MODES:
        eng = ServingEngine(cfg, mesh, params, EngineConfig(
            hp=ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp"),
            **E._config_kw("stagger", mode, "packed")), clock=lambda: 0.0)
        runs[mode] = E._drive(eng, "stagger", cfg.vocab_size)
    np.savez(out_path, engine=np.array(json.dumps(runs)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_llama") / "ref.npz"
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
    ref["engine"] = json.loads(str(ref["engine"]))
    return ref


@pytest.fixture(scope="module")
def port(jax_ref):
    """The port's config and the reference's weights on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    K, _ = _helpers()
    cfg = llama_config(get_config)
    return cfg, from_jax_numpy(cfg, K._unflatten(jax_ref, "params"),
                               device="cpu")


@pytest.fixture(scope="module")
def serve_runs(port):
    """prefill + 4 teacher-forced serve_steps in every pairing, and the
    plain full forward over prompt + forced tokens."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)
    cfg, params = port
    prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                       for a in _serve_inputs(cfg.vocab_size))
    runs = {}
    for pairing in PAIRINGS:
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR)
        lay = make_layout(P, CAP, hp, prefill_len=N)
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        logits, cache = prefill(cfg, params, prompts, prism, lay, hp)
        run = {"prefill_logits": logits.numpy(),
               "cache_prefill": [{k: t.clone().numpy() for k, t in c.items()}
                                 for c in cache]}
        for i in range(STEPS):
            pos = torch.full((B,), N + i, dtype=torch.long)
            logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                       lay, hp)
            run[f"step{i}_logits"] = logits.numpy()
        run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                              for c in cache]
        runs[_case(pairing)] = run
    runs["full_forward"] = T.forward(
        cfg, params, torch.cat([prompts, forced], dim=1)).numpy()
    runs["lay"] = lay
    return runs


@pytest.fixture(scope="module")
def tick_runs(port):
    """The port's tick programs with the reference's weights and plans,
    every cache leaf after every call."""
    from repro_torch.runtime.serve import ServeHParams, init_cache, make_layout
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    K, _ = _helpers()
    cs = K._chip_smoke()
    cfg, params = port
    prompts, forced = _tick_inputs(cfg.vocab_size)
    runs = {}
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR)
        lay = make_layout(P, TCAP, hp, prefill_len=TN)
        run = {"lay": lay}
        cache = init_cache(cfg, lay, TB, hp, "cpu")
        for i, call in enumerate(cs.plan_chunks(prompts, CHUNK, JOIN)):
            chunk_prefill_step(cfg, params, cache,
                               *map(torch.as_tensor, call), lay, hp)
            run[f"chunk{i}"] = [{k: t.clone().numpy() for k, t in c.items()}
                                for c in cache]
        cache = init_cache(cfg, lay, TB, hp, "cpu")
        for i, t in enumerate(cs.plan_packed(prompts, TGEN, BUDGET, forced)):
            logits, cache = packed_step(
                cfg, params, cache, *(torch.as_tensor(t[k]) for k in (
                    "tok", "slot", "pos", "off", "pre")), lay, hp)
            run[f"tick{i}/logits"] = logits.numpy()
            run[f"tick{i}"] = [{k: t.clone().numpy() for k, t in c.items()}
                               for c in cache]
        runs[mode] = run
    return runs


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _assert_leaves(port_cache, want, prefix, mode, batch, lay):
    """Every leaf of every layer, the reference's (B, cap, ...) K/V viewed
    as the port's (B, P, cap_l, ...)."""
    leaves = LEAVES if mode == "prism" else LEAVES[:2]
    assert set(port_cache[0]) == set(leaves)
    for name in leaves:
        w_all = want[f"{prefix}/{name}"]                      # (layers, ...)
        for layer, c in enumerate(port_cache):
            w = w_all[layer]
            if name in ("k", "v"):
                w = w.reshape(batch, P, lay.cap_l, *w.shape[2:])
            np.testing.assert_allclose(c[name], w, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{prefix} {name} {layer}")


# --------------------------------------------------------------------------
# the layers, in process, against repro.models.layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pos_kind", ["rows", "per_shard", "midpoints"])
def test_rope_matches_reference(pos_kind):
    """Split-half RoPE at theta 5e6 and 1e4: token positions, per-shard
    (P, n) positions, and fractional segment midpoints."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(3)
    x = rng.standard_normal((P, 24, 4, 32)).astype(np.float32)
    pos = {"rows": np.arange(24),
           "per_shard": np.arange(P)[:, None] * 24 + np.arange(24),
           "midpoints": np.arange(24) * 4 + 1.5}[pos_kind]
    for theta in (5e6, 1e4):
        got = TL.rope(torch.as_tensor(x), torch.as_tensor(pos), theta=theta)
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


def test_rmsnorm_matches_reference():
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    got = TL.norm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x),
                  "rmsnorm")
    want = JL.norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), "rmsnorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    assert set(TL.norm_init(64, "rmsnorm", "cpu")) == {"scale"}


def test_swiglu_matches_reference():
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(5)
    m = {name: {"w": (rng.standard_normal(shape) * 0.25).astype(np.float32)}
         for name, shape in (("up", (16, 40)), ("gate", (16, 40)),
                             ("down", (40, 16)))}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    got = TL.mlp({k: {"w": torch.as_tensor(d["w"])} for k, d in m.items()},
                 torch.as_tensor(x), "swiglu")
    want = JL.mlp(m, jnp.asarray(x), "swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    init = TL.mlp_init(torch.Generator().manual_seed(0), 16, 40, "swiglu",
                       device="cpu")
    assert {k: tuple(v["w"].shape) for k, v in init.items()} == {
        "up": (16, 40), "gate": (16, 40), "down": (40, 16)}


# --------------------------------------------------------------------------
# parameters and the full forward
# --------------------------------------------------------------------------

def test_convert_round_trip(jax_ref, port):
    """The untied head comes across as ``lm_head``, and a RoPE model has
    no ``pos_embed``; every leaf is a plain copy; ``init`` builds the
    same tree."""
    from repro_torch.models import transformer as T
    K, _ = _helpers()
    cfg, params = port
    tree = K._unflatten(jax_ref, "params")
    assert "pos_embed" not in tree and "pos_embed" not in params
    np.testing.assert_array_equal(params["lm_head"]["w"].numpy(),
                                  tree["lm_head"]["w"])
    assert params["lm_head"]["w"].shape == (cfg.d_model, cfg.vocab_size)
    np.testing.assert_array_equal(
        params["layers"][1]["mlp"]["gate"]["w"].numpy(),
        tree["scan"][0]["mlp"]["gate"]["w"][1])
    assert set(params["layers"][0]["ln1"]) == {"scale"}
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")

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
    """Every cache leaf after prefill and after the last decode step:
    the RoPE'd keys (the means' at their segment midpoints), values and,
    in prism mode, the means state."""
    case = _case(pairing)
    _assert_leaves(serve_runs[case][f"cache_{stage}"], jax_ref,
                   f"{case}/cache_{stage}", pairing[1], B, serve_runs["lay"])


def test_exact_decode_matches_full_forward(serve_runs):
    """Exact decode, teacher-forced, equals the port's own plain causal
    forward at every step: RoPE at the decode positions agrees with RoPE
    over the whole sequence."""
    run = serve_runs[_case(("voltage", "exact"))]
    full = serve_runs["full_forward"]
    for i in range(-1, STEPS):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = _rel_err(got, full[:, N + i])
        assert err <= 1e-4, (i, err)


# --------------------------------------------------------------------------
# the tick programs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["chunk", "tick"])
@pytest.mark.parametrize("mode", MODES)
def test_tick_caches_match_reference(jax_ref, tick_runs, mode, kind):
    """Every cache leaf after every chunk call (ragged chunks of 3,
    staggered rows, a 5-token prompt) and every packed tick (decode and
    prompt tokens mixed, dead tails)."""
    run = tick_runs[mode]
    n = sum(1 for k in run if k.startswith(kind) and "/" not in k)
    assert n > 10
    for i in range(n):
        _assert_leaves(run[f"{kind}{i}"], jax_ref, f"{mode}/{kind}{i}", mode,
                       TB, run["lay"])


@pytest.mark.parametrize("mode", MODES)
def test_packed_logits_match_reference(jax_ref, tick_runs, mode):
    run = tick_runs[mode]
    n = sum(1 for k in run if k.startswith("tick") and k.endswith("logits"))
    assert n > 10
    for i in range(n):
        got, want = run[f"tick{i}/logits"], jax_ref[f"{mode}/tick{i}/logits"]
        assert got.shape == want.shape
        assert _rel_err(got, want) <= 1e-4, i


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_engine_tokens_match_reference(jax_ref, port, mode):
    """Packed ticks on the paged cache at P = 4: each request's tokens
    and the schedule equal the JAX engine's."""
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    _, E = _helpers()
    cfg, params = port
    eng = ServingEngine(cfg, params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR),
        **E._config_kw("stagger", mode, "packed")), n_seq=P,
        clock=lambda: 0.0)
    got = E._drive(eng, "stagger", cfg.vocab_size)
    want = jax_ref["engine"][mode]
    assert got[0] == want[0]
    assert got[1] == want[1]
    eng.kv_cache.check()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
