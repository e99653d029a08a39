"""The port's Mixture-of-Experts blocks against the JAX reference, on the
CPU.

OLMoE-1B-7B reduced to 2 layers and d_model 256 (``reduced()``: 4
experts, top-2, capacity factor 1.25, expert d_ff 128, 4 heads of 64,
qk-norm, SwiGLU, RMSNorm, RoPE, untied head), P = 4 sequence shards,
CR 4.  At capacity factor 1.25 the runs drop tokens, and the tests
assert that they do.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: on a
(1, 4) mesh with the jnp backend the child runs the reference's full
forward, ``make_prefill_step`` / ``make_serve_step`` in the three
prefill/decode pairings (B 2, prompt 32, 4 teacher-forced steps), the
unpaged chunk and packed programs in both decode modes
(``test_torch_llama.py``'s plans) and the ``ServingEngine`` on
``test_torch_engine.py``'s staggered trace in packed exact, packed prism
and chunked exact, and once in exact mode with a page poisoned before
the first decode tick.  A ``jax.debug.callback`` wrapped around the
reference's ``route`` in the child records every routing decision (the
experts of every token, per sequence shard under ``shard_map``), which
the port's ``RoutingLog`` must equal.

Capacity is counted per routing group: in prefill per sequence shard
(the reference's ``shard_map``), in a decode step, chunk call or packed
tick over all of the call's tokens, in the full forward over all B·N.
So the serving paths are held to the reference's serving paths, and to
the full forward only at a capacity factor at which nothing drops.

In process, against ``repro.models.moe``: ``route``, ``capacity``,
``dispatch_indices`` (ties in expert ids included), ``moe_apply`` with
and without arctic's dense residual MLP, the per-shard grouping of
prefill, and the one place the port departs from the reference on
purpose: a dropped token's combine reads a clamped slot and selects
zero, where the reference multiplies by zero and so picks up another
token's non-finite expert output.

``test_torch_gemma7b.py`` and ``test_torch_command_r.py`` run the same
serving paths for Gemma 7B and Command-R through this file's helpers,
each with a JAX child of its own.
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
ARCH = "olmoe-1b-7b"
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
# the engine: test_torch_engine.py's staggered trace
ENGINE_RUNS = (("packed", "exact"), ("packed", "prism"),
               ("chunked", "exact"))
# a capacity factor at which no group drops a token (each group's
# capacity is at least its token count)
NO_DROP = 8.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _helpers():
    """test_torch_ticks.py's pytree flattening and chip_smoke.py loader,
    test_torch_engine.py's ``_drive``."""
    sys.path.insert(0, HERE)
    import test_torch_engine as E
    import test_torch_ticks as K
    return K, E


# what ``reduced()`` would take from a family, put back: it clamps the
# KV heads to the 4 query heads, and Command-R's GQA is kept at 2
FAMILY_OVERRIDES = {"command-r-35b": dict(n_kv_heads=2)}


def family_config(get_config, arch=ARCH):
    """The test's config from either package's registry."""
    return dataclasses.replace(get_config(arch).reduced(d_model=256),
                               **FAMILY_OVERRIDES.get(arch, {}))


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


def _poison_plan(faults):
    """The poisoned-page run's plan: a page of a decoding slot NaN-filled
    before the first decode tick."""
    return faults.FaultPlan(seed=0,
                            page_poison=faults.FaultSpec(at=(0,)))


# --------------------------------------------------------------------------
# the JAX child
# --------------------------------------------------------------------------

class _Decisions:
    """The child's record of the reference's routing: ``route`` wrapped
    in a ``jax.debug.callback`` that hands each call's experts and its
    sequence shard (-1 outside ``shard_map``) to the host."""

    def __init__(self):
        import jax
        from jax import lax
        from repro.models import moe as M
        self.calls = []
        orig = M.route

        def route(router_p, x_flat, top_k, n_experts):
            probs, idx, aux = orig(router_p, x_flat, top_k, n_experts)
            try:
                shard = lax.axis_index("model")
            except NameError:
                shard = -1
            jax.debug.callback(self._keep, idx, shard)
            return probs, idx, aux
        M.route = route

    def _keep(self, idx, shard):
        self.calls.append((int(shard), np.asarray(idx)))

    def take(self, per_shard: bool):
        """The calls since the last take: (layers, T, k) from one shard
        (every shard routes the same tokens: decode, ticks, the
        forward), or (P, layers, T, k) with ``per_shard`` (prefill)."""
        import jax
        jax.effects_barrier()
        calls, self.calls = self.calls, []
        shards = sorted({s for s, _ in calls})
        by = {s: np.stack([i for t, i in calls if t == s]) for s in shards}
        if per_shard:
            return np.stack([by[s] for s in shards])
        for s in shards[1:]:
            np.testing.assert_array_equal(by[s], by[shards[0]])
        return by[shards[0]]


def jax_reference(out_path, arch=ARCH):
    """Child process: the reference on a (1, 4) host mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime import faults
    from repro.runtime.serve import (ServeHParams, init_cache,
                                     make_chunk_prefill_step,
                                     make_packed_step, make_prefill_step,
                                     make_serve_step)
    from repro.serving import EngineConfig, ServingEngine
    K, E = _helpers()
    cs = K._chip_smoke()
    cfg = family_config(get_config, arch)
    moe = "moe" in cfg.block_kinds
    dec = _Decisions() if moe else None
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    K._flatten(jax.tree.map(np.asarray, params), "params", out)
    i32 = lambda a: jnp.asarray(a, jnp.int32)                 # noqa: E731

    def decisions(key, per_shard=False):
        if moe:
            out[f"dec/{key}"] = dec.take(per_shard)

    prompts, forced = _serve_inputs(cfg.vocab_size)
    logits, _ = T.forward(cfg, params, jnp.asarray(
        np.concatenate([prompts, forced], axis=1)))
    out["forward"] = np.asarray(logits)
    decisions("forward")
    for pairing in PAIRINGS:
        case = _case(pairing)
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR, backend="jnp")
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism, batch=B,
                                         n=N, hp=hp, cap=CAP)
        logits, cache = pre(params, {"tokens": jnp.asarray(prompts)})
        out[f"{case}/prefill_logits"] = np.asarray(logits)
        decisions(f"{case}/prefill", per_shard=True)
        K._flatten(cache["scan"][0], f"{case}/cache_prefill", out)
        step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B, cap=CAP,
                                        prefill_len=N, hp=hp)
        for i in range(STEPS):
            pos = jnp.full((B,), N + i, jnp.int32)
            logits, cache = step(params, cache, jnp.asarray(forced[:, i]),
                                 pos)
            out[f"{case}/step{i}_logits"] = np.asarray(logits)
            decisions(f"{case}/step{i}")
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
            decisions(f"{mode}/chunk{i}")
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
            decisions(f"{mode}/tick{i}")

    runs = {}
    for prefill, mode in ENGINE_RUNS:
        eng = ServingEngine(cfg, mesh, params, EngineConfig(
            hp=ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp"),
            **E._config_kw("stagger", mode, prefill)), clock=lambda: 0.0)
        runs[f"{prefill}/{mode}"] = E._drive(eng, "stagger", cfg.vocab_size)
    if moe:
        eng = ServingEngine(cfg, mesh, params, EngineConfig(
            hp=ServeHParams(decode_mode="exact", means_cr=CR, backend="jnp"),
            faults=_poison_plan(faults),
            **E._config_kw("stagger", "exact", "packed")), clock=lambda: 0.0)
        runs["poisoned"] = list(E._drive(eng, "stagger", cfg.vocab_size)) + [
            {str(r): st.restarts for r, st in eng._results.items()}]
    np.savez(out_path, engine=np.array(json.dumps(runs)), **out)


def run_child(tmp_path_factory, name, arch):
    """Run this file's ``jax_reference`` for ``arch`` in a subprocess with
    four fake host devices; returns its results."""
    out = tmp_path_factory.mktemp(name) / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    here = os.path.join(HERE, "test_torch_moe.py")
    r = subprocess.run([sys.executable, here, "--jax-ref", str(out), arch],
                       env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(out) as z:
        ref = dict(z)
    ref["engine"] = json.loads(str(ref["engine"]))
    return ref


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_child(tmp_path_factory, "jax_moe", ARCH)


# --------------------------------------------------------------------------
# the port's runs
# --------------------------------------------------------------------------

def port_params(jax_ref, arch=ARCH):
    """The port's config and the reference's weights on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    K, _ = _helpers()
    cfg = family_config(get_config, arch)
    return cfg, from_jax_numpy(cfg, K._unflatten(jax_ref, "params"),
                               device="cpu")


@pytest.fixture(scope="module")
def port(jax_ref):
    return port_params(jax_ref)


def _log():
    from repro_torch.models.moe import RoutingLog
    return RoutingLog()


def serve_runs_of(cfg, params):
    """prefill + 4 teacher-forced serve_steps in every pairing, and the
    plain full forward over prompt + forced tokens; with each call's
    routing decisions (``dec/...``: a list of per-layer records)."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)
    prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                       for a in _serve_inputs(cfg.vocab_size))
    runs = {}
    for pairing in PAIRINGS:
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR,
                          routing=_log())
        lay = make_layout(P, CAP, hp, prefill_len=N)
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        logits, cache = prefill(cfg, params, prompts, prism, lay, hp)
        run = {"prefill_logits": logits.numpy(),
               "cache_prefill": [{k: t.clone().numpy() for k, t in c.items()}
                                 for c in cache],
               "dec/prefill": hp.routing.calls}
        for i in range(STEPS):
            hp = dataclasses.replace(hp, routing=_log())
            pos = torch.full((B,), N + i, dtype=torch.long)
            logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                       lay, hp)
            run[f"step{i}_logits"] = logits.numpy()
            run[f"dec/step{i}"] = hp.routing.calls
        run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                              for c in cache]
        runs[_case(pairing)] = run
    log = _log()
    runs["full_forward"] = T.forward(
        cfg, params, torch.cat([prompts, forced], dim=1),
        routing=log).numpy()
    runs["dec/forward"] = log.calls
    runs["lay"] = lay
    return runs


def tick_runs_of(cfg, params):
    """The port's tick programs with the reference's weights and plans,
    every cache leaf and the routing decisions after every call."""
    from repro_torch.runtime.serve import ServeHParams, init_cache, make_layout
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    K, _ = _helpers()
    cs = K._chip_smoke()
    prompts, forced = _tick_inputs(cfg.vocab_size)
    runs = {}
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR)
        lay = make_layout(P, TCAP, hp, prefill_len=TN)
        run = {"lay": lay}
        cache = init_cache(cfg, lay, TB, hp, "cpu")
        for i, call in enumerate(cs.plan_chunks(prompts, CHUNK, JOIN)):
            hp = dataclasses.replace(hp, routing=_log())
            chunk_prefill_step(cfg, params, cache,
                               *map(torch.as_tensor, call), lay, hp)
            run[f"chunk{i}"] = [{k: t.clone().numpy() for k, t in c.items()}
                                for c in cache]
            run[f"dec/chunk{i}"] = hp.routing.calls
        cache = init_cache(cfg, lay, TB, hp, "cpu")
        for i, t in enumerate(cs.plan_packed(prompts, TGEN, BUDGET, forced)):
            hp = dataclasses.replace(hp, routing=_log())
            logits, cache = packed_step(
                cfg, params, cache, *(torch.as_tensor(t[k]) for k in (
                    "tok", "slot", "pos", "off", "pre")), lay, hp)
            run[f"tick{i}/logits"] = logits.numpy()
            run[f"tick{i}"] = [{k: t.clone().numpy() for k, t in c.items()}
                               for c in cache]
            run[f"dec/tick{i}"] = hp.routing.calls
        runs[mode] = run
    return runs


@pytest.fixture(scope="module")
def serve_runs(port):
    return serve_runs_of(*port)


@pytest.fixture(scope="module")
def tick_runs(port):
    return tick_runs_of(*port)


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def assert_leaves(port_cache, want, prefix, mode, batch, lay,
                  atol_rel=0.0):
    """Every leaf of every layer, the reference's (B, cap, ...) K/V viewed
    as the port's (B, P, cap_l, ...).  ``atol_rel`` > 0 widens the
    absolute tolerance of a leaf to that share of its largest |value|
    where that is above 1e-5: f32 sums of large rows that cancel are
    exact only to their summands' scale."""
    leaves = LEAVES if mode == "prism" else LEAVES[:2]
    assert set(port_cache[0]) == set(leaves)
    for name in leaves:
        w_all = want[f"{prefix}/{name}"]                      # (layers, ...)
        for layer, c in enumerate(port_cache):
            w = w_all[layer]
            if name in ("k", "v"):
                w = w.reshape(batch, P, lay.cap_l, *w.shape[2:])
            atol = max(1e-5, atol_rel * float(np.abs(w).max()))
            np.testing.assert_allclose(c[name], w, atol=atol, rtol=1e-4,
                                       err_msg=f"{prefix} {name} {layer}")


def engine_run(cfg, params, prefill, mode, faults=None):
    """The staggered trace through the port's engine at P = 4; returns
    ``_drive``'s tokens and schedule, and the engine."""
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    _, E = _helpers()
    eng = ServingEngine(cfg, params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR), faults=faults,
        **E._config_kw("stagger", mode, prefill)), n_seq=P,
        clock=lambda: 0.0)
    return E._drive(eng, "stagger", cfg.vocab_size), eng


# --------------------------------------------------------------------------
# the MoE functions, in process, against repro.models.moe
# --------------------------------------------------------------------------

def _skewed(shape, seed):
    """Inputs that share most of one direction, so the router sends most
    tokens to the same experts and capacity drops some."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape[-1]) + 0.5 * rng.standard_normal(
        shape)).astype(np.float32)


def _moe_params(arch, seed=0):
    """A reduced config's MoE leaves from the reference's ``moe_init``:
    numpy for JAX, tensors for the port."""
    import jax
    from repro.configs import get_config
    from repro.models import moe as JM
    cfg = family_config(get_config, arch)
    p = JM.moe_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.n_experts,
                    cfg.expert_d_ff, cfg.mlp_kind,
                    dense_d_ff=cfg.moe_dense_d_ff)
    p = jax.tree.map(np.asarray, p)
    return cfg, p, jax.tree.map(torch.as_tensor, p)


@pytest.mark.parametrize("t,e,k", [(24, 4, 2), (40, 64, 8), (5, 8, 8)])
def test_route_matches_reference(t, e, k):
    """Softmax over all E, the top-k of the probabilities (not
    renormalised), the Switch aux loss; a leading group axis routes each
    group alone."""
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro_torch.models import moe as TM
    rng = np.random.default_rng(t + e)
    w = rng.standard_normal((32, e)).astype(np.float32)
    x = rng.standard_normal((3, t, 32)).astype(np.float32)
    probs, idx, aux = TM.route({"w": torch.as_tensor(w)}, torch.as_tensor(x),
                               k, e)
    for g in range(3):
        wp, wi, wa = JM.route({"w": jnp.asarray(w)}, jnp.asarray(x[g]), k, e)
        np.testing.assert_array_equal(idx[g].numpy(), np.asarray(wi))
        np.testing.assert_allclose(probs[g].numpy(), np.asarray(wp),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(float(aux[g]), float(wa), rtol=1e-5)


@pytest.mark.parametrize("t,k,e,f", [(4096, 8, 64, 1.25), (8, 8, 64, 1.25),
                                     (72, 8, 64, 1.25), (16, 2, 4, 1.25),
                                     (1, 2, 4, 1.25), (11, 2, 4, 8.0),
                                     (0, 2, 4, 1.25)])
def test_capacity_matches_reference(t, k, e, f):
    from repro.models import moe as JM
    from repro_torch.models import moe as TM
    assert TM.capacity(t, k, e, f) == JM.capacity(t, k, e, f)


@pytest.mark.parametrize("case", ["random", "ties", "one_expert",
                                  "all_kept"])
def test_dispatch_indices_match_reference(case):
    """Slots in token order per expert (a stable sort), drops past
    ``cap``: random ids, runs of equal ids, every assignment to one
    expert, and a capacity no expert reaches."""
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro_torch.models import moe as TM
    rng = np.random.default_rng(7)
    e, cap = 6, 3
    idx = {"random": rng.integers(0, e, size=(20, 2)),
           "ties": np.repeat(rng.integers(0, e, size=(5, 1)), 4,
                             axis=0).reshape(10, 2),
           "one_expert": np.full((9, 1), 4),
           "all_kept": np.stack([np.arange(6), (np.arange(6) + 1) % 6], 1),
           }[case].astype(np.int32)
    got = TM.dispatch_indices(torch.as_tensor(idx, dtype=torch.long), e, cap)
    want = JM.dispatch_indices(jnp.asarray(idx), e, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2].numpy()
    assert keep.all() if case == "all_kept" else not keep.all()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_apply_matches_reference(arch):
    """The whole block at capacity factor 1.25 on one group (tokens
    dropped), with arctic's dense residual MLP; the batched expert
    product reads the same stacked leaves."""
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro.models.context import FullContext as JFull
    from repro_torch.models import moe as TM
    from repro_torch.models.context import FullContext
    cfg, pj, pt = _moe_params(arch)
    assert ("dense_mlp" in pt) == (arch == "arctic-480b")
    x = _skewed((2, 24, cfg.d_model), 2)
    log = TM.RoutingLog()
    y, aux = TM.moe_apply(pt, torch.as_tensor(x), cfg, FullContext(),
                          routing=log, aux=True)
    wy, wa = JM.moe_apply(pj, jnp.asarray(x), cfg, JFull())
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux[0]), float(wa), rtol=1e-5)
    assert not bool(TM.record_keep(log.calls[0]).all())    # drops happen


def test_prefill_routes_each_shard_alone():
    """The sharded prefill's groups: shard p routes its B·n_loc tokens at
    their own capacity, as the reference's ``moe_apply`` over that
    shard's (B, n_loc) block does under ``shard_map``; one group over
    all B·N tokens gives another answer."""
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro.models.context import FullContext as JFull
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import moe as TM
    from repro_torch.models.context import FullContext
    from repro_torch.sharding.context import ShardedPrismContext
    cfg, pj, pt = _moe_params(ARCH, seed=1)
    b, n_loc = 2, 8
    x = _skewed((b * P, n_loc, cfg.d_model), 4)
    ctx = ShardedPrismContext(PrismConfig(P=P, cr=CR), n_shards=P)
    y, _ = TM.moe_apply(pt, torch.as_tensor(x), cfg, ctx)
    xs = x.reshape(b, P, n_loc, -1)
    for p in range(P):
        wy, _ = JM.moe_apply(pj, jnp.asarray(xs[:, p]), cfg, JFull())
        np.testing.assert_allclose(y.numpy().reshape(b, P, n_loc, -1)[:, p],
                                   np.asarray(wy), atol=1e-5, rtol=1e-4)
    one, _ = TM.moe_apply(pt, torch.as_tensor(x), cfg, FullContext())
    assert np.abs(one.numpy() - y.numpy()).max() > 1e-3


def test_dropped_token_does_not_take_a_nonfinite_row():
    """The departure (``src/repro/models/moe.py:100``): a dropped token's
    gather ``y_buf[flat_e, slot]`` with ``slot >= cap`` reads the
    expert's last slot (JAX clamps it), and ``NaN · 0`` is NaN.  Scale
    the token in that last slot until its expert output overflows (its
    routing is scale-free): in the reference the dropped tokens of that
    expert turn non-finite, in the port only the overflowing token does;
    every other token agrees."""
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro.models.context import FullContext as JFull
    from repro_torch.models import moe as TM
    from repro_torch.models.context import FullContext
    cfg, pj, pt = _moe_params(ARCH)
    t = 24
    x = _skewed((1, t, cfg.d_model), 2)
    _, idx, _ = JM.route(pj["router"], jnp.asarray(x[0]), cfg.top_k,
                         cfg.n_experts)
    cap = JM.capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    flat_e, slot, keep, token = (np.asarray(a) for a in JM.dispatch_indices(
        idx, cfg.n_experts, cap))
    e = int(flat_e[~keep][0])                        # an expert that drops
    last = int(token[(flat_e == e) & (slot == cap - 1)][0])
    dropped = sorted(set(token[(flat_e == e) & ~keep].tolist()))
    x[0, last] *= 1e20
    wy = np.asarray(JM.moe_apply(pj, jnp.asarray(x), cfg, JFull())[0])[0]
    y = TM.moe_apply(pt, torch.as_tensor(x), cfg, FullContext())[0][0]
    y = y.numpy()
    assert not np.isfinite(wy[last]).all() and not np.isfinite(y[last]).all()
    for tok in dropped:
        assert not np.isfinite(wy[tok]).all()            # the reference
        assert np.isfinite(y[tok]).all()                 # the port
    rest = [i for i in range(t) if i != last and i not in dropped]
    np.testing.assert_allclose(y[rest], wy[rest], atol=1e-5, rtol=1e-4)


def test_routing_log_replays_decisions():
    """The checks' replay: a log recorded on one input makes a second
    call take its experts (and so its drops), keeping its own beside."""
    from repro_torch.models import moe as TM
    from repro_torch.models.context import FullContext
    cfg, _, pt = _moe_params(ARCH)
    rng = np.random.default_rng(5)
    x1, x2 = (torch.as_tensor(rng.standard_normal(
        (1, 24, cfg.d_model)).astype(np.float32)) for _ in range(2))
    rec = TM.RoutingLog()
    TM.moe_apply(pt, x1, cfg, FullContext(), routing=rec)
    rep = TM.RoutingLog(replay=rec)
    TM.moe_apply(pt, x2, cfg, FullContext(), routing=rep)
    c = rep.calls[0]
    assert torch.equal(c["idx"], rec.calls[0]["idx"])
    assert torch.equal(TM.record_keep(c), TM.record_keep(rec.calls[0]))
    own = TM.RoutingLog()
    y_own, _ = TM.moe_apply(pt, x2, cfg, FullContext(), routing=own)
    assert torch.equal(c["own_idx"], own.calls[0]["idx"])
    assert torch.equal(TM.record_keep(c, own=True),
                       TM.record_keep(own.calls[0]))
    assert not torch.equal(c["own_idx"], c["idx"])
    assert torch.equal(TM.record_margin(c), TM.record_margin(own.calls[0]))
    # recording changes nothing
    y, _ = TM.moe_apply(pt, x2, cfg, FullContext())
    assert torch.equal(y, y_own)
    with pytest.raises(ValueError, match="routed"):
        TM.moe_apply(pt, x2[:, :5], cfg, FullContext(),
                     routing=TM.RoutingLog(replay=rec))


def test_decode_tp_is_refused():
    """decode_tp takes a mesh whose model axis is over 1 (the fold's
    layout refuses it); over MoE blocks (expert-TP) it takes an expert
    d_ff that splits over ``data``, else the decode-TP rule would cut
    ``down/w`` across d_model (reduced arctic's 87 on 2 data ranks, where
    the reference fails); OLMoE's 1,024 serves."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import (ServeHParams, check_mesh_serving,
                                           make_layout)
    hp = ServeHParams(decode_tp=True)
    with pytest.raises(NotImplementedError, match="model axis"):
        make_layout(4, 64, hp, prefill_len=32)
    with pytest.raises(NotImplementedError, match="model axis"):
        check_mesh_serving(get_config("gpt2-small"), hp,
                           {"data": 4, "model": 1})
    with pytest.raises(NotImplementedError, match="down/w across d_model"):
        check_mesh_serving(get_config("arctic-480b").reduced(d_model=128),
                           hp, {"data": 2, "model": 2})
    check_mesh_serving(get_config("olmoe-1b-7b"), hp,
                       {"data": 2, "model": 2})


# --------------------------------------------------------------------------
# parameters, the full forward and the routing decisions
# --------------------------------------------------------------------------

def test_convert_round_trip(jax_ref, port):
    """The vmapped expert leaves (n_units, E, ...) come across slice by
    slice, with the router; ``init`` builds the same tree."""
    from repro_torch.models import transformer as T
    K, _ = _helpers()
    cfg, params = port
    tree = K._unflatten(jax_ref, "params")
    for layer in range(cfg.n_layers):
        for name in ("up", "gate", "down"):
            np.testing.assert_array_equal(
                params["layers"][layer]["moe"]["experts"][name]["w"].numpy(),
                tree["scan"][0]["moe"]["experts"][name]["w"][layer])
        np.testing.assert_array_equal(
            params["layers"][layer]["moe"]["router"]["w"].numpy(),
            tree["scan"][0]["moe"]["router"]["w"][layer])
    assert params["layers"][0]["moe"]["experts"]["up"]["w"].shape == (
        cfg.n_experts, cfg.d_model, cfg.expert_d_ff)
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(mine) == shapes(params)


def test_forward_matches_reference(jax_ref, serve_runs):
    err = rel_err(serve_runs["full_forward"], jax_ref["forward"])
    assert err <= 1e-5, err


def _decision_pairs(jax_ref, serve_runs, tick_runs):
    """(name, port records, the reference's (layers, ...) or (P, layers,
    ...) experts) of every routed call the child recorded."""
    yield "forward", serve_runs["dec/forward"], jax_ref["dec/forward"]
    for pairing in PAIRINGS:
        case = _case(pairing)
        run = serve_runs[case]
        yield (f"{case}/prefill", run["dec/prefill"],
               jax_ref[f"dec/{case}/prefill"].swapaxes(0, 1))
        for i in range(STEPS):
            yield (f"{case}/step{i}", run[f"dec/step{i}"],
                   jax_ref[f"dec/{case}/step{i}"])
    for mode in MODES:
        for key in tick_runs[mode]:
            if key.startswith("dec/"):
                yield (f"{mode}/{key[4:]}", tick_runs[mode][key],
                       jax_ref[f"dec/{mode}/{key[4:]}"])


def test_routing_decisions_match_reference(jax_ref, serve_runs, tick_runs):
    """Every token's experts equal the reference's, in every layer of
    every call (per sequence shard in prefill); the calls at capacity
    factor 1.25 drop tokens.  Prints the smallest router margin (the gap
    between a token's k-th and (k+1)-th router logits)."""
    from repro_torch.models import moe as TM
    n_calls, dropped, margin = 0, 0, np.inf
    for name, recs, want in _decision_pairs(jax_ref, serve_runs, tick_runs):
        assert len(recs) == want.shape[0], name
        for layer, rec in enumerate(recs):
            got = rec["idx"].numpy()
            w = want[layer]
            got = got if w.ndim == 3 else got[0]
            np.testing.assert_array_equal(got, w, err_msg=f"{name} {layer}")
            dropped += int((~TM.record_keep(rec)).sum())
            margin = min(margin, float(TM.record_margin(rec).min()))
            n_calls += 1
    print(f"{n_calls} routed calls equal; {dropped} assignments dropped; "
          f"smallest router margin {margin:.3e}")
    assert dropped > 0


@pytest.mark.parametrize("path", ["prefill", "chunk", "tick"])
def test_serving_paths_drop_tokens(serve_runs, tick_runs, path):
    """Capacity factor 1.25 drops assignments on the prefill (per
    shard), chunk and packed paths (a decode step of B = 2 tokens over 4
    experts cannot: capacity 2)."""
    from repro_torch.models import moe as TM
    if path == "prefill":
        recs = [r for pairing in PAIRINGS
                for r in serve_runs[_case(pairing)]["dec/prefill"]]
        assert recs[0]["idx"].shape[0] == P            # one group a shard
    else:
        recs = [r for mode in MODES for k, v in tick_runs[mode].items()
                if k.startswith(f"dec/{path}") for r in v]
    assert sum(int((~TM.record_keep(r)).sum()) for r in recs) > 0


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
        err = rel_err(run[key], jax_ref[f"{case}/{key}"])
        assert err <= 1e-4, (key, err)


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_cache_leaves_match_reference(jax_ref, serve_runs, pairing, stage):
    case = _case(pairing)
    assert_leaves(serve_runs[case][f"cache_{stage}"], jax_ref,
                  f"{case}/cache_{stage}", pairing[1], B, serve_runs["lay"])


def test_exact_decode_matches_full_forward_where_nothing_drops(port):
    """At capacity factor 8 no group drops a token, so routing in groups
    of a shard, of a step or of the whole sequence agree: exact decode,
    teacher-forced, equals the plain full forward.  At 1.25 the prefill's
    shards drop and the two part."""
    cfg, params = port
    wide = dataclasses.replace(cfg, capacity_factor=NO_DROP)
    runs = serve_runs_of(wide, params)
    run = runs[_case(("voltage", "exact"))]
    recs = run["dec/prefill"] + [r for i in range(STEPS)
                                 for r in run[f"dec/step{i}"]]
    from repro_torch.models import moe as TM
    assert all(bool(TM.record_keep(r).all())
               for r in recs + runs["dec/forward"])
    full = runs["full_forward"]
    for i in range(-1, STEPS):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = rel_err(got, full[:, N + i])
        assert err <= 1e-4, (i, err)


# --------------------------------------------------------------------------
# the tick programs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["chunk", "tick"])
@pytest.mark.parametrize("mode", MODES)
def test_tick_caches_match_reference(jax_ref, tick_runs, mode, kind):
    """Every cache leaf after every chunk call (B·C tokens one routing
    group) and every packed tick (all T entries one group, dead ones
    included)."""
    run = tick_runs[mode]
    n = sum(1 for k in run if k.startswith(kind) and "/" not in k)
    assert n > 10
    for i in range(n):
        assert_leaves(run[f"{kind}{i}"], jax_ref, f"{mode}/{kind}{i}", mode,
                      TB, run["lay"])


@pytest.mark.parametrize("mode", MODES)
def test_packed_logits_match_reference(jax_ref, tick_runs, mode):
    run = tick_runs[mode]
    n = sum(1 for k in run if k.startswith("tick") and k.endswith("logits"))
    assert n > 10
    for i in range(n):
        got, want = run[f"tick{i}/logits"], jax_ref[f"{mode}/tick{i}/logits"]
        assert got.shape == want.shape
        assert rel_err(got, want) <= 1e-4, i


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", ENGINE_RUNS, ids=lambda r: "-".join(r))
def test_engine_tokens_match_reference(jax_ref, port, run):
    """The paged engine at P = 4: each request's tokens and the schedule
    equal the JAX engine's."""
    got, eng = engine_run(*port, *run)
    want = jax_ref["engine"]["/".join(run)]
    assert got[0] == want[0]
    assert got[1] == want[1]
    eng.kv_cache.check()


def test_poisoned_page_engine_holds_the_ports_rule(jax_ref, port):
    """Exact mode with a page NaN-filled before the first decode tick.  A
    packed tick routes its tokens as one group, so the poisoned token
    (NaN router probabilities, which ``torch.topk`` and
    ``jax.lax.top_k`` rank differently) takes capacity from its
    neighbours, and a restart moves every later group: neither engine
    gives the clean run's tokens, and the two engines part on the
    requests either restarts.  The reference also restarts a neighbour
    the poison never touched: a dropped token's clamped gather takes
    the poisoned row (``NaN · 0``).  The port's rule: it restarts the
    poisoned request alone; every request neither engine restarts has
    the reference's tokens; a request only the reference restarts keeps
    its clean tokens in the port; no request fails."""
    from repro_torch.runtime import faults
    got, eng = engine_run(*port, "packed", "exact",
                          faults=_poison_plan(faults))
    toks, _, ref_restarts = jax_ref["engine"]["poisoned"]
    clean = jax_ref["engine"]["packed/exact"][0]
    mine = {str(r): st.restarts for r, st in eng._results.items()}
    s = eng.stats.summary()
    assert (s["quarantined"], s["restarts"]) == (1, 1) and not eng.failed()
    assert sorted(got[0]) == sorted(toks) and all(
        len(t) == 8 for t in got[0].values())
    poisoned = [r for r, n in mine.items() if n]
    spread = [r for r, n in ref_restarts.items() if n and not mine[r]]
    assert len(poisoned) == 1 and ref_restarts[poisoned[0]] == 1
    assert spread                      # the reference's clamped gather
    for rid in got[0]:
        if not mine[rid] and not ref_restarts[rid]:
            assert got[0][rid] == toks[rid], rid
    for rid in spread:
        assert got[0][rid] == clean[rid], rid
    eng.kv_cache.check()


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2], sys.argv[3])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz ARCH")
