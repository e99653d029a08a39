"""The port's engine ticks (chunked prefill, packed ticks) against the JAX
reference, on the CPU.

GPT-2 small reduced (2 layers, d_model 256, 4 heads of 64), 4 slots,
prefill length 32 with one short prompt of 5 tokens, cap 40, P = 4
sequence shards, CR 4, both decode modes.  A module fixture runs this
file as a subprocess (``--jax-ref OUT.npz``) with four fake host devices
set in the child's environment only: the child runs the reference's
unpaged ``make_chunk_prefill_step`` (chunk_len 3, which does not divide
32, rows admitted at different calls) and ``make_packed_step`` (token
budget 7: ragged and dead tails, decode and prompt tokens in one tick,
teacher-forced decode tokens) on a (1, 4) mesh with the jnp backend, and
saves the parameters, every cache leaf after every call and the packed
logits.  The tick plans come from ``chip_smoke.py``'s planners, which
both processes load.  The port must match them; the in-process tests
hold its pieces to the JAX functions they replace.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
B, N, CAP, P, CR, GEN = 4, 32, 40, 4, 4.0, 4
CHUNK, BUDGET = 3, 7
JOIN = [0, 1, 1, 3]                  # the call at which each row joins
SHORT = 2                            # the row with a 5-token prompt
MODES = ("exact", "prism")
LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(vocab):
    """Prompts (lists of ids; row SHORT has 5 tokens) and the forced
    decode tokens (B, GEN - 1)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, size=5 if i == SHORT else N).tolist()
               for i in range(B)]
    forced = rng.integers(1, vocab, size=(B, GEN - 1))
    return prompts, forced


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat, prefix):
    root = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def jax_reference(out_path):
    """Child process: the reference's tick programs on a (1, 4) mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, init_cache,
                                     make_chunk_prefill_step,
                                     make_packed_step)

    cs = _chip_smoke()
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    prompts, forced = _inputs(cfg.vocab_size)
    out = {}
    _flatten(jax.tree.map(np.asarray, params), "params", out)
    i32 = lambda a: jnp.asarray(a, jnp.int32)                 # noqa: E731
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp")
        step, lay, _ = make_chunk_prefill_step(
            cfg, mesh, params, batch=B, cap=CAP, prefill_len=N,
            chunk_len=CHUNK, hp=hp)
        cache = init_cache(cfg, lay, B, hp)
        for i, call in enumerate(cs.plan_chunks(prompts, CHUNK, JOIN)):
            cache = step(params, cache, *map(i32, call))
            _flatten(cache["scan"][0], f"{mode}/chunk{i}", out)
        step, lay, _, _ = make_packed_step(
            cfg, mesh, params, batch=B, cap=CAP, prefill_len=N,
            token_budget=BUDGET, hp=hp)
        cache = init_cache(cfg, lay, B, hp)
        for i, t in enumerate(cs.plan_packed(prompts, GEN, BUDGET, forced)):
            logits, cache = step(params, cache, *(i32(t[k]) for k in (
                "tok", "slot", "pos", "off", "pre")))
            out[f"{mode}/tick{i}/logits"] = np.asarray(logits)
            _flatten(cache["scan"][0], f"{mode}/tick{i}", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ticks") / "ref.npz"
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


def _setup(mode, params_np=None):
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import ServeHParams, make_layout
    cfg = get_config("gpt2-small").reduced()
    params = (from_jax_numpy(cfg, params_np, device="cpu")
              if params_np is not None
              else T.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    hp = ServeHParams(decode_mode=mode, means_cr=CR)
    return cfg, params, hp, make_layout(P, CAP, hp, prefill_len=N)


@pytest.fixture(scope="module")
def port_runs(jax_ref):
    """The port's tick programs on the CPU with the reference's weights,
    the same plans, every cache leaf after every call."""
    from repro_torch.runtime.serve import init_cache
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    cs = _chip_smoke()
    params_np = _unflatten(jax_ref, "params")
    runs = {}
    for mode in MODES:
        cfg, params, hp, lay = _setup(mode, params_np)
        prompts, forced = _inputs(cfg.vocab_size)
        run = {"lay": lay}
        cache = init_cache(cfg, lay, B, hp, "cpu")
        for i, call in enumerate(cs.plan_chunks(prompts, CHUNK, JOIN)):
            chunk_prefill_step(cfg, params, cache,
                               *map(torch.as_tensor, call), lay, hp)
            run[f"chunk{i}"] = [{k: t.clone().numpy() for k, t in c.items()}
                                for c in cache]
        cache = init_cache(cfg, lay, B, hp, "cpu")
        for i, t in enumerate(cs.plan_packed(prompts, GEN, BUDGET, forced)):
            logits, cache = packed_step(
                cfg, params, cache, *(torch.as_tensor(t[k]) for k in (
                    "tok", "slot", "pos", "off", "pre")), lay, hp)
            run[f"tick{i}/logits"] = logits.numpy()
            run[f"tick{i}"] = [{k: t.clone().numpy() for k, t in c.items()}
                               for c in cache]
        runs[mode] = run
    return runs


def _assert_leaves(port, want, prefix, mode, lay):
    leaves = LEAVES if mode == "prism" else LEAVES[:2]
    assert set(port[0]) == set(leaves)
    for name in leaves:
        w_all = want[f"{prefix}/{name}"]                      # (layers, ...)
        for layer, c in enumerate(port):
            w = w_all[layer]
            if name in ("k", "v"):
                w = w.reshape(B, P, lay.cap_l, *w.shape[2:])
            np.testing.assert_allclose(c[name], w, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{prefix} {name} {layer}")


def _n_calls(run, kind):
    return sum(1 for k in run if k.startswith(kind) and "/" not in k)


@pytest.mark.parametrize("mode", MODES)
def test_chunk_cache_matches_reference(jax_ref, port_runs, mode):
    """Every cache leaf after every chunk call: ragged chunks of 3 over
    a 32-token prompt, rows at different offsets, a short prompt."""
    run = port_runs[mode]
    n = _n_calls(run, "chunk")
    assert n == 14
    for i in range(n):
        _assert_leaves(run[f"chunk{i}"], jax_ref, f"{mode}/chunk{i}", mode,
                       run["lay"])


@pytest.mark.parametrize("mode", MODES)
def test_packed_cache_matches_reference(jax_ref, port_runs, mode):
    """Every cache leaf after every packed tick: ragged and dead tails,
    decode and prompt tokens mixed."""
    run = port_runs[mode]
    n = _n_calls(run, "tick")
    assert n > 10
    for i in range(n):
        _assert_leaves(run[f"tick{i}"], jax_ref, f"{mode}/tick{i}", mode,
                       run["lay"])


@pytest.mark.parametrize("mode", MODES)
def test_packed_logits_match_reference(jax_ref, port_runs, mode):
    """The LM head's min(B, T) rows of every tick, 1e-4 relative."""
    run = port_runs[mode]
    for i in range(_n_calls(run, "tick")):
        got, want = run[f"tick{i}/logits"], jax_ref[f"{mode}/tick{i}/logits"]
        assert got.shape == want.shape == (B, 512)
        err = np.abs(got - want).max() / max(1e-6, np.abs(want).max())
        assert err <= 1e-4, (i, err)


@pytest.mark.parametrize("kind", ["chunk", "tick"])
def test_short_prompt_means_count_real_columns(port_runs, kind):
    """After the last call the short prompt's repeat counts are its real
    columns per segment (5 tokens on shard 0), and its zsum holds nothing
    past them."""
    from repro_torch.core.segment_means import segment_fill_counts
    from repro_torch.sharding.context import means_columns
    run = port_runs["prism"]
    last = run[f"{kind}{_n_calls(run, kind) - 1}"]
    lay = run["lay"]
    cols = means_columns(P, lay.n_loc0, lay.L, torch.device("cpu"))
    want = segment_fill_counts(cols.lo, cols.hi, torch.tensor(5)).numpy()
    assert want.sum() == 5
    for c in last:
        np.testing.assert_array_equal(c["gz"][SHORT], want)
        dead = want == 0
        assert np.all(c["zsum"][SHORT][dead] == 0)
        full = np.delete(np.arange(B), SHORT)
        np.testing.assert_array_equal(c["gz"][full], cols.sizes.numpy()[
            None].repeat(B - 1, 0))


# --------------------------------------------------------------------------
# the pieces, in process, against the JAX functions they replace
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_loc,L", [(8, 2), (10, 3), (7, 7)])
def test_segment_fill_counts_matches_reference(n_loc, L):
    import jax.numpy as jnp
    from repro.core.segment_means import segment_fill_counts as jfill
    from repro_torch.core.segment_means import segment_fill_counts
    from repro_torch.sharding.context import means_columns
    cols = means_columns(P, n_loc, L, torch.device("cpu"))
    filled = np.array([[0, 1, 5, n_loc], [n_loc * P, 3 * n_loc - 1, 17, 2]])
    got = segment_fill_counts(cols.lo, cols.hi, torch.as_tensor(filled))
    want = jfill(cols.lo.numpy(), cols.hi.numpy(), jnp.asarray(filled))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("n_loc,L", [(8, 2), (10, 3)])
def test_prism_gz_matches_reference_rule(n_loc, L):
    """The means' visibility rule of ``serve.py::prism_gz`` against the
    reference's, shard by shard (its ``_means_meta`` grid, a shard's own
    means masked, a mean visible once [lo, lo + count) is past): filled
    and partly filled segments, dead (-1) and early positions."""
    from types import SimpleNamespace
    from repro.runtime import serve as JS
    from repro_torch.core.segment_means import segment_fill_counts
    from repro_torch.runtime.serve import prism_gz
    from repro_torch.sharding.context import means_columns
    cols = means_columns(P, n_loc, L, torch.device("cpu"))
    lo, _, _, _, shard_of = JS._means_meta(
        SimpleNamespace(n_loc0=n_loc, L=L, n_seq=P))
    filled = torch.as_tensor([P * n_loc, 5, 2 * n_loc + 1, P * n_loc, 0])
    cnt = segment_fill_counts(cols.lo, cols.hi, filled)          # (B, m)
    pos = torch.as_tensor([P * n_loc + 3, 4, 2 * n_loc, n_loc - 1, -1])
    got = prism_gz(cols, cnt, pos)
    want = np.stack([np.where((shard_of[None, :] != s)
                              & (lo[None, :] + cnt.numpy()
                                 <= pos.numpy()[:, None] + 1),
                              cnt.numpy(), 0.0) for s in range(P)], axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    full = prism_gz(cols, cols.sizes, pos)           # the static prefill's
    assert full.shape == (5, P, P * L)
    assert (full[-1] == 0).all() and (full[0].sum(-1) > 0).all()


@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2)])
def test_chunk_softmax_stats_matches_reference(hq, hkv):
    """Per-query causal bias with dead queries and dead columns."""
    import jax.numpy as jnp
    from repro.kernels import decode_attention as JD
    from repro_torch.kernels.decode_attention import chunk_softmax_stats
    rng = np.random.default_rng(hq)
    b, c, hd = 2, 5, 16
    q = rng.standard_normal((b, c, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, c, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, c, hkv, hd)).astype(np.float32)
    alive = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    vis = (np.tril(np.ones((c, c), bool))[None] & alive[:, :, None]
           & alive[:, None, :])
    bias = np.where(vis, 0.0, -1e30).astype(np.float32)
    got = chunk_softmax_stats(*map(torch.as_tensor, (q, k, v, bias)), 0.25)
    want = JD.chunk_softmax_stats(*map(jnp.asarray, (q, k, v, bias)), 0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("nq", [1, 5])
def test_combine_exact_matches_reference(nq):
    """The port's combine over the shard axis, Nq queries, one shard with
    no valid column: the reference's associative merge of the shards'
    stats, then its ``_combine_exact`` normalisation."""
    import jax.numpy as jnp
    from repro.kernels import decode_attention as JD
    from repro.runtime import serve as JS
    from repro_torch.runtime.serve import _combine_exact
    rng = np.random.default_rng(nq)
    b, p, hq, hd = 2, 4, 3, 8
    m = rng.standard_normal((b, p, hq, nq)).astype(np.float32)
    l = rng.uniform(0.5, 3, (b, p, hq, nq)).astype(np.float32)
    acc = rng.standard_normal((b, p, nq, hq, hd)).astype(np.float32)
    m[:, 2], l[:, 2], acc[:, 2] = -1e30, 0.0, 0.0         # a dead shard
    got = _combine_exact(*map(torch.as_tensor, (m, l, acc)))
    stats = [(jnp.asarray(m[:, s, ..., None]), jnp.asarray(l[:, s, ..., None]),
              jnp.asarray(acc[:, s])) for s in range(p)]
    merged = stats[0]
    for s in stats[1:]:
        merged = JD.merge_stats(merged, s)
    want = JS._combine_exact(*merged, ())
    assert got.shape == (b, nq, hq, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("rep,kind", [(1, "repeats"), (4, "repeats"),
                                      (4, "clamped"), (2, "equal")])
def test_decode_rows_equal_explicit_gather(rep, kind):
    """``decode_stats_reference`` with a row map equals the reference's
    plain stats over an explicit per-token gather (out-of-range rows
    clamped), with and without means columns."""
    import jax.numpy as jnp
    from repro.kernels import decode_attention as JD
    from repro_torch.kernels.decode_attention import decode_stats_reference
    rng = np.random.default_rng(rep)
    t, n_rows, m_loc, mz, hq, hkv, hd = 7, 3, 11, 5, 4, 2, 16
    q = rng.standard_normal((t, 1, hq, hd)).astype(np.float32)
    k = rng.standard_normal((n_rows * rep, m_loc, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_rows * rep, m_loc, hkv, hd)).astype(np.float32)
    kz = rng.standard_normal((n_rows, mz, hkv, hd)).astype(np.float32)
    vz = rng.standard_normal((n_rows, mz, hkv, hd)).astype(np.float32)
    valid = rng.random((t * rep, m_loc)) < 0.6
    valid[0] = False
    log_gz = np.where(rng.random((t * rep, mz)) < 0.5, 0.7,
                      -1e30).astype(np.float32)
    rows = rng.integers(0, n_rows, t)
    if kind == "equal":
        rows[:] = rows[0]
    elif kind == "clamped":
        rows[::3], rows[1::3] = -1, n_rows + 1
    sel = np.clip(rows, 0, n_rows - 1)
    shard_rows = (sel[:, None] * rep + np.arange(rep)).reshape(-1)
    T_ = torch.as_tensor
    for means in (False, True):
        extra = (log_gz, kz, vz) if means else ()
        got = decode_stats_reference(
            T_(q), T_(k), T_(v), T_(valid), *map(T_, extra), scale=0.25,
            rows=T_(rows).to(torch.int32))
        jx = (jnp.asarray(log_gz), jnp.asarray(kz[sel].repeat(rep, 0)),
              jnp.asarray(vz[sel].repeat(rep, 0))) if means else ()
        want = JD.decode_stats_reference(
            jnp.asarray(q.repeat(rep, 0)), jnp.asarray(k[shard_rows]),
            jnp.asarray(v[shard_rows]), jnp.asarray(valid), *jx, scale=0.25)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-5)


def test_pack_and_merge_match_reference():
    """First-maximum ties, a non-finite row, dead and prompt rows, and
    the double-buffer splice, against the reference's jitted pair."""
    import jax.numpy as jnp
    from repro.runtime.serve import make_result_pack
    from repro_torch.runtime.ticks import merge, pack
    s, v = 5, 9
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, v)).astype(np.float32)
    logits[0, [2, 6]] = 9.0                   # a tie: the first wins
    logits[2, 4] = np.inf
    logits[3, 1] = np.nan
    row_slot = np.array([3, 0, 1, -1], np.int32)
    is_decode = np.array([1, 1, 1, 0], np.int32)
    lengths = np.array([7, 3, 0, 12, 5], np.int32)
    jpack, jmerge = make_result_pack(s)
    got = pack(*map(torch.as_tensor, (logits, row_slot, is_decode,
                                      lengths)))
    want = np.asarray(jpack(*map(jnp.asarray, (logits, row_slot, is_decode,
                                               lengths))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got[3, 0] == 2 and got[1, 3] == 0
    tok_host = np.array([11, 12, 13, 14, 15, 16], np.int32)
    src = np.array([3, -1, 0, 4, -1, 1], np.int32)
    got_m = merge(torch.as_tensor(tok_host), torch.as_tensor(src), got)
    want_m = jmerge(jnp.asarray(tok_host), jnp.asarray(src),
                    jnp.asarray(want))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("mode", MODES)
def test_packed_identical_prompts_stay_isolated(mode):
    """Two requests with identical prompts packed into one tick (and a
    third, different one sharing the ticks) each generate what they
    generate alone: no softmax stats leak between their tokens."""
    from repro_torch.runtime.serve import make_layout
    cs = _chip_smoke()
    cfg, params, hp, _ = _setup(mode)
    lay = make_layout(P, 24, hp, prefill_len=8)
    prompt, other = [7, 19, 3, 42, 11, 23], [5, 50, 2]
    kw = dict(gen=6, lay=lay, hp=hp, budget=9, device="cpu")
    ticks = cs.plan_packed([prompt, prompt, other], 6, 9)
    assert any({0, 1} <= set(t["slot"][t["pre"] == 1]) for t in ticks)
    tokens, logits, _, _ = cs.run_packed(cfg, params,
                                         [prompt, prompt, other], **kw)
    for i, p in enumerate((prompt, prompt, other)):
        solo, solo_logits, _, _ = cs.run_packed(cfg, params, [p], **kw)
        np.testing.assert_array_equal(tokens[i].numpy(), solo[0].numpy())
        np.testing.assert_allclose(logits[:, i].numpy(),
                                   solo_logits[:, 0].numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_packed_and_chunked_paths_agree(mode):
    """``chip_smoke.py``'s tick paths at a small size: chunked prefill
    (staggered rows, the rewind, greedy decode) matches the monolithic
    Voltage prefill's cache and, with the same decode steps, its logits;
    the packed path (greedy through pack / merge) matches the chunked
    path's tokens and logits."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime.serve import generate, prefill
    cs = _chip_smoke()
    cfg, params, hp, lay = _setup(mode)
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, N)).tolist()
    kw = dict(gen=GEN, lay=lay, hp=hp, device="cpu")
    tokens, logits, snap, info = cs.run_chunked(
        cfg, params, prompts, chunk_len=CHUNK, join=JOIN, **kw)
    assert info["calls"] == 14
    voltage = PrismConfig(P=P, cr=CR, mode="voltage")
    _, ref_cache = prefill(cfg, params, torch.as_tensor(prompts), voltage,
                           lay, hp)
    for a, b in zip(snap, ref_cache):
        assert set(a) == set(b)
        for name in b:
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                       atol=1e-5, rtol=1e-4)
    if mode == "exact":
        _, ref, _ = generate(cfg, params, torch.as_tensor(prompts), gen=GEN,
                             prism=voltage, lay=lay, hp=hp,
                             forced=tokens[:, :-1])
    else:
        ref = cs.rewind_decode(cfg, params, ref_cache, prompts,
                               forced=tokens[:, :-1], **kw)
    assert cs.rel_err(logits, ref) <= 1e-4
    p_tokens, p_logits, _, p_info = cs.run_packed(cfg, params, prompts,
                                                  budget=BUDGET, **kw)
    assert p_info["mixed_tick"] is not None
    np.testing.assert_array_equal(p_tokens.numpy(), tokens.numpy())
    assert cs.rel_err(p_logits, logits) <= 1e-4


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
