"""The port's paged KV cache against the JAX reference, on the CPU.

Host bookkeeping: the same operation sequences go through the port's and
the reference's ``PageTable`` / ``PrefixCache`` / ``KVCache`` (the cases
of ``tests/test_paging.py``) and must give the same page ids, refcounts
and admission plans.

Paged programs: GPT-2 small reduced (2 layers, d_model 256, 4 heads of
64), 4 slots, prefill length 32 with one 5-token prompt, cap 40, P = 4
sequence shards, CR 4, pages of 2 columns a shard (ppr 5) in a pool of
24 pages mapped by a seeded permutation with unmapped tail pages, and a
permuted state map over 5 state rows; both decode modes (exact stores
round-robin, ``'rr'``; prism keeps ``'aligned'``).  A module fixture
runs this file as a subprocess (``--jax-ref OUT.npz``) with four fake
host devices set in the child's environment only: the child runs the
reference's ``make_chunk_prefill_step`` (chunks of 3, rows joining at
different calls), then ``make_serve_step`` (the rewind and 3
teacher-forced steps), and ``make_packed_step`` (budget 7) with
``paging=`` on a (1, 4) mesh with the jnp backend, and saves every pool
leaf after every call and the logits.  The port must match them.

The kernel's plain version: with a page table it equals the dense plain
version on explicitly gathered rows, and pool pages that no row maps
(NaN-filled) never reach its result.
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
PAGE_TOKENS, N_PAGES, N_STATE = 8, 24, 5
MODES = ("exact", "prism")
LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once, and each would otherwise start a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    return _load("chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))


def _ticks():
    return _load("test_torch_ticks", os.path.join(HERE, "test_torch_ticks.py"))


def _maps():
    """The page map (B, ppr): each row's pages drawn from a seeded
    permutation of the pool, the short row's tail unmapped and one more
    row's last page too; the state map (B,), a permutation of 4 of the 5
    state rows."""
    ppr = CAP // P // (PAGE_TOKENS // P)
    perm = np.random.default_rng(4).permutation(N_PAGES).astype(np.int32)
    pm = perm[:B * ppr].reshape(B, ppr).copy()
    pm[SHORT, 3:] = -1
    pm[0, -1] = -1
    sm = np.array([3, 0, 4, 1], np.int32)
    return pm, sm


def jax_reference(out_path):
    """Child process: the reference's paged programs on a (1, 4) mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.runtime.paging import PagedLayout
    from repro.runtime.serve import (ServeHParams, init_cache,
                                     make_chunk_prefill_step,
                                     make_packed_step, make_serve_step)

    cs, tk = _chip_smoke(), _ticks()
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    prompts, forced = tk._inputs(cfg.vocab_size)
    pm, sm = _maps()
    paging = PagedLayout(page_cols=PAGE_TOKENS // P, n_seq=P,
                         pages_per_row=pm.shape[1], n_pages=N_PAGES,
                         n_state_pages=N_STATE)
    maps = (jnp.asarray(pm), jnp.asarray(sm))
    out = {}
    tk._flatten(jax.tree.map(np.asarray, params), "params", out)
    i32 = lambda a: jnp.asarray(a, jnp.int32)                 # noqa: E731
    kw = dict(batch=B, cap=CAP, prefill_len=N, paging=paging)
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp")
        step, lay, _ = make_chunk_prefill_step(cfg, mesh, params,
                                               chunk_len=CHUNK, hp=hp, **kw)
        cache = init_cache(cfg, lay, B, hp, paging=paging)
        for i, call in enumerate(cs.plan_chunks(prompts, CHUNK, JOIN)):
            cache = step(params, cache, *map(i32, call), *maps)
            tk._flatten(cache["scan"][0], f"{mode}/chunk{i}", out)
        dec, _, _, _ = make_serve_step(cfg, mesh, params, hp=hp, **kw)
        tok = i32([p[-1] for p in prompts])
        pos = i32([len(p) - 1 for p in prompts])
        for k in range(GEN):
            logits, cache = dec(params, cache, tok, pos + k, *maps)
            out[f"{mode}/decode{k}/logits"] = np.asarray(logits)
            tk._flatten(cache["scan"][0], f"{mode}/decode{k}", out)
            if k + 1 < GEN:
                tok = i32(forced[:, k])
        step, lay, _, _ = make_packed_step(cfg, mesh, params,
                                           token_budget=BUDGET, hp=hp, **kw)
        cache = init_cache(cfg, lay, B, hp, paging=paging)
        for i, t in enumerate(cs.plan_packed(prompts, GEN, BUDGET, forced)):
            logits, cache = step(params, cache, *(i32(t[k]) for k in (
                "tok", "slot", "pos", "off", "pre")), *maps)
            out[f"{mode}/tick{i}/logits"] = np.asarray(logits)
            tk._flatten(cache["scan"][0], f"{mode}/tick{i}", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_paging") / "ref.npz"
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


@pytest.fixture(scope="module")
def port_runs(jax_ref):
    """The port's paged programs on the CPU with the reference's weights,
    the same plans and maps: every pool leaf after every call."""
    from repro_torch.runtime.paging import PagedLayout
    from repro_torch.runtime.serve import (init_cache, make_layout,
                                           paged_placement, serve_step)
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    cs, tk = _chip_smoke(), _ticks()
    params_np = tk._unflatten(jax_ref, "params")
    pm, sm = _maps()
    paging = PagedLayout(page_cols=PAGE_TOKENS // P, n_seq=P,
                         pages_per_row=pm.shape[1], n_pages=N_PAGES,
                         n_state_pages=N_STATE)
    maps = (torch.as_tensor(pm), torch.as_tensor(sm))

    def snap(cache):
        return [{k: t.clone().numpy() for k, t in c.items()} for c in cache]
    runs = {}
    for mode in MODES:
        cfg, params, hp, _ = tk._setup(mode, params_np)
        lay = make_layout(P, CAP, hp, prefill_len=N,
                          placement=paged_placement(hp, paging))
        prompts, forced = tk._inputs(cfg.vocab_size)
        run = {"lay": lay}
        cache = init_cache(cfg, lay, B, hp, "cpu", paging)
        for i, call in enumerate(cs.plan_chunks(prompts, CHUNK, JOIN)):
            chunk_prefill_step(cfg, params, cache,
                               *map(torch.as_tensor, call), lay, hp, *maps)
            run[f"chunk{i}"] = snap(cache)
        tok = torch.as_tensor([p[-1] for p in prompts])
        pos = torch.as_tensor([len(p) - 1 for p in prompts])
        for k in range(GEN):
            logits, cache = serve_step(cfg, params, cache, tok, pos + k,
                                       lay, hp, *maps)
            run[f"decode{k}/logits"] = logits.numpy()
            run[f"decode{k}"] = snap(cache)
            if k + 1 < GEN:
                tok = torch.as_tensor(forced[:, k])
        cache = init_cache(cfg, lay, B, hp, "cpu", paging)
        for i, t in enumerate(cs.plan_packed(prompts, GEN, BUDGET, forced)):
            logits, cache = packed_step(
                cfg, params, cache, *(torch.as_tensor(t[k]) for k in (
                    "tok", "slot", "pos", "off", "pre")), lay, hp, *maps)
            run[f"tick{i}/logits"] = logits.numpy()
            run[f"tick{i}"] = snap(cache)
        runs[mode] = run
    return runs


def _assert_leaves(port, want, prefix, mode):
    leaves = LEAVES if mode == "prism" else LEAVES[:2]
    assert set(port[0]) == set(leaves)
    for name in leaves:
        w_all = want[f"{prefix}/{name}"]                      # (layers, ...)
        for layer, c in enumerate(port):
            w = w_all[layer]
            got = c[name]
            if name in ("k", "v"):                # (n_pages, P·pc, ...)
                w = w.reshape(N_PAGES, P, PAGE_TOKENS // P, *w.shape[2:])
            else:                                 # the port's sink row
                assert got.shape[0] == N_STATE + 1
                got = got[:N_STATE]
            np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{prefix} {name} {layer}")


def _n_calls(run, kind):
    return sum(1 for k in run if k.startswith(kind) and "/" not in k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["chunk", "decode", "tick"])
def test_paged_pools_match_reference(jax_ref, port_runs, mode, kind):
    """Every pool leaf (and, prism, state-pool leaf) after every chunk
    call, decode step and packed tick."""
    run = port_runs[mode]
    n = _n_calls(run, kind)
    assert n == {"chunk": 14, "decode": GEN}.get(kind, n) and n >= GEN
    for i in range(n):
        _assert_leaves(run[f"{kind}{i}"], jax_ref, f"{mode}/{kind}{i}", mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["decode", "tick"])
def test_paged_logits_match_reference(jax_ref, port_runs, mode, kind):
    """The logits of every decode step and packed tick, 1e-4 of the
    largest |logit|."""
    run = port_runs[mode]
    for i in range(_n_calls(run, kind)):
        got = run[f"{kind}{i}/logits"]
        want = jax_ref[f"{mode}/{kind}{i}/logits"]
        assert got.shape == want.shape == (B, 512)
        err = np.abs(got - want).max() / max(1e-6, np.abs(want).max())
        assert err <= 1e-4, (kind, i, err)


def test_unmapped_pages_stay_zero(port_runs):
    """Writes to an unmapped page are dropped: the pool pages no row maps
    are still zero after every program."""
    pm, _ = _maps()
    unused = sorted(set(range(N_PAGES)) - set(pm[pm >= 0].tolist()))
    assert len(unused) == N_PAGES - int((pm >= 0).sum())
    for mode in MODES:
        run = port_runs[mode]
        for key in (f"chunk{_n_calls(run, 'chunk') - 1}",
                    f"decode{GEN - 1}", f"tick{_n_calls(run, 'tick') - 1}"):
            for c in run[key]:
                assert not c["k"][unused].any() and not c["v"][unused].any()


# --------------------------------------------------------------------------
# host bookkeeping: the same operations through both implementations
# --------------------------------------------------------------------------

def _modules():
    from repro.runtime import paging as J
    from repro_torch.runtime import paging as Tp
    return J, Tp


def _churn(mod):
    rng = np.random.default_rng(0)
    table = mod.PageTable(16)
    holders, trace = [], []
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            got = table.alloc(int(rng.integers(1, 5)))
            trace.append(got)
            if got is not None:
                holders.append(list(got))
        elif op == 1 and holders:
            pages = holders[int(rng.integers(len(holders)))]
            table.share(pages)
            holders.append(list(pages))
        elif op == 2 and holders:
            table.free(holders.pop(int(rng.integers(len(holders)))))
        table.check()
        trace.append(table.refs.tolist())
    trace.append(table.alloc(table.free_pages + 1))
    for pages in holders:
        table.free(pages)
    trace.append((table.free_pages, list(table._free)))
    with pytest.raises(ValueError):
        table.free([0])
    return trace


def _prefix(mod):
    span, trace = 4, []
    table = mod.PageTable(8)
    prompt = list(range(1, 13))
    pages = table.alloc(3)
    cache = mod.PrefixCache(table)
    trace.append((pages, cache.register(prompt, pages, span)))
    table.free(pages)
    table.check()
    for p in (prompt + [99], prompt, [7, 7, 7, 7, 7]):
        ent = cache.lookup(p, span)
        trace.append(None if ent is None else (ent.pages, ent.tokens))
    trace.append((cache.hits, cache.misses, table.free_pages))
    trace.append((cache.reclaim(6), table.free_pages, sorted(cache.entries)))
    table.check()
    cache.clear()
    trace.append((table.free_pages, table.refs.tolist()))
    return trace


def _host_kv(mod, n_pages=12, ppr=3, n_state=4, prefix=False):
    paging = mod.PagedLayout(page_cols=4, n_seq=1, pages_per_row=ppr,
                             n_pages=n_pages, n_state_pages=n_state)
    kv = mod.KVCache(storage=None, layout=None, paging=paging)
    if prefix:
        kv.prefix = mod.PrefixCache(kv.table)
    return kv


def _plan(p):
    return (p.total_pages, p.fresh_pages, tuple(p.shared), p.covered)


def _stats(kv):
    """The stats both implementations keep (the reference's also count
    copy-on-write forks, which the port does not make)."""
    return {k: kv.stats()[k] for k in ("pages_total", "pages_free",
                                       "pages_used", "prefix_entries",
                                       "prefix_hits")}


def _lifecycle(mod):
    kv, trace = _host_kv(mod, ppr=4), []
    prompt = list(range(1, 7))
    plan = kv.plan(prompt, max_new_tokens=3)
    trace.append((_plan(plan), kv.can_admit(plan)))
    kv.alloc(0, plan)
    kv.append(0, len(prompt) + 3)
    kv.append(0, len(prompt) + 7)                  # one more page
    kv.check()
    full = kv.plan([1, 2], max_new_tokens=1, full_row=True)
    kv.alloc(1, full)
    plan2 = kv.plan([1] * kv.paging.span, max_new_tokens=1)
    trace.append((_plan(full), _plan(plan2), kv.reserve("r7", plan2)))
    kv.check()
    kv.cancel("r7")
    trace.append(kv.reserve("r8", plan2))
    kv.bind("r8", 2)
    kv.check()
    trace.append((kv.page_map(4).tolist(), kv.state_map(4).tolist(),
                  _stats(kv)))
    for slot in (1, 0, 2):
        kv.free(slot)
    kv.check()
    trace.append((kv.table.free_pages, list(kv.table._free),
                  list(kv._state_free)))
    return trace


def _out_of_pages(mod):
    kv, trace = _host_kv(mod, n_pages=4, ppr=4, n_state=2), []
    big = kv.plan(list(range(12)), max_new_tokens=4)
    kv.alloc(0, big)
    small = kv.plan([1, 2], 1)
    trace.append((_plan(big), kv.can_admit(small, reclaim=False),
                  kv.reserve("r1", small), kv.table.free_pages))
    kv.check()
    with pytest.raises(RuntimeError):
        kv.alloc(1, kv.plan([1, 2], 1))
    kv.free(0)
    kv.alloc(1, kv.plan([1, 2], 1))
    kv.check()
    trace.append((kv.page_map(2).tolist(), kv.state_map(2).tolist()))
    return trace


def _shared(mod):
    kv, trace = _host_kv(mod, prefix=True), []
    span = kv.paging.span
    prompt = list(range(1, 2 * span + 2))
    kv.alloc(0, kv.plan(prompt, max_new_tokens=2))
    kv.free(0, prompt=prompt)
    kv.check()
    plan = kv.plan(prompt, max_new_tokens=2)
    kv.alloc(1, plan)
    kv.check()
    trace.append((_plan(plan), kv.table.refs.tolist(), _stats(kv)))
    kv.free(1)
    kv.check()
    # an out-of-pages admission reclaims the prefix entries
    big = kv.plan(list(range(100, 100 + 2 * span)),
                  max_new_tokens=9 * span)          # 11 of the 12 pages
    trace.append((_plan(big), kv.can_admit(big), kv.table.free_pages,
                  len(kv.prefix.entries)))
    kv.prefix.clear()
    trace.append((kv.table.free_pages, kv.prefix.hits, kv.prefix.misses))
    return trace


@pytest.mark.parametrize("case", [_churn, _prefix, _lifecycle, _out_of_pages,
                                  _shared], ids=lambda f: f.__name__[1:])
def test_bookkeeping_matches_reference(case):
    """Page ids, refcounts, free lists, plans and maps after the same
    operations (the cases of tests/test_paging.py: churn, prefix
    register/lookup/reclaim, the alloc/append/reserve/bind/cancel/free
    lifecycle, all-or-nothing out-of-pages, shared refcounts)."""
    J, Tp = _modules()
    assert case(Tp) == case(J)


def test_paged_layout_matches_reference():
    """make_paged_layout: the same geometry, and the same refusals."""
    from types import SimpleNamespace
    J, Tp = _modules()
    for n0, cap, tokens, pages in ((32, 40, 8, None), (512, 576, 16, None),
                                   (32, 48, 16, 7)):
        lay = SimpleNamespace(n_seq=P, n_loc0=n0 // P, cap_l=cap // P)
        kw = dict(page_tokens=tokens, n_pages=pages, n_slots=8)
        got = Tp.make_paged_layout(lay, **kw)
        want = J.make_paged_layout(lay, **kw)
        assert (got.page_cols, got.pages_per_row, got.n_pages,
                got.n_state_pages, got.span) == (
            want.page_cols, want.pages_per_row, want.n_pages,
            want.n_state_pages, want.span)
    lay = SimpleNamespace(n_seq=P, n_loc0=8, cap_l=10)
    for tokens in (6, 16):
        with pytest.raises(ValueError):
            Tp.make_paged_layout(lay, page_tokens=tokens, n_pages=None,
                                 n_slots=2)


@pytest.mark.parametrize("n", [0, 1, 5, 9, 38, 39])
def test_rr_placement_matches_reference(n):
    """The 'rr' placement of ``_decode_cols``: write slot, owner and
    column positions per shard, against the reference's rule."""
    from types import SimpleNamespace
    import jax.numpy as jnp
    from repro.runtime import serve as JS
    from repro_torch.runtime.serve import (ServeHParams, _decode_cols,
                                           make_layout)
    lay = make_layout(P, CAP, ServeHParams(), prefill_len=N, placement="rr")
    pos = torch.as_tensor([n, -1, 3])
    slot, owner, col_pos = _decode_cols(lay, pos)
    jlay = SimpleNamespace(placement="rr", n_seq=P, cap_l=CAP // P)
    for s in range(P):
        w_slot, w_owner, w_col = JS._decode_cols(jlay, s, jnp.asarray(pos))
        np.testing.assert_array_equal(slot[:, s].numpy(), np.asarray(w_slot))
        np.testing.assert_array_equal(owner[:, s].numpy(),
                                      np.asarray(w_owner))
        np.testing.assert_array_equal(col_pos[s].numpy(), np.asarray(w_col))


# --------------------------------------------------------------------------
# the kernel's plain version with a page table
# --------------------------------------------------------------------------

def _paged_case(seed, rep, means, rows):
    rng = np.random.default_rng(seed)
    r, ppr, pc, n_pages, hq, hkv, hd = 3, 4, 2, 16, 4, 2, 16
    pool = rng.standard_normal((n_pages * rep, pc, hkv, hd)).astype(np.float32)
    vpool = rng.standard_normal(pool.shape).astype(np.float32)
    pages = rng.permutation(n_pages)[:r * ppr].reshape(r, ppr).astype(np.int32)
    pages[1, 2:] = -1
    pages[2, 0] = -1
    unused = sorted(set(range(n_pages)) - set(pages[pages >= 0].tolist()))
    for t in (pool, vpool):                       # unmapped: NaN
        t.reshape(n_pages, rep, pc, hkv, hd)[unused] = np.nan
    bq = 5 if rows else r
    q = rng.standard_normal((bq, 1, hq, hd)).astype(np.float32)
    valid = rng.random((bq * rep, ppr * pc)) < 0.8
    c = dict(q=q, k=pool, v=vpool, valid=valid, pages=pages, rep=rep,
             rows=(rng.integers(0, r, bq).astype(np.int32) if rows
                   else None), unused=unused)
    if means:
        mz, n_state = 6, 4
        c["kz"] = rng.standard_normal((n_state, mz, hkv, hd)).astype(
            np.float32)
        c["vz"] = rng.standard_normal(c["kz"].shape).astype(np.float32)
        c["log_gz"] = np.where(rng.random((bq * rep, mz)) < 0.6, 0.7,
                               -1e30).astype(np.float32)
        c["zrows"] = np.array([2, 0, 3], np.int32)
    return c


@pytest.mark.parametrize("rep,means,rows", [(1, False, False),
                                            (4, False, False),
                                            (4, True, False), (2, True, True),
                                            (4, False, True)])
def test_paged_plain_equals_gathered_rows(rep, means, rows):
    """The paged plain version against the dense plain version on rows
    gathered by hand (unmapped pages' columns dead), means rows through
    the means-row map; the NaN in pages no row maps never reaches a
    result."""
    from repro_torch.kernels.decode_attention import decode_stats
    c = _paged_case(rep, rep, means, rows)
    T_ = torch.as_tensor
    r, ppr = c["pages"].shape
    pc = c["k"].shape[1]
    # by hand: each cache row's pages in order, per shard
    dense_k = np.zeros((r * rep, ppr * pc) + c["k"].shape[2:], np.float32)
    dense_v = np.zeros_like(dense_k)
    mapped = np.zeros((r, ppr * pc), bool)
    for i in range(r):
        for j, pg in enumerate(c["pages"][i]):
            if pg < 0:
                continue
            mapped[i, j * pc:(j + 1) * pc] = True
            for s in range(rep):
                dense_k[i * rep + s, j * pc:(j + 1) * pc] = c["k"][pg * rep + s]
                dense_v[i * rep + s, j * pc:(j + 1) * pc] = c["v"][pg * rep + s]
    sel = c["rows"] if rows else np.arange(r)
    valid_d = c["valid"] & np.repeat(mapped[sel], rep, axis=0)
    extra, extra_d = (), ()
    if means:
        extra = (T_(c["log_gz"]), T_(c["kz"]), T_(c["vz"]))
        extra_d = (T_(c["log_gz"]), T_(c["kz"][c["zrows"]]),
                   T_(c["vz"][c["zrows"]]))
    rows_t = None if c["rows"] is None else T_(c["rows"])
    got = decode_stats(T_(c["q"]), T_(c["k"]), T_(c["v"]), T_(c["valid"]),
                       *extra, scale=0.25, rows=rows_t, pages=T_(c["pages"]),
                       zrows=T_(c["zrows"]) if means else None)
    want = decode_stats(T_(c["q"]), T_(dense_k), T_(dense_v), T_(valid_d),
                        *extra_d, scale=0.25, rows=rows_t)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-5)
    assert c["unused"]


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
