"""The port's fault injection, deadlines, NaN quarantine and snapshots,
on the CPU.

Units: ``FaultSpec`` / ``FaultPlan`` validation and the seeded
``FaultInjector`` streams (``fire`` and ``pick`` of every kind under the
chaos plan, and scheduled ``at`` hits) equal to the reference's for
three seeds.

Engine: GPT-2 small reduced (2 layers, d_model 256, 4 heads of 64), P = 4
sequence shards, CR 4, 4 slots, prefill length 32, cap 48, 16-token
pages, chunks of 8, a token budget of 11, prompts of 8-32 tokens from a
seeded rng, the prefix cache off so that a drained pool is wholly free.
Held to the port's own run without faults: store loss (lost restores
re-prefill, transient losses are retried away, ``max_restarts`` fails a
request cleanly), deadlines in every lifecycle state, a poisoned page
that quarantines exactly its slot, a non-finite packed row, and prism
mode's chaos and snapshot runs.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child records the reference's injector streams and runs its
``ServingEngine`` on a (1, 4) mesh with the jnp backend in exact mode
under ``FaultPlan.chaos(seed)`` (``shard_loss`` off) for seeds 0 and 1
and under a plan that fires every kind at a fixed opportunity, with
every request preempted by hand once, and a snapshot taken mid-run and
restored into a fresh engine.  The port's exact engine must give its
tokens, failures and fault and recovery counters.  Tokens are compared
exactly.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
P, CR, N, CAP, CHUNK, BUDGET = 4, 4.0, 32, 48, 8, 11
SEEDS = (0, 1, 2)
# chaos plans: FaultPlan.chaos(seed) for seeds 0 and 1, and "at": each
# kind at a fixed opportunity, so that every one fires
CHAOS = ("0", "1", "at")
COUNTERS = ("preemptions", "spilled_pages", "restore_hits",
            "restore_misses", "restarts", "quarantined", "failed_requests",
            "faults_injected", "faults_by_kind", "store_get_retries")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    """A logical clock: deadlines here are in steps, not seconds."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def injector_streams(faults, seed) -> dict:
    """Every kind's ``fire`` decisions (60 opportunities, a ``pick`` after
    each hit) under the chaos plan, and a plan of ``at`` schedules."""
    out = {}
    inj = faults.FaultInjector(faults.FaultPlan.chaos(seed))
    for kind in faults.KINDS:
        out[kind] = [[inj.fire(kind), inj.pick(kind, 7)] for _ in range(60)]
    out["stats"] = inj.stats()
    spec = faults.FaultSpec(p=0.25, at=(2, 5))
    inj = faults.FaultInjector(faults.FaultPlan(seed=seed,
                                                tick_delay=spec))
    out["at"] = [inj.fire("tick_delay") for _ in range(20)]
    return out


def chaos_plan(faults, name):
    """The plan of a chaos cell, ``shard_loss`` off."""
    off = faults.FaultSpec()
    if name != "at":
        return faults.FaultPlan.chaos(int(name), shard_loss=off)
    at = lambda *i: faults.FaultSpec(at=i)              # noqa: E731
    return faults.FaultPlan(seed=0, store_put_loss=at(0),
                            store_get_loss=at(1), page_poison=at(0),
                            admission_stall=at(3), tick_delay=at(5))


def _prompts(vocab, n):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=int(rng.integers(8, 33))).tolist()
            for _ in range(n)]


def _kw(**over):
    return {**dict(n_slots=4, prefill_len=N, max_cache=CAP, chunk_len=CHUNK,
                   token_budget=BUDGET, prefix_cache=False), **over}


def _submit(eng, vocab, n=4, new=6, **kw):
    from_port = type(eng).__module__.startswith("repro_torch")
    sp = _sampling(from_port)
    for i, p in enumerate(_prompts(vocab, n)):
        eng.submit(p, max_new_tokens=new, sampling=sp(seed=i), **kw)


def _sampling(port=True):
    if port:
        from repro_torch.serving import SamplingParams
    else:
        from repro.serving import SamplingParams
    return SamplingParams


def run_chaos(eng, vocab):
    """The chaos drive: every request preempted by hand once it has a
    token; returns {rid: tokens}, the failures and the counters."""
    _submit(eng, vocab)
    hit = set()
    for _ in range(3000):
        if not eng._sched.has_work:
            break
        eng.step()
        for st in list(eng._sched.active.values()):
            rid = st.req.rid
            if (rid not in hit and not st.prefilling and st.generated
                    and not st.finished()):
                assert eng.preempt(rid)
                hit.add(rid)
    else:
        raise AssertionError("chaos run did not drain")
    s = eng.stats.summary()
    return ({str(k): v for k, v in eng.results().items()},
            {str(k): v for k, v in eng.failed().items()},
            {k: s[k] for k in COUNTERS})


def run_snapshot(make, vocab):
    """Two slots, three requests, one preempted at the cut: the snapshot
    run driven on to the end, and two fresh engines restored from the
    one snapshot.  Returns the three token dicts and the restored
    engine's counters."""
    eng = make()
    _submit(eng, vocab, n=3)
    for _ in range(100):
        eng.step()
        if any(st.generated for st in eng._sched.active.values()):
            break
    assert eng.preempt(0)
    snap = eng.snapshot()
    outs = [eng.run()]
    for _ in range(2):
        e = make()
        e.restore(snap)
        assert 0 in e.kv_store
        outs.append(e.run())
        e.kv_cache.check()
        assert len(e.kv_store) == 0
    s = e.stats.summary()
    return ([{str(k): v for k, v in o.items()} for o in outs],
            {k: s[k] for k in COUNTERS})


def jax_reference(out_path):
    """Child process: the reference's injector streams, and its engine on
    a (1, 4) mesh in exact mode under chaos and through a snapshot."""
    import jax
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.runtime import faults
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine
    sys.path.insert(0, HERE)
    from test_torch_ticks import _flatten
    ref = {"streams": {str(s): injector_streams(faults, s) for s in SEEDS}}
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    _flatten(jax.tree.map(np.asarray, params), "params", out)
    hp = ServeHParams(decode_mode="exact", means_cr=CR, backend="jnp")

    def make(**over):
        return ServingEngine(cfg, mesh, params, EngineConfig(
            hp=hp, **_kw(**over)), clock=lambda: 0.0)
    ref["chaos"] = {name: run_chaos(make(offload=True, max_restarts=8,
                                         faults=chaos_plan(faults, name)),
                                    cfg.vocab_size) for name in CHAOS}
    ref["snapshot"] = run_snapshot(lambda: make(offload=True, n_slots=2),
                                   cfg.vocab_size)
    np.savez(out_path, ref=np.array(json.dumps(ref)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_faults") / "ref.npz"
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
    ref.update(json.loads(str(ref.pop("ref"))))
    return ref


def _port(params=None):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("gpt2-small").reduced()
    if params is None:
        params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


@pytest.fixture(scope="module")
def ref_params(jax_ref):
    from repro_torch.convert import from_jax_numpy
    sys.path.insert(0, HERE)
    from test_torch_ticks import _unflatten
    cfg, _ = _port(params={})
    return from_jax_numpy(cfg, _unflatten(jax_ref, "params"), device="cpu")


@pytest.fixture(scope="module")
def port():
    return _port()


def _engine(params, mode="exact", clock=None, **over):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params = _port(params)
    return ServingEngine(cfg, params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR), **_kw(**over)),
        n_seq=P, clock=clock or (lambda: 0.0))


def _oracle(params, mode="exact", n=2, new=6):
    eng = _engine(params, mode)
    _submit(eng, _port(params)[0].vocab_size, n=n, new=new)
    return eng.run()


def _audit(eng):
    """Leak-free after the drain: pages, state rows, slots and store all
    reclaimed."""
    kv = eng.kv_cache
    kv.check()
    assert not kv.slot_pages and not kv.slot_state
    assert kv.table.free_pages == kv.paging.n_pages
    if eng.kv_store is not None:
        assert len(eng.kv_store) == 0 and eng.kv_store.bytes_used == 0
    assert sorted(eng._sched.free_slots) == list(range(eng.n_slots))


def _drive(eng, hook, limit=600):
    """Step to the drain, calling ``hook(eng)`` before each step."""
    for _ in range(limit):
        if not eng._sched.has_work:
            return
        hook(eng)
        eng.step()
    raise AssertionError("engine did not drain")


# --------------------------------------------------------------------------
# FaultSpec / FaultPlan / FaultInjector
# --------------------------------------------------------------------------

def test_fault_spec_and_plan_validation():
    from repro_torch.runtime.faults import KINDS, FaultPlan, FaultSpec
    for bad in (dict(p=-0.1), dict(p=1.5), dict(shard=-1)):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
    assert not FaultSpec().enabled and FaultSpec(at=[3]).enabled
    assert FaultSpec(at=[3.0]).at == (3,) and FaultSpec(p=0.1).enabled
    plan = FaultPlan.chaos(4, page_poison=FaultSpec(p=0.5))
    assert plan.seed == 4 and plan.spec("page_poison").p == 0.5
    assert plan.any_enabled and not FaultPlan().any_enabled
    assert all(plan.spec(k).enabled for k in KINDS)
    with pytest.raises(KeyError):
        plan.spec("bit_flip")


@pytest.mark.parametrize("seed", SEEDS)
def test_injector_streams_match_reference(jax_ref, seed):
    """``fire`` and ``pick`` of every kind, and scheduled hits that never
    shift the Bernoulli stream, equal the reference's."""
    from repro_torch.runtime import faults
    got = json.loads(json.dumps(injector_streams(faults, seed)))
    assert got == jax_ref["streams"][str(seed)]
    assert got["at"][2] and got["at"][5]


# --------------------------------------------------------------------------
# store loss: re-prefill, retries, max_restarts
# --------------------------------------------------------------------------

def _preempt_when_decoding(times):
    """A hook that preempts request 0 up to ``times`` times, each once it
    has a token."""
    done = []

    def hook(eng):
        st = eng._find_active(0)
        if (len(done) < times and st is not None and not st.prefilling
                and st.generated and not st.finished()):
            assert eng.preempt(0)
            done.append(1)
    return hook, done


def test_three_lost_restores_reprefill_to_oracle_tokens(port):
    """A store that keeps nothing (capacity 0): three preemptions, three
    lost restores, three re-prefills with the sampler re-seeded; the
    tokens are the oracle's."""
    from repro_torch.runtime.offload import KVStore
    want = _oracle(port[1])
    eng = _engine(port[1], offload=True)
    eng._store = KVStore(capacity_bytes=0)
    _submit(eng, port[0].vocab_size, n=2)
    hook, done = _preempt_when_decoding(3)
    _drive(eng, hook)
    assert len(done) == 3 and eng.results() == want
    s = eng.stats
    assert (s.restore_misses, s.restore_hits, s.restarts) == (3, 0, 3)
    assert eng._results[0].restarts == 3 and not eng.failed()
    _audit(eng)


def test_max_restarts_fails_cleanly(port):
    """With ``max_restarts=2`` the third lost restore fails the request:
    nothing leaks, the queue is not blocked, the neighbour keeps the
    oracle's tokens."""
    from repro_torch.runtime.offload import KVStore
    want = _oracle(port[1])
    eng = _engine(port[1], offload=True, max_restarts=2)
    eng._store = KVStore(capacity_bytes=0)
    _submit(eng, port[0].vocab_size, n=2)
    hook, done = _preempt_when_decoding(3)
    _drive(eng, hook)
    assert eng.failed() == {0: "max_restarts"}
    assert (eng.stats.failed_requests, eng.stats.restarts) == (1, 2)
    out = eng.results()
    assert 0 not in out and out[1] == want[1]
    _audit(eng)


@pytest.mark.parametrize("retries", (2, 0))
def test_restore_retries_transient_store_loss(port, retries):
    """One injected ``store_get_loss`` at the restore: retried away with
    the default budget, a re-prefill without one; the tokens are the
    oracle's either way."""
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    want = _oracle(port[1])
    plan = FaultPlan(store_get_loss=FaultSpec(at=(0,)))
    eng = _engine(port[1], offload=True, faults=plan,
                  restore_retries=retries)
    _submit(eng, port[0].vocab_size, n=2)
    hook, done = _preempt_when_decoding(1)
    _drive(eng, hook)
    assert done and eng.results() == want and not eng.failed()
    s = eng.stats.summary()
    if retries:
        assert (s["restore_hits"], s["restore_misses"], s["restarts"]) == \
            (1, 0, 0)
        assert s["store_get_retries"] >= 1
    else:
        assert (s["restore_misses"], s["restarts"]) == (1, 1)
        assert s["store_get_retries"] == 0
    _audit(eng)


def test_store_put_loss_reprefills(port):
    """An injected ``store_put_loss`` drops the spill; the restore misses
    and the request re-prefills to the oracle's tokens."""
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    want = _oracle(port[1])
    eng = _engine(port[1], offload=True, faults=FaultPlan(
        store_put_loss=FaultSpec(at=(0,))))
    _submit(eng, port[0].vocab_size, n=2)
    hook, done = _preempt_when_decoding(1)
    _drive(eng, hook)
    assert eng.results() == want
    assert eng.kv_store.drops == 1 and eng.stats.restore_misses == 1
    assert eng.stats.faults_by_kind["store_put_loss"] == 1
    _audit(eng)


# --------------------------------------------------------------------------
# deadlines
# --------------------------------------------------------------------------

def test_deadline_validation_and_generous_deadline(port):
    eng = _engine(port[1])
    for dl in (5.0, 1.0):
        with pytest.raises(ValueError, match="deadline"):
            eng.submit((1, 2, 3), max_new_tokens=2, arrival=5.0,
                       deadline=dl)
    clk = _Clock()
    eng = _engine(port[1], clock=clk)
    _submit(eng, port[0].vocab_size, n=2, deadline=1e9)

    def tick(e):
        clk.t += 1.0
    _drive(eng, tick)
    assert eng.stats.completed == 2 and eng.stats.deadline_miss == 0
    assert not eng.failed()


def test_deadline_expiry_in_every_lifecycle_state(port):
    """Four doomed requests, each in another state when the clock passes
    their deadline: active (decoding), spilled on the resume queue,
    suspended, and queued fresh.  Each cancellation reclaims what its
    state holds; the misses are counted per class."""
    clk = _Clock()
    vocab = port[0].vocab_size
    eng = _engine(port[1], clock=clk, offload=True, n_slots=3)
    rng = np.random.default_rng(0)
    p = lambda n: rng.integers(1, vocab, size=n).tolist()   # noqa: E731
    a = eng.submit(p(6), max_new_tokens=8, deadline=500.0, priority=1)
    b = eng.submit(p(6), max_new_tokens=8, deadline=500.0)
    d = eng.submit(p(5), max_new_tokens=8, deadline=500.0)
    for _ in range(100):
        clk.t += 1.0
        eng.step()
        sts = [eng._find_active(r) for r in (a, b, d)]
        if all(st is not None and st.generated for st in sts):
            break
    else:
        raise AssertionError("never reached steady decode")
    assert eng.preempt(b)                      # spilled, resume-parked
    assert eng.suspend(d)                      # suspended
    c = eng.submit(p(4), max_new_tokens=4, deadline=500.0)   # queued
    assert b in eng.kv_store and d in eng.kv_store
    clk.t = 500.0
    assert eng.step() == "idle"
    assert eng.stats.deadline_miss == 4
    assert eng.stats.deadline_miss_by_class == {0: 3, 1: 1}
    assert eng.failed() == {r: "deadline" for r in (a, b, c, d)}
    assert not eng._sched.has_work and not eng._suspended
    _audit(eng)
    assert eng.run() == {}
    assert eng.stats.summary()["deadline_miss_by_class"] == {"0": 3, "1": 1}


def test_deadline_miss_leaves_the_neighbour(port):
    """A request that expires mid-decode does not touch its neighbour's
    tokens."""
    clk = _Clock()
    sp = _sampling()
    oracle = _engine(port[1])
    oracle.submit(tuple(range(1, 7)), max_new_tokens=6, sampling=sp(seed=1))
    want = oracle.run()[0]
    eng = _engine(port[1], clock=clk)
    doomed = eng.submit(tuple(range(2, 8)), max_new_tokens=18,
                        deadline=4.0, sampling=sp(seed=0))
    keep = eng.submit(tuple(range(1, 7)), max_new_tokens=6,
                      sampling=sp(seed=1))

    def tick(e):
        clk.t += 1.0
    _drive(eng, tick)
    out = eng.results()
    assert doomed not in out and out[keep] == want
    assert eng.failed() == {doomed: "deadline"}
    _audit(eng)


def test_cancel_and_suspend_in_every_state(port):
    """cancel() reaches pending, queued, parked, suspended and active
    requests (a second cancel is a no-op); resume() of a cancelled
    session is refused; the survivors keep the oracle's tokens."""
    vocab = port[0].vocab_size
    want = _oracle(port[1], n=3)
    eng = _engine(port[1], offload=True, n_slots=2)
    _submit(eng, vocab, n=3)
    late = eng.submit((1, 2, 3), max_new_tokens=2, arrival=50.0)
    for _ in range(100):
        eng.step()
        st = eng._find_active(1)
        if st is not None and st.generated:
            break
    assert eng.suspend(1) and not eng.suspend(1)
    assert eng.cancel(1) and not eng.resume(1)
    assert eng.cancel(late) and not eng.cancel(late)
    assert eng.cancel(0) and eng.failed() == {0: "cancelled"}
    assert not eng.cancel(999)
    out = eng.run()
    assert out == {2: want[2]}
    assert eng.stats.cancelled == 3
    _audit(eng)


# --------------------------------------------------------------------------
# NaN quarantine
# --------------------------------------------------------------------------

def test_poisoned_page_quarantines_only_that_slot(port):
    """NaN in one request's private page mid-decode: exactly that slot is
    quarantined (scrubbed, prefilled again, sampler re-seeded); both
    requests end with the oracle's tokens."""
    want = _oracle(port[1])
    eng = _engine(port[1])
    _submit(eng, port[0].vocab_size, n=2)
    poisoned = []

    def hook(e):
        st = e._find_active(0)
        if (not poisoned and st is not None and not st.prefilling
                and len(st.generated) >= 2 and not st.finished()):
            kv = e.kv_cache
            kv.poison_page(kv.slot_pages[st.slot][0])
            assert torch.isnan(kv.storage[0]["k"][
                kv.slot_pages[st.slot][0]]).all()
            poisoned.append(1)
    _drive(eng, hook)
    assert poisoned
    assert (eng.stats.quarantined, eng.stats.restarts) == (1, 1)
    assert eng.results() == want and not eng.failed()
    assert (eng._results[0].restarts, eng._results[1].restarts) == (1, 0)
    _audit(eng)
    for c in eng.kv_cache.storage:             # scrubbed: no NaN left
        assert all(bool(torch.isfinite(t).all()) for t in c.values())


def test_quarantine_max_restarts_fails_hard(port):
    """A slot poisoned on every decode tick fails after ``max_restarts``:
    its pages scrubbed and freed, the neighbour untouched."""
    want = _oracle(port[1])
    eng = _engine(port[1], max_restarts=1)
    _submit(eng, port[0].vocab_size, n=2)

    def hook(e):
        st = e._find_active(0)
        if st is not None and not st.prefilling and not st.finished():
            e.kv_cache.poison_page(e.kv_cache.slot_pages[st.slot][0])
    _drive(eng, hook)
    assert eng.failed() == {0: "max_restarts"}
    s = eng.stats
    assert (s.quarantined, s.restarts, s.failed_requests) == (2, 1, 1)
    out = eng.results()
    assert 0 not in out and out[1] == want[1]
    _audit(eng)
    for c in eng.kv_cache.storage:
        assert all(bool(torch.isfinite(t).all()) for t in c.values())


def test_poisoned_page_reaches_exactly_its_rows(monkeypatch):
    """``chip_smoke.py``'s poisoned-page check of the decode kernel, run
    here on the plain version at a small size: over a permuted page
    pool, one mapped page NaN-filled makes exactly the output rows that
    read it non-finite (every shard of its cache row; both tokens of
    that row in the packed layout), and every other row equals the
    result without the poison."""
    import importlib.util
    from repro_torch.kernels import decode_attention as D
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    plain = D.decode_stats
    monkeypatch.setattr(D, "decode_stats", lambda *a, backend=None, **k:
                        plain(*a, backend="plain", **k))
    monkeypatch.setattr(D, "launch_route", lambda route, *a, **k:
                        plain(*a, backend="plain", **k))
    monkeypatch.setattr(cs, "PROMPT", 4 * cs.SHARDS * cs.PAGE_COLS)
    g = torch.Generator().manual_seed(0)
    b, rep, m, hq, hkv, mz = 3, 4, 16, 4, 2, 6
    rnd = lambda *sh: torch.randn(*sh, generator=g)        # noqa: E731
    valid = torch.ones(b * rep, m, dtype=torch.bool)
    valid[b * rep - 1] = False                 # a dead row elsewhere
    dec = [rnd(b, 1, hq, 64), rnd(b * rep, m, hkv, 64),
           rnd(b * rep, m, hkv, 64), valid]
    prism = dec + [torch.zeros(b * rep, mz), rnd(b, mz, hkv, 64),
                   rnd(b, mz, hkv, 64)]
    rows = torch.tensor([0, 1, 0, 2, 1], dtype=torch.int32)
    packed = [rnd(5, 1, hq, 64), dec[1], dec[2],
              torch.ones(5 * rep, m, dtype=torch.bool)]
    chk = cs.Checker(torch)
    out = cs.check_poisoned(torch, chk, g, {
        "decode": (dec, None), "decode_prism": (prism, None),
        "packed": (packed, rows), "chunk": (dec, None)}, 0.125)
    assert {k: v["rows_nonfinite"] for k, v in out.items()} == {
        "decode": 4, "decode_prism": 4, "packed": 8, "chunk": 4}
    assert chk.cases["flash_decode_stats"] == 7


def test_packed_nonfinite_row_quarantines_exactly_one_slot(port):
    """A non-finite decode row out of a packed tick (one request decoding,
    one prefilling) quarantines exactly that slot; both end with the
    oracle's tokens."""
    sp = _sampling()
    pa, pb = tuple(range(1, 7)), tuple(range(2, 8))
    oracle = _engine(port[1])
    oracle.submit(pa, max_new_tokens=6, sampling=sp(seed=0))
    oracle.submit(pb, max_new_tokens=6, sampling=sp(seed=1))
    want = oracle.run()
    eng = _engine(port[1])
    eng.submit(pa, max_new_tokens=6, sampling=sp(seed=0))
    for _ in range(100):
        eng.step()
        st = eng._find_active(0)
        if st is not None and not st.prefilling and st.generated:
            break
    eng.submit(pb, max_new_tokens=6, sampling=sp(seed=1))
    real = eng._packed

    def nan_row0(*a):
        logits = real(*a)
        logits[0] = float("nan")           # decode rows pack first
        return logits
    eng._packed = nan_row0
    assert eng.step() == "packed"
    eng._packed = real
    assert (eng.stats.quarantined, eng.stats.restarts) == (1, 1)
    eng.run()
    assert eng.results() == want and not eng.failed()
    assert (eng._results[0].restarts, eng._results[1].restarts) == (1, 0)


# --------------------------------------------------------------------------
# chaos and snapshots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHAOS)
def test_exact_chaos_matches_reference(jax_ref, ref_params, name):
    """Exact mode under a chaos plan (``shard_loss`` off) with forced
    preemptions: tokens, failures and every fault and recovery counter
    equal the JAX engine's; completed requests have the clean run's
    tokens; the drained engine leaks nothing.  Under the "at" plan every
    kind fires, and the poisoned page is quarantined."""
    from repro_torch.runtime import faults
    cfg, _ = _port(params={})
    want_clean = _oracle(ref_params, n=4)
    eng = _engine(ref_params, offload=True, max_restarts=8,
                  faults=chaos_plan(faults, name))
    got = run_chaos(eng, cfg.vocab_size)
    assert list(got) == jax_ref["chaos"][name]
    out, failed, counters = got
    assert counters["faults_injected"] > 0
    if name == "at":
        assert all(counters["faults_by_kind"][k] == 1
                   for k in faults.KINDS if k != "shard_loss")
        assert counters["quarantined"] == 1 and counters["restarts"] >= 2
        assert counters["store_get_retries"] >= 1
    assert set(out) | set(failed) == {"0", "1", "2", "3"}
    for rid, toks in out.items():
        assert toks == want_clean[int(rid)]
    _audit(eng)


@pytest.mark.parametrize("name", CHAOS)
def test_prism_chaos_matches_uninterrupted(port, name):
    """Prism mode under the same plans (no page poison there, as in the
    reference): the clean run's tokens, nothing leaked."""
    from repro_torch.runtime import faults
    want = _oracle(port[1], "prism", n=4)
    eng = _engine(port[1], "prism", offload=True, max_restarts=8,
                  faults=chaos_plan(faults, name))
    out, failed, counters = run_chaos(eng, port[0].vocab_size)
    assert set(out) | set(failed) == {"0", "1", "2", "3"}
    for rid, toks in out.items():
        assert toks == want[int(rid)]
    assert counters["faults_injected"] > 0
    assert counters["faults_by_kind"]["page_poison"] == 0
    _audit(eng)


def test_exact_snapshot_matches_reference(jax_ref, ref_params):
    """A snapshot mid-run (one request spilled at the cut) restored into
    two fresh engines: all three runs give the JAX engine's tokens, and
    the restored engine its counters."""
    cfg, _ = _port(params={})
    got = run_snapshot(lambda: _engine(ref_params, offload=True,
                                       n_slots=2), cfg.vocab_size)
    assert list(got) == jax_ref["snapshot"]
    outs = got[0]
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) == 3


def test_prism_snapshot_matches_uninterrupted(port):
    """Prism mode: the snapshot carries every live slot's state row; the
    restored engines give the uninterrupted run's tokens."""
    want = _oracle(port[1], "prism", n=3)
    outs, _ = run_snapshot(lambda: _engine(port[1], "prism", offload=True,
                                           n_slots=2), port[0].vocab_size)
    assert all(o == {str(k): v for k, v in want.items()} for o in outs)


def test_snapshot_validation(port):
    dense = _engine(port[1], paged=False)
    with pytest.raises(ValueError, match="paged"):
        dense.snapshot()
    eng = _engine(port[1], offload=True)
    _submit(eng, port[0].vocab_size, n=2)
    eng.step()
    snap = eng.snapshot()
    with pytest.raises(ValueError, match="fresh"):
        eng.restore(snap)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
