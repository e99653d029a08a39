"""The port's host offload tier and priority preemption against the JAX
reference, on the CPU.

Bookkeeping: the same operation sequences go through the port's and the
reference's ``KVStore`` (LRU, byte capacity, the fault seams, retries)
and ``FifoScheduler`` (priority classes, resume queues, the preempt
policy), and the reference's churn run (``tests/test_preemption.py``,
``_Churn``: 320 seeded random submit / admit / tick / preempt / cancel
ops, then the drain) over both host-only ``KVCache``s; the stats, admit
orders, victims, page lists and refcounts after every op must be equal.

Engine: GPT-2 small reduced (2 layers, d_model 256, 4 heads of 64), P = 4
sequence shards, CR 4, 4 slots, prefill length 32, cap 48, 16-token
pages (3 a row), chunks of 8, a token budget of 11, 6 prompts of 8-32
tokens from a seeded rng, 8 new tokens each, a clock that stands still.
Two runs with ``offload=True``:

  * ``forced``: every request preempted by hand once it has a token,
    all submitted at once;
  * ``pressure``: a pool of 6 pages (two rows), the first 4 prompts at
    priority 0, 6 engine steps, then the last 2 at priority 1.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's bookkeeping cases and its ``ServingEngine``
on a (1, 4) mesh with the jnp backend in exact mode.  The port's exact
engine must give its tokens and its preemptions, restore hits, spilled
pages and out-of-pages blocks.  In prism mode the reference's restore
raises on that mesh (its ``_inject`` writes a state row whose sharding
differs from the pool's), so the port's prism runs are held to its own
uninterrupted run.  Tokens are compared exactly.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
P, CR, N, CAP, CHUNK, BUDGET, NEW = 4, 4.0, 32, 48, 8, 11, 8
RUNS = ("forced", "pressure")
SCHEDULE = ("preemptions", "restore_hits", "restore_misses",
            "spilled_pages", "out_of_pages", "prefix_hits")
CHURN = {"seed0": dict(seed=0), "seed1": dict(seed=1),
         "seed2": dict(seed=2), "prefix": dict(seed=5, prefix=True),
         "flaky": dict(seed=7, capacity=5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# implementations: the same scripts drive the reference's and the port's
# --------------------------------------------------------------------------

def _impl(pkg):
    """The bookkeeping classes of ``repro`` or ``repro_torch``."""
    import importlib
    rt = importlib.import_module(f"{pkg}.runtime.paging")
    off = importlib.import_module(f"{pkg}.runtime.offload")
    fl = importlib.import_module(f"{pkg}.runtime.faults")
    sc = importlib.import_module(f"{pkg}.serving.scheduler")
    return SimpleNamespace(
        KVCache=rt.KVCache, PagedLayout=rt.PagedLayout,
        PrefixCache=rt.PrefixCache, KVStore=off.KVStore,
        FaultInjector=fl.FaultInjector, FaultPlan=fl.FaultPlan,
        FaultSpec=fl.FaultSpec, FifoScheduler=sc.FifoScheduler,
        Request=sc.Request, RequestState=sc.RequestState)


def store_script(S) -> list:
    """KVStore cases (payloads None: the page count stands for bytes);
    each op's result and the store's stats after it."""
    obs = []

    def note(store, tag, val):
        ent = val if not hasattr(val, "n_pages") else (
            val.key, val.n_pages, val.tokens, val.nbytes)
        obs.append([tag, ent, store.stats(), sorted(map(str,
                                                       store._entries))])
    s = S.KVStore()
    note(s, "put a", s.put("a", 3, None, tokens=9))
    note(s, "peek a", s.peek("a"))
    note(s, "pop a", s.pop("a"))
    note(s, "pop a again", s.pop("a"))
    s = S.KVStore(capacity_bytes=5)
    for key, n in (("a", 2), ("b", 2), ("c", 2)):
        note(s, f"put {key}", s.put(key, n, None))
    note(s, "peek b", s.peek("b"))
    note(s, "put d", s.put("d", 2, None))
    note(s, "put huge", s.put("e", 6, None))
    note(s, "replace b", s.put("b", 1, None, tokens=4))
    note(s, "drop c", s.drop("c"))
    note(s, "entries", [e.key for e in s.entries()])
    s = S.KVStore(capacity_bytes=0)
    note(s, "put zero", s.put("a", 1, None))
    plan = S.FaultPlan(store_put_loss=S.FaultSpec(at=(1,)),
                       store_get_loss=S.FaultSpec(at=(0, 1, 4, 5, 6)))
    s = S.KVStore(injector=S.FaultInjector(plan))
    note(s, "put 0", s.put("a", 2, None))
    note(s, "put 1 lost", s.put("b", 2, None))
    note(s, "put 2", s.put("c", 3, None))
    note(s, "get retried", s.get("a", retries=2))
    note(s, "get hit", s.get("a", retries=0, consume=True))
    note(s, "peek torn", s.peek("c"))
    s.put("d", 1, None)
    note(s, "pop torn", s.pop("d"))
    s.put("e", 1, None)
    note(s, "get exhausted", s.get("e", retries=0))
    other = S.KVStore()
    other.put("x", 4, None, tokens=2)
    other.put("y", 1, None)
    s.adopt(other.entries())
    note(s, "adopt", len(s))
    return obs


def scheduler_script(S) -> list:
    """FifoScheduler cases: priority classes high first and FIFO within,
    resume before fresh, fair resume order, the preempt policy (class,
    deadline slack, work left, decode phase first) and cancel."""
    obs = []

    def req(rid, plen=6, max_new=4, priority=0, arrival=0.0,
            deadline=None):
        return S.Request(rid=rid, prompt=tuple(range(1, plen + 1)),
                         max_new_tokens=max_new, priority=priority,
                         arrival=arrival, deadline=deadline)

    s = S.FifoScheduler(2)
    for rid, prio in ((0, 0), (1, 2), (2, 1), (3, 2), (4, 0)):
        s.submit(req(rid, priority=prio, arrival=float(rid)))
    order = []
    while s.has_work:
        for st in s.admit(now=0.0):
            order.append(st.req.rid)
        for st in list(s.active.values()):
            s.evict(st, now=1.0)
    obs.append(["priority order", order])

    s = S.FifoScheduler(3)
    for rid in range(3):
        s.submit(req(rid, arrival=float(rid)))
    sts = s.admit(now=0.0)
    for st in sts:
        st.begin_decode()
    s.preempt(sts[2])
    s.preempt(sts[0])
    s.submit(req(3, arrival=3.0))
    obs.append(["resume first", s.peek_admit().req.rid, s.queued])
    obs.append(["admit", [st.req.rid for st in s.admit(now=1.0)],
                s.free_slots])

    s = S.FifoScheduler(4)
    specs = ((0, 0, 8, None), (1, 0, 20, None), (2, 1, 30, None),
             (3, 0, 20, 40.0), (4, 0, 20, 9.0))
    for rid, prio, new, dl in specs:
        s.submit(req(rid, max_new=new, priority=prio, deadline=dl))
    sts = {st.req.rid: st for st in s.admit(now=0.0)}
    for rid in (0, 1, 2):
        sts[rid].begin_decode()
    victims = []
    for below, now in ((1, 0.0), (2, 0.0), (5, 15.0), (0, 0.0)):
        v = s.pick_victim(below, now=now)
        victims.append(None if v is None else v.req.rid)
    obs.append(["victims", victims])
    s.preempt(sts[1])
    obs.append(["remaining", [st.remaining for st in sts.values()]])
    s.submit(req(9))
    obs.append(["cancel", [getattr(s.cancel(r), "rid", None)
                           for r in (9, 42)],
                s.cancel(1).req.rid, s.queued])
    return obs


class _Churn:
    """The reference's churn run (``tests/test_preemption.py``
    ``_Churn``) over one implementation's host-side subsystem: the
    engine's admission and restore logic without device storage.  It
    records the page lists, refcounts, state rows and slots after every
    op."""

    def __init__(self, S, seed, *, n_slots=4, n_pages=14, ppr=4,
                 prefix=False, capacity=None):
        self.S = S
        self.rng = np.random.default_rng(seed)
        paging = S.PagedLayout(page_cols=4, n_seq=1, pages_per_row=ppr,
                               n_pages=n_pages, n_state_pages=n_slots)
        self.kv = S.KVCache(storage=None, layout=None, paging=paging)
        if prefix:
            self.kv.prefix = S.PrefixCache(self.kv.table)
        self.sched = S.FifoScheduler(n_slots)
        self.store = S.KVStore(capacity_bytes=capacity)
        self.n_slots, self.n_pages = n_slots, n_pages
        self.next_rid, self.now = 0, 0.0
        self.plans, self.from_store = {}, set()
        self.finished, self.cancelled, self.restarted = set(), set(), set()
        self.trace = []

    def _fresh_gate(self, req) -> bool:
        kv, pfx = self.kv, self.kv.prefix is not None
        plan = kv.plan(req.prompt, req.max_new_tokens, use_prefix=pfx)
        if not kv.can_admit(plan, reclaim=False):
            if kv.prefix is not None:
                kv.prefix.reclaim(plan.fresh_pages)
                plan = kv.plan(req.prompt, req.max_new_tokens,
                               use_prefix=pfx)
            if not kv.can_admit(plan, reclaim=False):
                return False
        if not kv.reserve(req.rid, plan):
            return False
        self.plans[req.rid] = plan
        return True

    def _gate(self, cand) -> bool:
        if not isinstance(cand, self.S.RequestState):
            return self._fresh_gate(cand)
        rid = cand.req.rid
        plan = self.kv.plan_restore(rid, self.store)
        if plan is None:                  # store lost it: re-prefill
            cand.reset_for_refill()
            self.restarted.add(rid)
            return self._fresh_gate(cand.req)
        if not (self.kv.can_admit(plan) and self.kv.reserve(rid, plan)):
            return False
        self.plans[rid] = plan
        self.from_store.add(rid)
        return True

    def op_submit(self):
        rid = self.next_rid
        self.next_rid += 1
        plen = int(self.rng.integers(1, 9))
        gen = int(self.rng.integers(1, 9))
        prio = int(self.rng.integers(0, 3))
        prompt = tuple(int(t) for t in self.rng.integers(1, 50, size=plen))
        self.sched.submit(self.S.Request(rid=rid, prompt=prompt,
                                         max_new_tokens=gen, priority=prio,
                                         arrival=self.now))
        self.now += 1.0

    def op_admit(self):
        for st in self.sched.admit(self.now, gate=self._gate):
            rid = st.req.rid
            self.kv.bind(rid, st.slot)
            plan = self.plans.pop(rid)
            if rid in self.from_store:
                self.from_store.discard(rid)
                if not self.kv.restore(rid, st.slot, self.store):
                    st.reset_for_refill()
                    self.restarted.add(rid)
            elif plan.covered and st.nprefilled < plan.covered:
                st.nprefilled = plan.covered

    def op_tick(self):
        for st in self.sched.prefilling():
            st.nprefilled += min(3, len(st.req.prompt) - st.nprefilled)
            if not st.prefilling:
                st.begin_decode()
        for st in self.sched.decoding():
            st.generated.append(7)
            st.pos += 1
            st.next_token = 7
            if st.finished():
                self.kv.free(st.slot, st.req.prompt
                             if self.kv.prefix is not None else None)
                self.sched.evict(st, self.now)
                self.finished.add(st.req.rid)
        self.now += 1.0

    def op_preempt(self):
        active = list(self.sched.active.values())
        if not active:
            return
        st = active[int(self.rng.integers(len(active)))]
        self.kv.spill(st.req.rid, st.slot, self.store,
                      tokens=st.nprefilled)
        self.sched.preempt(st)

    def op_cancel(self):
        waiting = ([r for q in self.sched.queues.values() for r in q]
                   + [s.req for q in self.sched.resume.values() for s in q])
        if not waiting:
            return
        rid = waiting[int(self.rng.integers(len(waiting)))].rid
        assert self.sched.cancel(rid) is not None
        self.store.drop(rid)
        self.cancelled.add(rid)

    def record(self, op):
        kv = self.kv
        kv.check()
        self.trace.append([
            op, sorted((int(s), [int(p) for p in pg])
                       for s, pg in kv.slot_pages.items()),
            kv.table.refs.tolist(),
            sorted((int(s), int(r)) for s, r in kv.slot_state.items()),
            sorted((int(s), st.req.rid)
                   for s, st in self.sched.active.items()),
            sorted(str(k) for k in self.store._entries)])

    def run(self, n_ops=320):
        ops = [self.op_submit, self.op_admit, self.op_tick,
               self.op_preempt, self.op_cancel]
        weights = [0.28, 0.22, 0.30, 0.13, 0.07]
        for _ in range(n_ops):
            op = self.rng.choice(ops, p=weights)
            op()
            self.record(op.__name__)
        for _ in range(3000):
            if not self.sched.has_work:
                break
            self.op_admit()
            self.op_tick()
            self.record("drain")
        if self.kv.prefix is not None:
            self.kv.prefix.clear()
        return {"trace": self.trace,
                "finished": sorted(self.finished),
                "cancelled": sorted(self.cancelled),
                "restarted": sorted(self.restarted),
                "free_pages": self.kv.table.free_pages,
                "store": self.store.stats()}


def churn(S, name):
    return _Churn(S, **CHURN[name]).run()


# --------------------------------------------------------------------------
# the engine runs
# --------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=int(rng.integers(8, 33))).tolist()
            for _ in range(6)]


def _config_kw(run):
    kw = dict(n_slots=4, prefill_len=N, max_cache=CAP, chunk_len=CHUNK,
              token_budget=BUDGET)
    if run is not None:
        kw["offload"] = True
    if run == "pressure":
        kw["n_pages"] = 6
    return kw


def drive(eng, run, vocab):
    """One run on either engine; returns {rid: tokens} and the schedule
    stats.  ``run=None`` is the uninterrupted oracle."""
    prompts = _prompts(vocab)
    if run == "pressure":
        for p in prompts[:4]:
            eng.submit(p, max_new_tokens=NEW)
        for _ in range(6):
            eng.step()
        for p in prompts[4:]:
            eng.submit(p, max_new_tokens=NEW, priority=1)
        out = eng.run()
    else:
        for p in prompts:
            eng.submit(p, max_new_tokens=NEW)
        hit = set()
        while eng._sched.has_work:
            eng.step()
            for st in list(eng._sched.active.values()):
                rid = st.req.rid
                if (run == "forced" and rid not in hit and not st.prefilling
                        and st.generated and not st.finished()):
                    assert eng.preempt(rid)
                    hit.add(rid)
        out = eng.results()
    s = eng.stats.summary()
    return ({str(k): v for k, v in out.items()},
            {k: s[k] for k in SCHEDULE})


def jax_reference(out_path):
    """Child process: the reference's bookkeeping cases and its engine on
    a (1, 4) mesh, exact mode."""
    import jax
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine
    sys.path.insert(0, HERE)
    from test_torch_ticks import _flatten
    S = _impl("repro")
    ref = {"store": store_script(S), "scheduler": scheduler_script(S),
           "churn": {name: churn(S, name) for name in CHURN}}
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    _flatten(jax.tree.map(np.asarray, params), "params", out)
    hp = ServeHParams(decode_mode="exact", means_cr=CR, backend="jnp")
    ref["engine"], ref["engine_store"] = {}, {}
    for run in RUNS:
        eng = ServingEngine(cfg, mesh, params, EngineConfig(
            hp=hp, **_config_kw(run)), clock=lambda: 0.0)
        ref["engine"][run] = drive(eng, run, cfg.vocab_size)
        ref["engine_store"][run] = eng.kv_store.stats()
        eng.kv_cache.check()
    np.savez(out_path, ref=np.array(json.dumps(ref)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_offload") / "ref.npz"
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


def _json(x):
    """The reference's observations went through JSON: compare alike."""
    return json.loads(json.dumps(x))


def test_kvstore_matches_reference(jax_ref):
    """LRU order, capacity drops and evictions, same-key replacement,
    the put and get loss seams with retries, and adopt: every result and
    stat equal to the reference's."""
    assert _json(store_script(_impl("repro_torch"))) == jax_ref["store"]


def test_kvstore_counts_tensor_bytes():
    """A payload of per-layer dicts of tensors is counted by its tensors'
    bytes (the reference sums a pytree's leaves)."""
    from repro_torch.runtime.offload import KVStore
    payload = [{"k": torch.zeros(2, 4, 3), "v": torch.zeros(2, 4, 3)},
               {"k": torch.zeros(2, 4, 3, dtype=torch.float64)}]
    s = KVStore(capacity_bytes=500)
    assert s.put("a", 2, payload)
    assert s.bytes_used == 24 * 4 * 2 + 24 * 8
    assert not s.put("b", 2, payload + [{"x": np.zeros(30)}])
    assert s.drops == 1 and "b" not in s


def test_scheduler_matches_reference(jax_ref):
    """Admission order over priority classes, resume before fresh,
    victims under the preempt policy, work left and cancel: equal to the
    reference's."""
    assert _json(scheduler_script(_impl("repro_torch"))) == \
        jax_ref["scheduler"]


@pytest.mark.parametrize("name", list(CHURN))
def test_churn_matches_reference(jax_ref, name):
    """The churn run over both host-only caches: the page lists,
    refcounts, state rows, slots and store keys after every op equal the
    reference's; everything not cancelled finishes, nothing leaks."""
    got = _json(churn(_impl("repro_torch"), name))
    want = jax_ref["churn"][name]
    assert len(got["trace"]) == len(want["trace"])
    for i, (g, w) in enumerate(zip(got["trace"], want["trace"])):
        assert g == w, f"op {i} ({w[0]})"
    assert {k: v for k, v in got.items() if k != "trace"} == \
        {k: v for k, v in want.items() if k != "trace"}
    assert got["free_pages"] == 14
    if name == "flaky":
        assert got["restarted"]
    else:
        assert got["store"]["entries"] == 0


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


def _engine(params, mode, run, **over):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params = _port(params)
    kw = {**_config_kw(run), **over}
    return ServingEngine(cfg, params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR), **kw), n_seq=P,
        clock=lambda: 0.0)


def _audit(eng):
    """Leak-free after the drain: the refcounts hold, only prefix entries
    hold pages, no slot is bound, the store is empty."""
    kv = eng.kv_cache
    kv.check()
    held = ({p for e in kv.prefix.entries.values() for p in e.pages}
            if kv.prefix is not None else set())
    assert not kv.slot_pages and not kv.slot_state
    assert kv.table.free_pages + len(held) == kv.paging.n_pages
    assert len(eng.kv_store) == 0 and eng.kv_store.bytes_used == 0
    assert sorted(eng._sched.free_slots) == list(range(eng.n_slots))


@pytest.mark.parametrize("run", RUNS)
def test_exact_engine_matches_reference(jax_ref, ref_params, run):
    """Exact mode: the tokens and the schedule (preemptions, restore hits
    and misses, spilled pages, out-of-pages blocks, prefix hits) equal
    the JAX engine's at P = 4."""
    cfg, _ = _port(params={})
    eng = _engine(ref_params, "exact", run)
    got = drive(eng, run, cfg.vocab_size)
    want = jax_ref["engine"][run]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["preemptions"] >= (6 if run == "forced" else 1)
    assert got[1]["restore_hits"] == got[1]["preemptions"]
    _audit(eng)


@pytest.mark.parametrize("run", RUNS)
def test_prism_engine_matches_uninterrupted(run):
    """Prism mode: preempted requests (pages and the Segment-Means state
    row spilled and restored into other pages and another row) give the
    tokens of the port's run without offload."""
    cfg, params = _port()
    want = drive(_engine(params, "prism", None), None, cfg.vocab_size)[0]
    eng = _engine(params, "prism", run)
    got, sched = drive(eng, run, cfg.vocab_size)
    assert got == want
    assert sched["preemptions"] >= 1
    assert sched["restore_hits"] == sched["preemptions"]
    assert sched["restore_misses"] == 0
    _audit(eng)


@pytest.mark.parametrize("mode", ("exact", "prism"))
def test_spill_restore_moves_pages_and_state_bit_exact(mode):
    """``spill`` then ``restore`` into other pages and another state row
    carries every byte: the restored slot's pool pages and state row
    equal the spilled ones, and the spilled pages are back on the free
    list."""
    from repro_torch.runtime.offload import KVStore
    cfg, params = _port()
    eng = _engine(params, mode, "forced")
    for p in _prompts(cfg.vocab_size)[:2]:
        eng.submit(p, max_new_tokens=NEW)
    for _ in range(4):
        eng.step()
    kv, store = eng.kv_cache, KVStore()
    slot = min(kv.slot_pages)
    pages, srow = list(kv.slot_pages[slot]), kv.slot_state[slot]
    before = [{k: (t[pages].clone() if k in ("k", "v") else t[srow].clone())
               for k, t in c.items()} for c in kv.storage]
    free = kv.table.free_pages
    assert kv.spill("r", slot, store, tokens=5) == len(pages)
    assert kv.table.free_pages == free + len(pages)
    assert store.bytes_used == sum(v.nbytes for c in before
                                   for v in c.values())
    # take the spilled pages first, so the restore lands elsewhere
    decoy = kv.table.alloc(len(pages))
    plan = kv.plan_restore("r", store)
    assert (plan.total_pages, plan.covered) == (len(pages), 5)
    kv.alloc(slot, plan)
    assert kv.restore("r", slot, store) and len(store) == 0
    new, nrow = kv.slot_pages[slot], kv.slot_state[slot]
    assert not set(new) & set(pages)
    for c, b in zip(kv.storage, before):
        for k, t in c.items():
            got = t[new] if k in ("k", "v") else t[nrow]
            assert torch.equal(got, b[k])
    kv.table.free(decoy)
    kv.check()


def test_ensure_writable_forks_shared_pages():
    """A shared prefix page in a slot's write window is copied to a
    private page (content equal), the shared one keeps its other
    holder's reference."""
    cfg, params = _port()
    eng = _engine(params, "exact", None)
    kv = eng.kv_cache
    (shared,) = kv.table.alloc(1)  # held elsewhere, e.g. a prefix entry
    kv.storage[0]["k"][shared].fill_(3.0)
    kv.fork_cow([shared], 1, 1)
    assert kv.ensure_writable(1, 20, 30) == 0      # page 1 is private
    assert kv.ensure_writable(1, 0, 20) == 1
    p = kv.slot_pages[1][0]
    assert p != shared and kv.cow_copies == 1
    assert torch.equal(kv.storage[0]["k"][p], kv.storage[0]["k"][shared])
    assert kv.table.refs[shared] == 1 and kv.table.refs[p] == 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
