"""The port's streaming loop (``serving/streaming.py``) against the JAX
reference's, on the CPU.

GPT-2 small reduced (2 layers, d_model 256, 4 heads of 64), P = 4
sequence shards, CR 4, 4 slots, prefill length 32, cap 48, 16-token
pages, chunks of 8, a token budget of 11; 6 prompts of 8-32 tokens from
a seeded rng, 8 greedy tokens each, all submitted at t = 0 on a clock
that stands still.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's ``ServingEngine`` and its ``StreamingEngine``
(overlap on and off) on a (1, 4) mesh with the jnp backend, exact and
prism, and saves each request's tokens and the tick counts.  The port's
streaming loop must give them, and the port's synchronous engine's
tokens.  The rest holds the port's loop to the cases of
``tests/test_streaming.py``: the asyncio front-end, a cancel in flight
with no leak, a forced preemption in flight, and, beyond them, a
quarantine whose rows in flight are dropped by epoch, the synchronous
fallback for sampled requests, and a dispatch that runs ahead of the
reconcile.
"""
from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
P, CR, MODES, NEW = 4, 4.0, ("exact", "prism"), 8
ENGINE = dict(n_slots=4, prefill_len=32, max_cache=48, chunk_len=8,
              token_budget=11)
TICKS = ("packed_ticks", "decode_steps", "tokens_streamed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=int(rng.integers(8, 33))).tolist()
            for _ in range(6)]


def _stream(seng, vocab):
    """Every prompt through ``submit_stream``, then ``run_sync``: the
    results, each stream's delivered tokens and finish reason, and the
    tick counts."""
    streams = {rid: s for rid, s in (
        seng.submit_stream(p, max_new_tokens=NEW) for p in _prompts(vocab))}
    out = seng.run_sync()
    s = seng.engine.stats.summary()
    return ({str(k): v for k, v in out.items()},
            {str(rid): [st.drain(), st.finished]
             for rid, st in streams.items()},
            {k: s[k] for k in TICKS})


def jax_reference(out_path):
    """Child process: the reference engine and streaming loop on a
    (1, 4) mesh."""
    import jax
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine, StreamingEngine
    sys.path.insert(0, HERE)
    from test_torch_ticks import _flatten
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out, runs = {}, {}
    _flatten(jax.tree.map(np.asarray, params), "params", out)

    def engine(mode):
        return ServingEngine(cfg, mesh, params, EngineConfig(
            hp=ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp"),
            **ENGINE), clock=lambda: 0.0)
    for mode in MODES:
        eng = engine(mode)
        for p in _prompts(cfg.vocab_size):
            eng.submit(p, max_new_tokens=NEW)
        runs[f"{mode}/sync"] = {str(k): v for k, v in eng.run().items()}
        for overlap in (True, False):
            seng = StreamingEngine(engine(mode), overlap=overlap)
            runs[f"{mode}/{overlap}"] = _stream(seng, cfg.vocab_size)
    runs["summary_keys"] = sorted(eng.stats.summary())
    np.savez(out_path, runs=np.array(json.dumps(runs)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_streaming") / "ref.npz"
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
    ref.update(json.loads(str(ref.pop("runs"))))
    return ref


def _cfg():
    from repro_torch.configs import get_config
    return get_config("gpt2-small").reduced()


@pytest.fixture(scope="module")
def ref_params(jax_ref):
    from repro_torch.convert import from_jax_numpy
    sys.path.insert(0, HERE)
    from test_torch_ticks import _unflatten
    return from_jax_numpy(_cfg(), _unflatten(jax_ref, "params"),
                          device="cpu")


@pytest.fixture(scope="module")
def params():
    from repro_torch.models import transformer as T
    return T.init(_cfg(), torch.Generator().manual_seed(0), "cpu")


def _engine(params, mode="exact", clock=None, **over):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    return ServingEngine(_cfg(), params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR),
        **{**ENGINE, **over}), n_seq=P, clock=clock or (lambda: 0.0))


def _sync(params, mode="exact", **over):
    eng = _engine(params, mode, **over)
    for p in _prompts(_cfg().vocab_size):
        eng.submit(p, max_new_tokens=NEW)
    return eng.run()


@pytest.fixture(scope="module")
def oracle(params):
    """The port's synchronous engine's tokens, by decode mode."""
    return {mode: _sync(params, mode) for mode in MODES}


def _audit(eng):
    """Leak-free after the drain: every page free or held by a prefix
    entry, no slot holding pages or a state row, every slot free."""
    kv = eng.kv_cache
    kv.check()
    assert not kv.slot_pages and not kv.slot_state
    held = ({p for e in kv.prefix.entries.values() for p in e.pages}
            if kv.prefix is not None else set())
    assert kv.table.free_pages + len(held) == kv.paging.n_pages
    assert sorted(eng._sched.free_slots) == list(range(ENGINE["n_slots"]))


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_stream_matches_reference(jax_ref, ref_params, mode, overlap):
    """The streamed tokens, every stream's delivered tokens and finish
    reason, and the tick counts equal the JAX streaming loop's; the
    tokens are the synchronous engine's (the port's and the JAX one's);
    the overlap counters land in the summary."""
    from repro_torch.serving import StreamingEngine
    seng = StreamingEngine(_engine(ref_params, mode), overlap=overlap)
    assert seng.overlap is overlap
    got = _stream(seng, _cfg().vocab_size)
    want = jax_ref[f"{mode}/{overlap}"]
    assert got[0] == want[0] == jax_ref[f"{mode}/sync"]
    assert got[1] == want[1]
    assert got[2] == want[2]
    sync = _sync(ref_params, mode)
    assert got[0] == {str(k): v for k, v in sync.items()}
    s = seng.engine.stats.summary()
    assert s["tokens_streamed"] == 6 * NEW
    assert 0.0 <= s["host_overhead_fraction"] < 1.0
    assert not seng._pipe and all(
        st.inflight == 0 for st in seng.engine._sched.active.values())
    _audit(seng.engine)


def test_summary_keys_match_reference(jax_ref, params):
    """``EngineStats.summary`` has the reference's keys, the streaming
    and degraded-mesh counters included."""
    assert sorted(_engine(params).stats.summary()) == \
        jax_ref["summary_keys"]


# --------------------------------------------------------------------------
# the cases of tests/test_streaming.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_stream_async_frontend(params, oracle, mode):
    """``serve_stream``: staggered arrivals on the wall clock, consumed
    by ``async for`` loops, deliver the synchronous tokens and finish
    reasons, each stream's delivery times in order."""
    import time
    from repro_torch.serving import StreamingEngine, serve_stream
    seng = StreamingEngine(_engine(params, mode, clock=time.monotonic))
    reqs = [dict(prompt=p, max_new_tokens=NEW, arrival=0.002 * i)
            for i, p in enumerate(_prompts(_cfg().vocab_size))]
    got = asyncio.run(serve_stream(seng, reqs))
    assert {rid: g["tokens"] for rid, g in sorted(got.items())} == \
        oracle[mode]
    assert all(g["finished"] == "length" for g in got.values())
    for g in got.values():
        assert g["times"] == sorted(g["times"])
    assert seng.itl_samples()


def test_stream_cancel_mid_flight_zero_leak(params, oracle):
    """Cancelling a decoding request with ticks in flight drains the
    pipeline, frees its pages and slot, closes its stream as
    'cancelled', and leaves every other stream token-identical; the pool
    comes back whole (prefix cache off)."""
    from repro_torch.serving import StreamingEngine
    eng = _engine(params, prefix_cache=False)
    seng = StreamingEngine(eng)
    streams = dict(seng.submit_stream(p, max_new_tokens=NEW)
                   for p in _prompts(_cfg().vocab_size))
    for _ in range(40):
        seng.step()
        victim = next((st.req.rid for st in eng._sched.active.values()
                       if not st.prefilling and st.generated), None)
        if victim is not None and seng._pipe:
            break
    assert victim is not None and seng._pipe
    assert seng.cancel(victim)
    assert not seng._pipe
    assert streams[victim].finished == "cancelled"
    out = seng.run_sync()
    assert victim not in out and eng.failed()[victim] == "cancelled"
    for rid, stream in streams.items():
        if rid != victim:
            assert out[rid] == oracle["exact"][rid]
            assert stream.drain() == oracle["exact"][rid]
    assert eng.stats.cancelled == 1
    _audit(eng)


def test_stream_forced_preemption_reconciles(params, oracle):
    """A request preempted into the host store while rows are in flight:
    ``preempt`` drains first, the request restores through admission,
    every stream matches the synchronous tokens, nothing is left in
    flight or in the store."""
    from repro_torch.serving import StreamingEngine
    eng = _engine(params, offload=True, prefix_cache=False)
    seng = StreamingEngine(eng)
    streams = dict(seng.submit_stream(p, max_new_tokens=NEW)
                   for p in _prompts(_cfg().vocab_size))
    for _ in range(40):
        seng.step()
        victim = next((st.req.rid for st in eng._sched.active.values()
                       if not st.prefilling), None)
        if victim is not None and seng._pipe:
            break
    assert victim is not None and seng._pipe
    assert seng.preempt(victim)
    assert not seng._pipe
    assert seng.run_sync() == oracle["exact"]
    assert eng.stats.preemptions >= 1 and eng.stats.restore_hits >= 1
    for rid, stream in streams.items():
        assert stream.drain() == oracle["exact"][rid]
        assert stream.finished == "length"
    assert all(st.inflight == 0 for st in eng._sched.active.values())
    assert len(eng.kv_store) == 0
    _audit(eng)


def test_quarantine_drops_rows_in_flight_by_epoch(params, oracle):
    """One slot's decode row comes home non-finite while its next row is
    already in flight: the reconcile quarantines exactly that slot
    (epoch bumped), drops its row in flight as stale, and the request
    is served again to the synchronous tokens."""
    from repro_torch.serving import StreamingEngine
    eng = _engine(params)
    seng = StreamingEngine(eng)
    for p in _prompts(_cfg().vocab_size):
        seng.submit_stream(p, max_new_tokens=NEW)
    real, hit, stale = eng._decode_program, [], []

    def nan_slot0(tok, pos, maps):
        logits = real(tok, pos, maps)
        st = eng._sched.active.get(0)
        if not hit and st is not None and len(st.generated) >= 2:
            hit.append(st)
            logits = logits.clone()
            logits[0] = float("nan")
        return logits
    eng._decode_program = nan_slot0
    reconcile = seng._reconcile_one

    def watch():
        tick = seng._pipe[0]
        stale.extend(st for _, st, ep in tick.records
                     if hit and st is hit[0] and st.epoch != ep)
        reconcile()
    seng._reconcile_one = watch
    assert seng.run_sync() == oracle["exact"]
    assert hit and stale, "no row of the quarantined slot was in flight"
    assert eng.stats.quarantined == 1 and eng.stats.restarts == 1
    assert hit[0].restarts == 1 and hit[0].epoch == 1
    _audit(eng)


def test_sampled_requests_run_synchronous_ticks(params):
    """A ``temperature > 0`` request needs the full logits row: its
    ticks run synchronously (the pipeline drained), and the seeded
    tokens are the synchronous engine's."""
    from repro_torch.serving import SamplingParams, StreamingEngine
    prompts = _prompts(_cfg().vocab_size)
    sp = [SamplingParams(temperature=0.8 if i % 2 else 0.0, top_k=20,
                         seed=i) for i in range(len(prompts))]
    eng = _engine(params)
    for p, s in zip(prompts, sp):
        eng.submit(p, max_new_tokens=NEW, sampling=s)
    want = eng.run()
    eng2 = _engine(params)
    seng = StreamingEngine(eng2)
    assert seng.overlap
    for p, s in zip(prompts, sp):
        seng.submit_stream(p, max_new_tokens=NEW, sampling=s)
    synchronous = 0
    while seng.has_work:
        sampled = any(st.req.sampling.temperature > 0
                      for st in eng2._sched.decoding())
        seng.step()
        if sampled:
            assert not seng._pipe      # drained, one synchronous tick
            synchronous += 1
    seng.drain()
    assert synchronous > 0 and eng2.results() == want


def test_dispatch_runs_ahead_of_reconcile(params, oracle):
    """Tick N+1 is dispatched before tick N reconciles: at some dispatch
    a tick is already in flight, the pipeline reaches its depth, and a
    decode row's token comes from the previous tick's device result
    (the merge) rather than the host."""
    from repro_torch.serving import StreamingEngine
    eng = _engine(params)
    seng = StreamingEngine(eng)
    for p in _prompts(_cfg().vocab_size):
        seng.submit_stream(p, max_new_tokens=NEW)
    events, spliced = [], []
    real = {k: getattr(seng, k) for k in ("_dispatch", "_reconcile_one",
                                           "_spec_token")}

    def dispatch():
        before = len(seng._pipe)
        kind = real["_dispatch"]()
        if kind is not None:
            events.append(("dispatch", before))
        return kind

    def reconcile():
        events.append(("reconcile", len(seng._pipe)))
        real["_reconcile_one"]()

    def spec(st, tok, src, i):
        real["_spec_token"](st, tok, src, i)
        spliced.append(src[i] >= 0)
    seng._dispatch, seng._reconcile_one = dispatch, reconcile
    seng._spec_token = spec
    assert seng.run_sync() == oracle["exact"]
    assert any(e == ("dispatch", 1) for e in events)
    assert any(e == ("reconcile", 2) for e in events)
    assert any(spliced)


def test_overlap_needs_packed_ticks_and_no_fault_plan(params):
    """Overlap is on only for packed ticks and no fault plan; the staging
    buffers send a tick's inputs in one copy and give back their
    device views."""
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    from repro_torch.serving import StreamingEngine
    from repro_torch.serving.streaming import _Stage
    assert StreamingEngine(_engine(params)).overlap
    assert not StreamingEngine(_engine(params, prefill_mode="chunked")
                               ).overlap
    plan = FaultPlan(tick_delay=FaultSpec(at=(1,)))
    assert not StreamingEngine(_engine(params, faults=plan)).overlap
    stage = _Stage(16, 3, torch.device("cpu"))
    arrays = [np.arange(4), np.full(3, -1), np.array([[5, 6], [7, 8]])]
    views = stage.inputs(arrays)
    for v, a in zip(views, arrays):
        assert v.tolist() == a.reshape(-1).tolist()
    stage.result(torch.arange(12, dtype=torch.int32).view(3, 4))
    assert stage.get().tolist() == np.arange(12).reshape(3, 4).tolist()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
