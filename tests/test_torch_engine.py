"""The port's serving engine against the JAX engine, on the CPU.

GPT-2 small reduced (2 layers, d_model 256, 4 heads of 64), P = 4
sequence shards, CR 4, the paged cache (16-token pages).  Two traces:

  * ``stagger``: 4 slots, prefill length 32, cap 48, chunks of 8, a
    token budget of 11; 6 prompts of 8-32 tokens, 4 submitted, 4 engine
    steps, then 2 more, 8 new tokens each;
  * ``prefix``: 2 slots, the same lengths; 6 prompts that begin with one
    shared 16-token prefix, 4 new tokens each, so exact mode maps the
    prefix's page once the first requests finish.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's ``ServingEngine`` on a (1, 4) mesh with the
jnp backend, in {exact, prism} x {packed, chunked}, and saves each
request's tokens and the stats that define the schedule.  The port's
engine, with the same weights and a clock that stands still, must give
the same.  The rest of the file holds the port's engine to itself:
paged against dense, backpressure, page accounting, configuration.
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
P, CR, N, CAP, CHUNK = 4, 4.0, 32, 48, 8
MODES = ("exact", "prism")
PREFILL = ("packed", "chunked")
SCHEDULE = ("prefix_hits", "prefix_tokens_saved", "packed_ticks",
            "prefill_chunks", "prefill_tokens", "out_of_pages")
TRACES = {"stagger": dict(n_slots=4, token_budget=11, new=8),
          "prefix": dict(n_slots=2, token_budget=None, new=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs six test processes at once, and each would otherwise start a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(trace, vocab):
    rng = np.random.default_rng(3)
    if trace == "stagger":
        return [rng.integers(1, vocab, size=int(rng.integers(8, 33))).tolist()
                for _ in range(6)]
    shared = rng.integers(1, vocab, size=16).tolist()
    return [shared + rng.integers(1, vocab, size=int(rng.integers(1, 9))
                                  ).tolist() for _ in range(6)]


def _drive(eng, trace, vocab):
    """Submit the trace's prompts the same way on either engine; returns
    {rid: tokens} and the schedule's stats."""
    prompts, new = _prompts(trace, vocab), TRACES[trace]["new"]
    if trace == "stagger":
        for p in prompts[:4]:
            eng.submit(p, max_new_tokens=new)
        for _ in range(4):
            eng.step()
        for p in prompts[4:]:
            eng.submit(p, max_new_tokens=new)
    else:
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
    out = eng.run()
    s = eng.stats.summary()
    return ({str(k): v for k, v in out.items()},
            {k: s[k] for k in SCHEDULE})


def _config_kw(trace, mode, prefill):
    t = TRACES[trace]
    return dict(n_slots=t["n_slots"], prefill_len=N, max_cache=CAP,
                chunk_len=CHUNK, token_budget=t["token_budget"],
                prefill_mode=prefill)


def jax_reference(out_path):
    """Child process: the reference engine on a (1, 4) mesh."""
    import jax
    from repro.configs import get_config
    from repro.models import transformer as T
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine
    sys.path.insert(0, HERE)
    from test_torch_ticks import _flatten
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out, runs = {}, {}
    _flatten(jax.tree.map(np.asarray, params), "params", out)
    for trace in TRACES:
        for mode in MODES:
            for prefill in PREFILL:
                hp = ServeHParams(decode_mode=mode, means_cr=CR,
                                  backend="jnp")
                eng = ServingEngine(cfg, mesh, params, EngineConfig(
                    hp=hp, **_config_kw(trace, mode, prefill)),
                    clock=lambda: 0.0)
                runs[f"{trace}/{mode}/{prefill}"] = _drive(
                    eng, trace, cfg.vocab_size)
    np.savez(out_path, runs=np.array(json.dumps(runs)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_engine") / "ref.npz"
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


def _engine(params, trace, mode, prefill, **over):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params = _port(params)
    kw = _config_kw(trace, mode, prefill)
    kw.update(over)
    hp = ServeHParams(decode_mode=mode, means_cr=CR)
    return ServingEngine(cfg, params, EngineConfig(hp=hp, **kw), n_seq=P,
                         clock=lambda: 0.0)


@pytest.mark.parametrize("prefill", PREFILL)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("trace", list(TRACES))
def test_engine_matches_reference(jax_ref, ref_params, trace, mode, prefill):
    """Tokens per request and the schedule (prefix hits and tokens
    saved, packed ticks, chunk calls, prompt tokens, out-of-pages
    blocks) equal the JAX engine's."""
    from repro_torch.configs import get_config
    eng = _engine(ref_params, trace, mode, prefill)
    got = _drive(eng, trace, get_config("gpt2-small").reduced().vocab_size)
    want = jax_ref[f"{trace}/{mode}/{prefill}"]
    assert got[0] == want[0]
    assert got[1] == want[1]
    eng.kv_cache.check()
    if trace == "prefix" and mode == "exact":
        assert got[1]["prefix_hits"] == 4
        assert got[1]["prefix_tokens_saved"] == 64


# --------------------------------------------------------------------------
# the port's engine against itself
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prefill", PREFILL)
@pytest.mark.parametrize("mode", MODES)
def test_paged_equals_dense(mode, prefill):
    """The paged engine's tokens equal the dense rowset's (paged=False,
    the unpaged programs) on the staggered trace."""
    cfg, params = _port()
    outs = [_drive(_engine(params, "stagger", mode, prefill, paged=paged),
                   "stagger", cfg.vocab_size)[0] for paged in (True, False)]
    assert outs[0] == outs[1]


def test_page_accounting_after_every_step():
    """The full refcount invariant holds after every engine step of the
    prefix trace; after the drain only prefix entries hold pages."""
    cfg, params = _port()
    eng = _engine(params, "prefix", "exact", "packed")
    for p in _prompts("prefix", cfg.vocab_size):
        eng.submit(p, max_new_tokens=4)
    while eng._sched.has_work:
        eng.step()
        eng.kv_cache.check()
    kv = eng.kv_cache
    assert eng.stats.completed == 6 and not kv.slot_pages
    held = {p for e in kv.prefix.entries.values() for p in e.pages}
    assert kv.table.free_pages + len(held) == kv.paging.n_pages
    assert eng.stats.prefix_hits == 4


@pytest.mark.parametrize("prefix_on", [False, True])
def test_out_of_pages_backpressure(prefix_on):
    """A pool of one full row (3 pages): the second request blocks at the
    admission gate (counted), admits after the first finishes (its prefix
    entries reclaimed when on), and both give what they give alone."""
    cfg, params = _port()
    rng = np.random.default_rng(5)
    pa, pb = (rng.integers(1, cfg.vocab_size, size=30).tolist()
              for _ in range(2))
    eng = _engine(params, "stagger", "exact", "packed", n_slots=2,
                  token_budget=None, n_pages=3, prefix_cache=prefix_on)
    assert eng.kv_cache.pages_needed(30 + 8) == 3
    ra, rb = (eng.submit(p, max_new_tokens=8) for p in (pa, pb))
    out = eng.run()
    assert eng.stats.out_of_pages >= 1
    eng.kv_cache.check()
    for rid, p in ((ra, pa), (rb, pb)):
        solo = _engine(params, "stagger", "exact", "packed", n_slots=2,
                       token_budget=None)
        r = solo.submit(p, max_new_tokens=8)
        assert solo.run()[r] == out[rid]


@pytest.mark.parametrize("mode", MODES)
def test_submit_refuses_a_request_the_pool_cannot_hold(mode):
    """A pool of two pages, less than a row of three: a request that
    needs more pages than the pool holds is refused at submit (it would
    block the FIFO head for ever); in exact mode a short one still
    serves, while paged prism takes whole rows and serves none."""
    cfg, params = _port()
    eng = _engine(params, "stagger", mode, "packed", n_pages=2)
    assert eng.kv_cache.paging.pages_per_row == 3
    rng = np.random.default_rng(7)
    with pytest.raises(ValueError, match="pool holds 2"):
        eng.submit(rng.integers(1, cfg.vocab_size, size=30).tolist(),
                   max_new_tokens=8)
    short = rng.integers(1, cfg.vocab_size, size=10).tolist()
    if mode == "prism":
        with pytest.raises(ValueError, match="pool holds 2"):
            eng.submit(short, max_new_tokens=4)
        return
    rid = eng.submit(short, max_new_tokens=4)
    assert len(eng.run()[rid]) == 4
    eng.kv_cache.check()


def test_future_arrivals_fast_forward_a_still_clock():
    """Arrivals in the future are held back, and ``run`` fast-forwards a
    clock that does not move; requests admit in arrival order."""
    cfg, params = _port()
    eng = _engine(params, "stagger", "exact", "packed")
    rng = np.random.default_rng(1)
    rids = [eng.submit(rng.integers(1, cfg.vocab_size, size=9).tolist(),
                       max_new_tokens=3, arrival=t) for t in (5.0, 0.0, 2.5)]
    assert eng.next_arrival() == 2.5
    out = eng.run()
    assert sorted(out) == sorted(rids) and all(len(v) == 3
                                               for v in out.values())
    st = eng.request_stats()
    assert all(s["tokens"] == 3 for s in st.values())


def test_engine_config_validation_and_defaults():
    """The reference's normalisation and refusals (offload needs the
    paged cache, faults a FaultPlan, the restart and retry bounds), the
    padded flush on the dense cache and a plan with ``shard_loss`` taken,
    and a ValueError that points at ROADMAP queue 3 for each part the
    engine does not serve, as the reference's does not (other block kinds,
    Mamba2's included, and frontends)."""
    import dataclasses
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    base = dict(n_slots=2, prefill_len=8, max_cache=16)
    cfg = EngineConfig(**base)
    assert (cfg.paged, cfg.prefix_cache, cfg.chunk_len, cfg.token_budget,
            cfg.prefill_mode) == (True, True, 8, 10, "packed")
    prism = ServeHParams(decode_mode="prism", means_cr=2.0)
    cfg = EngineConfig(hp=prism, **base)
    assert cfg.paged is True and cfg.prefix_cache is False
    assert EngineConfig(paged=False, **base).prefix_cache is False
    for bad in (dict(hp=prism, prefix_cache=True),
                dict(paged=False, prefix_cache=True),
                dict(prefill_mode="bogus"), dict(token_budget=1),
                dict(n_slots=0), dict(prefill_len=17),
                dict(max_restarts=0), dict(restore_retries=-1),
                dict(restore_backoff_s=-0.5)):
        with pytest.raises(ValueError):
            EngineConfig(**{**base, **bad})
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    for bad, match in ((dict(offload=True, paged=False), "paged"),
                       (dict(faults=object()), "FaultPlan")):
        with pytest.raises(ValueError, match=match):
            EngineConfig(**{**base, **bad})
    assert EngineConfig(prefill_mode="padded", **base).paged is False
    assert EngineConfig(faults=FaultPlan.chaos(0), **base).faults.seed == 0
    cfg = EngineConfig(offload=True, faults=FaultPlan(
        page_poison=FaultSpec(p=0.5)), **base)
    assert (cfg.offload, cfg.offload_bytes, cfg.max_restarts,
            cfg.restore_retries, cfg.restore_backoff_s) == (
        True, None, 3, 2, 0.0)
    c, params = _port()
    eng = ServingEngine(c, params, EngineConfig(**base), n_seq=P)
    pg = eng.kv_cache.paging
    assert eng.layout.placement == "rr"
    assert pg.span * pg.pages_per_row == eng.layout.cap
    assert pg.n_seq == P and pg.n_pages == 2 * pg.pages_per_row
    for kind, item in (("mlstm", "queue 3"), ("attn_local", "queue 3"),
                       ("mamba", "queue 3")):
        other = dataclasses.replace(c, blocks=(kind, "attn"), ssm_state=16)
        with pytest.raises(ValueError, match=item):
            ServingEngine(other, params, EngineConfig(**base), n_seq=P)
    with pytest.raises(ValueError, match="queue 3"):
        ServingEngine(dataclasses.replace(c, frontend="siglip_stub"),
                      params, EngineConfig(**base), n_seq=P)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(list(range(1, 9)), max_new_tokens=9)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
