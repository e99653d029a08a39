"""The port's padded admission flush and gang admission against the JAX
reference, on the CPU.

GPT-2 small reduced (2 layers, d_model 256, 4 heads of 64), P = 4
sequence shards, CR 4, 4 slots, prefill length 32, cap 48, chunks of 8,
a token budget of 11; 6 prompts of 8-32 tokens from a seeded rng, 8
greedy tokens each, all submitted at t = 0 on a clock that stands still.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: the
child runs the reference's ``ServingEngine`` on a (1, 4) mesh with the
jnp backend with ``prefill_mode='padded'`` (the dense cache) and with
``gang=True`` (packed ticks), exact and prism, and the reference's
prefill program sized to decode capacity (``make_prefill_step(...,
cap=48)``) over the padded batch.  The port must give the same tokens,
schedule and cache rows.  The padded flush's prism means count the pad
columns (the reference's own wart, ``tests/test_chunked_prefill.py``),
so its prism tokens are held to the JAX padded run, not to the packed
one.  The scheduler's gang cases are those of ``tests/test_serving.py``.
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
P, CR, MODES, NEW = 4, 4.0, ("exact", "prism"), 8
N, CAP = 32, 48
ENGINE = dict(n_slots=4, prefill_len=N, max_cache=CAP, chunk_len=8,
              token_budget=11)
RUNS = {"padded": dict(prefill_mode="padded"), "gang": dict(gang=True)}
SCHEDULE = ("prefills", "prefill_tokens", "packed_ticks", "decode_steps")
LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")


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


def _padded_batch(vocab):
    """The first flush's batch: the first 4 prompts right-padded with 0."""
    batch = np.zeros((4, N), np.int32)
    for i, p in enumerate(_prompts(vocab)[:4]):
        batch[i, :len(p)] = p
    return batch


def _drive(eng, vocab):
    for p in _prompts(vocab):
        eng.submit(p, max_new_tokens=NEW)
    out = eng.run()
    s = eng.stats.summary()
    return ({str(k): v for k, v in out.items()},
            {k: s[k] for k in SCHEDULE})


def jax_reference(out_path):
    """Child process: the reference engine and prefill on a (1, 4)
    mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import ServeHParams, make_prefill_step
    from repro.serving import EngineConfig, ServingEngine
    sys.path.insert(0, HERE)
    from test_torch_ticks import _flatten
    cfg = get_config("gpt2-small").reduced()
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out, runs = {}, {}
    _flatten(jax.tree.map(np.asarray, params), "params", out)
    for mode in MODES:
        hp = ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp")
        for name, over in RUNS.items():
            eng = ServingEngine(cfg, mesh, params, EngineConfig(
                hp=hp, **ENGINE, **over), clock=lambda: 0.0)
            runs[f"{name}/{mode}"] = _drive(eng, cfg.vocab_size)
        prism = PrismConfig(P=1, cr=CR, mode="prism" if mode == "prism"
                            else "voltage")
        step, _, _, _ = make_prefill_step(cfg, mesh, params, prism,
                                          batch=4, n=N, hp=hp, cap=CAP)
        logits, cache = step(params, {"tokens": jnp.asarray(
            _padded_batch(cfg.vocab_size))})
        out[f"{mode}/prefill/logits"] = np.asarray(logits)
        _flatten(cache["scan"][0], f"{mode}/prefill", out)
    np.savez(out_path, runs=np.array(json.dumps(runs)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_admission") / "ref.npz"
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


def _engine(params, mode="exact", **over):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    return ServingEngine(_cfg(), params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR),
        **{**ENGINE, **over}), n_seq=P, clock=lambda: 0.0)


def _req(rid, prompt=(1, 2, 3)):
    from repro_torch.serving import Request
    return Request(rid=rid, prompt=tuple(prompt), max_new_tokens=4)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_reference(jax_ref, ref_params, mode, run):
    """The padded and the gang engines' tokens and schedule (flushes,
    prompt tokens, packed ticks, decode steps) equal the JAX engine's."""
    eng = _engine(ref_params, mode, **RUNS[run])
    got = _drive(eng, _cfg().vocab_size)
    assert got[0] == jax_ref[f"{run}/{mode}"][0]
    assert got[1] == jax_ref[f"{run}/{mode}"][1]
    assert len(got[0]) == 6 and all(len(v) == NEW for v in got[0].values())
    if run == "padded":
        assert not eng.kv_cache.paged and got[1]["prefills"] >= 2
    else:
        eng.kv_cache.check()
        assert not eng.kv_cache.slot_pages


@pytest.mark.parametrize("mode", MODES)
def test_prefill_at_decode_capacity_matches_reference(jax_ref, ref_params,
                                                      mode):
    """The padded flush's prefill over the dense decode layout (cap 48 >
    prefill 32) gives the reference's ``make_prefill_step(..., cap=48)``
    logits and cache rows, every leaf at decode capacity."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime.serve import ServeHParams, make_layout, prefill
    hp = ServeHParams(decode_mode=mode, means_cr=CR)
    lay = make_layout(P, CAP, hp, prefill_len=N)
    prism = PrismConfig(P=1, cr=CR, mode="prism" if mode == "prism"
                        else "voltage")
    logits, cache = prefill(_cfg(), ref_params, torch.as_tensor(
        _padded_batch(_cfg().vocab_size), dtype=torch.long), prism, lay, hp)
    np.testing.assert_allclose(logits.numpy(),
                               jax_ref[f"{mode}/prefill/logits"],
                               atol=1e-4, rtol=1e-4)
    for name in LEAVES if mode == "prism" else LEAVES[:2]:
        want = jax_ref[f"{mode}/prefill/{name}"]          # (layers, ...)
        for layer, c in enumerate(cache):
            got = c[name].numpy()
            if name in ("k", "v"):               # (B, P, cap_l, ...)
                assert got.shape[2] == CAP // P
                got = got.reshape(4, CAP, *got.shape[3:])
            np.testing.assert_allclose(got, want[layer], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{name} {layer}")


# --------------------------------------------------------------------------
# the port against itself
# --------------------------------------------------------------------------

def test_padded_exact_equals_packed_and_prism_keeps_the_wart(params):
    """Exact decode: the padded flush gives the packed engine's tokens.
    Prism decode: its means average the pad columns, so its tokens part
    from the packed engine's (the reference's known wart)."""
    vocab = _cfg().vocab_size
    outs = {(mode, run): _drive(_engine(params, mode, **over), vocab)[0]
            for mode in MODES
            for run, over in (("packed", {}), ("padded", RUNS["padded"]))}
    assert outs["exact", "padded"] == outs["exact", "packed"]
    assert outs["prism", "padded"] != outs["prism", "packed"]


def test_gang_admits_full_gangs_into_an_empty_pool(params):
    """Gang mode on the engine: 4 requests admit together, the other 2
    only once all 4 finished (the drain-time remainder), and the tokens
    are the continuous engine's."""
    vocab = _cfg().vocab_size
    want = _drive(_engine(params), vocab)[0]
    eng = _engine(params, gang=True)
    for p in _prompts(vocab):
        eng.submit(p, max_new_tokens=NEW)
    admitted = []
    while eng._sched.has_work:
        before = set(eng._sched.active)
        eng.step()
        new = set(eng._sched.active) - before
        if new:
            assert not before, "a gang admitted into a busy pool"
            admitted.append(len(new))
    assert admitted == [4, 2]
    assert {str(k): v for k, v in eng.results().items()} == want


def test_insert_row_splices_one_row():
    """``KVCache.insert_row`` copies one row of a prefill cache into one
    slot row of every leaf and touches no other row."""
    from repro_torch.runtime.paging import KVCache
    from repro_torch.runtime.serve import ServeHParams, make_layout
    hp = ServeHParams(decode_mode="prism", means_cr=CR)
    lay = make_layout(P, CAP, hp, prefill_len=N)
    g = torch.Generator().manual_seed(0)
    shapes = {"k": (3, P, 12, 2, 4), "v": (3, P, 12, 2, 4),
              "kz": (3, 8, 2, 4), "gz": (3, 8)}
    dst = [{k: torch.randn(s, generator=g) for k, s in shapes.items()}
           for _ in range(2)]
    src = [{k: torch.randn(s, generator=g) for k, s in shapes.items()}
           for _ in range(2)]
    before = [{k: t.clone() for k, t in c.items()} for c in dst]
    KVCache(storage=dst, layout=lay).insert_row(src, 2, 0)
    for c, s, b in zip(dst, src, before):
        for k in shapes:
            assert torch.equal(c[k][0], s[k][2])
            assert torch.equal(c[k][1:], b[k][1:])


def test_padded_and_gang_config():
    """``prefill_mode='padded'`` forces the dense cache and turns the NaN
    guard off; offload refuses the dense cache and gang admission; the
    ``prism`` exchange defaults to the decode mode's pairing."""
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig
    base = dict(n_slots=2, prefill_len=8, max_cache=16)
    cfg = EngineConfig(prefill_mode="padded", **base)
    assert cfg.paged is False and cfg.prefix_cache is False
    assert cfg.prism.mode == "voltage" and cfg.gang is False
    prism = EngineConfig(hp=ServeHParams(decode_mode="prism", means_cr=2.0),
                         **base).prism
    assert prism.mode == "prism" and prism.cr == 2.0
    for bad, match in ((dict(prefill_mode="padded", offload=True), "paged"),
                       (dict(gang=True, offload=True), "gang")):
        with pytest.raises(ValueError, match=match):
            EngineConfig(**{**base, **bad})
    from repro_torch.models import transformer as T
    eng = _engine(T.init(_cfg(), torch.Generator().manual_seed(0), "cpu"),
                  prefill_mode="padded")
    assert not eng._nan_guard and not eng.kv_cache.paged
    assert eng.layout.placement == "aligned"


# --------------------------------------------------------------------------
# the scheduler's gang cases (tests/test_serving.py)
# --------------------------------------------------------------------------

def test_scheduler_want_admit_gang_vs_fifo():
    """FIFO admission is immediate; gang admission waits for a full gang
    into an empty pool, or the remainder at drain time."""
    from repro_torch.serving import FifoScheduler
    s = FifoScheduler(2)
    s.submit(_req(0))
    assert s.want_admit()
    s.admit(now=0.0)[0].begin_decode()
    s.submit(_req(1))
    assert s.want_admit()
    g = FifoScheduler(2, gang=True)
    g.submit(_req(0))
    assert not g.want_admit()
    g.submit(_req(1))
    assert g.want_admit()
    states = g.admit(now=0.0)
    g.submit(_req(2))
    assert not g.want_admit()
    g.evict(states[0], now=1.0)
    g.evict(states[1], now=1.0)
    g.drain = True
    assert g.want_admit()


def test_scheduler_gang_is_static_batching():
    """The padded flush under gang admission: a full gang, then nothing
    until the pool is empty, then the partial gang at drain time."""
    from repro_torch.serving import FifoScheduler
    s = FifoScheduler(2, gang=True)
    s.submit(_req(0))
    assert not s.want_prefill()
    s.submit(_req(1))
    s.submit(_req(2))
    assert s.want_prefill()
    states = s.admit(now=0.0)
    assert len(states) == 2
    s.submit(_req(3))
    assert not s.want_prefill()
    s.evict(states[0], now=1.0)
    assert not s.want_prefill()
    s.evict(states[1], now=1.0)
    s.drain = True
    assert s.want_prefill()


def test_scheduler_padded_flush_interleave():
    """Without gang the padded flush admits at once into an idle pool and
    then at most once per ``decode_per_prefill`` decode steps."""
    from repro_torch.serving import FifoScheduler
    s = FifoScheduler(2, decode_per_prefill=2)
    s.submit(_req(0))
    assert s.want_prefill()
    s.admit(now=0.0)[0].begin_decode()
    s.submit(_req(1))
    assert not s.want_prefill()
    s.note_decode()
    assert not s.want_prefill()
    s.note_decode()
    assert s.want_prefill()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
