"""The port's bf16, mixed-dtype and head-dim 16/32 kernel cases on the
CPU: each plain version against the reference's Pallas kernel run with
``interpret=True`` and its jnp oracle, at the reference's tolerances
(tests/test_kernels.py: atol 2e-2, rtol 1e-2 at bf16; atol 2e-5, rtol
2e-4 for the prefill attention and 1e-5 for decode at f32).

- The prefill attention in bf16 at tests/test_kernels.py's dtype case
  and at head dims 16 and 32 (causal, non-causal, window, prefix), and
  in f32 at head dim 16.
- Decode over a bf16 cache (``k``, ``v``, ``kz``, ``vz`` bf16, a bf16
  query) and over an f32 cache with a bf16 query (the engine's bf16
  model over its f32 cache), in both decode modes, through the
  reference's two oracles (``flash_decode_combine``,
  ``prism_decode_attention``) and its kernel; f32 at head dims 16 and
  32.  Decode compares the normalised outputs, as the reference's own
  decode tests do.
- The dtypes that come out, and the wrappers' refusals: a dtype or head
  dim with no instance raises before any launch.

The CUDA kernels themselves run on a card only: ``chip_smoke.py`` holds
each new case to its plain version there.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import prism_attention_op as j_attention_op  # noqa: E402
from repro.kernels.ref import prism_attention_reference as j_attention_ref  # noqa: E402
from repro.runtime import serve as JS  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import decode_attention as TD  # noqa: E402
from repro_torch.kernels import prism_attention as TP  # noqa: E402
from repro_torch.kernels.ops import prism_attention_op  # noqa: E402
from repro_torch.runtime import serve as S  # noqa: E402

BF16_TOL = dict(atol=2e-2, rtol=1e-2)
F32_ATTN_TOL = dict(atol=2e-5, rtol=2e-4)
F32_DECODE_TOL = dict(atol=1e-5, rtol=1e-5)
BF = {"bf16": (torch.bfloat16, jnp.bfloat16),
      "f32": (torch.float32, jnp.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rounded(x: np.ndarray, dtype: str) -> np.ndarray:
    """x rounded to ``dtype`` and back to f32: the same values reach both
    packages, whichever rounds them."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(BF[dtype][0]).float().numpy()


def pair(x: np.ndarray, dtype: str):
    """(torch tensor, jax array) of x in ``dtype`` (x already rounded)."""
    return (torch.from_numpy(x).to(BF[dtype][0]),
            jnp.asarray(x).astype(BF[dtype][1]))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------
# prefill attention
# ---------------------------------------------------------------------

def attention_case(b, nq, m_loc, L, hq, hkv, hd, dtype, *, seed=0):
    """tests/test_kernels.py's case (m_loc exact columns, then L means of
    4 positions each) with q, k, v in ``dtype``."""
    rng = np.random.default_rng(seed)
    q, k, v = (rounded(rng.standard_normal(s) * 0.5, dtype) for s in (
        (b, nq, hq, hd), (b, m_loc + L, hkv, hd), (b, m_loc + L, hkv, hd)))
    g = np.concatenate([np.ones(m_loc), np.full(L, 4.0)]).astype(np.float32)
    lo = np.concatenate([np.arange(m_loc),
                         m_loc + 4 * np.arange(L)]).astype(np.int32)
    hi = np.concatenate([np.arange(m_loc),
                         m_loc + 4 * np.arange(L) + 3]).astype(np.int32)
    row = (np.arange(nq) + (m_loc - nq)).astype(np.int32)
    return (q, k, v), (g, lo, hi, row)


@pytest.mark.parametrize("dtype,shape", [
    ("bf16", (1, 32, 32, 8, 4, 2, 64)),   # tests/test_kernels.py's dtypes
    ("bf16", (1, 8, 8, 4, 1, 1, 16)),
    ("bf16", (1, 17, 33, 5, 6, 3, 32)),   # odd everything
    ("f32", (2, 24, 20, 4, 4, 2, 16)),
])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=8, prefix_len=6)])
def test_attention_plain_vs_reference(dtype, shape, kw):
    """The plain version of q's dtype against the reference's Pallas
    kernel (interpret mode) and its jnp oracle; the output in q's dtype
    on both sides."""
    (q, k, v), meta = attention_case(*shape, dtype)
    tq, tk, tv = (pair(x, dtype)[0] for x in (q, k, v))
    jq, jk, jv = (pair(x, dtype)[1] for x in (q, k, v))
    got = prism_attention_op(tq, tk, tv, *map(torch.from_numpy, meta), **kw)
    assert got.dtype == BF[dtype][0]
    g, lo, hi, row = map(jnp.asarray, meta)
    pallas = j_attention_op(jq, jk, jv, g, lo, hi, row, interpret=True,
                            **kw)
    oracle = j_attention_ref(jq, jk, jv,
                             jnp.where(g > 0, jnp.log(g), -1e30), lo, hi,
                             row, **kw)
    assert pallas.dtype == BF[dtype][1]
    tol = BF16_TOL if dtype == "bf16" else F32_ATTN_TOL
    for want in (pallas, oracle):
        np.testing.assert_allclose(f32(got), f32(want), **tol)


# ---------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------

def decode_case(b, m_loc, hq, hkv, hd, mz, q_dtype, kv_dtype, *, seed=0):
    """tests/test_decode_attention.py's case (per-row positions, one idle
    row at -1, prefix-valid columns, means with g 0 or 4) with the query
    in ``q_dtype`` and the cache (k, v, kz, vz) in ``kv_dtype``."""
    rng = np.random.default_rng(seed)
    q = rounded(rng.standard_normal((b, 1, hq, hd)) * 0.5, q_dtype)
    k, v, kz, vz = (rounded(rng.standard_normal(s) * 0.5, kv_dtype)
                    for s in ((b, m_loc, hkv, hd),) * 2
                    + ((b, mz, hkv, hd),) * 2)
    pos = rng.integers(-1, m_loc, size=b)
    pos[0] = m_loc - 1
    if b > 1:
        pos[1] = -1
    valid = np.arange(m_loc)[None, :] <= pos[:, None]
    gz = np.where(np.arange(mz)[None, :] % 3 == 0, 0.0, 4.0)
    gz = (gz * (pos >= 0)[:, None]).astype(np.float32)
    return dict(q=q, k=k, v=v, kz=kz, vz=vz, valid=valid, gz=gz, pos=pos,
                owner=pos >= 0, scale=hd ** -0.5)


def port_decode(c, q_dtype, kv_dtype, mode):
    """The port's decode attention over one shard (P = 1), normalised."""
    q = pair(c["q"], q_dtype)[0]
    k, v, kz, vz = (pair(c[n], kv_dtype)[0] for n in ("k", "v", "kz", "vz"))
    valid = torch.from_numpy(c["valid"])[:, None]
    if mode == "exact":
        return S.decode_attention(q, k[:, None], v[:, None], valid,
                                  c["scale"])
    return S.decode_attention(
        q, k[:, None], v[:, None], valid, c["scale"],
        gz=torch.from_numpy(c["gz"])[:, None], kz=kz, vz=vz,
        owner=torch.from_numpy(c["owner"])[:, None], mode="prism")


def reference_decode(c, q_dtype, kv_dtype, mode, backend):
    """The reference's ``decode_attention`` (its kernel in interpret mode,
    or its jnp path) and its dense oracle, normalised."""
    q = pair(c["q"], q_dtype)[1]
    k, v, kz, vz = (pair(c[n], kv_dtype)[1] for n in ("k", "v", "kz", "vz"))
    valid, gz = jnp.asarray(c["valid"]), jnp.asarray(c["gz"])
    owner = jnp.asarray(c["owner"])
    if mode == "exact":
        got = JS.decode_attention(q, k, v, valid, (), c["scale"],
                                  backend=backend)
        oracle = JS.flash_decode_combine(q, k, v, valid, (), c["scale"])
    else:
        got = JS.decode_attention(q, k, v, valid, (), c["scale"], gz=gz,
                                  kz=kz, vz=vz, owner=owner, mode="prism",
                                  backend=backend)
        oracle = JS.prism_decode_attention(q, k, v, kz, vz, valid, gz,
                                           owner, (), c["scale"])
    return got, oracle


DECODE_GRID = [
    # b, m_loc, hq, hkv, hd (tests/test_decode_attention.py's grid, and
    # an MQA row at 128)
    (4, 16, 2, 2, 16),
    (3, 33, 8, 2, 32),
    (2, 40, 4, 1, 128),
]


@pytest.mark.parametrize("q_dtype,kv_dtype", [("bf16", "bf16"),
                                              ("bf16", "f32")])
@pytest.mark.parametrize("shape", DECODE_GRID)
@pytest.mark.parametrize("mode", ["exact", "prism"])
def test_decode_plain_vs_reference(q_dtype, kv_dtype, shape, mode):
    """A bf16 cache and a bf16 query over an f32 cache, on live rows,
    against the reference's kernel and its jnp path and dense oracle,
    outputs in the cache's dtype; idle rows give exactly 0.  A bf16
    query is exact in f32, so over an f32 cache the reference's products
    are f32 ones and the tolerance is f32's."""
    c = decode_case(*shape, 6, q_dtype, kv_dtype, seed=sum(shape))
    got = port_decode(c, q_dtype, kv_dtype, mode)
    assert got.dtype == BF[kv_dtype][0]
    live = c["pos"] >= 0
    assert not f32(got)[~live].any()
    tol = BF16_TOL if kv_dtype == "bf16" else F32_DECODE_TOL
    for backend in ("pallas", "jnp"):
        want, oracle = reference_decode(c, q_dtype, kv_dtype, mode, backend)
        assert want.dtype == BF[kv_dtype][1]
        for ref in (want, oracle):
            np.testing.assert_allclose(f32(got)[live], f32(ref)[live],
                                       err_msg=backend, **tol)


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("mode", ["exact", "prism"])
def test_decode_f32_head_dims_16_and_32(hd, mode):
    """f32 at the small head dims the kernels now build, against the
    reference's kernel and oracle at its f32 tolerance."""
    c = decode_case(3, 33, 8, 2, hd, 6, "f32", "f32", seed=hd)
    got = port_decode(c, "f32", "f32", mode)
    live = c["pos"] >= 0
    want, oracle = reference_decode(c, "f32", "f32", mode, "pallas")
    for ref in (want, oracle):
        np.testing.assert_allclose(f32(got)[live], f32(ref)[live],
                                   **F32_DECODE_TOL)


def test_decode_stats_cast_the_means_to_the_cache():
    """The plain stats cast kz / vz to k's dtype, as the reference's
    ``kz.astype(k.dtype)``: f32 means over a bf16 cache give the bf16
    means' stats exactly."""
    c = decode_case(2, 12, 4, 2, 16, 6, "bf16", "bf16", seed=5)
    args = [pair(c[n], "bf16")[0] for n in ("q", "k", "v")]
    valid = torch.from_numpy(c["valid"])
    log_gz = torch.where(torch.from_numpy(c["gz"]) > 0,
                         torch.from_numpy(c["gz"]).log(), -1e30)
    kz, vz = (pair(c[n], "bf16")[0] for n in ("kz", "vz"))
    a = TD.decode_stats(*args, valid, log_gz, kz, vz, scale=c["scale"])
    b = TD.decode_stats(*args, valid, log_gz, kz.float(), vz.float(),
                        scale=c["scale"])
    for x, y in zip(a, b):
        assert x.dtype == torch.float32 and torch.equal(x, y)


# ---------------------------------------------------------------------
# the wrappers: instances and refusals
# ---------------------------------------------------------------------

def _stub_launches(monkeypatch):
    """The C entry points and the CUDA guard as stand-ins, the tensor
    checks' device test off: the calls reach ``dispatch.launch`` on the
    CPU, which records the library and entry of each."""
    import contextlib
    import types
    from repro_torch.kernels import build
    calls = []

    def function(lib, entry, argtypes):
        def fn(*args):
            calls.append((lib, entry))
            return 0
        return fn

    def check(t, name, *, dtype, ndim, device):
        dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: kernel takes {dtypes}, got {t.dtype}")
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (TD, TP):
        monkeypatch.setattr(mod, "check_tensor", check)
    return calls


def test_wrappers_pick_the_instance_by_dtype(monkeypatch):
    """The attention's bf16 instance is its own library; decode's library
    follows the cache's dtype, whatever the query's; each bf16 launch
    counts under ``.bf16`` too, a bf16 cache's under ``.kv_bf16``."""
    calls = _stub_launches(monkeypatch)
    dispatch.LAUNCHES.clear()
    bf, f = torch.bfloat16, torch.float32
    (q, k, v), meta = attention_case(1, 8, 8, 4, 2, 1, 16, "bf16")
    g, lo, hi, row = map(torch.from_numpy, meta)
    meta = (torch.log(g)[None], lo[None], hi[None], row[None])
    for dt in (bf, f):
        TP.prism_flash_attention(*(torch.from_numpy(x).to(dt)
                                   for x in (q, k, v)), *meta, causal=True)
    c = decode_case(2, 8, 4, 4, 32, 3, "bf16", "bf16")
    for qd, kd in ((bf, bf), (bf, f), (f, f), (f, bf)):
        TD.flash_decode_stats(torch.from_numpy(c["q"]).to(qd),
                              *(torch.from_numpy(c[n]).to(kd)
                                for n in ("k", "v")),
                              torch.from_numpy(c["valid"]),
                              scale=c["scale"])
    assert calls == [("prism_attention_bf16", "prism_attention_bf16"),
                     ("prism_attention", "prism_attention_f32"),
                     ("decode_attention_bf16", "flash_decode_stats_bf16"),
                     ("decode_attention", "flash_decode_stats_f32"),
                     ("decode_attention", "flash_decode_stats_f32"),
                     ("decode_attention_bf16", "flash_decode_stats_bf16")]
    assert dict(dispatch.LAUNCHES) == {
        "prism_flash_attention": 2, "prism_flash_attention.bf16": 1,
        "flash_decode_stats": 4, "flash_decode_stats.bf16": 3,
        "flash_decode_stats.kv_bf16": 2}
    dispatch.LAUNCHES.clear()


def test_wrappers_refuse_what_has_no_instance(monkeypatch):
    """fp16, mixed q / k dtypes in the prefill kernel, a bf16 V over an
    f32 K, and head dims no source builds raise before any launch."""
    calls = _stub_launches(monkeypatch)
    dispatch.LAUNCHES.clear()
    (q, k, v), meta = attention_case(1, 8, 8, 4, 2, 1, 16, "bf16")
    g, lo, hi, row = map(torch.from_numpy, meta)
    meta = (torch.log(g)[None], lo[None], hi[None], row[None])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        TP.prism_flash_attention(tq.half(), tk.half(), tv.half(), *meta,
                                 causal=True)
    with pytest.raises(TypeError, match="k: kernel takes"):
        TP.prism_flash_attention(tq.bfloat16(), tk, tv, *meta, causal=True)
    (q48, k48, v48), _ = attention_case(1, 8, 8, 4, 2, 1, 48, "bf16")
    with pytest.raises(ValueError, match="head dim 48 not in"):
        TP.prism_flash_attention(*(torch.from_numpy(x).bfloat16()
                                   for x in (q48, k48, v48)), *meta,
                                 causal=True)
    c = decode_case(2, 8, 4, 4, 32, 3, "bf16", "bf16")
    dq, dk, dv = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    valid = torch.from_numpy(c["valid"])
    with pytest.raises(TypeError, match="k: kernel takes"):
        TD.flash_decode_stats(dq, dk.half(), dv.half(), valid,
                              scale=c["scale"])
    with pytest.raises(TypeError, match="v: kernel takes"):
        TD.flash_decode_stats(dq, dk, dv.bfloat16(), valid, scale=1.0)
    c48 = decode_case(2, 8, 4, 4, 48, 3, "bf16", "bf16")
    with pytest.raises(ValueError, match="head dim 48 not in"):
        TD.flash_decode_stats(*(torch.from_numpy(c48[n]).bfloat16()
                                for n in ("q", "k", "v")), valid,
                              scale=c48["scale"])
    assert calls == [] and sum(dispatch.LAUNCHES.values()) == 0
