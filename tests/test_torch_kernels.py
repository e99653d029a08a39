"""The port's kernel modules on the CPU: each plain version against the
JAX jnp oracle and the JAX Pallas kernel run with ``interpret=True``, at
the tolerances of tests/test_kernels.py and tests/test_decode_attention.py
and a few of their shapes (GQA ratios, ragged M, pos = -1 rows, means
columns, per-shard metadata, bf16 segment means).  Also: the PRISM
augment's plain version against a numpy construction, the dispatch rule,
and that a CUDA-only path raises cleanly without a card (no fallback).

The CUDA kernels themselves build and run only on a card: chip_smoke.py
compares them with their plain versions there.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as JD  # noqa: E402
from repro.kernels.ops import prism_attention_op as j_attention_op  # noqa: E402
from repro.kernels.ref import prism_attention_reference as j_attention_ref  # noqa: E402
from repro.kernels.segment_means import segment_means_op as j_means_op  # noqa: E402
from repro.core.segment_means import segment_means as j_means  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels import decode_attention as TD  # noqa: E402
from repro_torch.core.masks import NEG_INF, visibility  # noqa: E402
from repro_torch.kernels.ops import prism_attention_op  # noqa: E402
from repro_torch.kernels.prism_attention import (  # noqa: E402
    prism_attention_reference, prism_flash_attention)
from repro_torch.kernels.segment_means import (  # noqa: E402
    prism_augment_cuda, prism_augment_op, prism_augment_plain,
    segment_means_cuda, segment_means_op)
from repro_torch.sharding.context import means_columns  # noqa: E402

T = torch.as_tensor


# ---------------------------------------------------------------------
# inputs (numpy, seeded)
# ---------------------------------------------------------------------

def attention_case(b, nq, m_loc, L, hq, hkv, hd, *, seed=0):
    """tests/test_kernels.py's case: m_loc exact columns, then L means
    each covering 4 positions of a remote partition ahead."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, nq, hq, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, m_loc + L, hkv, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, m_loc + L, hkv, hd)) * 0.5).astype(np.float32)
    g = np.concatenate([np.ones(m_loc), np.full(L, 4.0)]).astype(np.float32)
    lo = np.concatenate([np.arange(m_loc),
                         m_loc + 4 * np.arange(L)]).astype(np.int32)
    hi = np.concatenate([np.arange(m_loc),
                         m_loc + 4 * np.arange(L) + 3]).astype(np.int32)
    row = (np.arange(nq) + (m_loc - nq)).astype(np.int32)
    return q, k, v, g, lo, hi, row


def decode_case(b, m_loc, hq, hkv, hd, *, mz=0, seed=0):
    """tests/test_decode_attention.py's case: per-row positions (one
    idle row at pos = -1), prefix-valid columns, optional means columns
    with a per-row g (0 = dead)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, 1, hq, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, m_loc, hkv, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, m_loc, hkv, hd)) * 0.5).astype(np.float32)
    pos = rng.integers(-1, m_loc, size=b)
    pos[0] = m_loc - 1
    if b > 1:
        pos[1] = -1
    valid = np.arange(m_loc)[None, :] <= pos[:, None]
    case = dict(q=q, k=k, v=v, valid=valid, pos=pos, scale=hd ** -0.5)
    if mz:
        case["kz"] = (rng.standard_normal((b, mz, hkv, hd)) * 0.5).astype(
            np.float32)
        case["vz"] = (rng.standard_normal((b, mz, hkv, hd)) * 0.5).astype(
            np.float32)
        gz = np.where(np.arange(mz)[None, :] % 3 == 0, 0.0, 4.0)
        gz = (gz * (pos >= 0)[:, None]).astype(np.float32)
        case["log_gz"] = np.where(gz > 0, np.log(np.maximum(gz, 1e-30)),
                                  -1e30).astype(np.float32)
    return case


def assert_stats_close(got, want):
    """Decode stats (m, l, acc): l and acc everywhere, m where the row
    has a live column (an all-dead row's m is only the sentinel)."""
    m_g, l_g, a_g = (np.asarray(t) for t in got)
    m_w, l_w, a_w = (np.asarray(t) for t in want)
    np.testing.assert_allclose(l_g, l_w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(a_g, a_w, atol=1e-5, rtol=1e-5)
    alive = l_w > 0
    np.testing.assert_allclose(m_g[alive], m_w[alive], atol=1e-6, rtol=1e-6)


GQA_GRID = [
    (4, 16, 2, 2, 16),           # MHA
    (3, 33, 8, 2, 32),           # GQA 4:1, ragged M
    (2, 100, 6, 3, 64),          # GQA 2:1, ragged M
    (1, 7, 4, 4, 16),            # shorter than one block
]


# ---------------------------------------------------------------------
# prefill attention
# ---------------------------------------------------------------------

def j_log_g(g):
    return jnp.where(jnp.asarray(g) > 0, jnp.log(jnp.asarray(g)), -1e30)


@pytest.mark.parametrize("b,nq,m_loc,L,hq,hkv,hd", [
    (2, 16, 16, 8, 4, 2, 32),
    (1, 17, 33, 5, 6, 3, 32),         # odd everything, ragged M
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_vs_reference(b, nq, m_loc, L, hq, hkv, hd, causal):
    q, k, v, g, lo, hi, row = attention_case(b, nq, m_loc, L, hq, hkv, hd)
    got = prism_attention_op(T(q), T(k), T(v), T(g), T(lo), T(hi), T(row),
                             causal=causal).numpy()
    want_ref = j_attention_ref(*map(jnp.asarray, (q, k, v)), j_log_g(g),
                               *map(jnp.asarray, (lo, hi, row)),
                               causal=causal)
    want_pallas = j_attention_op(*map(jnp.asarray, (q, k, v, g, lo, hi,
                                                    row)),
                                 causal=causal, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=2e-5,
                               rtol=2e-4)
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=2e-5,
                               rtol=2e-4)


@pytest.mark.parametrize("kw", [dict(window=8), dict(prefix_len=6),
                                dict(window=16, prefix_len=4)])
def test_attention_window_and_prefix(kw):
    q, k, v, g, lo, hi, row = attention_case(1, 32, 32, 4, 2, 1, 32)
    got = prism_attention_op(T(q), T(k), T(v), T(g), T(lo), T(hi), T(row),
                             causal=True, **kw).numpy()
    want = j_attention_op(*map(jnp.asarray, (q, k, v, g, lo, hi, row)),
                          causal=True, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-4)


def test_attention_g_zero_and_dead_rows():
    """g = 0 columns get no weight; a row that sees nothing gives 0."""
    q, k, v, g, lo, hi, row = attention_case(1, 16, 16, 4, 2, 2, 32)
    g0 = g.copy()
    g0[-2:] = 0.0
    row = row.copy()
    row[0] = -1                                   # sees no column
    got = prism_attention_op(T(q), T(k), T(v), T(g0), T(lo), T(hi), T(row),
                             causal=True).numpy()
    want = prism_attention_op(T(q), T(k[:, :-2]), T(v[:, :-2]), T(g[:-2]),
                              T(lo[:-2]), T(hi[:-2]), T(row),
                              causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)
    assert not got[:, 0].any()
    pallas = j_attention_op(*map(jnp.asarray, (q, k, v, g0, lo, hi, row)),
                            causal=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=2e-4)


def test_attention_per_shard_metadata_and_shared_kv():
    """P shards folded into the batch, each with its own (P, M) / (P, Nq)
    metadata, equal P separate reference calls; K/V with batch B / rep is
    read by rep consecutive query rows (the voltage layout)."""
    p, nq, m, hq, hkv, hd = 3, 8, 20, 4, 2, 16
    rng = np.random.default_rng(9)
    q = (rng.standard_normal((2 * p, nq, hq, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((2, m, hkv, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((2, m, hkv, hd)) * 0.5).astype(np.float32)
    g = rng.integers(0, 4, size=(p, m)).astype(np.float32)
    lo = rng.integers(0, 24, size=(p, m)).astype(np.int32)
    hi = (lo + rng.integers(0, 3, size=(p, m))).astype(np.int32)
    row = (np.arange(nq)[None] + 8 * np.arange(p)[:, None]).astype(np.int32)
    got = prism_attention_op(T(q), T(k), T(v), T(g), T(lo), T(hi), T(row),
                             causal=True).numpy()
    for i in range(2 * p):
        s = i % p
        want = j_attention_op(jnp.asarray(q[i:i + 1]),
                              jnp.asarray(k[i // p:i // p + 1]),
                              jnp.asarray(v[i // p:i // p + 1]),
                              *map(jnp.asarray, (g[s], lo[s], hi[s], row[s])),
                              causal=True, interpret=True)
        np.testing.assert_allclose(got[i:i + 1], np.asarray(want),
                                   atol=2e-5, rtol=2e-4, err_msg=str(i))


def _tf32(x, *, round_=True):
    """x cut to TF32 (10 mantissa bits) on the f32 bit pattern: rounded
    to nearest with ties away from zero (``cvt.rna.tf32.f32``), or
    truncated, as the tensor core reads an operand's top 19 bits."""
    bits = x.contiguous().view(torch.int32)
    return (((bits + 0x1000) if round_ else bits) & -0x2000).view(
        torch.float32)


def _mm_3xtf32(a, b):
    """a @ b from TF32 parts with f32 accumulation, as the kernel forms
    it: hi rounded, lo = x - hi truncated by the tensor core; lo·hi, then
    hi·lo, then hi·hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, round_=False), _tf32(b - bh, round_=False)
    return (al @ bh + ah @ bl) + ah @ bh


def _attention_3xtf32(q, k, v, log_g, lo, hi, row, *, causal, window,
                      q_tile=64, k_tile=32):
    """csrc/prism_attention.cu's arithmetic on the CPU (one shard of
    metadata): query tiles of 64 rows, the block's tile-skip rule from
    each column's own [lo, hi] against the tile's row-position range,
    an online softmax in the log2 domain over the kept 32-column tiles,
    and both products in 3xTF32.  Returns the output and the number of
    (query tile, K tile) pairs skipped; a skipped pair must hold no
    visible live column."""
    b, nq, hq, hd = q.shape
    m = k.shape[1]
    grp = hq // k.shape[2]
    scale, log2e = hd ** -0.5, 1.4426950408889634
    kh = k.repeat_interleave(grp, 2).transpose(1, 2)        # (b, hq, m, hd)
    vh = v.repeat_interleave(grp, 2).transpose(1, 2)
    live = visibility(row, lo, hi, causal=causal, window=window) & (
        log_g > NEG_INF / 2)[None, :]                        # (nq, m)
    out = torch.zeros_like(q)
    skipped = 0
    for q0 in range(0, nq, q_tile):
        rows = slice(q0, q0 + q_tile)
        rmin, rmax = int(row[rows].min()), int(row[rows].max())
        a = torch.maximum(hi, torch.tensor(rmin)) if causal else \
            torch.full_like(hi, rmin)
        z = (torch.minimum(lo + window - 1, torch.tensor(rmax))
             if window is not None else torch.full_like(lo, rmax))
        maybe = (a <= z) & (log_g > NEG_INF / 2)
        qt = q[:, rows].transpose(1, 2)                     # (b, hq, r, hd)
        m_run = torch.full(qt.shape[:3], -torch.inf)
        l_run = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for c0 in range(0, m, k_tile):
            cols = slice(c0, c0 + k_tile)
            if not maybe[cols].any():
                assert not live[rows, cols].any()
                skipped += 1
                continue
            x = (_mm_3xtf32(qt, kh[:, :, cols].transpose(-1, -2)) * scale
                 + log_g[cols]) * log2e
            x = torch.where(live[rows, cols], x, -torch.inf)
            m_new = torch.maximum(m_run, x.amax(-1))
            m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
            corr = torch.exp2(m_run - m_use)
            p = torch.exp2(x - m_use[..., None])
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + _mm_3xtf32(p, vh[:, :, cols])
            m_run = m_new
        out[:, rows] = (acc / l_run.clamp(min=1e-30)[..., None]).transpose(
            1, 2)
    return out, skipped


@pytest.mark.parametrize("causal,window,shuffle", [
    (True, None, False), (True, 40, False), (False, 50, False),
    (True, None, True)])
def test_attention_3xtf32_tiles_match_plain(causal, window, shuffle):
    """The kernel's tensor-core arithmetic (3xTF32) with its tile
    skipping stays within the kernel-vs-plain tolerance of the f32
    plain version at the main path's input scale (0.5·randn): Nq 130
    and M 200 are off the 64-row and 32-column tiles; the means lie ahead of every row, so
    whole tiles are skipped; shuffled columns are the PRISM layout's
    unsorted positions."""
    q, k, v, g, lo, hi, row = attention_case(2, 130, 150, 50, 4, 2, 64,
                                             seed=21)
    if shuffle:
        perm = np.random.default_rng(5).permutation(k.shape[1])
        k, v, g, lo, hi = k[:, perm], v[:, perm], g[perm], lo[perm], hi[perm]
    log_g = torch.where(T(g) > 0, T(g).log(), torch.tensor(NEG_INF))
    got, skipped = _attention_3xtf32(T(q), T(k), T(v), log_g, T(lo), T(hi),
                                     T(row), causal=causal, window=window)
    want = prism_attention_reference(T(q), T(k), T(v), log_g[None],
                                     T(lo)[None], T(hi)[None], T(row)[None],
                                     causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-4)
    assert shuffle or skipped > 0


# ---------------------------------------------------------------------
# segment means
# ---------------------------------------------------------------------

@pytest.mark.parametrize("b,n,L,d", [(1, 16, 4, 8), (2, 128, 16, 512),
                                     (3, 32, 32, 16), (1, 17, 4, 8),
                                     (2, 100, 16, 64), (1, 9, 1, 16)])
def test_segment_means_plain_vs_reference(b, n, L, d):
    """Even and Eq. 8 ragged splits: plain == jnp oracle == Pallas."""
    x = np.random.default_rng(2).standard_normal((b, n, d)).astype(
        np.float32)
    got = segment_means_op(T(x), L=L).numpy()
    np.testing.assert_allclose(got, np.asarray(j_means(jnp.asarray(x), L)),
                               atol=1e-5, rtol=1e-5)
    pallas = j_means_op(jnp.asarray(x), L=L, block_d=min(512, d),
                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,n,L,d", [(2, 64, 8, 64), (1, 17, 4, 8),
                                     (3, 32, 32, 16), (1, 9, 1, 16)])
def test_segment_means_bf16_vs_reference(b, n, L, d):
    """bf16 in, bf16 out, summed in f32: plain == jnp oracle == Pallas
    at the reference's bf16 tolerance (tests/test_kernels.py)."""
    x = np.random.default_rng(3).standard_normal((b, n, d)).astype(
        np.float32)
    xt = T(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    got = segment_means_op(xt, L=L)
    assert got.dtype == torch.bfloat16 and got.shape == (b, L, d)
    got = got.float().numpy()
    want = np.asarray(j_means(xj, L), np.float32)
    pallas = np.asarray(j_means_op(xj, L=L, block_d=min(512, d),
                                   interpret=True), np.float32)
    np.testing.assert_allclose(got, want, atol=1e-2)
    np.testing.assert_allclose(got, pallas, atol=1e-2)


def numpy_augment(x, L, n_shards):
    """[x_local ; every shard's means, shard-major] per shard row, from
    the JAX package's segment means."""
    bp, n, d = x.shape
    z = np.asarray(j_means(jnp.asarray(x), L))               # (B·P, L, D)
    rows = []
    for r in range(bp):
        seq = r - r % n_shards
        rows.append(np.concatenate([x[r]] + [z[seq + q]
                                             for q in range(n_shards)]))
    return np.stack(rows)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("n_loc,L", [(16, 4), (17, 4), (9, 1), (12, 12),
                                     (7, 7)])
def test_prism_augment_plain_vs_numpy(n_shards, n_loc, L):
    """The augment's plain version: even and ragged n_loc, L = 1 and
    L = n_loc, against a numpy construction of x_hat."""
    x = np.random.default_rng(4).standard_normal(
        (2 * n_shards, n_loc, 24)).astype(np.float32)
    got = prism_augment_op(T(x), L=L, n_shards=n_shards)
    assert got.shape == (2 * n_shards, n_loc + n_shards * L, 24)
    np.testing.assert_allclose(got.numpy(), numpy_augment(x, L, n_shards),
                               atol=1e-5, rtol=1e-5)
    bf = prism_augment_plain(T(x).to(torch.bfloat16), L, n_shards)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(),
                               numpy_augment(x, L, n_shards), atol=1e-2)


@pytest.mark.parametrize("n_shards,n_loc,L", [(1, 16, 4), (4, 17, 4),
                                              (2, 9, 1), (4, 8, 8)])
def test_means_columns_match_concatenated_metadata(n_shards, n_loc, L):
    """The cached x_hat columns equal the local rows' positions followed
    by the means columns, as the per-layer concatenation built them."""
    cols = means_columns(n_shards, n_loc, L, torch.device("cpu"))
    rows = (torch.arange(n_shards)[:, None] * n_loc
            + torch.arange(n_loc)).to(torch.int32)
    m = n_shards * L
    assert torch.equal(cols.col_lo, torch.cat(
        [rows, cols.lo.expand(n_shards, m)], dim=1))
    assert torch.equal(cols.col_hi, torch.cat(
        [rows, cols.hi.expand(n_shards, m)], dim=1))
    assert torch.equal(cols.col_g, torch.cat(
        [torch.ones(n_shards, n_loc), cols.g], dim=1))
    assert cols.col_lo.dtype == cols.col_hi.dtype == torch.int32
    # the own shard's means are dead, the others' weigh their sizes
    for p in range(n_shards):
        own = slice(p * L, (p + 1) * L)
        others = torch.ones(m, dtype=torch.bool)
        others[own] = False
        assert torch.equal(cols.g[p, own], torch.zeros(L))
        assert torch.equal(cols.g[p, others], cols.sizes[others])


@pytest.mark.parametrize("entry", ["segment_means", "prism_augment"])
@pytest.mark.parametrize("dtype,accepted", [(torch.float32, True),
                                            (torch.bfloat16, True),
                                            (torch.float16, False),
                                            (torch.float64, False)])
def test_segment_means_entries_check_dtype(entry, dtype, accepted):
    """Both CUDA entries take f32 and bf16 and refuse other dtypes; on a
    CPU tensor an accepted dtype still raises for want of a card, and no
    launch is counted."""
    dispatch.LAUNCHES.clear()
    x = torch.zeros(4, 8, 16, dtype=dtype)
    call = {"segment_means": lambda: segment_means_cuda(x, 2),
            "prism_augment": lambda: prism_augment_cuda(x, 2, 2)}[entry]
    if accepted:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    else:
        with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
            call()
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        prism_augment_op(x, L=2, n_shards=2, backend="kernel")
    assert sum(dispatch.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------
# flash-decode stats
# ---------------------------------------------------------------------

@pytest.mark.parametrize("b,m_loc,hq,hkv,hd", GQA_GRID)
@pytest.mark.parametrize("mz", [0, 6])
def test_decode_plain_vs_reference(b, m_loc, hq, hkv, hd, mz):
    """Against the jnp oracle everywhere, and against the Pallas kernel
    with means columns (the superset of its two streams)."""
    c = decode_case(b, m_loc, hq, hkv, hd, mz=mz, seed=b + m_loc)
    names = ("q", "k", "v", "valid") + (("log_gz", "kz", "vz") if mz else ())
    got = TD.decode_stats(*(T(c[n]) for n in names), scale=c["scale"])
    want = JD.decode_stats_reference(*(jnp.asarray(c[n]) for n in names),
                                     scale=c["scale"])
    assert_stats_close(got, want)
    if mz:
        pallas = JD.flash_decode_stats(*(jnp.asarray(c[n]) for n in names),
                                       scale=c["scale"], interpret=True)
        assert_stats_close(got, pallas)
    idle = c["pos"] < 0                           # exactly-empty stats
    assert not got[1].numpy()[idle].any() and not got[2].numpy()[idle].any()


def test_decode_folded_shards_equal_per_shard_calls():
    """rep shards folded into the batch (each with its own cache shard,
    valid and means bias, sharing the query and the means) equal one
    reference call per shard."""
    rep, bq, m_loc, hq, hkv, hd, mz = 4, 1, 12, 4, 2, 16, 8
    c = decode_case(bq * rep, m_loc, hq, hkv, hd, mz=mz, seed=11)
    q, kz, vz = c["q"][:bq], c["kz"][:bq], c["vz"][:bq]
    got = TD.decode_stats(T(q), T(c["k"]), T(c["v"]), T(c["valid"]),
                          T(c["log_gz"]), T(kz), T(vz), scale=c["scale"])
    for i in range(bq * rep):
        want = JD.flash_decode_stats(
            jnp.asarray(q[i // rep:i // rep + 1]),
            *(jnp.asarray(c[n][i:i + 1]) for n in ("k", "v", "valid",
                                                    "log_gz")),
            jnp.asarray(kz[i // rep:i // rep + 1]),
            jnp.asarray(vz[i // rep:i // rep + 1]),
            scale=c["scale"], interpret=True)
        assert_stats_close([t[i:i + 1] for t in got], want)


def test_merge_stats_is_concat():
    c = decode_case(3, 24, 4, 2, 16, seed=5)
    q, k, v = T(c["q"]), T(c["k"]), T(c["v"])
    bias = torch.where(T(c["valid"]), 0.0, -1e30)
    whole = TD.partial_softmax_stats(q, k, v, bias, c["scale"])
    for cut in (1, 8, 23):
        a = TD.partial_softmax_stats(q, k[:, :cut], v[:, :cut],
                                     bias[:, :cut], c["scale"])
        b = TD.partial_softmax_stats(q, k[:, cut:], v[:, cut:],
                                     bias[:, cut:], c["scale"])
        _, l, acc = TD.merge_stats(a, b)
        np.testing.assert_allclose(l, whole[1], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(acc, whole[2], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mz", [0, 20])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5, 8, None, "warps"])
def test_decode_chunked_merge_equals_unsplit(n_chunks, mz):
    """What csrc/decode_attention.cu's merge must compute: a row's
    columns (its cache shard, then the means) split into sets, partial
    stats per set, merged in order with ``merge_stats``, equal the
    unsplit plain version at every split: contiguous chunks (None: one
    column per chunk), and the kernel's own split over its 4 warps, each
    taking every fourth group of 16 columns.  Row 1 is all dead, row 2
    sees 3 local columns and 4 means (so some sets hold no live column),
    and the shards are folded (rep = 2)."""
    rep, bq, m_loc, hq, hkv, hd = 2, 2, 45, 6, 2, 16
    c = decode_case(bq * rep, m_loc, hq, hkv, hd, mz=max(mz, 1), seed=13)
    pos = np.array([m_loc - 1, -1, 2, 30])
    valid = T(np.arange(m_loc)[None, :] <= pos[:, None])
    q, k, v = T(c["q"][:bq]), T(c["k"]), T(c["v"])
    args = [q, k, v, valid]
    bias = torch.where(valid, 0.0, NEG_INF)
    kc, vc = k, v
    if mz:
        log_gz = T(c["log_gz"][:, :mz]).clone()
        log_gz[1] = NEG_INF
        log_gz[2, 4:] = NEG_INF
        kz, vz = T(c["kz"][:bq, :mz]), T(c["vz"][:bq, :mz])
        args += [log_gz, kz, vz]
        bias = torch.cat([bias, log_gz], dim=1)
        kc = torch.cat([k, kz.repeat_interleave(rep, 0)], dim=1)
        vc = torch.cat([v, vz.repeat_interleave(rep, 0)], dim=1)
    want = TD.decode_stats_reference(*args, scale=c["scale"])
    q_rows = q.repeat_interleave(rep, 0)
    stats = None
    n_cols = kc.shape[1]
    if n_chunks == "warps":
        group = np.arange(n_cols) // 16
        sets = [np.flatnonzero(group % 4 == w) for w in range(4)]
        sets = [cols for cols in sets if len(cols)]   # a warp of no column
    else:
        sets = np.array_split(np.arange(n_cols), n_chunks or n_cols)
    for cols in sets:
        part = TD.partial_softmax_stats(q_rows, kc[:, cols], vc[:, cols],
                                        bias[:, cols], c["scale"])
        stats = part if stats is None else TD.merge_stats(stats, part)
    assert_stats_close(stats, want)
    assert not stats[1][1].any() and not stats[2][1].any()   # dead row


def _round_to_zero(x):
    """float64 x to float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_3xtf32(c, a, b):
    """c + a @ b as a chain of m16n8k8 mma.sync in 3xTF32, modelling the
    tensor core: per 8-deep k-step, lo·hi, hi·lo, then hi·hi, each mma's
    exact products added to c and the sum truncated to f32 (rounded
    toward zero, as the card accumulates)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, round_=False), _tf32(b - bh, round_=False)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            c = _round_to_zero(c.double() + x[..., ks].double()
                               @ y[..., ks, :].double())
    return c


def _decode_3xtf32(q, k, v, valid, log_gz=None, kz=None, vz=None, *,
                   scale, tile=32):
    """csrc/decode_attention.cu's tile route on the CPU: each output
    row's column bias (log2 domain, -inf for a dead column), its local
    32-column tiles then its means tiles in order, a tile with no live
    column skipped (the state untouched), both products as chains of
    3xTF32 mma (``_mma_3xtf32``), S from zero, each tile's PV in an
    accumulator of its own added to the rescaled acc in f32, the online
    softmax rescaled once per tile; m back in natural-log units, a row
    with no live column (NEG, 0, 0).  Returns the stats and the number
    of (output row, tile) pairs skipped."""
    log2e = 1.4426950408889634
    b, m_loc, hkv, hd = k.shape
    rep = b // q.shape[0]
    hq = q.shape[2]
    grp = hq // hkv
    qg = q[:, 0].repeat_interleave(rep, 0).reshape(b, hkv, grp, hd)
    bias = torch.where(valid, 0.0, -torch.inf)
    sets = [(k, v, bias)]
    if kz is not None:
        sets.append((kz.repeat_interleave(rep, 0),
                     vz.repeat_interleave(rep, 0),
                     torch.where(log_gz > NEG_INF / 2, log_gz * log2e,
                                 -torch.inf)))
    m_run = torch.full((b, hkv, grp), -torch.inf)
    l_run = torch.zeros(b, hkv, grp)
    acc = torch.zeros(b, hkv, grp, hd)
    skipped = 0
    for kk, vv, bb in sets:
        for c0 in range(0, kk.shape[1], tile):
            cols = slice(c0, c0 + tile)
            bt = bb[:, cols]                               # (b, n)
            live = (bt > -torch.inf).any(1)                # (b,)
            skipped += int((~live).sum())
            kt = torch.where(bt[..., None, None] > -torch.inf, kk[:, cols],
                             0.0).transpose(1, 2)          # (b, hkv, n, hd)
            vt = torch.where(bt[..., None, None] > -torch.inf, vv[:, cols],
                             0.0).transpose(1, 2)
            s = _mma_3xtf32(torch.zeros(b, hkv, grp, kt.shape[2]), qg,
                            kt.transpose(-1, -2))          # (b, hkv, grp, n)
            x = torch.where(bt[:, None, None] > -torch.inf,
                            s * (scale * log2e) + bt[:, None, None],
                            -torch.inf)
            m_new = torch.maximum(m_run, x.amax(-1))
            m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
            corr = torch.exp2(m_run - m_use)
            p = torch.exp2(x - m_use[..., None])
            keep = live[:, None, None]
            l_run = torch.where(keep, l_run * corr + p.sum(-1), l_run)
            pv = _mma_3xtf32(torch.zeros_like(acc), p, vt)
            acc = torch.where(keep[..., None], acc * corr[..., None] + pv,
                              acc)
            m_run = torch.where(keep, m_new, m_run)
    m = torch.where(m_run == -torch.inf, NEG_INF, m_run / log2e)
    return ((m.reshape(b, hq, 1, 1), l_run.reshape(b, hq, 1, 1),
             acc.reshape(b, 1, hq, hd)), skipped)


@pytest.mark.parametrize("means", [False, True])
@pytest.mark.parametrize("offsets", [(0,) * 4, (64,) * 4, (448,) * 4,
                                     (448, 384, 320, 256)])
def test_decode_3xtf32_tiles_match_plain(offsets, means):
    """The tile route's tensor-core arithmetic (3xTF32 with the card's
    truncating accumulation, 32-column tiles, dead tiles skipped, one
    rescale a tile, a PV accumulator per tile) stays within the decode
    kernel's (1e-5, 1e-5) tolerance of the f32 plain version at the chunk
    layout (one PV chain over every tile misses it here, as it did on
    the card): a chunk of 64 queries folded into the head axis (group 64 of
    12 KV heads), the whole cache rows (8 rows of 4 shards of cap_l 144)
    at 0.5·randn, valid = col_pos < offset; with means, 128 columns whose g is 0 in a whole
    32-column tile, in scattered columns, and everywhere in one row.
    Every layout here holds whole dead tiles, and each is skipped."""
    from repro_torch.runtime.serve import (ServeHParams, _decode_cols,
                                           make_layout)
    n_seq, hkv, grp, hd = 4, 12, 64, 64
    lay = make_layout(n_seq, 576, ServeHParams(), prefill_len=512)
    _, _, col_pos = _decode_cols(lay, torch.zeros(1, dtype=torch.long))
    off = torch.tensor(offsets).repeat_interleave(2)      # 8 cache rows
    valid = (col_pos[None] < off[:, None, None]).reshape(-1, lay.cap_l)
    b = valid.shape[0]
    rng = np.random.default_rng(5)

    def rnd(*shape):
        return T((0.5 * rng.standard_normal(shape)).astype(np.float32))
    q = rnd(len(off), 1, hkv * grp, hd)
    k, v = rnd(b, lay.cap_l, hkv, hd), rnd(b, lay.cap_l, hkv, hd)
    args = [q, k, v, valid]
    if means:
        mz = 128
        g = T(rng.integers(0, 5, (b, mz)).astype(np.float32))
        g[:, 32:64] = 0.0                      # a whole dead means tile
        g[1] = 0.0                             # a row with no live mean
        log_gz = torch.where(g > 0, g.log(), torch.tensor(NEG_INF))
        args += [log_gz, rnd(len(off), mz, hkv, hd),
                 rnd(len(off), mz, hkv, hd)]
    scale = hd ** -0.5
    got, skipped = _decode_3xtf32(*args, scale=scale)
    want = TD.decode_stats_reference(*args, scale=scale)
    m_g, l_g, a_g = (t.numpy() for t in got)
    m_w, l_w, a_w = (t.numpy() for t in want)
    np.testing.assert_allclose(l_g, l_w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(a_g, a_w, atol=1e-5, rtol=1e-5)
    alive = l_w > 0
    np.testing.assert_allclose(m_g[alive], m_w[alive], atol=1e-5,
                               rtol=1e-5)
    assert (m_g[~alive] == NEG_INF).all()
    pad = -lay.cap_l % 32
    dead = ~torch.nn.functional.pad(valid, (0, pad)).reshape(
        b, -1, 32).any(-1)
    want_skipped = int(dead.sum())
    if means:
        want_skipped += int((~(log_gz > NEG_INF / 2).reshape(
            b, -1, 32).any(-1)).sum())
    assert skipped == want_skipped > 0


@pytest.mark.parametrize("hq,hkv,no_rows,route", [
    (64 * 12, 12, True, "tile"),      # the chunk layout: C = 64 folded
    (12, 12, True, "row"),            # static decode: one token a row
    (12, 12, False, "row"),           # a packed tick: the row map
    (64 * 12, 12, False, "row"),      # a row map always takes the row route
    (4, 1, True, "tile"),             # the measured crossover
    (3, 1, True, "row"), (24, 8, True, "row"), (2, 1, True, "row"),
    (16, 1, True, "tile"), (48, 12, True, "tile"), (40, 1, True, "tile"),
    (128, 2, True, "tile"), (4, 1, False, "row"),
])
def test_decode_route_rule(hq, hkv, no_rows, route):
    """The wrapper's fixed rule: the tile route for a group of at least
    TILE_MIN_GROUP (4, the measured crossover) query heads a KV head and
    no row map, else the row route."""
    assert TD.decode_route(hq, hkv, no_rows) == route
    assert TD.TILE_MIN_GROUP == 4


def test_decode_tile_route_raises_without_a_card():
    """At the chunk layout (the tile route's shapes) CPU tensors still
    raise on every kernel entry, and no launch is counted; the tile route
    takes no row map and an unknown route is refused."""
    dispatch.LAUNCHES.clear()
    c = decode_case(4, 40, 64, 1, 64)
    args = [T(c[n]) for n in ("q", "k", "v", "valid")]
    assert TD.decode_route(64, 1, True) == "tile"
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        TD.decode_stats(*args, scale=c["scale"], backend="kernel")
    with pytest.raises(ValueError, match="CUDA tensor"):
        TD.flash_decode_stats(*args, scale=c["scale"])
    for route in TD.ROUTES:
        with pytest.raises(ValueError, match="CUDA tensor"):
            TD.launch_route(route, *args, scale=c["scale"])
    with pytest.raises(ValueError, match="not in"):
        TD.launch_route("cluster", *args, scale=c["scale"])
    assert sum(dispatch.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------
# dispatch: no fallback, clean failure without a card
# ---------------------------------------------------------------------

def test_dispatch_rule_has_no_fallback(monkeypatch):
    x = torch.zeros(2, 3)
    assert dispatch.use_kernel("auto", x) is False
    assert dispatch.use_kernel("plain", x) is False
    with pytest.raises(RuntimeError):
        dispatch.use_kernel("kernel", x)          # never quietly plain
    with pytest.raises(ValueError):
        dispatch.use_kernel("cuda", x)
    # the reference's env override does not exist here
    monkeypatch.setenv("PRISM_KERNEL_BACKEND", "kernel")
    assert dispatch.use_kernel("auto", x) is False
    with pytest.raises(RuntimeError):
        segment_means_op(torch.zeros(1, 4, 8), L=2, backend="kernel")


def test_cuda_paths_raise_without_a_card():
    """The kernel wrappers refuse CPU tensors (no hidden plain path), the
    entry point refuses a missing card, and no launch is counted."""
    dispatch.LAUNCHES.clear()
    q, k, v, g, lo, hi, row = attention_case(1, 8, 8, 4, 1, 1, 64)
    meta = (T(np.log(g))[None], T(lo)[None], T(hi)[None], T(row)[None])
    with pytest.raises(ValueError, match="CUDA tensor"):
        prism_flash_attention(T(q), T(k), T(v), *meta, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_means_cuda(torch.zeros(1, 4, 8), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        prism_augment_cuda(torch.zeros(2, 4, 8), 2, 2)
    c = decode_case(2, 8, 2, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TD.flash_decode_stats(T(c["q"]), T(c["k"]), T(c["v"]),
                              T(c["valid"]), scale=c["scale"])
    assert sum(dispatch.LAUNCHES.values()) == 0
    if not torch.cuda.is_available():
        from repro_torch.launch.serve import setup
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup(batch=1, prompt_len=8, gen=2, device="cuda")


def test_kernel_wrappers_check_dtype_and_layout():
    """check_tensor raises on dtype, rank, contiguity and a CPU tensor;
    a nonzero CUDA error code raises."""
    cpu = torch.device("cpu")
    kw = dict(dtype=torch.float32, ndim=2, device=cpu)
    with pytest.raises(TypeError, match="takes torch.float32"):
        dispatch.check_tensor(torch.zeros(2, 3, dtype=torch.float16), "x",
                              **kw)
    with pytest.raises(ValueError, match="expected rank 2"):
        dispatch.check_tensor(torch.zeros(2), "x", **kw)
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.check_tensor(torch.zeros(3, 2).T, "x", **kw)
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        dispatch.check_tensor(torch.zeros(2, 3), "x", **kw)
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        dispatch.raise_on_error(7, "k")
    dispatch.raise_on_error(0, "k")


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    """A library's build path names its source, every shared header
    under csrc/ and the flags: an edited or added header gives every
    library a new path, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.LIBS}
    assert before == {n: build.library_path(n) for n in build.LIBS}
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    edited = {n: build.library_path(n) for n in build.LIBS}
    assert all(edited[n] != before[n] for n in build.LIBS)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = {n: build.library_path(n) for n in build.LIBS}
    assert all(added[n] != edited[n] for n in build.LIBS)


def test_build_sources_and_nvcc():
    """Every library has its source in the repo; without nvcc the build
    raises instead of doing anything else."""
    for name in build.LIBS:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).parent == build.BUILD_DIR
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        if shutil.which("nvcc") is None:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                build.nvcc()
