"""The port's ``core`` modules against the JAX reference, on the CPU:
masks, segment means, the exchange config and the scaling-aware
attention (dense and streamed, g = 0 padding, fully masked rows).
Inputs come from numpy with a seed and go through both sides; f32,
atol 1e-5 / rtol 1e-4."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import attention as JA  # noqa: E402
from repro.core import masks as JM  # noqa: E402
from repro.core import protocol as JP  # noqa: E402
from repro.core import segment_means as JS  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import masks as TM  # noqa: E402
from repro_torch.core import protocol as TP  # noqa: E402
from repro_torch.core import segment_means as TS  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def pair(a):
    """One numpy array -> (jax array, torch tensor)."""
    return jnp.asarray(a), torch.as_tensor(a)


@pytest.mark.parametrize("causal,prefix_len,window",
                         [(True, 0, None), (True, 5, None), (True, 0, 6),
                          (False, 0, None), (False, 0, 4), (True, 3, 8)])
def test_visibility(causal, prefix_len, window):
    rng = np.random.default_rng(1)
    row = rng.integers(0, 40, size=12).astype(np.int32)
    lo = rng.integers(0, 40, size=20).astype(np.int32)
    hi = (lo + rng.integers(0, 5, size=20)).astype(np.int32)
    kw = dict(causal=causal, prefix_len=prefix_len, window=window)
    want = JM.visibility(*map(jnp.asarray, (row, lo, hi)), **kw)
    got = TM.visibility(*map(torch.as_tensor, (row, lo, hi)), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,L", [((2, 16, 8), 4), ((3, 32, 5), 32),
                                     ((1, 17, 6), 4), ((2, 100, 3), 16),
                                     ((4, 7, 2), 3), ((1, 9, 4), 1)])
def test_segment_means(shape, L):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    close(TS.segment_means(torch.as_tensor(x), L),
          JS.segment_means(jnp.asarray(x), L))
    n = shape[1]
    np.testing.assert_array_equal(TS.segment_sizes(n, L),
                                  JS.segment_sizes(n, L))
    for a, b in zip(TS.segment_bounds(n, L, offset=5),
                    JS.segment_bounds(n, L, offset=5)):
        np.testing.assert_array_equal(a, b)


def test_segment_means_rejects_bad_L():
    with pytest.raises(ValueError):
        TS.segment_means(torch.zeros(1, 4, 2), 5)


@pytest.mark.parametrize("n,cr,p", [(512, 4.0, 4), (32, 4.0, 4),
                                    (10, 16.0, 4), (100, 3.0, 2)])
def test_landmarks_and_partitions(n, cr, p):
    assert TS.num_landmarks(n, cr, p) == JS.num_landmarks(n, cr, p)
    assert TP.partition_bounds(n, p) == JP.partition_bounds(n, p)
    cfg_t, cfg_j = TP.PrismConfig(P=p, cr=cr), JP.PrismConfig(P=p, cr=cr)
    assert cfg_t.landmarks(n) == cfg_j.landmarks(n)
    assert cfg_t.with_(L=3).landmarks(n) == 3


def test_prism_config_validates():
    with pytest.raises(ValueError):
        TP.PrismConfig(mode="bogus")
    with pytest.raises(ValueError):
        TP.PrismConfig(P=0)


def test_log_repeats():
    g = np.array([0.0, 1.0, 4.0, 0.0, 7.5, 1e-3], np.float32)
    close(TA.log_repeats(torch.as_tensor(g)), JA.log_repeats(jnp.asarray(g)))


@pytest.mark.parametrize("with_g,with_mask", [(True, True), (False, True),
                                              (True, False)])
def test_scaling_softmax(with_g, with_mask):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 3, 5, 9)).astype(np.float32)
    log_g = np.log(rng.integers(1, 5, size=9)).astype(np.float32)
    mask = rng.random((5, 9)) > 0.4
    mask[1] = False                               # a fully masked row
    args_j = [jnp.asarray(logits), jnp.asarray(log_g) if with_g else None,
              jnp.asarray(mask) if with_mask else None]
    args_t = [torch.as_tensor(logits),
              torch.as_tensor(log_g) if with_g else None,
              torch.as_tensor(mask) if with_mask else None]
    got = TA.scaling_softmax(*args_t)
    close(got, JA.scaling_softmax(*args_j))
    if with_mask:
        assert not got[:, :, 1].any()


def _attention_case(seed, b=2, nq=10, m=40, hq=4, hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, nq, hq, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, m, hkv, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, m, hkv, hd)) * 0.5).astype(np.float32)
    g = rng.integers(1, 5, size=m).astype(np.float32)
    g[-3:] = 0.0                                  # g = 0 padding columns
    row = np.arange(nq) + (m - nq)
    mask = np.arange(m)[None, :] <= row[:, None]
    mask[0] = False                               # a fully masked row
    return q, k, v, g, mask


@pytest.mark.parametrize("block", [0, 8, 16])
@pytest.mark.parametrize("with_g", [True, False])
def test_prism_attention_dense_and_streamed(block, with_g):
    """block = 0 is the dense path; block > 0 streams K/V (M = 40 > 2·16)
    and pads the ragged last block with g = 0 columns."""
    q, k, v, g, mask = _attention_case(4)
    gj = jnp.asarray(g) if with_g else None
    gt = torch.as_tensor(g) if with_g else None
    if with_g:                                    # dense path: mask g = 0
        mask = mask & (g > 0)[None, :]
    want = JA.prism_attention(*map(jnp.asarray, (q, k, v)), gj,
                              jnp.asarray(mask), block=block)
    got = TA.prism_attention(*map(torch.as_tensor, (q, k, v)), gt,
                             torch.as_tensor(mask), block=block)
    close(got, want)
    assert not got[:, 0].any()                    # fully masked row -> 0


def test_prism_attention_batched_mask_and_g():
    """The dense path with a (B, 1, Nq, M) mask and broadcast g."""
    q, k, v, g, mask = _attention_case(5)
    g = np.maximum(g, 1.0)
    bmask = np.stack([mask, np.tril(np.ones_like(mask))])[:, None]
    gb = g[None, None, None, :]
    want = JA.prism_attention(*map(jnp.asarray, (q, k, v, gb, bmask)))
    got = TA.prism_attention(*map(torch.as_tensor, (q, k, v, gb, bmask)))
    close(got, want)


def test_gqa_helpers():
    q, k, v, _, _ = _attention_case(6, hq=6, hkv=3)
    close(TA._gqa_logits(torch.as_tensor(q), torch.as_tensor(k), 0.3),
          JA._gqa_logits(jnp.asarray(q), jnp.asarray(k), 0.3))
    w = np.random.default_rng(7).random((2, 6, 10, 40)).astype(np.float32)
    close(TA._gqa_output(torch.as_tensor(w), torch.as_tensor(v)),
          JA._gqa_output(jnp.asarray(w), jnp.asarray(v)))
    with pytest.raises(ValueError):
        TA._gqa_logits(torch.zeros(1, 2, 5, 4), torch.zeros(1, 2, 2, 4), 1.0)
