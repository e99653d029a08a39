"""The port's training and accuracy path against the JAX reference, on
the CPU: the data pipeline, AdamW, the losses, checkpoints, the
protocol's device views and communication accounting, the simulated
context, the sharded context's Table II modes, ``score``, the kernels'
autograd guard, GPT-2's loss and gradients, the launcher against the
reference's ``make_train_step`` on a (1, 4) host mesh (one JAX child),
a char-LM that learns, and the reference's accuracy protocol scoring a
port checkpoint.

    python tests/test_torch_train.py --table2 CKPT_DIR

scores a char-LM checkpoint (chip_smoke.py's phase 19 keeps the one it
trains under ``CHIP_SMOKE_CHARLM_DIR``) with the reference's protocol
and prints {setting: bpc}.

Inputs come from numpy seeds, weights from the reference's ``T.init``
through ``convert.from_jax_numpy``.  Each test states its tolerance.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.checkpoint import io as JIO  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import protocol as JP  # noqa: E402
from repro.core.attention import prism_attention as j_prism_attention  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.context import SimulatedContext as JSimulated  # noqa: E402
from repro.runtime import losses as JL  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch.checkpoint import io as IO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy, to_jax_numpy  # noqa: E402
from repro_torch.core import protocol as PP  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ops import prism_attention_op  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.context import SimulatedContext  # noqa: E402
from repro_torch.models.layers import AttnSpec  # noqa: E402
from repro_torch.runtime import losses as L  # noqa: E402
from repro_torch.runtime.serve import ServeHParams, score  # noqa: E402
from repro_torch.runtime.train import (TrainHParams,  # noqa: E402
                                       loss_and_grads, make_train_step,
                                       to_batch)
from repro_torch.sharding.context import ShardedPrismContext  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = 1e-6                 # of the largest |value|: same math, f32
# the reference runner's limits (tests/shard_equiv_runner.py): the loss
# absolutely, each gradient leaf relative to its largest |grad|
LOSS_TOL, GRAD_TOL = 2e-4, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-12, np.abs(want).max()))


def grad_err(got, want) -> float:
    """The reference runner's gradient rule: the largest difference over
    max(1e-6, the leaf's largest |grad|); a leaf whose gradient is zero
    in exact arithmetic (a key bias without RoPE) holds only rounding."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def model(arch="gpt2-small", **over):
    """(port config, reference config, reference numpy tree, port
    parameters on the CPU) at the reduced size."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    tree = jax.tree.map(np.asarray, JT.init(j_cfg, jax.random.PRNGKey(0)))
    return cfg, j_cfg, tree, from_jax_numpy(cfg, tree, device="cpu")


def tokens(cfg, b, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, n)).astype(np.int32)


# --------------------------------------------------------------------------
# data, optimizer, losses, checkpoints
# --------------------------------------------------------------------------

def test_data_pipeline_equals_reference():
    """The corpus, the tokenizer and both batch iterators, exactly."""
    text = D.synthetic_text(20_000, seed=2)
    assert text == JD.synthetic_text(20_000, seed=2)
    tok, j_tok = D.CharTokenizer(), JD.CharTokenizer()
    assert tok.chars == j_tok.chars and tok.vocab == j_tok.vocab == 97
    ids = tok.encode(text + "\t~")
    np.testing.assert_array_equal(ids, j_tok.encode(text + "\t~"))
    assert tok.decode(ids[:50]) == j_tok.decode(ids[:50])
    it, j_it = (D.lm_batches(ids, batch=4, seq=40, seed=9),
                JD.lm_batches(ids, batch=4, seq=40, seed=9))
    for _ in range(3):
        for a, b in zip(next(it), next(j_it)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    it = D.classification_batches(batch=3, seq=7, n_classes=5, vocab=50,
                                  seed=4)
    j_it = JD.classification_batches(batch=3, seq=7, n_classes=5, vocab=50,
                                     seed=4)
    for _ in range(3):
        for a, b in zip(next(it), next(j_it)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        next(D.lm_batches(ids[:10], batch=1, seq=40))


def _opt_tree(rng):
    """A nested tree with 2-D leaves (decayed) and 1-D ones (not)."""
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "blk": {"scale": rng.standard_normal(5).astype(np.float32),
                    "up": rng.standard_normal((3, 2, 2)).astype(np.float32)},
            "list": [rng.standard_normal((2, 6)).astype(np.float32)]}


def test_adamw_cosine_clip_match_reference():
    """Three clipped, scheduled AdamW steps over the same numpy
    gradients: parameters, m, v, the norms and the learning rates within
    1e-6 (absolute, all of order 1)."""
    rng = np.random.default_rng(0)
    tree = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    to_t = lambda t: O.adamw.tree_map(torch.as_tensor, t)  # noqa: E731
    p, opt = to_t(tree), O.adamw_init(to_t(tree))
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = JO.adamw_init(jp)
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0
    for g in grads:
        g_c, gn = O.clip_by_global_norm(to_t(g), 1.5)
        jg_c, jgn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.5)
        assert abs(float(gn) - float(jgn)) < 1e-6
        lr = O.cosine_schedule(opt["step"], base_lr=3e-2, warmup=1, total=3)
        jlr = JO.cosine_schedule(jopt["step"], base_lr=3e-2, warmup=1,
                                 total=3)
        assert abs(float(lr) - float(jlr)) < 1e-9
        p, opt = O.adamw_update(p, g_c, opt, lr=lr, weight_decay=0.1)
        jp, jopt = JO.adamw_update(jp, jg_c, jopt, lr=jlr, weight_decay=0.1)
    assert int(opt["step"]) == int(jopt["step"]) == 3
    for mine, ref in ((p, jp), (opt["m"], jopt["m"]), (opt["v"], jopt["v"])):
        a, b = O.adamw.tree_leaves(mine), jax.tree.leaves(ref)
        # jax orders dict keys; the port keeps insertion order
        a = [t.numpy() for t in sorted(a, key=lambda t: (t.shape, float(
            t.sum())))]
        b = [np.asarray(t) for t in sorted(b, key=lambda t: (t.shape, float(
            t.sum())))]
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)
    # the schedule's warm-up, cosine and floor
    for s in (0, 1, 5, 50, 100, 200):
        got = O.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                base_lr=1.0, warmup=10, total=100)
        want = JO.cosine_schedule(jnp.asarray(s, jnp.int32), base_lr=1.0,
                                  warmup=10, total=100)
        assert abs(float(got) - float(want)) < 1e-6, s


@pytest.mark.parametrize("softcap", [None, 30.0, 2.0])
def test_losses_match_reference(softcap):
    """softmax_xent and chunked_lm_loss (chunks of 4 and the whole
    sequence), the softcap too, within 1e-6 of the reference's loss."""
    rng = np.random.default_rng(3)
    b, n, d, v = 2, 12, 16, 37
    f = rng.standard_normal((b, n, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    y = rng.integers(0, v, size=(b, n)).astype(np.int32)
    logits = f @ table.T
    assert abs(float(L.softmax_xent(torch.as_tensor(logits),
                                    torch.as_tensor(y)))
               - float(JL.softmax_xent(jnp.asarray(logits), jnp.asarray(y)))
               ) < 1e-6
    for chunk in (4, n):
        got = L.chunked_lm_loss(torch.as_tensor(f), torch.as_tensor(table),
                                torch.as_tensor(y), chunk=chunk,
                                softcap=softcap)
        want = JL.chunked_lm_loss(jnp.asarray(f), jnp.asarray(table),
                                  jnp.asarray(y), chunk=chunk,
                                  softcap=softcap)
        assert abs(float(got) - float(want)) < 1e-6, chunk
    with pytest.raises(ValueError):
        L.chunked_lm_loss(torch.as_tensor(f), torch.as_tensor(table),
                          torch.as_tensor(y), chunk=5)


def test_checkpoints_read_across(tmp_path):
    """A reference checkpoint of GPT-2's tree restores into the port's
    parameters bit for bit, and the port's (``to_jax_numpy``) into the
    reference's template; ``latest_step`` agrees."""
    cfg, _, tree, params = model()
    JIO.save_checkpoint(str(tmp_path / "ref"), 7, tree)
    got = IO.restore_checkpoint(str(tmp_path / "ref"), 7,
                                to_jax_numpy(cfg, params))
    back = from_jax_numpy(cfg, got, device="cpu")
    for a, b in zip(O.adamw.tree_leaves(back), O.adamw.tree_leaves(params)):
        assert torch.equal(a, b)
    mine = O.adamw.tree_map(lambda t: t * 2, params)
    IO.save_checkpoint(str(tmp_path / "port"), 12, to_jax_numpy(cfg, mine))
    IO.save_checkpoint(str(tmp_path / "port"), 3, to_jax_numpy(cfg, params))
    assert IO.latest_step(str(tmp_path / "port")) == JIO.latest_step(
        str(tmp_path / "port")) == 12
    assert IO.latest_step(str(tmp_path / "none")) is None
    ref = JIO.restore_checkpoint(str(tmp_path / "port"), 12, tree)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(ref)[0],
            jax.tree_util.tree_flatten_with_path(to_jax_numpy(cfg, mine))[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    # an optimizer state (a 0-d int step among f32 moments) round-trips
    opt = O.adamw_init(params)
    IO.save_checkpoint(str(tmp_path / "opt"), 1, opt)
    back = IO.restore_checkpoint(str(tmp_path / "opt"), 1, opt)
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 0


# --------------------------------------------------------------------------
# the protocol: partitions, device views, communication
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(1, 1), (7, 3), (12, 4), (100, 8), (3, 5),
                                 (64, 2)])
def test_partition_matches_reference(n, p):
    """Alg. 1's bounds and views, an uneven tail too (the cases of
    tests/test_protocol.py's property)."""
    if n < p:
        with pytest.raises(ValueError):
            PP.partition_bounds(n, p)
        return
    assert PP.partition_bounds(n, p) == JP.partition_bounds(n, p)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    for a, b in zip(PP.partition(torch.as_tensor(x), p),
                    JP.partition(jnp.asarray(x), p)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


VIEW_CASES = [(12, 3, 2, m) for m in JP.MODES] + [
    (17, 4, 2, "prism"), (17, 4, 3, "duplicate"), (17, 4, 1, "prism_nodup"),
    (33, 2, 5, "prism"), (8, 1, 2, "prism"), (20, 4, 5, "voltage")]


@pytest.mark.parametrize("n,p,L,mode", VIEW_CASES)
def test_device_views_match_reference(n, p, L, mode):
    """Every view's rows, x_hat, g, column ranges, row positions and mask
    equal to the reference's (even and Alg. 1's uneven splits, every
    mode), within 1e-6 for the means."""
    x = np.random.default_rng(n).standard_normal((2, n, 4)).astype(
        np.float32)
    cfg = PP.PrismConfig(P=p, L=L, mode=mode)
    j_cfg = JP.PrismConfig(P=p, L=L, mode=mode)
    mine = PP.device_views(torch.as_tensor(x), cfg)
    ref = JP.device_views(jnp.asarray(x), j_cfg)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.p == b.p
        np.testing.assert_array_equal(a.x_p.numpy(), np.asarray(b.x_p))
        np.testing.assert_allclose(a.x_hat.numpy(), np.asarray(b.x_hat),
                                   atol=1e-6, rtol=0)
        assert (a.g is None) == (b.g is None)
        if a.g is not None:
            np.testing.assert_array_equal(a.g, b.g)
        for f in ("col_lo", "col_hi", "row_pos"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.mask(cfg).numpy(),
                                      np.asarray(b.mask(j_cfg)))


def test_comm_accounting_matches_reference_and_paper():
    """Elements a device sends a layer, tensor-parallel traffic and the
    speed-up, against the reference over modes and shapes; the paper's
    99.2% for BERT (N 512, D 768) at P 4, CR 128 (L 1)."""
    for n, d, p, kw in ((4096, 768, 4, dict(L=16)), (197, 768, 2, dict(L=10)),
                        (197, 768, 3, dict(L=10)), (512, 768, 4,
                                                    dict(cr=128.0)),
                        (1000, 64, 8, dict(cr=2.0)), (64, 8, 1, {})):
        for mode in JP.MODES:
            cfg = PP.PrismConfig(P=p, mode=mode, **kw)
            j_cfg = JP.PrismConfig(P=p, mode=mode, **kw)
            assert PP.comm_elements_per_device_per_layer(n, d, cfg) == \
                JP.comm_elements_per_device_per_layer(n, d, j_cfg)
            assert PP.comm_speedup(n, d, cfg) == pytest.approx(
                JP.comm_speedup(n, d, j_cfg), abs=1e-12)
        assert PP.tensor_parallel_comm(n, d, p) == \
            JP.tensor_parallel_comm(n, d, p)
    bert = PP.comm_speedup(512, 768, PP.PrismConfig(P=4, cr=128.0))
    assert PP.PrismConfig(P=4, cr=128.0).landmarks(512) == 1
    assert round(bert, 1) == 99.2


# --------------------------------------------------------------------------
# SimulatedContext, the sharded context's modes, score
# --------------------------------------------------------------------------

SIM_CASES = [(p, m) for p in (2, 3, 4) for m in
             ("prism", "prism_nodup", "voltage")] + [(3, "duplicate")]
N_SIM = 48                  # divisible by P 2, 3, 4


@pytest.fixture(scope="module")
def sim_models():
    """GPT-2 (learned positions) and Yi-6B (RoPE: the means at their
    segments' midpoints) at the reduced size, and their tokens."""
    out = {}
    for arch in ("gpt2-small", "yi-6b"):
        cfg, j_cfg, tree, params = model(arch)
        out[arch] = (cfg, j_cfg, tree, params, tokens(cfg, 2, N_SIM))
    return out


@pytest.mark.parametrize("arch,p,mode", [("gpt2-small",) + c
                                         for c in SIM_CASES] + [
    ("yi-6b", 3, "prism"), ("yi-6b", 4, "prism_nodup"),
    ("yi-6b", 2, "voltage")])
def test_simulated_forward_matches_reference(sim_models, arch, p, mode):
    """``T.forward`` under the port's SimulatedContext against the
    reference's, and ``score(backend="plain")`` over P sequence shards
    against the same: logits within 1e-5 of the reference's largest
    |logit|; at CR 1 (L = N/P) PRISM is the full forward's."""
    cfg, j_cfg, tree, params, toks = sim_models[arch]
    prism = PP.PrismConfig(P=p, cr=4.0, mode=mode)
    want, _ = JT.forward(j_cfg, tree, jnp.asarray(toks),
                         ctx=JSimulated(JP.PrismConfig(P=p, cr=4.0,
                                                       mode=mode)))
    got = T.forward(cfg, params, torch.as_tensor(toks),
                    ctx=SimulatedContext(prism))
    assert rel(got.detach().numpy(), want) < 1e-5
    sc = score(cfg, params, torch.as_tensor(toks), prism=prism,
               n_shards=p, hp=ServeHParams(backend="plain"))
    assert sc.dtype == torch.float32 and sc.shape == got.shape
    assert rel(sc.numpy(), want) < 1e-5
    if mode == "prism":
        exact = T.forward(cfg, params, torch.as_tensor(toks))
        cr1 = score(cfg, params, torch.as_tensor(toks),
                    prism=PP.PrismConfig(P=p, L=N_SIM // p), n_shards=p,
                    hp=ServeHParams(backend="plain"))
        assert rel(cr1.numpy(), exact.detach().numpy()) < 1e-5


def test_simulated_context_refusals():
    with pytest.raises(NotImplementedError, match="FullContext"):
        SimulatedContext(PP.PrismConfig(P=2, mode="single"))
    ctx = SimulatedContext(PP.PrismConfig(P=3))
    spec = AttnSpec(d_model=8, n_heads=2, n_kv_heads=2, head_dim=4)
    with pytest.raises(ValueError, match="N % P"):
        ctx.augment(torch.zeros(1, 8, 8), spec)
    cfg = get_config("bert-base").reduced()
    with pytest.raises(ValueError, match="encoder"):
        score(cfg, {}, torch.zeros(1, 8, dtype=torch.int64),
              prism=PP.PrismConfig(P=2), n_shards=2,
              hp=ServeHParams(backend="plain"))


@pytest.mark.parametrize("mode", JP.MODES)
@pytest.mark.parametrize("p,L", [(2, 3), (3, 2), (4, 1)])
def test_sharded_modes_match_device_views(mode, p, L):
    """Attention over ``ShardedPrismContext.augment`` in every mode (the
    plain prefill attention, per-shard metadata) against the reference's
    ``device_views`` with its mask and softmax, shard by shard: within
    1e-5 of the largest |output|."""
    b, n, h, hd = 2, 24, 2, 4
    x = np.random.default_rng(p * 10 + L).standard_normal(
        (b, n, h * hd)).astype(np.float32)
    ctx = ShardedPrismContext(PP.PrismConfig(P=p, L=L, mode=mode),
                              n_shards=p, backend="plain")
    xs = ctx.shard(torch.as_tensor(x))
    spec = AttnSpec(d_model=h * hd, n_heads=h, n_kv_heads=h, head_dim=hd)
    xq, akv = ctx.augment(xs, spec)
    q = xq.reshape(*xq.shape[:2], h, hd)
    kv = akv.x_hat.reshape(*akv.x_hat.shape[:2], h, hd)
    g = akv.g if akv.g is not None else torch.ones(kv.shape[1])
    out = prism_attention_op(q, kv, kv, g, akv.col_lo, akv.col_hi,
                             akv.row_pos, causal=True, backend="plain")
    out = out.reshape(b, p, n // p, h, hd)
    j_cfg = JP.PrismConfig(P=p, L=L, mode=mode)
    views = JP.device_views(jnp.asarray(x), j_cfg)
    if mode == "single":           # one view of the whole sequence
        v = views[0]
        want = j_prism_attention(
            v.x_p.reshape(b, n, h, hd), v.x_hat.reshape(b, n, h, hd),
            v.x_hat.reshape(b, n, h, hd), mask=v.mask(j_cfg))
        assert rel(out.reshape(b, n, h, hd).numpy(), want) < 1e-5
        return
    for v in views:
        m = v.x_hat.shape[-2]
        want = j_prism_attention(
            v.x_p.reshape(b, -1, h, hd), v.x_hat.reshape(b, m, h, hd),
            v.x_hat.reshape(b, m, h, hd),
            g=None if v.g is None else jnp.asarray(v.g, jnp.float32),
            mask=v.mask(j_cfg))
        assert rel(out[:, v.p].numpy(), want) < 1e-5, v.p


# --------------------------------------------------------------------------
# the autograd guard
# --------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card: what the guard reads."""

    @property
    def is_cuda(self):
        return True


def test_kernel_under_autograd_raises():
    """A call that would go to a kernel raises while autograd records
    (grad mode on, an input requiring grad), naming backend='plain' and
    the missing backward, before any launch; not under no_grad, nor for
    inputs that need no grad; the plain version is never taken
    instead."""
    t = torch.zeros(2, 3).as_subclass(_OnCard)
    w = torch.zeros(2, 3, requires_grad=True)
    assert dispatch.use_kernel("auto", t) is True
    for args in ((t.requires_grad_(True),), (t.detach(), w)):
        with pytest.raises(RuntimeError, match="backend='plain'.*"):
            dispatch.use_kernel("auto", *args)
        with pytest.raises(RuntimeError, match="no backward"):
            dispatch.use_kernel("kernel", *args)
        with torch.no_grad():
            assert dispatch.use_kernel("auto", *args) is True
        assert dispatch.use_kernel("plain", *args) is False
    dispatch.LAUNCHES.clear()
    q = torch.zeros(1, 4, 1, 32).as_subclass(_OnCard).requires_grad_(True)
    meta = torch.zeros(1, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        prism_attention_op(q, q, q, meta + 1, meta, meta, meta)
    assert not dispatch.LAUNCHES
    # on the CPU the plain version is differentiable, as the train step
    # needs
    x = torch.randn(1, 4, 1, 8, requires_grad=True)
    out = prism_attention_op(x, x, x, meta + 1, meta, meta,
                             torch.arange(4.0)[None])
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _j_loss(j_cfg, tree, toks, labels, prism):
    """The reference's objective on one device: T.forward under its
    SimulatedContext plus softmax_xent (tests/shard_equiv_runner.py's
    ``ref_loss``)."""
    from repro.runtime.losses import softmax_xent
    logits, _ = JT.forward(j_cfg, tree, toks,
                           ctx=JSimulated(prism, prefix_len=j_cfg.prefix_len),
                           chunk=8)
    return softmax_xent(logits, labels)


@pytest.fixture(scope="module")
def gpt2_grads():
    """GPT-2 reduced, tokens and labels (2, 32), and the reference's loss
    and gradients at P 4, CR 4, prism (jitted ``value_and_grad``)."""
    cfg, j_cfg, tree, params = model()
    toks, labels = tokens(cfg, 2, 32, 1), tokens(cfg, 2, 32, 2)
    jprism = JP.PrismConfig(P=4, cr=4.0)
    want, j_grads = jax.jit(jax.value_and_grad(
        lambda t: _j_loss(j_cfg, t, jnp.asarray(toks), jnp.asarray(labels),
                          jprism)))(jax.tree.map(jnp.asarray, tree))
    return cfg, params, toks, labels, float(want), jax.tree.map(
        np.asarray, j_grads)


@pytest.mark.parametrize("remat", [True, False])
def test_gpt2_loss_and_grads_match_reference(gpt2_grads, remat):
    """GPT-2 reduced at P 4, CR 4, prism: the port's loss and every
    gradient leaf against ``jax.value_and_grad`` of the reference's
    simulated forward plus ``softmax_xent``, in process: the loss within
    1e-5 (the reference runner's 2e-4), each leaf within the runner's 5e-3
    of max(1e-6, its largest |grad|) (``grad_err``)."""
    cfg, params, toks, labels, want, j_grads = gpt2_grads
    ctx = ShardedPrismContext(PP.PrismConfig(P=4, cr=4.0), n_shards=4,
                              backend="plain")
    hp = TrainHParams(loss_chunks=4, remat=remat)
    nll, aux, grads = loss_and_grads(
        cfg, params, to_batch({"tokens": toks, "labels": labels}, "cpu"),
        ctx, hp)
    assert abs(float(nll) - want) < 1e-5 and float(aux) == 0.0
    g_ref = to_jax_numpy(cfg, grads)
    for (pa, a), (pb, w) in zip(
            jax.tree_util.tree_flatten_with_path(g_ref)[0],
            jax.tree_util.tree_flatten_with_path(j_grads)[0]):
        assert pa == pb
        assert grad_err(a, w) < GRAD_TOL, jax.tree_util.keystr(pa)
    for t in O.adamw.tree_leaves(params):       # the step leaves them be
        assert not t.requires_grad and t.grad is None


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "yi-6b"])
def test_forward_returns_moe_aux(arch):
    """``T.forward(aux=True)`` -> (logits, the load-balance loss summed
    over the blocks) as the reference's ``(logits, aux["moe_aux"])``
    under FullContext (one routing group): logits within 1e-5 of the
    largest |logit|, aux within 1e-6; 0 without experts; the default
    returns the logits alone."""
    cfg, j_cfg, tree, params = model(arch)
    toks = tokens(cfg, 2, 16)
    logits, aux = T.forward(cfg, params, torch.as_tensor(toks), aux=True)
    want, j_aux = jax.jit(lambda t, x: JT.forward(j_cfg, t, x))(
        tree, jnp.asarray(toks))
    assert rel(logits.detach().numpy(), want) < 1e-5
    assert abs(float(aux) - float(j_aux["moe_aux"])) < 1e-6
    assert (float(aux) > 0) == bool(cfg.n_experts)
    plain = T.forward(cfg, params, torch.as_tensor(toks))
    assert torch.equal(plain, logits)


def test_train_step_refusals():
    cfg, *_ = model()
    prism = PP.PrismConfig(P=2)
    with pytest.raises(NotImplementedError, match="runs over a mesh"):
        make_train_step(cfg, prism, n_shards=2, device="cpu",
                        n_data=2)
    enc = get_config("bert-base").reduced()
    with pytest.raises(ValueError, match="encoder"):
        make_train_step(enc, prism, n_shards=2, device="cpu")


LAUNCH_STEPS, LAUNCH_B, LAUNCH_N = 3, 4, 64


def jax_launcher_reference(out_path):
    """The child: the reference's ``make_train_step`` on a (1, 4) host
    mesh with the reference launcher's hyper-parameters and batches, 3
    steps of GPT-2 reduced, prism CR 4; per-step metrics and the first
    step's m."""
    from repro.data.pipeline import CharTokenizer, lm_batches, synthetic_text
    from repro.optim import adamw_init
    from repro.runtime.train import TrainHParams as JHP
    from repro.runtime.train import make_train_step as j_make
    j_cfg = j_get_config("gpt2-small").reduced()
    params = JT.init(j_cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    hp = JHP(lr=3e-4, total_steps=LAUNCH_STEPS,
             warmup=max(1, LAUNCH_STEPS // 10))
    step, _, psh, osh, bsh = j_make(j_cfg, mesh, params,
                                    JP.PrismConfig(P=4, cr=4.0), hp)
    params = jax.device_put(params, psh)
    opt = jax.device_put(adamw_init(params), osh)
    it = lm_batches(CharTokenizer().encode(synthetic_text(500_000, seed=1)),
                    batch=LAUNCH_B, seq=LAUNCH_N, seed=0)
    out = {}
    for i in range(LAUNCH_STEPS):
        x, y = next(it)
        params, opt, m = step(params, opt, jax.device_put(
            {"tokens": x, "labels": y}, bsh))
        for k, v in m.items():
            out[f"{k}/{i}"] = np.asarray(v)
        if i == 0:
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(opt["m"]))[0]:
                out["m" + jax.tree_util.keystr(path)] = np.asarray(leaf)
    np.savez(out_path, **out)


def test_launcher_matches_reference_make_train_step(tmp_path):
    """Three steps of the port's launcher (``setup``, ``corpus_batches``,
    ``train``) against the reference's ``make_train_step`` on a (1, 4)
    host mesh in a JAX child, from the same weights: each step's loss and
    gnorm within 2e-4 (relative for gnorm), its lr within 1e-9, and the
    first step's gradient (m / 0.1) within 5e-3 of max(1e-6, each leaf's
    largest |grad|) (the reference runner's limits and rule)."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--jax-ref", str(out)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    ref = dict(np.load(out))
    cfg, _, tree, params = model()
    run = launch.setup("gpt2-small", reduced=True, seq_shards=4, cr=4.0,
                       lr=3e-4, steps=LAUNCH_STEPS, device="cpu",
                       params=params)
    lines = []
    batches = launch.corpus_batches(LAUNCH_B, LAUNCH_N)
    x, y = next(batches)
    first_m = None
    hist = []
    for i in range(LAUNCH_STEPS):
        if i:
            x, y = next(batches)
        hist += launch.train(run, iter([(x, y)]), 1, log=lines.append)
        if i == 0:
            first_m = to_jax_numpy(cfg, run.opt["m"])
    assert all(ln.startswith("step ") for ln in lines)
    for i, h in enumerate(hist):
        assert abs(h["loss"] - float(ref[f"loss/{i}"])) < 2e-4, i
        assert abs(h["gnorm"] / float(ref[f"gnorm/{i}"]) - 1) < 2e-4, i
        assert abs(h["lr"] - float(ref[f"lr/{i}"])) < 1e-9, i
        assert h["moe_aux"] == float(ref[f"moe_aux/{i}"]) == 0.0
    assert hist[-1]["lr"] > 0
    # m = (1 - b1)·g after one step: g against the reference's
    for path, leaf in jax.tree_util.tree_flatten_with_path(first_m)[0]:
        want = ref["m" + jax.tree_util.keystr(path)] / 0.1
        assert grad_err(leaf / 0.1, want) < 5e-3, path


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_char_lm_learns_and_scores_agree():
    """chip_smoke.py's accuracy harness (benchmarks/accuracy_vs_cr.py's
    char-LM: 4 layers, d 128, 4 heads of 32) on the CPU at a small size
    (B 4 x 48, a 20,000-character corpus): 20 steps under FullContext
    take the loss below 0.7 x the first (the benchmark's rule); each bpc
    under SimulatedContext equals ``score``'s over sequence shards within
    1e-4 bits and 1e-5 of the largest |logit| (the card's rule is
    1e-4); P 2 at CR 1 equals the single device within 1e-5 bits; a
    fine-tuning step under SimulatedContext runs."""
    cs = _chip_smoke()
    h = cs.CharLM(torch, torch.device("cpu"), seq=48, batch=4,
                  train_chars=20_000, held_chars=5_000, n_eval=2)
    assert h.cfg.hd == 32 and h.cfg.n_layers == 4
    first, last, losses = h.train(20)
    assert all(np.isfinite(losses)) and last < cs.TRAIN_FALL * first
    base, _ = h.bpc()
    for prism in (None, PP.PrismConfig(P=2, L=24), PP.PrismConfig(P=3, cr=2.0),
                  PP.PrismConfig(P=4, cr=4.0, mode="prism_nodup"),
                  PP.PrismConfig(P=2, cr=4.0, mode="voltage")):
        b, sim = h.bpc(prism)
        bk, kern = h.bpc_scored(prism)
        assert abs(b - bk) < 1e-4
        assert max(rel(a.numpy(), c.numpy()) for a, c in zip(kern, sim)) \
            < 1e-5
        if prism is not None and prism.L == 24:
            assert abs(b - base) < 1e-5
    first, last, _ = h.train(2, prism=PP.PrismConfig(P=3, cr=8.0), lr=1e-3)
    assert np.isfinite(last)


TABLE2 = [(None, "single")] + [
    (JP.PrismConfig(P=p, cr=4.0, mode=m), f"P{p}-CR4-{m}")
    for p in (2, 3) for m in ("prism", "prism_nodup")]


def reference_table2(ckpt_dir):
    """benchmarks/accuracy_vs_cr.py's own ``Harness`` (the reference's
    protocol, in JAX) scoring the char-LM saved in ``ckpt_dir`` (the
    reference's checkpoint layout, as chip_smoke.py's phase 19 keeps it
    under ``CHIP_SMOKE_CHARLM_DIR``): {setting: bpc} for the single
    device and Table II at P 2 and 3, CR 4."""
    spec = importlib.util.spec_from_file_location(
        "accuracy_vs_cr", os.path.join(HERE, "..", "benchmarks",
                                       "accuracy_vs_cr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    h = mod.Harness()
    h.params = JIO.restore_checkpoint(ckpt_dir, JIO.latest_step(ckpt_dir),
                                      h.params)
    return {name: h.bpc(prism) for prism, name in TABLE2}


def test_reference_protocol_scores_a_port_checkpoint(tmp_path):
    """The port's char-LM at its seeded initialisation, saved by the
    port's ``checkpoint.io``, scored by the reference's own protocol
    (``reference_table2``) and by chip_smoke.py's harness under the port's
    SimulatedContext, on the protocol's held-out batches (B 16 x 120, 8
    batches): each bpc within 1e-5 bits."""
    cs = _chip_smoke()
    h = cs.CharLM(torch, torch.device("cpu"), train_chars=1_000)
    IO.save_checkpoint(str(tmp_path), 0, to_jax_numpy(h.cfg, h.params))
    want = reference_table2(str(tmp_path))
    for prism, name in TABLE2:
        cfg = None if prism is None else PP.PrismConfig(
            P=prism.P, cr=prism.cr, mode=prism.mode)
        assert abs(h.bpc(cfg)[0] - want[name]) < 1e-5, name


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        jax_launcher_reference(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--table2":
        import json
        print(json.dumps(reference_table2(sys.argv[2])))
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz | --table2 "
                 "CKPT_DIR")
