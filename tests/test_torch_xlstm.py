"""The port's xLSTM against the JAX reference, on the CPU.

xLSTM 1.3B (``models/ssm.py``: mLSTM blocks, whose linear recurrence
runs in chunks and hands its constant-size state across sequence shards,
and sLSTM blocks, which scan the gathered sequence) reduced to d_model
256 and 2 layers, one ``mlstm`` and one ``slstm``, 2 heads (the mLSTM's
of 256, the sLSTM's of 128).  P = 4 sequence shards of 16 rows and an
mLSTM chunk of 8 (``ssm_chunk``), so every shard has two chunks.

In process, against ``repro.models.ssm``: ``chunked_linear_attention``
at P 1 (with and without the normaliser, its end state too), the cells'
apply and decode steps.  A module fixture runs this file as a subprocess
(``--jax-ref OUT.npz``) with four fake host devices set in the child's
environment only: on a (1, 4) mesh with the jnp backend the child runs
the recurrence and both cells through the reference's
``ShardedPrismContext`` under ``shard_map``, the full forward, and
``make_prefill_step`` / ``make_serve_step`` (B 2, prompt 64, 8
teacher-forced steps) in the three pairings, and saves the parameters
and every result.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_moe as M  # noqa: E402

ARCH = "xlstm-1.3b"
P, B, CR = 4, 2, 4.0
N, STEPS, CHUNK = 64, 8, 8          # shards of 16 rows: two chunks each
CAP = N + STEPS
PAIRINGS = [("voltage", "exact"), ("prism", "prism"), ("voltage", "prism")]
# the recurrence's own inputs: (B, N, H, dk) keys, values of dv
REC = dict(b=2, n=64, h=2, dk=16, dv=12)
DECODE_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def xlstm_config(get_config):
    """The test's config from either package's registry."""
    return get_config(ARCH).reduced(d_model=256)


def _case(pairing):
    return f"{pairing[0]}-{pairing[1]}"


def _serve_inputs(vocab):
    rng = np.random.default_rng(11)
    prompts = rng.integers(1, vocab, size=(B, N)).astype(np.int32)
    forced = rng.integers(1, vocab, size=(B, STEPS)).astype(np.int32)
    return prompts, forced


def _recurrence_inputs(seed):
    """q, k (B, N, H, dk), v (B, N, H, dv), log_f <= 0 and the input gate
    (B, N, H), as the mLSTM makes them."""
    rng = np.random.default_rng(seed)
    b, n, h, dk, dv = (REC[k] for k in ("b", "n", "h", "dk", "dv"))
    q = rng.standard_normal((b, n, h, dk)).astype(np.float32) * dk ** -0.5
    k = rng.standard_normal((b, n, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, n, h, dv)).astype(np.float32)
    f_pre = rng.standard_normal((b, n, h)).astype(np.float32) + 1.0
    i_pre = rng.standard_normal((b, n, h)).astype(np.float32)
    log_f = -np.logaddexp(0.0, -f_pre).astype(np.float32)
    gate_i = (1.0 / (1.0 + np.exp(-i_pre))).astype(np.float32)
    return q, k, v, log_f, gate_i


def _cell_input(d, seed, n=N):
    return np.random.default_rng(seed).standard_normal((B, n, d)).astype(
        np.float32)


def _cell_params(kind):
    """A cell's weights from the reference's init at the reduced widths
    (d 256, 2 heads, expansion 2): numpy leaves."""
    import jax
    from repro.configs import get_config
    from repro.models import ssm as JS
    cfg = xlstm_config(get_config)
    key = jax.random.PRNGKey(3)
    if kind == "mlstm":
        p = JS.mlstm_init(key, cfg.d_model, cfg.n_ssm_heads, cfg.ssm_expand)
    else:
        p = JS.slstm_init(key, cfg.d_model, cfg.n_ssm_heads)
    return cfg, jax.tree.map(np.asarray, p)


def jax_reference(out_path):
    """Child process: the reference on a (1, 4) host mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from repro.compat import shard_map
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import ssm as JS
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, make_prefill_step,
                                     make_serve_step)
    from repro.sharding.context import ShardedPrismContext
    K, _ = M._helpers()
    cfg = xlstm_config(get_config)
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    K._flatten(jax.tree.map(np.asarray, params), "params", out)

    # the recurrence and the cells through the sharded context
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="prism"),
                              axis="model", n_shards=P)

    def sharded(body, n_in):
        return jax.jit(shard_map(
            body, mesh=mesh, in_specs=(PS(None, "model"),) * n_in,
            out_specs=(PS(None, "model"), PS()), check_vma=False))
    rec = [jnp.asarray(a) for a in _recurrence_inputs(5)]
    for norm_ in (False, True):
        y, s = sharded(lambda *a, nz=norm_: JS.chunked_linear_attention(
            *a, chunk=CHUNK, ctx=ctx, normalize=nz, return_state=True),
            5)(*rec)
        out[f"rec/norm{int(norm_)}/y"] = np.asarray(y)
        out[f"rec/norm{int(norm_)}/s"] = np.asarray(s)
    for kind in ("mlstm", "slstm"):
        _, p = _cell_params(kind)
        x = jnp.asarray(_cell_input(cfg.d_model, 7))
        if kind == "mlstm":
            fn = lambda xl: JS.mlstm_apply(  # noqa: E731
                p, xl, heads=cfg.n_ssm_heads, ctx=ctx, chunk=CHUNK,
                return_state=True)
        else:
            fn = lambda xl: JS.slstm_apply(  # noqa: E731
                p, xl, heads=cfg.n_ssm_heads, ctx=ctx, return_state=True)
        y, s = sharded(fn, 1)(x)
        out[f"{kind}/sharded/y"] = np.asarray(y)
        out[f"{kind}/sharded/s"] = np.asarray(s)

    prompts, forced = _serve_inputs(cfg.vocab_size)
    logits, _ = jax.jit(lambda p_, t_: T.forward(cfg, p_, t_, chunk=CHUNK))(
        params, jnp.asarray(np.concatenate([prompts, forced], axis=1)))
    out["forward"] = np.asarray(logits)
    for pairing in PAIRINGS:
        case = _case(pairing)
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR,
                          backend="jnp", ssm_chunk=CHUNK)
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism, batch=B,
                                         n=N, hp=hp, cap=CAP)
        logits, cache = pre(params, {"tokens": jnp.asarray(prompts)})
        out[f"{case}/prefill_logits"] = np.asarray(logits)
        K._flatten(cache["scan"], f"{case}/cache_prefill", out)
        step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B, cap=CAP,
                                        prefill_len=N, hp=hp)
        for i in range(STEPS):
            pos = jnp.full((B,), N + i, jnp.int32)
            logits, cache = step(params, cache, jnp.asarray(forced[:, i]),
                                 pos)
            out[f"{case}/step{i}_logits"] = np.asarray(logits)
        K._flatten(cache["scan"], f"{case}/cache_final", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_xlstm") / "ref.npz"
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
def port(jax_ref):
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    K, _ = M._helpers()
    cfg = xlstm_config(get_config)
    return cfg, from_jax_numpy(cfg, K._unflatten(jax_ref, "params"),
                               device="cpu")


@pytest.fixture(scope="module")
def serve_runs(port):
    """prefill + 8 teacher-forced serve_steps in every pairing, and the
    plain full forward over prompt + forced tokens."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)
    cfg, params = port
    prompts, forced = (torch.as_tensor(a).long()
                       for a in _serve_inputs(cfg.vocab_size))
    runs = {"forward": T.forward(cfg, params, torch.cat([prompts, forced],
                                                        dim=1),
                                 chunk=CHUNK).numpy()}
    for pairing in PAIRINGS:
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR,
                          ssm_chunk=CHUNK)
        lay = make_layout(P, CAP, hp, prefill_len=N)
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        logits, cache = prefill(cfg, params, prompts, prism, lay, hp)
        run = {"prefill_logits": logits.numpy(),
               "cache_prefill": [{k: t.clone().numpy() for k, t in c.items()}
                                 for c in cache],
               "storage": [c["s"].data_ptr() for c in cache]}
        for i in range(STEPS):
            pos = torch.full((B,), N + i, dtype=torch.long)
            logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                       lay, hp)
            run[f"step{i}_logits"] = logits.numpy()
        run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                              for c in cache]
        run["storage_final"] = [c["s"].data_ptr() for c in cache]
        runs[_case(pairing)] = run
    return runs


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# --------------------------------------------------------------------------
# the config and the parameters
# --------------------------------------------------------------------------

def test_config_is_xlstm():
    """The full config the card runs: 42 mLSTM and 6 sLSTM blocks (every
    8th), d 2048, 4 heads (the mLSTM's of 1,024), no FFN, an untied head
    over 50304; its decode state at B 8; the reduced one here."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import (ServeHParams, layer_cache_shape,
                                           make_layout)
    cfg = get_config(ARCH)
    kinds = cfg.block_kinds
    assert (cfg.n_layers, cfg.d_model, cfg.n_ssm_heads, cfg.ssm_expand,
            cfg.d_ff, cfg.vocab_size) == (48, 2048, 4, 2, 0, 50304)
    assert kinds.count("slstm") == 6 and kinds[7::8] == ("slstm",) * 6
    assert cfg.scan_split == (8, 6, 0) and not cfg.tie_embeddings
    hp = ServeHParams()
    lay = make_layout(P, 576, hp, prefill_len=512)
    assert layer_cache_shape(cfg, lay, 8, hp, kind="mlstm") == {
        "s": (8, 4, 1024, 1025)}
    assert layer_cache_shape(cfg, lay, 8, hp, kind="slstm") == {
        "s": (8, 3, 4, 512)}
    small = xlstm_config(get_config)
    assert small.block_kinds == ("mlstm", "slstm")
    assert small.n_ssm_heads == 2 and hp.ssm_chunk == 128


def test_convert_takes_the_8_layer_unit():
    """xLSTM's layers are stored as 8 stacked trees (7 mLSTM, 1 sLSTM):
    layer i·8 + j is slice i of scan[j]; a 16-layer cut of the full
    pattern comes across in depth order, the sLSTM's raw ``r`` with it,
    and ``init`` builds the same tree."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as JT
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.models import transformer as T

    def cut(get):
        full = get(ARCH)
        return dataclasses.replace(
            full, n_layers=16, blocks=full.block_kinds[:16], d_model=64,
            n_heads=2, n_kv_heads=2, ssm_heads=2, vocab_size=32)
    cfg = cut(get_config)
    assert cfg.scan_split == (8, 2, 0)
    # the reference's tree, its shapes from init, filled with numbers
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.eval_shape(functools.partial(JT.init, cut(j_get_config)),
                       jax.random.PRNGKey(1)))
    params = from_jax_numpy(cfg, tree, device="cpu")
    for i, layer in enumerate(params["layers"]):
        stack = tree["scan"][i % 8]
        assert set(layer["cell"]) == set(stack["cell"])
        leaf = "r" if cfg.block_kinds[i] == "slstm" else "wq"
        got = layer["cell"][leaf]
        np.testing.assert_array_equal(
            (got if leaf == "r" else got["w"]).numpy(),
            stack["cell"][leaf][i // 8] if leaf == "r"
            else stack["cell"][leaf]["w"][i // 8])
    assert tuple(params["layers"][7]["cell"]["r"].shape) == (4, 2, 32, 32)
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(mine["layers"], params["layers"]):
        assert ({k: tuple(v.shape) for k, v in a["cell"].items()
                 if not isinstance(v, dict)}
                == {k: tuple(v.shape) for k, v in b["cell"].items()
                    if not isinstance(v, dict)})
    assert set(mine) == set(params) == {"layers", "final_norm", "embed",
                                        "lm_head"}


# --------------------------------------------------------------------------
# the modules, in process, against repro.models.ssm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_recurrence_matches_reference(normalize):
    """One executor (P 1): the chunked recurrence at chunks of 8 over 64
    rows, its output and end state, against the reference's."""
    import jax
    from repro.models import ssm as JS
    from repro.models.context import FullContext as JFull
    from repro_torch.models import ssm as S
    from repro_torch.models.context import FullContext
    args = _recurrence_inputs(5)
    want_y, want_s = jax.jit(lambda *a: JS.chunked_linear_attention(
        *a, chunk=CHUNK, ctx=JFull(), normalize=normalize,
        return_state=True))(*args)
    y, s = S.chunked_linear_attention(*_t(*args), chunk=CHUNK,
                                      ctx=FullContext(),
                                      normalize=normalize, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=1e-4)


def test_recurrence_refuses_a_ragged_chunk():
    """N must be a multiple of the chunk, as the reference asserts."""
    from repro_torch.models import ssm as S
    from repro_torch.models.context import FullContext
    args = _t(*_recurrence_inputs(5))
    with pytest.raises(ValueError, match="not divisible"):
        S.chunked_linear_attention(*args, chunk=24, ctx=FullContext())


@pytest.mark.parametrize("normalize", [False, True])
def test_sharded_recurrence_matches_reference(jax_ref, normalize):
    """P 4 through the port's ShardedPrismContext (the state handed
    across the shards, two chunks a shard) against the reference's under
    shard_map: every row's output, and the sequence's end state."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import ssm as S
    from repro_torch.sharding.context import ShardedPrismContext
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="prism"),
                              n_shards=P)
    b, n = REC["b"], REC["n"]
    args = [t.reshape(b * P, n // P, *t.shape[2:])
            for t in _t(*_recurrence_inputs(5))]
    y, s = S.chunked_linear_attention(*args, chunk=CHUNK, ctx=ctx,
                                      normalize=normalize, return_state=True)
    key = f"rec/norm{int(normalize)}"
    np.testing.assert_allclose(y.reshape(b, n, *y.shape[2:]).numpy(),
                               jax_ref[f"{key}/y"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), jax_ref[f"{key}/s"], atol=1e-5,
                               rtol=1e-4)


def test_state_handoff_is_the_exclusive_prefix():
    """Shard p's incoming state is the composition of shards 0..p-1's
    totals, zeros for shard 0, per sequence."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.sharding.context import ShardedPrismContext
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="voltage"),
                              n_shards=P)
    g = torch.Generator().manual_seed(0)
    la = -torch.rand(2 * P, 3, generator=g)
    u = torch.randn(2 * P, 3, 4, 5, generator=g)
    got = ctx.state_handoff(la, u).view(2, P, 3, 4, 5)
    la, u = la.view(2, P, 3), u.view(2, P, 3, 4, 5)
    want = torch.zeros_like(u[:, 0])
    for p in range(P):
        torch.testing.assert_close(got[:, p], want)
        want = la[:, p].exp()[..., None, None] * want + u[:, p]


def _cells(kind):
    from repro_torch.models import ssm as S
    cfg, p = _cell_params(kind)
    tp = {k: ({n: torch.tensor(a) for n, a in v.items()}
              if isinstance(v, dict) else torch.tensor(v))
          for k, v in p.items()}
    if kind == "mlstm":
        return cfg, p, tp, S.mlstm_apply, S.mlstm_decode
    return cfg, p, tp, S.slstm_apply, S.slstm_decode


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_apply_and_decode_match_reference(kind):
    """A cell at P 1 over 64 rows (the mLSTM in chunks of 8), its end
    state, then three decode steps from that state: each step's output
    and state against the reference's (the port's state updated in
    place)."""
    import jax
    from repro.models import ssm as JS
    from repro.models.context import FullContext as JFull
    from repro_torch.models.context import FullContext
    cfg, p, tp, apply, decode = _cells(kind)
    heads = cfg.n_ssm_heads
    x = _cell_input(cfg.d_model, 7)
    kw = dict(chunk=CHUNK) if kind == "mlstm" else {}
    j_apply = JS.mlstm_apply if kind == "mlstm" else JS.slstm_apply
    j_decode = jax.jit(functools.partial(
        JS.mlstm_decode if kind == "mlstm" else JS.slstm_decode,
        heads=heads))
    want_y, want_s = jax.jit(lambda p_, x_: j_apply(
        p_, x_, heads=heads, ctx=JFull(), return_state=True, **kw))(p, x)
    y, s = apply(tp, torch.as_tensor(x), heads=heads, ctx=FullContext(),
                 return_state=True, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=1e-4)
    s = s.contiguous()
    ptr = s.data_ptr()
    for i in range(DECODE_STEPS):
        xt = _cell_input(cfg.d_model, 20 + i, n=1)
        want_y, want_s = j_decode(p, xt, want_s)
        y, s = decode(tp, torch.as_tensor(xt), s, heads=heads)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   atol=1e-5, rtol=1e-4, err_msg=str(i))
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s),
                                   atol=1e-5, rtol=1e-4, err_msg=str(i))
    assert s.data_ptr() == ptr


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_sharded_cell_matches_reference(jax_ref, kind):
    """A cell at P 4 through the port's sharded context (the mLSTM's
    state handoff, the sLSTM's gathered scan) against the reference's
    under shard_map: every row, and the end state."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.sharding.context import ShardedPrismContext
    cfg, _, tp, apply, _ = _cells(kind)
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="prism"),
                              n_shards=P)
    x = torch.as_tensor(_cell_input(cfg.d_model, 7))
    kw = dict(chunk=CHUNK) if kind == "mlstm" else {}
    y, s = apply(tp, x.reshape(B * P, N // P, -1), heads=cfg.n_ssm_heads,
                 ctx=ctx, return_state=True, **kw)
    np.testing.assert_allclose(y.reshape(B, N, -1).numpy(),
                               jax_ref[f"{kind}/sharded/y"], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), jax_ref[f"{kind}/sharded/s"],
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_uneven_split_is_refused(kind):
    """Alg. 1's uneven split (66 rows over 4 shards: 16/16/16/18, padded)
    would run a recurrent state through the pad rows: refused."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.sharding.context import ShardedPrismContext
    cfg, _, tp, apply, _ = _cells(kind)
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="voltage"),
                              n_shards=P, n=66)
    x = ctx.shard(torch.as_tensor(_cell_input(cfg.d_model, 7, n=66)))
    kw = dict(chunk=2) if kind == "mlstm" else {}
    with pytest.raises(NotImplementedError, match="even split"):
        apply(tp, x, heads=cfg.n_ssm_heads, ctx=ctx, **kw)


# --------------------------------------------------------------------------
# the slice: forward, prefill and decode in three pairings
# --------------------------------------------------------------------------

def test_forward_matches_reference(jax_ref, serve_runs):
    err = M.rel_err(serve_runs["forward"], jax_ref["forward"])
    assert err <= 1e-5, err


@pytest.mark.parametrize("pairing", PAIRINGS, ids=lambda p: "-".join(p))
def test_prefill_and_decode_logits_match_reference(jax_ref, serve_runs,
                                                   pairing):
    case = _case(pairing)
    run = serve_runs[case]
    for key in ["prefill_logits"] + [f"step{i}_logits"
                                     for i in range(STEPS)]:
        err = M.rel_err(run[key], jax_ref[f"{case}/{key}"])
        assert err <= 1e-4, (key, err)


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("pairing", PAIRINGS, ids=lambda p: "-".join(p))
def test_states_match_reference(jax_ref, serve_runs, pairing, stage):
    """Every layer's state leaf (the mLSTM's (B, H, 256, 257), the
    sLSTM's (B, 3, H, 128)) after prefill and after the 8 steps, at 1e-5
    absolute and 1e-4 relative, the absolute part no tighter than 1e-6
    of the leaf's largest |value|."""
    case = _case(pairing)
    for layer, c in enumerate(serve_runs[case][f"cache_{stage}"]):
        assert set(c) == {"s"}
        w = jax_ref[f"{case}/cache_{stage}/{layer}/s"][0]
        atol = max(1e-5, 1e-6 * float(np.abs(w).max()))
        np.testing.assert_allclose(c["s"], w, atol=atol, rtol=1e-4,
                                   err_msg=f"{case} {stage} {layer}")


def test_pairings_agree(jax_ref, serve_runs):
    """No layer of xLSTM reads the exchange or the means cache: the three
    pairings give the same logits and states, the port's bit for bit and
    the reference's within the tolerance."""
    base = serve_runs[_case(PAIRINGS[0])]
    for pairing in PAIRINGS[1:]:
        run = serve_runs[_case(pairing)]
        for key in ["prefill_logits"] + [f"step{i}_logits"
                                         for i in range(STEPS)]:
            np.testing.assert_array_equal(run[key], base[key])
            err = M.rel_err(jax_ref[f"{_case(pairing)}/{key}"],
                            jax_ref[f"{_case(PAIRINGS[0])}/{key}"])
            assert err <= 1e-5, (pairing, key, err)
        for a, b in zip(run["cache_final"], base["cache_final"]):
            np.testing.assert_array_equal(a["s"], b["s"])


def test_exact_decode_matches_full_forward(jax_ref, serve_runs):
    """Voltage prefill + exact decode, teacher-forced, equals the
    reference's full forward over prompt + forced tokens (chunks of 8
    over 72 rows)."""
    run = serve_runs[_case(("voltage", "exact"))]
    for i in range(-1, STEPS):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = M.rel_err(got, jax_ref["forward"][:, N + i])
        assert err <= 1e-4, (i, err)


def test_decode_updates_the_state_in_place(serve_runs):
    """A decode step writes each state leaf where it lies (the full
    model's mLSTM state is 134 MB a layer at B 8)."""
    for pairing in PAIRINGS:
        run = serve_runs[_case(pairing)]
        assert run["storage"] == run["storage_final"]


# --------------------------------------------------------------------------
# refusals and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("program", ["engine", "launcher", "chunk",
                                     "packed", "paged"])
def test_position_addressed_programs_refuse_xlstm(port, program):
    """The engine (built directly, or by the launcher's ``--engine``),
    the tick programs and the paged cache need position-addressed
    attention caches: a recurrent state takes in every token it sees."""
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve import (ServeHParams, init_cache,
                                           layer_cache_shape, make_layout)
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params = port
    hp = ServeHParams()
    lay = make_layout(P, 36, hp, prefill_len=32)
    t = torch.zeros(4, dtype=torch.long)
    words = {"engine": "static serve path serves attn_local, mlstm, "
                       "slstm, mamba and shared_attn",
             "launcher": "static serve path serves",
             "chunk": "block kind 'mlstm'", "packed": "block kind 'mlstm'",
             "paged": "block kind 'slstm'"}[program]
    with pytest.raises(ValueError, match=words):
        if program == "engine":
            ServingEngine(cfg, params, EngineConfig(
                n_slots=2, prefill_len=32, max_cache=36, hp=hp), n_seq=P)
        elif program == "launcher":
            launch.main(["--arch", ARCH, "--reduced", "--engine",
                         "--device", "cpu", "--requests", "2", "--batch",
                         "2", "--prompt-len", "32", "--gen", "2"])
        elif program == "chunk":
            chunk_prefill_step(cfg, params, init_cache(cfg, lay, 4, hp,
                                                       "cpu"),
                               t[:, None], t, t, lay, hp)
        elif program == "packed":
            packed_step(cfg, params, init_cache(cfg, lay, 4, hp, "cpu"), t,
                        t, t, t, t, lay, hp)
        else:
            layer_cache_shape(cfg, lay, 4, hp, types.SimpleNamespace(),
                              kind="slstm")


def test_reference_engine_refuses_xlstm():
    """The reference's engine refuses the recurrent kinds too."""
    import jax
    from repro.configs import get_config
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine
    with pytest.raises(ValueError, match="mlstm"):
        ServingEngine(xlstm_config(get_config),
                      jax.make_mesh((1, 1), ("data", "model")), {},
                      EngineConfig(n_slots=2, prefill_len=32, max_cache=36,
                                   hp=ServeHParams(backend="jnp")))


def test_launcher_serves_xlstm(port):
    """``setup`` / ``StaticServe.run`` at the reduced size on the CPU
    (the default chunk of 128 over shards of 16 rows is one chunk)."""
    from repro_torch.launch.serve import setup
    cfg, params = port
    run = setup(ARCH, batch=2, prompt_len=64, gen=3, device="cpu",
                reduced=True, params=params, decode_mode="prism")
    tokens, logits, _ = run.run()
    assert tuple(tokens.shape) == (2, 3) and bool(torch.isfinite(
        logits).all())
    assert run.embeds is None and tuple(run.prompts.shape) == (2, 64)


@pytest.mark.parametrize("fault", [None, "decode"])
def test_chip_smoke_recurrent_check(port, fault, monkeypatch):
    """``chip_smoke.py::recurrent_check`` at the reduced size on the CPU:
    the static path passes against its float64 witness, each cell's
    output recorded at all 40 positions; a relative fault of 1e-3 in the
    mLSTM's decode steps alone fails the per-cell gate."""
    import importlib.util

    from repro_torch.launch.serve import setup
    from repro_torch.models import transformer as T
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = 8                              # 32 + 8 rows: chunks of 8 and 4
    monkeypatch.setattr(cs, "GEN", gen)
    monkeypatch.setattr(cs, "XLSTM_REF_CHUNK", 8)
    if fault:
        step = T.mlstm_decode

        def faulty(*a, **kw):
            y, state = step(*a, **kw)
            return y * (1 + 1e-3), state
        monkeypatch.setattr(T, "mlstm_decode", faulty)
    cfg, params = port
    run = setup(ARCH, batch=B, prompt_len=32, gen=gen, device="cpu",
                reduced=True, params=params)
    tokens, logits, _ = run.run()
    if fault:
        with pytest.raises(AssertionError, match="cell's output"):
            cs.recurrent_check(torch, run, tokens, logits)
        return
    err, limit, ref, extra = cs.recurrent_check(torch, run, tokens, logits)
    assert tuple(ref.shape) == (gen, B, cfg.vocab_size)
    assert ref.dtype == torch.float64
    assert len(extra["layer_rel_err"]) == cfg.n_layers == 2
    assert extra["layer_rel_err_max"] < 1e-5 and err <= limit
    for mine, base in zip(extra["layer_rel_err"],
                          extra["layer_plain_f32_rel_err"]):
        assert mine[1] <= 4 * base[1] and mine[2] <= 4 * base[2]
    assert limit >= cs.PATH_REL_TOL
    cs.tokens_agree(torch, tokens, ref)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
