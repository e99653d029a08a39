"""The port's Zamba2 against the JAX reference, on the CPU.

Zamba2 2.7B (``models/ssm.py``'s Mamba2 blocks: a causal depthwise conv
whose halo comes from the previous sequence shard, then the chunked
linear recurrence whose state is handed across the shards; and every
6th layer one shared attention + MLP block, ``params["shared"]``)
reduced to d_model 256 and 4 layers, ``mamba, shared_attn, mamba,
shared_attn``, with the attention's head dim set back to 80 (4 heads of
80: the head dim new to the kernels), 2 SSM heads of 256, d_state 16.
P = 4 sequence shards of 16 rows and a recurrence chunk of 8
(``ssm_chunk``), so every shard has two chunks; 8 decode steps make the
full forward's 72 rows a multiple of the chunk.

In process, against ``repro.models.ssm``: Mamba2's apply and decode at
P 1.  A module fixture runs this file as a subprocess (``--jax-ref
OUT.npz``) with four fake host devices set in the child's environment
only: on a (1, 4) mesh with the jnp backend the child runs ``mamba2_apply``
through the reference's ``ShardedPrismContext`` under ``shard_map`` (the
``prev_tail`` halo, the state handoff, the end state and tail), the full
forward, and ``make_prefill_step`` / ``make_serve_step`` (B 2, prompt 64,
8 teacher-forced steps) in the three pairings, and saves the parameters
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

ARCH = "zamba2-2.7b"
P, B, CR = 4, 2, 4.0
N, STEPS, CHUNK = 64, 8, 8          # shards of 16 rows: two chunks each
CAP = N + STEPS
PAIRINGS = [("voltage", "exact"), ("prism", "prism"), ("voltage", "prism")]
DECODE_STEPS = 3
# logits: 1e-4 of the reference's largest |logit|, as every family's
# static path; a cell's output, state and tail: 1e-4 relative and 1e-5
# absolute, the absolute part no tighter than 1e-5 of the leaf's largest
# |value| (the SSM sums terms larger than their result: at P 1 the
# port's output is 3.7e-6 of its largest |value| from the float64 form,
# the reference's 1.8e-6, apart by 5.5e-6); the serving caches the same,
# since every layer after the first reads rows through such a cell
LOGIT_TOL = 1e-4
CELL_ATOL = 1e-5


def assert_cell_close(got, want, what):
    want = np.asarray(want)
    atol = max(1e-5, CELL_ATOL * float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=1e-4,
                               err_msg=what)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def zamba_config(get_config):
    """The test's config from either package's registry: the reduced
    pattern, four layers, head dim 80."""
    return dataclasses.replace(get_config(ARCH).reduced(n_layers=4),
                               head_dim=80)


def _case(pairing):
    return f"{pairing[0]}-{pairing[1]}"


def _serve_inputs(vocab):
    rng = np.random.default_rng(13)
    prompts = rng.integers(1, vocab, size=(B, N)).astype(np.int32)
    forced = rng.integers(1, vocab, size=(B, STEPS)).astype(np.int32)
    return prompts, forced


def _cell_input(d, seed, n=N):
    return np.random.default_rng(seed).standard_normal((B, n, d)).astype(
        np.float32)


def _cell_kw(cfg):
    return dict(heads=cfg.n_ssm_heads, d_state=cfg.ssm_state,
                expand=cfg.ssm_expand, conv=cfg.ssm_conv)


def _cell_params():
    """A Mamba2 cell's weights from the reference's init at the reduced
    widths (d 256, 2 heads, d_state 16, expansion 2, conv 4), with a_log,
    dt_bias and d_skip drawn too (the init leaves them constant): numpy
    leaves."""
    import jax
    from repro.configs import get_config
    from repro.models import ssm as JS
    cfg = zamba_config(get_config)
    p = jax.tree.map(np.asarray, JS.mamba2_init(
        jax.random.PRNGKey(3), cfg.d_model, cfg.n_ssm_heads, cfg.ssm_state,
        cfg.ssm_expand, cfg.ssm_conv))
    rng = np.random.default_rng(4)
    h = cfg.n_ssm_heads
    p["a_log"] = (0.3 * rng.standard_normal(h)).astype(np.float32)
    p["dt_bias"] = (0.5 * rng.standard_normal(h)).astype(np.float32)
    p["d_skip"] = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    return cfg, p


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
    cfg = zamba_config(get_config)
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    K._flatten(jax.tree.map(np.asarray, params), "params", out)

    # Mamba2 through the sharded context: the halo, the handoff
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="prism"),
                              axis="model", n_shards=P)
    _, p = _cell_params()
    y, st = jax.jit(shard_map(
        lambda xl: JS.mamba2_apply(p, xl, ctx=ctx, chunk=CHUNK,
                                   return_state=True, **_cell_kw(cfg)),
        mesh=mesh, in_specs=(PS(None, "model"),),
        out_specs=(PS(None, "model"), PS()), check_vma=False))(
            jnp.asarray(_cell_input(cfg.d_model, 7)))
    out["mamba/sharded/y"] = np.asarray(y)
    out["mamba/sharded/s"] = np.asarray(st["s"])
    out["mamba/sharded/tail"] = np.asarray(st["tail"])

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
        for j, kind in enumerate(("mamba", "attn")):
            K._flatten(cache["scan"][j], f"{case}/cache_prefill/{kind}", out)
        step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B, cap=CAP,
                                        prefill_len=N, hp=hp)
        for i in range(STEPS):
            pos = jnp.full((B,), N + i, jnp.int32)
            logits, cache = step(params, cache, jnp.asarray(forced[:, i]),
                                 pos)
            out[f"{case}/step{i}_logits"] = np.asarray(logits)
        for j, kind in enumerate(("mamba", "attn")):
            K._flatten(cache["scan"][j], f"{case}/cache_final/{kind}", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_zamba2") / "ref.npz"
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


def _numpy_tree(cfg, flat, prefix):
    """The reference's parameter pytree from its flattened leaves: a
    ``shared_attn`` unit position holds no leaf, so its ``{}`` is put
    back in the scan list."""
    K, _ = M._helpers()
    tree = K._unflatten(flat, prefix)
    u = cfg.scan_split[0]
    scan = iter(tree["scan"])
    tree["scan"] = [{} if kind == "shared_attn" else next(scan)
                    for kind in cfg.block_kinds[:u]]
    return tree


@pytest.fixture(scope="module")
def port(jax_ref):
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    cfg = zamba_config(get_config)
    return cfg, from_jax_numpy(cfg, _numpy_tree(cfg, jax_ref, "params"),
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
        run = {"lay": lay, "prefill_logits": logits.numpy(),
               "cache_prefill": [{k: t.clone().numpy() for k, t in c.items()}
                                 for c in cache],
               "storage": [{k: t.data_ptr() for k, t in c.items()}
                           for c in cache]}
        for i in range(STEPS):
            pos = torch.full((B,), N + i, dtype=torch.long)
            logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                       lay, hp)
            run[f"step{i}_logits"] = logits.numpy()
        run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                              for c in cache]
        run["storage_final"] = [{k: t.data_ptr() for k, t in c.items()}
                                for c in cache]
        runs[_case(pairing)] = run
    return runs


def _t(tree):
    return {k: torch.tensor(v) if not isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# the config and the parameters
# --------------------------------------------------------------------------

def test_config_is_zamba2():
    """The full config the card runs: 45 Mamba2 blocks and 9
    ``shared_attn`` layers (every 6th), d 2560, 32 heads of 80 (MHA),
    32 SSM heads of 160 (d_in 5120), d_state 64, conv 4, GELU d_ff 10240,
    an untied head over 32000; its cache leaves at B 8; the reduced one
    here."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ServeHParams, layer_cache_shape,
                                           make_layout)
    cfg = get_config(ARCH)
    T.check_supported(cfg)
    kinds = cfg.block_kinds
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_conv, cfg.d_ff,
            cfg.vocab_size) == (54, 2560, 32, 32, 80, 32, 64, 4, 10240,
                                32000)
    assert kinds.count("shared_attn") == 9
    assert kinds[5::6] == ("shared_attn",) * 9
    assert cfg.scan_split == (6, 9, 0) and not cfg.tie_embeddings
    for mode in ("exact", "prism"):
        hp = ServeHParams(decode_mode=mode)
        lay = make_layout(P, 576, hp, prefill_len=512)
        assert layer_cache_shape(cfg, lay, 8, hp, kind="mamba") == {
            "s": (8, 32, 64, 160), "tail": (8, 3, 5120)}
        attn = layer_cache_shape(cfg, lay, 8, hp, kind="shared_attn")
        assert attn == layer_cache_shape(cfg, lay, 8, hp, kind="attn")
        assert attn["k"] == (8, P, 144, 32, 80)
        assert ("kz" in attn) == (mode == "prism")
    small = zamba_config(get_config)
    assert small.block_kinds == ("mamba", "shared_attn") * 2
    assert (small.hd, small.n_ssm_heads, small.ssm_state) == (80, 2, 16)


def test_convert_takes_the_6_layer_unit():
    """Zamba2's layers are stored as 6 stacked trees (5 Mamba2, 1 empty
    ``shared_attn``): layer i·6 + j is slice i of scan[j]; a 12-layer cut
    of the full pattern comes across in depth order, each shared_attn
    layer ``{}``, the shared block once; ``init`` builds the same tree."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as JT
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.models import transformer as T

    def cut(get):
        full = get(ARCH)
        return dataclasses.replace(
            full, n_layers=12, blocks=full.block_kinds[:12], d_model=64,
            n_heads=2, n_kv_heads=2, head_dim=80, ssm_heads=2, ssm_state=8,
            d_ff=96, vocab_size=32)
    cfg = cut(get_config)
    assert cfg.scan_split == (6, 2, 0)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.eval_shape(functools.partial(JT.init, cut(j_get_config)),
                       jax.random.PRNGKey(1)))
    params = from_jax_numpy(cfg, tree, device="cpu")
    names = {"in", "conv", "a_log", "dt_bias", "d_skip", "ynorm", "out"}
    for i, layer in enumerate(params["layers"]):
        stack = tree["scan"][i % 6]
        if cfg.block_kinds[i] == "shared_attn":
            assert layer == {} and stack == {}
            continue
        assert set(layer["cell"]) == names
        np.testing.assert_array_equal(layer["cell"]["conv"].numpy(),
                                      stack["cell"]["conv"][i // 6])
        np.testing.assert_array_equal(layer["cell"]["in"]["w"].numpy(),
                                      stack["cell"]["in"]["w"][i // 6])
    np.testing.assert_array_equal(params["shared"]["attn"]["wq"]["w"],
                                  tree["shared"]["attn"]["wq"]["w"])
    np.testing.assert_array_equal(params["shared"]["mlp"]["up"]["w"],
                                  tree["shared"]["mlp"]["up"]["w"])
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    assert [shapes(a) for a in mine["layers"]] == [
        shapes(b) for b in params["layers"]]
    assert shapes(mine["shared"]) == shapes(params["shared"])
    assert set(mine) == set(params) == {"layers", "final_norm", "embed",
                                        "lm_head", "shared"}


# --------------------------------------------------------------------------
# the modules, in process and at P 4
# --------------------------------------------------------------------------

def test_prev_tail_is_the_previous_shards_rows():
    """The conv halo: one executor starts at the sequence's start
    (zeros); over P shards shard 0 gets zeros and shard p the last rows
    of shard p - 1 of the same sequence."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models.context import FullContext
    from repro_torch.sharding.context import ShardedPrismContext
    x = torch.randn(2, 64, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(FullContext().prev_tail(x, 3), torch.zeros(2, 3, 5))
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="voltage"),
                              n_shards=P)
    halo = ctx.prev_tail(x.reshape(2 * P, 16, 5), 3).view(2, P, 3, 5)
    assert torch.equal(halo[:, 0], torch.zeros(2, 3, 5))
    for p in range(1, P):
        torch.testing.assert_close(halo[:, p], x[:, 16 * p - 3:16 * p],
                                   rtol=0, atol=0)


def test_mamba2_apply_and_decode_match_reference():
    """A Mamba2 cell at P 1 over 64 rows (chunks of 8): the output, the
    end state and the conv tail, then three decode steps from them, each
    step's output, state and tail against the reference's; the port's
    state and tail are updated in place."""
    import jax
    from repro.models import ssm as JS
    from repro.models.context import FullContext as JFull
    from repro_torch.models import ssm as S
    from repro_torch.models.context import FullContext
    cfg, p = _cell_params()
    tp, kw = _t(p), _cell_kw(cfg)
    x = _cell_input(cfg.d_model, 7)
    want_y, want_c = jax.jit(lambda p_, x_: JS.mamba2_apply(
        p_, x_, ctx=JFull(), chunk=CHUNK, return_state=True, **kw))(p, x)
    y, c = S.mamba2_apply(tp, torch.as_tensor(x), ctx=FullContext(),
                          chunk=CHUNK, return_state=True, **kw)
    assert_cell_close(y, want_y, "y")
    for name in ("s", "tail"):
        assert_cell_close(c[name], want_c[name], name)
    c = {k: t.clone() for k, t in c.items()}
    ptrs = {k: t.data_ptr() for k, t in c.items()}
    j_decode = jax.jit(functools.partial(JS.mamba2_decode, **kw))
    for i in range(DECODE_STEPS):
        xt = _cell_input(cfg.d_model, 20 + i, n=1)
        want_y, want_c = j_decode(p, xt, want_c)
        y, c = S.mamba2_decode(tp, torch.as_tensor(xt), c, **kw)
        assert_cell_close(y, want_y, f"y {i}")
        for name in ("s", "tail"):
            assert_cell_close(c[name], want_c[name], f"{name} {i}")
    assert {k: t.data_ptr() for k, t in c.items()} == ptrs


def test_sharded_mamba2_matches_reference(jax_ref):
    """The cell at P 4 through the port's sharded context (the conv's
    halo from the previous shard, the state handed across the shards,
    two chunks a shard) against the reference's under shard_map: every
    row, the sequence's end state and its conv tail."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import ssm as S
    from repro_torch.sharding.context import ShardedPrismContext
    cfg, p = _cell_params()
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="prism"),
                              n_shards=P)
    x = torch.as_tensor(_cell_input(cfg.d_model, 7))
    y, c = S.mamba2_apply(_t(p), x.reshape(B * P, N // P, -1), ctx=ctx,
                          chunk=CHUNK, return_state=True, **_cell_kw(cfg))
    assert_cell_close(y.reshape(B, N, -1), jax_ref["mamba/sharded/y"], "y")
    for name in ("s", "tail"):
        assert_cell_close(c[name], jax_ref[f"mamba/sharded/{name}"], name)


def test_uneven_split_is_refused():
    """Alg. 1's uneven split (66 rows over 4 shards: 16/16/16/18, padded)
    would run the conv halo and the state through the pad rows:
    refused."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import ssm as S
    from repro_torch.sharding.context import ShardedPrismContext
    cfg, p = _cell_params()
    ctx = ShardedPrismContext(PrismConfig(P=P, L=2, mode="voltage"),
                              n_shards=P, n=66)
    x = ctx.shard(torch.as_tensor(_cell_input(cfg.d_model, 7, n=66)))
    with pytest.raises(NotImplementedError, match="even split"):
        ctx.prev_tail(x, 3)
    with pytest.raises(NotImplementedError, match="even split"):
        S.mamba2_apply(_t(p), x, ctx=ctx, chunk=2, **_cell_kw(cfg))


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
        assert err <= LOGIT_TOL, (key, err)


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("pairing", PAIRINGS, ids=lambda p: "-".join(p))
def test_caches_match_reference(jax_ref, serve_runs, pairing, stage):
    """Every Mamba2 layer's state (B, 2, 16, 256) and conv tail (B, 3,
    512), and every shared layer's attention leaves (K/V, and the means
    cache in prism mode), after prefill and after the 8 steps, under
    ``CELL_ATOL``."""
    case = _case(pairing)
    run = serve_runs[case]
    caches = run[f"cache_{stage}"]
    prefix = f"{case}/cache_{stage}"
    mamba = [c for c, k in zip(caches, ("mamba", "shared_attn") * 2)
             if k == "mamba"]
    for unit, c in enumerate(mamba):
        assert set(c) == {"s", "tail"}
        for name in ("s", "tail"):
            assert_cell_close(c[name], jax_ref[f"{prefix}/mamba/{name}"][unit],
                              f"{prefix} {name} {unit}")
    M.assert_leaves(caches[1::2], jax_ref, f"{prefix}/attn", pairing[1], B,
                    run["lay"], atol_rel=CELL_ATOL)


def test_exact_decode_matches_full_forward(jax_ref, serve_runs):
    """Voltage prefill + exact decode, teacher-forced, equals the
    reference's full forward over prompt + forced tokens (chunks of 8
    over 72 rows)."""
    run = serve_runs[_case(("voltage", "exact"))]
    for i in range(-1, STEPS):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = M.rel_err(got, jax_ref["forward"][:, N + i])
        assert err <= LOGIT_TOL, (i, err)


def test_decode_updates_state_and_tail_in_place(serve_runs):
    """A decode step writes each Mamba2 layer's state and tail, and each
    shared layer's K/V, where they lie."""
    for pairing in PAIRINGS:
        run = serve_runs[_case(pairing)]
        assert run["storage"] == run["storage_final"]


def test_shared_layers_write_their_own_caches(port, serve_runs):
    """The two shared_attn layers hold no weights of their own and read
    one weight set, and each keeps a cache of its own: different K/V
    (their inputs differ), both written by every decode step."""
    cfg, params = port
    assert params["layers"][1] == params["layers"][3] == {}
    assert "shared" in params
    for pairing in PAIRINGS:
        run = serve_runs[_case(pairing)]
        first, second = run["cache_final"][1], run["cache_final"][3]
        assert not np.allclose(first["k"], second["k"])
        assert not np.allclose(first["v"], second["v"])
        for c in (first, second):
            pre = run["cache_prefill"][1 if c is first else 3]
            assert not np.array_equal(c["k"], pre["k"])


# --------------------------------------------------------------------------
# refusals, the launcher, the chip check's rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("program", ["engine", "launcher", "chunk",
                                     "packed", "paged"])
def test_position_addressed_programs_refuse_zamba2(port, program):
    """The engine (built directly, or by the launcher's ``--engine``),
    the tick programs and the paged cache need position-addressed
    attention caches: a Mamba2 state and conv tail take in every token
    they see.  The reference refuses the same."""
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve import (ServeHParams, init_cache,
                                           layer_cache_shape, make_layout)
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params = port
    hp = ServeHParams()
    lay = make_layout(P, 36, hp, prefill_len=32)
    t = torch.zeros(4, dtype=torch.long)
    words = {"engine": r"\['mamba', 'shared_attn'\].*queue 3",
             "launcher": "static serve path serves attn_local, mlstm, "
                         "slstm, mamba and shared_attn",
             "chunk": "block kind 'mamba'", "packed": "block kind 'mamba'",
             "paged": "block kind 'mamba'"}[program]
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
                              kind="mamba")


def test_reference_refuses_zamba2_on_the_engine():
    """The reference's engine refuses the Mamba2 kind too."""
    import jax
    from repro.configs import get_config
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine
    with pytest.raises(ValueError, match="mamba"):
        ServingEngine(zamba_config(get_config),
                      jax.make_mesh((1, 1), ("data", "model")), {},
                      EngineConfig(n_slots=2, prefill_len=32, max_cache=36,
                                   hp=ServeHParams(backend="jnp")))


def test_launcher_serves_zamba2(capsys):
    """``--arch zamba2-2.7b --reduced --device cpu`` serves the static
    path (prism + prism) and prints its tokens."""
    from repro_torch.launch import serve as launch
    launch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "64", "--gen", "3", "--decode-mode",
                 "prism"])
    out = capsys.readouterr().out
    assert "[serve] zamba2-2.7b-smoke prism+prism: prefill 2x64" in out


@pytest.mark.parametrize("fault", [None, "decode"])
def test_chip_smoke_recurrent_check(port, fault, monkeypatch):
    """``chip_smoke.py::recurrent_check`` on Zamba2 at the reduced size
    on the CPU: the static path passes against its float64 witness, each
    Mamba2 cell's output recorded at all 40 positions (the shared layers
    have no cell); a relative fault of 1e-3 in the Mamba2 decode steps
    alone fails the per-cell gate."""
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
        step = T.mamba2_decode

        def faulty(*a, **kw):
            y, cache = step(*a, **kw)
            return y * (1 + 1e-3), cache
        monkeypatch.setattr(T, "mamba2_decode", faulty)
    cfg, params = port
    run = setup(ARCH, batch=B, prompt_len=32, gen=gen, device="cpu",
                reduced=True, params=params)
    run.cfg = cfg
    tokens, logits, _ = run.run()
    if fault:
        with pytest.raises(AssertionError, match="cell's output"):
            cs.recurrent_check(torch, run, tokens, logits)
        return
    err, limit, ref, extra = cs.recurrent_check(torch, run, tokens, logits)
    assert tuple(ref.shape) == (gen, B, cfg.vocab_size)
    assert ref.dtype == torch.float64
    assert extra["cell_layers"] == [0, 2]
    assert len(extra["layer_rel_err"]) == 2
    assert extra["layer_rel_err_max"] < 1e-5 and err <= limit
    for mine, base in zip(extra["layer_rel_err"],
                          extra["layer_plain_f32_rel_err"]):
        assert mine[1] <= 4 * base[1] and mine[2] <= 4 * base[2]
    assert limit >= cs.PATH_REL_TOL
    cs.tokens_agree(torch, tokens, ref, err)


@pytest.mark.parametrize("prefill", ["prism", "voltage"])
def test_chip_smoke_plain_witness(port, prefill):
    """``chip_smoke.py::plain_witness`` on Zamba2's prism pairings at the
    reduced size on the CPU: the backend='plain' twin rerun in float64
    (the plain attention, decode, means and RoPE keep float64 rows in
    float64) is the witness; the f32 run lies within ``PATH_REL_TOL`` of
    it here, and the limit is at least that."""
    import importlib.util

    from repro_torch.launch.serve import setup
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg, params = port
    runs = [setup(ARCH, batch=B, prompt_len=32, gen=8, device="cpu",
                  reduced=True, params=params, decode_mode="prism",
                  prefill=prefill, backend=backend)
            for backend in ("auto", "plain")]
    for run in runs:
        run.cfg = cfg
    tokens, logits, _ = runs[0].run()
    _, plain_logits, _ = runs[1].run(forced=tokens[:, :-1])
    err, limit, ref, extra = cs.plain_witness(torch, runs[1], tokens,
                                              logits, plain_logits)
    assert runs[1].params is params
    assert tuple(ref.shape) == (8, B, cfg.vocab_size)
    assert 0 < err == extra["plain_f32_rel_err"] < cs.PATH_REL_TOL
    assert limit == cs.PATH_REL_TOL and extra["plain_twin_rel_err"] == 0
    cs.tokens_agree(torch, tokens, ref, err)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
