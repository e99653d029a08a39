"""The port's encoders (BERT-base and ViT-B/16, the paper's NLU and
vision models) against the JAX reference, on the CPU, in process.

Both are reduced to 2 layers, d_model 256 and 4 heads of 64; ViT keeps
its full config's ``vocab_size=0`` (stub patch embeddings through
``frontend_proj``, no token table).  Weights come from the reference's
``T.init`` through ``convert.from_jax_numpy``; inputs from numpy seeds.
Every comparison holds the class logits to 1e-5 of the reference's
largest |logit| (``TOL``): the full forward, ``encode`` over P = 4
shards in Voltage (against the full forward) and PRISM (against the
reference's ``SimulatedContext`` at N 32, an even split), and ViT's real
197 tokens over Alg. 1's uneven split at P 2, 3 and 4 (against a
block-by-block composition over ``core.protocol.device_views``, the one
reference that takes that split).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.attention import prism_attention as j_prism_attention  # noqa: E402
from repro.core.protocol import PrismConfig as JPrismConfig  # noqa: E402
from repro.core.protocol import device_views  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.context import SimulatedContext  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.core.protocol import PrismConfig  # noqa: E402
from repro_torch.kernels.segment_means import prism_augment_op  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import ticks  # noqa: E402
from repro_torch.runtime.serve import (ServeHParams, encode,  # noqa: E402
                                       generate, make_layout, prefill,
                                       serve_step)
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.sharding.context import ShardedPrismContext  # noqa: E402

ARCHS = ("bert-base", "vit-b16")
P, CR, B = 4, 4.0, 2
N_EVEN, N_VIT = 32, 197
TOL = 1e-5                  # of the reference's largest |logit|


def reduced(arch, get=get_config):
    """The reduced config of either package; ViT without a vocabulary,
    as its full config has none."""
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, vocab_size=0) if cfg.frontend else cfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, port config, reference config, reference numpy tree, port
    parameters on the CPU)."""
    arch = request.param
    cfg, j_cfg = reduced(arch), reduced(arch, j_get_config)
    tree = jax.tree.map(np.asarray, JT.init(j_cfg, jax.random.PRNGKey(0)))
    return arch, cfg, j_cfg, tree, from_jax_numpy(cfg, tree, device="cpu")


def inputs(cfg, n, seed=1):
    """Token ids (B, n) or, for a frontend model, stub embeddings
    (B, n, D): numpy, from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return rng.integers(1, cfg.vocab_size, size=(B, n)).astype(np.int32)


def as_kw(cfg, x, torch_side):
    """The call's input keyword: ``tokens`` or ``embeds``."""
    if torch_side:
        x = torch.as_tensor(x, dtype=torch.long if x.dtype == np.int32
                            else torch.float32)
    else:
        x = jnp.asarray(x)
    return {"embeds": x} if cfg.frontend else {"tokens": x}


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f"rel err {err:.3e} > {TOL}"


def port_encode(cfg, params, x, mode, **prism):
    return encode(cfg, params, **as_kw(cfg, x, True),
                  prism=PrismConfig(P=P, mode=mode, **prism), n_shards=P,
                  hp=ServeHParams())


def j_forward(j_cfg, tree, x, ctx=None):
    kw = as_kw(j_cfg, x, False)
    return JT.forward(j_cfg, tree, kw.get("tokens"), embeds=kw.get("embeds"),
                      ctx=ctx)[0]


# (a) configs -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(j_get_config(arch)))
    TT.check_supported(get_config(arch))


# (b) convert -----------------------------------------------------------

def test_convert_carries_the_encoder_leaves(model):
    arch, cfg, _, tree, params = model
    d = cfg.d_model
    want = {"layers", "final_norm", "pos_embed", "head"}
    want |= {"frontend_proj"} if cfg.frontend else {"embed"}
    assert set(params) == want
    assert "embed" not in tree if cfg.frontend else "embed" in tree
    assert tuple(params["head"]["w"].shape) == (d, cfg.num_classes)
    assert tuple(params["head"]["b"].shape) == (cfg.num_classes,)
    np.testing.assert_array_equal(params["head"]["w"].numpy(),
                                  tree["head"]["w"])
    if cfg.frontend:
        assert set(params["frontend_proj"]) == {"w"}
        assert tuple(params["frontend_proj"]["w"].shape) == (d, d)
        np.testing.assert_array_equal(params["frontend_proj"]["w"].numpy(),
                                      tree["frontend_proj"]["w"])
    else:
        assert tuple(params["embed"]["table"].shape) == (cfg.vocab_size, d)
    assert len(params["layers"]) == cfg.n_layers == 2
    # the port's own init has the same leaves, shapes and kinds
    own = TT.init(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = lambda t: {k: tuple(v.shape) for k, v in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(own) == flat(params)


# (c) the full forward ------------------------------------------------------

def test_forward_matches_reference(model):
    _, cfg, j_cfg, tree, params = model
    x = inputs(cfg, N_EVEN)
    got = TT.forward(cfg, params, **as_kw(cfg, x, True))
    assert tuple(got.shape) == (B, cfg.num_classes)
    close(got, j_forward(j_cfg, tree, x))


# (d) encode at an even split -------------------------------------------

@pytest.mark.parametrize("mode, prism", [
    ("voltage", {}), ("prism", {"cr": CR}), ("prism", {"L": 1})],
    ids=["voltage", "prism-cr4", "prism-L1"])
def test_encode_even_split(model, mode, prism):
    """Voltage against the full forward; PRISM against the reference's
    SimulatedContext, non-causal (its masks follow the model, the
    PrismConfig says so too)."""
    _, cfg, j_cfg, tree, params = model
    x = inputs(cfg, N_EVEN)
    got = port_encode(cfg, params, x, mode, **prism)
    assert got.dtype == torch.float32
    ctx = (None if mode == "voltage" else SimulatedContext(
        JPrismConfig(P=P, mode=mode, causal=False, **prism)))
    close(got, j_forward(j_cfg, tree, x, ctx))


# (e) ViT's 197 tokens over Alg. 1's uneven split ------------------------

def _views_forward(tree, embeds, *, j_cfg, pcfg):
    """The reference composed block by block over ``device_views`` (the
    pattern of examples/distributed_edge_sim.py, non-causal): each
    device attends over its augmented view with ``norm`` /
    ``attn_project_*`` / ``prism_attention`` / ``mlp``, the partitions
    are concatenated after every block, and the class head reads row
    0."""
    spec = JT.attn_spec(j_cfg, "attn")
    x = JT.embed_inputs(j_cfg, tree, None, jnp.asarray(embeds))
    for _, p in JT.iter_layers(j_cfg, tree):
        outs = []
        for v in device_views(x, pcfg):
            xq = JL.norm(p["ln1"], v.x_p, j_cfg.norm_kind)
            xh = JL.norm(p["ln1"], v.x_hat, j_cfg.norm_kind)
            q = JL.attn_project_q(p["attn"], spec, xq, v.row_pos)
            k, vv = JL.attn_project_kv(p["attn"], spec, xh,
                                       (v.col_lo + v.col_hi) / 2.0)
            g = None if v.g is None else jnp.asarray(v.g, jnp.float32)
            o = j_prism_attention(q, k, vv, g=g, mask=v.mask(pcfg))
            y = v.x_p + JL.attn_output(p["attn"], o)
            outs.append(y + JL.mlp(p["mlp"], JL.norm(p["ln2"], y,
                                                     j_cfg.norm_kind),
                                   j_cfg.mlp_kind))
        x = jnp.concatenate(outs, axis=1)
    return JL.dense(tree["head"], JL.norm(tree["final_norm"], x[:, 0],
                                          j_cfg.norm_kind))


def views_forward(j_cfg, tree, embeds, pcfg):
    """``_views_forward``, jitted: one compile beats hundreds of eager
    dispatches."""
    return jax.jit(_views_forward, static_argnames=("j_cfg", "pcfg"))(
        tree, embeds, j_cfg=j_cfg, pcfg=pcfg)


@pytest.fixture(scope="module")
def vit():
    cfg, j_cfg = reduced("vit-b16"), reduced("vit-b16", j_get_config)
    tree = jax.tree.map(np.asarray, JT.init(j_cfg, jax.random.PRNGKey(0)))
    return cfg, j_cfg, tree, from_jax_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("mode", ["prism", "voltage"])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_vit_uneven_split_matches_device_views(vit, n_shards, mode):
    cfg, j_cfg, tree, params = vit
    x = inputs(cfg, N_VIT, seed=2)
    pcfg = JPrismConfig(P=n_shards, cr=CR, mode=mode, causal=False)
    want = views_forward(j_cfg, tree, x, pcfg)
    got = encode(cfg, params, embeds=torch.as_tensor(x),
                 prism=PrismConfig(P=n_shards, cr=CR, mode=mode),
                 n_shards=n_shards, hp=ServeHParams())
    close(got, want)
    if mode == "voltage":          # exact: the full forward as well
        close(got, j_forward(j_cfg, tree, x))


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_uneven_metadata_matches_device_views(n_shards):
    """The sharded context's PRISM view of each shard, pad rows and
    columns dropped, is ``device_views``': the same x_hat rows in the same
    column order (local block first, then the other shards' means), the
    same repeat counts and position ranges; every pad column is dead."""
    n, d, L = N_VIT, 8, 5
    x = np.random.default_rng(3).standard_normal((1, n, d)).astype(
        np.float32)
    views = device_views(jnp.asarray(x), JPrismConfig(P=n_shards, L=L,
                                                      causal=False))
    ctx = ShardedPrismContext(PrismConfig(P=n_shards, L=L),
                              n_shards=n_shards, n=n)
    xs = ctx.shard(torch.as_tensor(x))
    spec = TT.attn_spec(reduced("vit-b16"))
    xq, akv = ctx.augment(xs, spec)
    n_loc = xs.shape[1]
    for p, v in enumerate(views):
        size = v.x_p.shape[1]
        real = np.r_[np.arange(size), n_loc + np.arange(n_shards * L)]
        own = n_loc + p * L + np.arange(L)                # g = 0 here
        keep = np.setdiff1d(real, own)
        np.testing.assert_array_equal(xq[p, :size].numpy(), v.x_p[0])
        np.testing.assert_allclose(akv.x_hat[p, keep].numpy(), v.x_hat[0],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(akv.g[p, keep].numpy(), v.g)
        np.testing.assert_array_equal(akv.col_lo[p, keep].numpy(),
                                      v.col_lo)
        np.testing.assert_array_equal(akv.col_hi[p, keep].numpy(),
                                      v.col_hi)
        np.testing.assert_array_equal(akv.row_pos[p, :size].numpy(),
                                      v.row_pos)
        dead = np.setdiff1d(np.arange(akv.g.shape[1]), keep)
        assert (akv.g[p, dead] == 0).all()
        assert (akv.row_pos[p, size:] == -1).all()


@pytest.mark.parametrize("n, n_shards, L", [
    (197, 4, 12), (197, 3, 1), (197, 2, 98), (13, 4, 3), (32, 4, 8)])
def test_augment_uneven_split(n, n_shards, L):
    """The augment's plain version under the uneven split: the local
    rows copied whole (pad rows included), each shard's means over its
    real rows at its own Eq. 8 sizes (the last shard's last segment takes
    the remainder), repeated for every shard of the sequence."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, n, 6)).astype(np.float32)
    ctx = ShardedPrismContext(PrismConfig(P=n_shards, L=L),
                              n_shards=n_shards, n=n)
    xs = ctx.shard(torch.as_tensor(x))
    s, r = divmod(n, n_shards)
    got = prism_augment_op(xs, L=L, n_shards=n_shards, n_real=s).numpy()
    n_loc = s + r
    assert got.shape == (2 * n_shards, n_loc + n_shards * L, 6)
    np.testing.assert_array_equal(got[:, :n_loc], xs.numpy())
    for b in range(2):
        for q in range(n_shards):
            size = s + (r if q == n_shards - 1 else 0)
            part = x[b, q * s:q * s + size]
            cut = size // L
            for l in range(L):
                seg = part[l * cut:(l + 1) * cut if l < L - 1 else size]
                want = seg.mean(axis=0)
                for p in range(n_shards):
                    np.testing.assert_allclose(
                        got[b * n_shards + p, n_loc + q * L + l], want,
                        rtol=1e-6, atol=1e-6)


# (f) the paths that decode refuse an encoder ---------------------------

def test_decode_paths_refuse_encoders(model):
    arch, cfg, _, tree, params = model
    hp = ServeHParams()
    lay = make_layout(P, 40, hp, prefill_len=32)
    tok = torch.ones(B, 32, dtype=torch.long)
    prism = PrismConfig(P=P, cr=CR)
    for call in (
            lambda: prefill(cfg, params, tok, prism, lay, hp),
            lambda: serve_step(cfg, params, [], tok[:, 0], tok[:, 0], lay,
                               hp),
            lambda: generate(cfg, params, tok, gen=2, prism=prism, lay=lay,
                             hp=hp),
            lambda: ticks.chunk_prefill_step(cfg, params, [], tok, None,
                                             None, lay, hp),
            lambda: ticks.packed_step(cfg, params, [], tok[0], None, None,
                                      None, None, lay, hp)):
        with pytest.raises(ValueError, match="encoder"):
            call()
    with pytest.raises(ValueError) as err:
        ServingEngine(cfg, params, EngineConfig(n_slots=2, prefill_len=32,
                                                max_cache=40))
    if cfg.frontend:
        # ViT: the reference engine refuses it, in these words
        with pytest.raises(ValueError) as ref:
            JServingEngine(reduced(arch, j_get_config), None, None,
                           JEngineConfig(n_slots=2, prefill_len=32,
                                         max_cache=40))
        assert str(err.value).startswith(str(ref.value))
    else:
        # BERT: the reference would serve it as a decoder; the port
        # refuses it (ROADMAP queue 3)
        assert "encoder" in str(err.value)
    with pytest.raises(ValueError, match="class head"):
        encode(get_config("gpt2-small").reduced(), {}, tok, prism=prism,
               n_shards=P, hp=hp)


def test_embed_inputs_takes_one_input(model):
    _, cfg, _, _, params = model
    x = torch.zeros(B, 4, dtype=torch.long)
    e = torch.zeros(B, 4, cfg.d_model)
    for kw in ({}, {"tokens": x, "embeds": e}):
        with pytest.raises(ValueError, match="one of them"):
            TT.embed_inputs(cfg, params, **kw)


# (g) the launcher ----------------------------------------------------------

def test_launcher_classifies(capsys):
    launch.main(["--arch", "bert-base", "--reduced", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "32", "--prefill",
                 "prism"])
    out = capsys.readouterr().out
    assert "[encode] bert-base-smoke prism (L 2): 2x32 over shards of " \
           "8/8/8/8 tokens" in out
    assert "classes of 2 (first 16 rows): [" in out


@pytest.mark.parametrize("extra", [["--engine"], ["--gen", "4"]])
def test_launcher_refuses_decoding_an_encoder(extra):
    with pytest.raises(SystemExit):
        launch.main(["--arch", "vit-b16", "--reduced", "--device", "cpu",
                     *extra])


def test_launcher_vit_runs_the_uneven_split(capsys):
    run = launch.setup_encoder("vit-b16", batch=B, seq_shards=P,
                               prefill="prism", cr=CR, device="cpu",
                               reduced=True)
    assert tuple(run.embeds.shape) == (B, N_VIT, run.cfg.d_model)
    classes, logits, times = run.run()
    assert tuple(logits.shape) == (B, 1000) and classes.shape == (B,)
    assert times["clock"] == "host"
    # the same batch through the full forward and Voltage: the exact pair
    volt = launch.setup_encoder("vit-b16", batch=B, seq_shards=P,
                                device="cpu", reduced=True)
    ref = TT.forward(volt.cfg, volt.params, embeds=volt.embeds)
    err = float((volt.run()[1] - ref).abs().max() / ref.abs().max())
    assert err <= TOL
