"""The port's MusicGen against the JAX reference, on the CPU.

MusicGen-medium (a stub EnCodec frontend: the prompt is frame embeddings
through ``frontend_proj``, with parameter-free sinusoidal positions; the
generated codes go through ``embed``; LayerNorm, GELU, MHA, an untied
head over 2048 codes) reduced to 2 layers, d_model 256, 4 heads of 64,
a vocabulary of 512.  P = 4 sequence shards of 16 frames, CR 4.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: on a
(1, 4) mesh with the jnp backend the child runs the reference's full
forward over the frames and ``make_prefill_step`` / ``make_serve_step``
(B 2, 64 frames, 8 teacher-forced codes) in the three pairings, and saves
the parameters and every result.  The engine and the tick programs take
token prompts only and refuse the model, in the reference engine's
words.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_moe as M  # noqa: E402

ARCH = "musicgen-medium"
P, B, CR = 4, 2, 4.0
N, STEPS = 64, 8
CAP = N + STEPS
PAIRINGS = [("voltage", "exact"), ("prism", "prism"), ("voltage", "prism")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def musicgen_config(get_config):
    """The test's config from either package's registry."""
    return get_config(ARCH).reduced(d_model=256)


def _case(pairing):
    return f"{pairing[0]}-{pairing[1]}"


def _inputs(cfg):
    """The frames (B, N, D) and the forced codes (B, STEPS)."""
    rng = np.random.default_rng(13)
    frames = rng.standard_normal((B, N, cfg.d_model)).astype(np.float32)
    forced = rng.integers(1, cfg.vocab_size, size=(B, STEPS)).astype(
        np.int32)
    return frames, forced


def jax_reference(out_path):
    """Child process: the reference on a (1, 4) host mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, make_prefill_step,
                                     make_serve_step)
    K, _ = M._helpers()
    cfg = musicgen_config(get_config)
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    K._flatten(jax.tree.map(np.asarray, params), "params", out)
    frames, forced = _inputs(cfg)
    logits, _ = jax.jit(lambda p_, e_: T.forward(cfg, p_, embeds=e_))(
        params, jnp.asarray(frames))
    out["forward"] = np.asarray(logits)
    batch = {"embeds": jnp.asarray(frames)}
    for pairing in PAIRINGS:
        case = _case(pairing)
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR, backend="jnp")
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism, batch=B,
                                         n=N, hp=hp, cap=CAP)
        logits, cache = pre(params, batch)
        out[f"{case}/prefill_logits"] = np.asarray(logits)
        K._flatten(cache["scan"][0], f"{case}/cache_prefill", out)
        step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B, cap=CAP,
                                        prefill_len=N, hp=hp)
        for i in range(STEPS):
            pos = jnp.full((B,), N + i, jnp.int32)
            logits, cache = step(params, cache, jnp.asarray(forced[:, i]),
                                 pos)
            out[f"{case}/step{i}_logits"] = np.asarray(logits)
        K._flatten(cache["scan"][0], f"{case}/cache_final", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_musicgen") / "ref.npz"
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
    cfg = musicgen_config(get_config)
    return cfg, from_jax_numpy(cfg, K._unflatten(jax_ref, "params"),
                               device="cpu")


def frames_and_codes(cfg, params, frames, codes):
    """The rows of the plain full forward over the frames and the codes
    fed after them: the frames through ``embed_inputs`` (positions
    0 .. N - 1), the codes through the decode step's ``embed_tokens`` at
    positions N, N + 1, ..."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import embed_tokens
    n, t = frames.shape[1], codes.shape[1]
    pos = torch.arange(n, n + t).expand(codes.shape[0], t)
    return torch.cat([T.embed_inputs(cfg, params, embeds=frames),
                      embed_tokens(cfg, params, codes, pos)], dim=1)


@pytest.fixture(scope="module")
def serve_runs(port):
    """prefill from the frames + 8 teacher-forced serve_steps in every
    pairing; the plain full forward over the frames, and over the frames
    and the forced codes."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)
    cfg, params = port
    frames, forced = (torch.as_tensor(a) for a in _inputs(cfg))
    forced = forced.long()
    runs = {"forward": T.forward(cfg, params, embeds=frames).numpy(),
            "forward_codes": T.forward_embedded(
                cfg, params, frames_and_codes(cfg, params, frames,
                                              forced)).numpy()}
    for pairing in PAIRINGS:
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR)
        lay = make_layout(P, CAP, hp, prefill_len=N)
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        logits, cache = prefill(cfg, params, None, prism, lay, hp,
                                embeds=frames)
        run = {"lay": lay, "prefill_logits": logits.numpy(),
               "cache_prefill": [{k: t.clone().numpy()
                                  for k, t in c.items()} for c in cache]}
        for i in range(STEPS):
            pos = torch.full((B,), N + i, dtype=torch.long)
            logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                       lay, hp)
            run[f"step{i}_logits"] = logits.numpy()
        run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                              for c in cache]
        runs[_case(pairing)] = run
    return runs


def test_config_is_musicgen():
    """The full config the card runs: 48 layers, d 1536, 24 heads of 64
    (MHA), GELU d_ff 6144, LayerNorm, sinusoidal positions, an untied
    head over 2048 codes, the EnCodec stub; and the reduced one here."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (48, 1536, 24, 24, 64, 6144, 2048)
    assert (cfg.arch_type, cfg.frontend, cfg.pos, cfg.mlp_kind,
            cfg.norm_kind) == ("audio", "encodec_stub", "sincos", "gelu",
                               "layernorm")
    assert not cfg.tie_embeddings and cfg.scan_split == (1, 48, 0)
    small = musicgen_config(get_config)
    assert (small.n_heads, small.n_kv_heads, small.hd) == (4, 4, 64)


@pytest.mark.parametrize("start", [0, 16, 48])
def test_sincos_matches_reference(start):
    """The sinusoidal positions of 16 rows from ``start`` (0, and the
    starts of shards 1 and 3 of a 64-row prompt) against the
    reference's ``sincos_embed``, and the decode step's form at the same
    positions."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    want = np.asarray(JT.sincos_embed(16, 256, start))
    got = T.sincos_embed(16, 256, start)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    pos = torch.arange(start, start + 16)[None].expand(2, 16)
    np.testing.assert_array_equal(T.sincos(pos, 256)[1].numpy(),
                                  got.numpy())


def test_convert_round_trip(jax_ref, port):
    """The frontend projection and the untied head come across; there is
    no position table; ``init`` builds the same tree."""
    from repro_torch.models import transformer as T
    K, _ = M._helpers()
    cfg, params = port
    tree = K._unflatten(jax_ref, "params")
    for name in ("frontend_proj", "lm_head"):
        np.testing.assert_array_equal(params[name]["w"].numpy(),
                                      tree[name]["w"])
    assert "pos_embed" not in params
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(mine) == set(params)
    assert all(set(a) == set(b) for a, b in zip(mine["layers"],
                                                params["layers"]))


def test_forward_matches_reference(jax_ref, serve_runs):
    err = M.rel_err(serve_runs["forward"], jax_ref["forward"])
    assert err <= 1e-5, err


def test_positions_reach_the_frames(port):
    """The frames' rows are frontend_proj(frames) plus the sinusoidal
    positions: without them the rows would lose their order and the
    logits would change."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dense
    cfg, params = port
    frames = torch.as_tensor(_inputs(cfg)[0])
    x = T.embed_inputs(cfg, params, embeds=frames)
    torch.testing.assert_close(
        x - dense(params["frontend_proj"], frames),
        T.sincos_embed(N, cfg.d_model).expand_as(x), atol=1e-5, rtol=1e-4)
    flipped = T.forward(cfg, params, embeds=frames.flip(1))
    assert float((flipped.flip(1) - T.forward(cfg, params, embeds=frames))
                 .abs().max()) > 1e-3


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
def test_cache_leaves_match_reference(jax_ref, serve_runs, pairing, stage):
    """Every leaf at 1e-5 absolute and 1e-4 relative, the absolute part
    no tighter than 1e-6 of the leaf's largest |value| (the means cache's
    ``zsum`` sums frames at the sinusoids' unit scale)."""
    case = _case(pairing)
    M.assert_leaves(serve_runs[case][f"cache_{stage}"], jax_ref,
                    f"{case}/cache_{stage}", pairing[1], B,
                    serve_runs[case]["lay"], atol_rel=1e-6)


def test_exact_decode_matches_full_forward(serve_runs):
    """Exact decode after a Voltage prefill from the frames, teacher-
    forced, equals the plain full forward over the frames' rows and the
    codes' rows (the reference the card holds the path to)."""
    run = serve_runs[_case(("voltage", "exact"))]
    full = serve_runs["forward_codes"]
    for i in range(-1, STEPS):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = M.rel_err(got, full[:, N + i])
        assert err <= 1e-4, (i, err)


WORDS = r"serves token prompts only; arch '.*' \(arch_type='audio', " \
        r"frontend='encodec_stub'\) needs embedding inputs"


@pytest.mark.parametrize("program", ["engine", "launcher", "chunk",
                                     "packed"])
def test_token_programs_refuse_the_frames(port, program):
    """The engine (built directly, or by the launcher's ``--engine``) and
    the tick programs take token prompts only: each refuses MusicGen in
    the reference engine's words."""
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve import ServeHParams, init_cache, make_layout
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params = port
    hp = ServeHParams()
    lay = make_layout(P, 36, hp, prefill_len=32)
    t = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match=WORDS):
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
        else:
            packed_step(cfg, params, init_cache(cfg, lay, 4, hp, "cpu"), t,
                        t, t, t, t, lay, hp)


def test_reference_engine_refuses_in_the_same_words():
    """The words the port's refusals take are the reference engine's."""
    import jax
    from repro.configs import get_config
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine
    with pytest.raises(ValueError, match=WORDS):
        ServingEngine(musicgen_config(get_config),
                      jax.make_mesh((1, 1), ("data", "model")), {},
                      EngineConfig(n_slots=2, prefill_len=32, max_cache=36,
                                   hp=ServeHParams(backend="jnp")))


def test_launcher_draws_the_frames(port):
    """``setup`` draws seeded stub frames (B, n, D) as the whole prompt
    (no token ids) and ``StaticServe.run`` passes them through; the same
    seed, the same frames."""
    from repro_torch.launch.serve import setup
    cfg, params = port
    kw = dict(batch=2, prompt_len=32, gen=3, device="cpu", reduced=True,
              params=params, decode_mode="prism")
    a, b = setup(ARCH, **kw), setup(ARCH, **kw)
    assert a.prompts is None
    assert tuple(a.embeds.shape) == (2, 32, cfg.d_model)
    torch.testing.assert_close(a.embeds, b.embeds)
    tokens, logits, _ = a.run()
    assert tuple(tokens.shape) == (2, 3) and bool(torch.isfinite(
        logits).all())
    assert int(tokens.max()) < cfg.vocab_size


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
