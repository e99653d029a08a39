"""The port's PaliGemma against the JAX reference, on the CPU.

PaliGemma 3B (a stub SigLIP frontend: image embeddings through
``frontend_proj`` overwrite the first ``prefix_len`` token positions,
which attend bidirectionally; GeGLU, RMSNorm, RoPE, sqrt(d) scaling
after the overwrite, MQA, a tied head) reduced to 2 layers, d_model 256
and an image prefix of 8 (4 query heads of 64 over 1 KV head).  P = 4
sequence shards.

The prefix is placed two ways, each in the three prefill/decode
pairings:

  * prompt 32 at CR 4 (n_loc 8, segments of 4): the prefix is shard 0,
    ending on a shard boundary;
  * prompt 24 at CR 3 (n_loc 6, segments of 3): the prefix ends inside
    shard 1 and inside its first means segment, [6, 8], whose last
    position is the first after the prefix: that mean takes the causal
    rule, as only a segment wholly inside the prefix is visible to every
    row.

A module fixture runs this file as a subprocess (``--jax-ref OUT.npz``)
with four fake host devices set in the child's environment only: on a
(1, 4) mesh with the jnp backend the child runs the reference's full
forward with the image embeddings and ``make_prefill_step`` /
``make_serve_step`` (B 2, 4 teacher-forced steps) at both prompts, and
saves the parameters and every result.  The engine and the tick
programs take token prompts only and refuse the model, in the
reference engine's words.
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

ARCH = "paligemma-3b"
P, B, STEPS = 4, 2, 4
PAIRINGS = [("voltage", "exact"), ("prism", "prism"), ("voltage", "prism")]
# prompt length -> CR: the prefix of 8 ends on shard 0's boundary, or
# inside shard 1 and inside its first segment
PLACEMENTS = {32: 4.0, 24: 3.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pali_config(get_config):
    """The test's config from either package's registry."""
    return get_config(ARCH).reduced(d_model=256)


def _cap(n):
    return n + STEPS + (-(n + STEPS)) % P


def _case(n, pairing):
    return f"n{n}/{pairing[0]}-{pairing[1]}"


def _inputs(cfg, n):
    """Prompts (B, n), the image embeddings (B, prefix_len, D) and the
    forced decode tokens (B, STEPS)."""
    rng = np.random.default_rng(n)
    prompts = rng.integers(1, cfg.vocab_size, size=(B, n)).astype(np.int32)
    embeds = rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(
        np.float32)
    forced = rng.integers(1, cfg.vocab_size, size=(B, STEPS)).astype(
        np.int32)
    return prompts, embeds, forced


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
    cfg = pali_config(get_config)
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    out = {}
    K._flatten(jax.tree.map(np.asarray, params), "params", out)
    for n, cr in PLACEMENTS.items():
        prompts, embeds, forced = _inputs(cfg, n)
        logits, _ = T.forward(cfg, params, jnp.asarray(
            np.concatenate([prompts, forced], axis=1)),
            embeds=jnp.asarray(embeds))
        out[f"n{n}/forward"] = np.asarray(logits)
        batch = {"tokens": jnp.asarray(prompts),
                 "embeds": jnp.asarray(embeds)}
        for pairing in PAIRINGS:
            case = _case(n, pairing)
            hp = ServeHParams(decode_mode=pairing[1], means_cr=cr,
                              backend="jnp")
            prism = PrismConfig(P=P, cr=cr, mode=pairing[0])
            pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism,
                                             batch=B, n=n, hp=hp,
                                             cap=_cap(n))
            logits, cache = pre(params, batch)
            out[f"{case}/prefill_logits"] = np.asarray(logits)
            K._flatten(cache["scan"][0], f"{case}/cache_prefill", out)
            step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B,
                                            cap=_cap(n), prefill_len=n,
                                            hp=hp)
            for i in range(STEPS):
                pos = jnp.full((B,), n + i, jnp.int32)
                logits, cache = step(params, cache,
                                     jnp.asarray(forced[:, i]), pos)
                out[f"{case}/step{i}_logits"] = np.asarray(logits)
            K._flatten(cache["scan"][0], f"{case}/cache_final", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_paligemma") / "ref.npz"
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
    cfg = pali_config(get_config)
    return cfg, from_jax_numpy(cfg, K._unflatten(jax_ref, "params"),
                               device="cpu")


@pytest.fixture(scope="module")
def serve_runs(port):
    """At each prompt: prefill + 4 teacher-forced serve_steps in every
    pairing, and the plain full forward over prompt + forced tokens with
    the image."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)
    cfg, params = port
    runs = {}
    for n, cr in PLACEMENTS.items():
        prompts, embeds, forced = (torch.as_tensor(a) for a in
                                   _inputs(cfg, n))
        prompts, forced = prompts.long(), forced.long()
        runs[f"n{n}/forward"] = T.forward(
            cfg, params, torch.cat([prompts, forced], dim=1),
            embeds=embeds).numpy()
        for pairing in PAIRINGS:
            hp = ServeHParams(decode_mode=pairing[1], means_cr=cr)
            lay = make_layout(P, _cap(n), hp, prefill_len=n)
            prism = PrismConfig(P=P, cr=cr, mode=pairing[0])
            logits, cache = prefill(cfg, params, prompts, prism, lay, hp,
                                    embeds=embeds)
            run = {"lay": lay, "prefill_logits": logits.numpy(),
                   "cache_prefill": [{k: t.clone().numpy()
                                      for k, t in c.items()} for c in cache]}
            for i in range(STEPS):
                pos = torch.full((B,), n + i, dtype=torch.long)
                logits, cache = serve_step(cfg, params, cache, forced[:, i],
                                           pos, lay, hp)
                run[f"step{i}_logits"] = logits.numpy()
            run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                                  for c in cache]
            runs[_case(n, pairing)] = run
    return runs


def test_config_is_paligemma():
    """The full config the card runs and the reduced one here: MQA at
    head dim 256, GeGLU, a tied head, an image prefix of 256 (8 here)."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (18, 2048, 8, 1, 256, 16384, 257216)
    assert (cfg.arch_type, cfg.frontend, cfg.prefix_len) == (
        "vlm", "siglip_stub", 256)
    assert cfg.mlp_kind == "geglu" and cfg.embed_scale and cfg.tie_embeddings
    small = pali_config(get_config)
    assert (small.prefix_len, small.n_heads, small.n_kv_heads) == (8, 4, 1)


def test_segment_straddles_the_prefix_end():
    """The prompt-24 placement exercises the rule: shard 1's first mean
    covers [6, 8], its last position the first after the prefix of 8;
    at prompt 32 every mean of shard 0 lies inside the prefix."""
    from repro_torch.sharding.context import means_columns
    cols = means_columns(P, 6, 2, torch.device("cpu"))
    assert (int(cols.lo[2]), int(cols.hi[2])) == (6, 8)
    cols = means_columns(P, 8, 2, torch.device("cpu"))
    assert cols.hi[:2].tolist() == [3, 7]


def test_convert_round_trip(jax_ref, port):
    """The frontend projection comes across; a tied head (no
    ``lm_head``); ``init`` builds the same tree."""
    from repro_torch.models import transformer as T
    K, _ = M._helpers()
    cfg, params = port
    tree = K._unflatten(jax_ref, "params")
    np.testing.assert_array_equal(params["frontend_proj"]["w"].numpy(),
                                  tree["frontend_proj"]["w"])
    assert "lm_head" not in params and "pos_embed" not in params
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(mine) == set(params)
    assert all(set(a) == set(b) for a, b in zip(mine["layers"],
                                                params["layers"]))


@pytest.mark.parametrize("n", list(PLACEMENTS))
def test_forward_matches_reference(jax_ref, serve_runs, n):
    err = M.rel_err(serve_runs[f"n{n}/forward"], jax_ref[f"n{n}/forward"])
    assert err <= 1e-5, err


def test_image_and_prefix_reach_the_logits(port):
    """Other image embeddings change every position's logits, and so does
    the bidirectional prefix: the same inputs under a causal mask over
    the whole sequence differ in the prefix rows and after."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.models.context import FullContext
    cfg, params = port
    prompts, embeds, _ = (torch.as_tensor(a) for a in _inputs(cfg, 32))
    base = T.forward(cfg, params, prompts.long(), embeds=embeds)
    other = T.forward(cfg, params, prompts.long(), embeds=embeds + 1.0)
    assert float((other - base).abs().amax(dim=(0, 2)).min()) > 1e-4
    causal = T.forward(cfg, params, prompts.long(), embeds=embeds,
                       ctx=FullContext())
    assert float((causal - base)[:, :cfg.prefix_len - 1].abs().max()) > 1e-4
    with pytest.raises(ValueError, match="image embeds"):
        T.forward(cfg, params, prompts.long(), embeds=embeds[:, :4])
    dense = dataclasses.replace(cfg, arch_type="dense", frontend=None,
                                prefix_len=0)
    with pytest.raises(ValueError, match="vlm"):
        T.embed_inputs(dense, params, prompts.long(), embeds=embeds)


@pytest.mark.parametrize("pairing", PAIRINGS, ids=lambda p: "-".join(p))
@pytest.mark.parametrize("n", list(PLACEMENTS))
def test_prefill_and_decode_logits_match_reference(jax_ref, serve_runs, n,
                                                   pairing):
    case = _case(n, pairing)
    run = serve_runs[case]
    for key in ["prefill_logits"] + [f"step{i}_logits"
                                     for i in range(STEPS)]:
        err = M.rel_err(run[key], jax_ref[f"{case}/{key}"])
        assert err <= 1e-4, (key, err)


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("pairing", PAIRINGS, ids=lambda p: "-".join(p))
@pytest.mark.parametrize("n", list(PLACEMENTS))
def test_cache_leaves_match_reference(jax_ref, serve_runs, n, pairing,
                                      stage):
    """Every leaf at 1e-5 absolute and 1e-4 relative, the absolute part
    no tighter than 1e-6 of the leaf's largest |value|: the image rows
    come in at sqrt(d) times unit scale, and a segment's ``zsum`` of
    such rows that nearly cancel is exact only to their scale in f32."""
    case = _case(n, pairing)
    M.assert_leaves(serve_runs[case][f"cache_{stage}"], jax_ref,
                    f"{case}/cache_{stage}", pairing[1], B,
                    serve_runs[case]["lay"], atol_rel=1e-6)


@pytest.mark.parametrize("n", list(PLACEMENTS))
def test_exact_decode_matches_full_forward(serve_runs, n):
    """Exact decode after a Voltage prefill with the image, teacher-
    forced, equals the plain full forward with the image."""
    run = serve_runs[_case(n, ("voltage", "exact"))]
    full = serve_runs[f"n{n}/forward"]
    for i in range(-1, STEPS):
        got = run["prefill_logits" if i < 0 else f"step{i}_logits"]
        err = M.rel_err(got, full[:, n + i])
        assert err <= 1e-4, (i, err)


WORDS = r"serves token prompts only; arch '.*' \(arch_type='vlm', " \
        r"frontend='siglip_stub'\) needs embedding inputs"


@pytest.mark.parametrize("program", ["engine", "launcher", "chunk",
                                     "packed"])
def test_token_programs_refuse_the_image(port, program):
    """The engine (built directly, or by the launcher's ``--engine``) and
    the tick programs take token prompts only: each refuses PaliGemma in
    the reference engine's words (the reference's tick programs would
    run the placeholder tokens without the image)."""
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
    cfg = pali_config(get_config)
    with pytest.raises(ValueError, match=WORDS):
        ServingEngine(cfg, jax.make_mesh((1, 1), ("data", "model")), {},
                      EngineConfig(n_slots=2, prefill_len=32, max_cache=36,
                                   hp=ServeHParams(backend="jnp")))


def test_launcher_draws_the_image(port):
    """``setup`` draws seeded stub embeddings (B, prefix_len, D) and
    ``StaticServe.run`` passes them through; the same seed, the same
    image."""
    from repro_torch.launch.serve import setup
    cfg, params = port
    kw = dict(batch=2, prompt_len=32, gen=3, device="cpu", reduced=True,
              params=params)
    a, b = setup(ARCH, **kw), setup(ARCH, **kw)
    assert tuple(a.embeds.shape) == (2, cfg.prefix_len, cfg.d_model)
    torch.testing.assert_close(a.embeds, b.embeds)
    tokens, logits, _ = a.run()
    assert tuple(tokens.shape) == (2, 3) and bool(torch.isfinite(
        logits).all())
    with pytest.raises(ValueError, match="image prefix"):
        setup(ARCH, **dict(kw, prompt_len=4))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
