"""The port's bf16 serving against the JAX reference, on the CPU.

Reduced GPT-2 small (d_model 128), Yi-6B (d_model 256, 8 query heads
over 2 KV heads of 32: test_torch_llama.py's config), Gemma 7B and
OLMoE-1B-7B (d_model 256), 2 layers each; B = 2, prompt 32, P = 4
sequence shards, CR 4, 3 teacher-forced decode steps in the static
pairings voltage + exact and prism + prism.  A module fixture runs this
file as a subprocess (``--jax-ref OUT.npz``) with four fake host devices:
the child draws each model with the reference's ``init(cfg, key,
jnp.bfloat16)`` and runs its forward, ``make_prefill_step`` and
``make_serve_step`` on a (1, 4) mesh with the jnp backend, saving every
bf16 leaf widened to f32 (exact) and each cache leaf's dtype.  The port
takes the same weights through ``from_jax_numpy(dtype=torch.bfloat16)``.

Checks: the logits within 2e-2 of the reference's largest |logit| (the
reference's bf16 kernel tolerance), and no farther from the f32 witness
(the port's plain f32 path on the same weights, widened) than 1.5 x the
reference's distance + 1e-3; the cache's leaf dtypes the reference's
leaf by leaf (k, v, kz, vz bf16; gz, zsum f32), the logits f32;
``init(dtype=bf16)`` is ``init`` rounded; bf16 crosses ``convert`` both
ways bit for bit; the engine with bf16 weights keeps the reference's
f32 cache (its chunked and packed ticks), and its tokens are the port's
bf16 static path's wherever that path's top-2 gap exceeds 2e-2 of its
largest |logit|.  The reference's engine raises on bf16 parameters
throughout (its layer scan's carry turns f32 over the f32 cache); the
child keeps its error, and runs it on the bf16 weights with the
embedding tables widened to f32 (packed and chunked, exact and prism),
saving its tokens and every decode row: the port's engine on the same
tree, forced on those tokens, is held to them by the rules above.
Every path this slice does not serve in bf16 refuses by name.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("gpt2-small", "yi-6b", "gemma-7b", "olmoe-1b-7b")
B, N, STEPS, P, CR = 2, 32, 3, 4, 4.0
CAP = N + STEPS + (-(N + STEPS)) % P
PAIRINGS = (("voltage", "exact"), ("prism", "prism"))
# the reference's bf16 tolerance (tests/test_kernels.py), of the largest
# |logit|; the witness rule's factor and floor
REL_TOL, E_FACTOR, E_FLOOR = 2e-2, 1.5, 1e-3
# the engine's runs: (prefill mode, decode mode) and the static pairing
# whose decode steps they must match (an engine's prefill is exact)
ENGINE_RUNS = {("packed", "exact"): ("voltage", "exact"),
               ("packed", "prism"): ("voltage", "prism"),
               ("chunked", "exact"): ("voltage", "exact"),
               ("chunked", "prism"): ("voltage", "prism")}
GEN = 6                                  # tokens an engine request makes
ENGINE_CAP = N + GEN + (-(N + GEN)) % P


def engine_config(EngineConfig, hp, prefill):
    """Either package's engine configuration for one run."""
    return EngineConfig(hp=hp, n_slots=B, prefill_len=N,
                        max_cache=ENGINE_CAP, chunk_len=8,
                        token_budget=B + 8, prefill_mode=prefill)


def f32_embedding(params, f32):
    """Either package's bf16 tree with its embedding tables (token and
    position) widened to f32 (exact), so that the residual stream is f32
    from the first layer on: the one bf16 tree the reference's engine
    runs (its layer scan carries one dtype, and over the engine's f32
    cache a layer's output is f32)."""
    return {k: ({n: t.astype(f32) if hasattr(t, "astype") else t.to(f32)
                 for n, t in v.items()} if k in ("embed", "pos_embed")
                else v) for k, v in params.items()}


def record_rows(eng, forced=None):
    """Keep each decode row's logits by request, on either package's
    engine (both sample every generated token in ``_advance_decode``):
    {rid: [row, ...]}.  ``forced`` {rid: tokens}: the engine samples
    request rid's k-th token as ``forced[rid][k]`` (its logit raised
    above the row's largest in a copy), the log keeps the real row."""
    log = {}
    advance = eng._advance_decode

    def advance_kept(st, row, now):
        rows = log.setdefault(st.req.rid, [])
        rows.append(np.array(row, dtype=np.float32))
        if forced is not None:
            row = np.array(row)
            row[forced[st.req.rid][len(rows) - 1]] = row.max() + 1.0
        return advance(st, row, now)
    eng._advance_decode = advance_kept
    return log


def family_config(get_config, arch):
    """The test's config from either package's registry."""
    if arch == "gpt2-small":
        return get_config(arch).reduced(d_model=128)
    cfg = get_config(arch).reduced(d_model=256)
    if arch == "yi-6b":                  # GQA back, as test_torch_llama.py
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=2, head_dim=32)
    return cfg


def _case(pairing):
    return f"{pairing[0]}-{pairing[1]}"


def _inputs(vocab):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, vocab, size=(B, N)).astype(np.int32)
    forced = rng.integers(1, vocab, size=(B, STEPS)).astype(np.int32)
    return prompts, forced


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = tree


def _unflatten(flat, prefix):
    root = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = root
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def engine_reference(cfg, params, mesh, prompts, arch, out, dtypes):
    """The reference's engine runs of one arch (the JAX child's "engine"
    part): on GPT-2, bf16 throughout, the error it raises; on every
    arch, the bf16 weights with ``f32_embedding``, its tokens and decode
    rows."""
    import jax
    import jax.numpy as jnp
    from repro.runtime.serve import ServeHParams
    from repro.serving import EngineConfig, ServingEngine
    for prefill, mode in ENGINE_RUNS:
        key = f"{arch}/engine/{prefill}-{mode}"
        hp = ServeHParams(decode_mode=mode, means_cr=CR, backend="jnp")
        if arch == "gpt2-small" and mode == "exact":
            # bf16 parameters throughout: each program's layer scan
            # refuses the carry that turns f32
            eng = ServingEngine(cfg, mesh, params,
                                engine_config(EngineConfig, hp, prefill),
                                clock=lambda: 0.0)
            eng.submit(prompts[0].tolist(), max_new_tokens=GEN)
            try:
                eng.run()
                dtypes[f"{prefill}/refusal"] = None
            except TypeError as e:
                dtypes[f"{prefill}/refusal"] = str(e)
        eng = ServingEngine(cfg, mesh, f32_embedding(params, jnp.float32),
                            engine_config(EngineConfig, hp, prefill),
                            clock=lambda: 0.0)
        log = record_rows(eng)
        rids = [eng.submit(p.tolist(), max_new_tokens=GEN)
                for p in prompts]
        res = eng.run()
        out[f"{key}/tokens"] = np.array([res[r] for r in rids])
        out[f"{key}/logits"] = np.stack([np.stack(log[r])
                                         for r in rids])
        dtypes[f"{key}/cache"] = sorted(
            {str(leaf.dtype) for leaf in
             jax.tree.leaves(eng.kv_cache.storage)})


def jax_reference(out_path, part):
    """Child process: the reference in bf16 on a (1, 4) host mesh; part
    "static" (the forward, the static pairings, the weights) or
    "engine" (the engine runs)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, make_prefill_step,
                                     make_serve_step)

    def widened(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))
    mesh = jax.make_mesh((1, P), ("data", "model"))
    out, dtypes = {}, {}
    for arch in ARCHS:
        cfg = family_config(get_config, arch)
        params = T.init(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
        prompts, forced = _inputs(cfg.vocab_size)
        if part == "engine":
            engine_reference(cfg, params, mesh, prompts, arch, out, dtypes)
            continue
        flat = {}
        _flatten(params, f"{arch}/params", flat)
        out.update({k: widened(v) for k, v in flat.items()})
        logits, _ = T.forward(cfg, params, jnp.asarray(
            np.concatenate([prompts, forced], axis=1)))
        out[f"{arch}/forward"] = widened(logits)
        dtypes[f"{arch}/forward"] = str(logits.dtype)
        for pairing in PAIRINGS:
            case = f"{arch}/{_case(pairing)}"
            hp = ServeHParams(decode_mode=pairing[1], means_cr=CR,
                              backend="jnp")
            prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
            pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism,
                                             batch=B, n=N, hp=hp, cap=CAP)
            logits, cache = pre(params, {"tokens": jnp.asarray(prompts)})
            out[f"{case}/logits0"] = widened(logits)
            dtypes[f"{case}/logits"] = str(logits.dtype)
            flat = {}
            _flatten(cache, "", flat)
            dtypes[f"{case}/cache"] = {k.rsplit("/", 1)[-1]: str(v.dtype)
                                       for k, v in flat.items()}
            step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B,
                                            cap=CAP, prefill_len=N, hp=hp)
            for i in range(STEPS):
                pos = jnp.full((B,), N + i, jnp.int32)
                logits, cache = step(params, cache,
                                     jnp.asarray(forced[:, i]), pos)
                out[f"{case}/logits{i + 1}"] = widened(logits)
    np.savez(out_path, dtypes=np.array(json.dumps(dtypes)), **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The two parts of the JAX child, run side by side."""
    tmp = tmp_path_factory.mktemp("jax_bf16")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    procs = {part: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--jax-ref",
         str(tmp / f"{part}.npz"), part], env=env,
        stdout=open(tmp / f"{part}.log", "w"), stderr=subprocess.STDOUT)
        for part in ("static", "engine")}
    ref = {"dtypes": {}}
    for part, proc in procs.items():
        rc = proc.wait(timeout=600)
        assert rc == 0, (tmp / f"{part}.log").read_text()[-6000:]
        with np.load(tmp / f"{part}.npz") as z:
            got = dict(z)
        ref["dtypes"].update(json.loads(str(got.pop("dtypes"))))
        ref.update(got)
    return ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the port's runs
# --------------------------------------------------------------------------

def static_run(cfg, params, pairing, prompts, forced):
    """Prefill and STEPS teacher-forced decode steps on the CPU: the
    logits (STEPS + 1, B, V) and the cache after prefill."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)
    hp = ServeHParams(decode_mode=pairing[1], means_cr=CR)
    lay = make_layout(P, CAP, hp, prefill_len=N)
    logits, cache = prefill(cfg, params, prompts,
                            PrismConfig(P=P, cr=CR, mode=pairing[0]), lay,
                            hp)
    dtypes = {name: str(t.dtype) for c in cache for name, t in c.items()}
    out = [logits]
    for i in range(STEPS):
        pos = torch.full((B,), N + i, dtype=torch.long)
        logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                   lay, hp)
        out.append(logits)
    return torch.stack(out), dtypes


@pytest.fixture(scope="module")
def port(jax_ref):
    """Each arch's config, bf16 and f32 parameters (the same values) and
    the port's runs: the forward and each static pairing, in bf16 and as
    the f32 witness."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.models import transformer as T
    runs = {}
    for arch in ARCHS:
        cfg = family_config(get_config, arch)
        tree = _unflatten(jax_ref, f"{arch}/params")
        p16 = from_jax_numpy(cfg, tree, device="cpu", dtype=torch.bfloat16)
        p32 = from_jax_numpy(cfg, tree, device="cpu")
        prompts, forced = (torch.from_numpy(a).long()
                           for a in _inputs(cfg.vocab_size))
        seq = torch.cat([prompts, forced], dim=1)
        r = {"cfg": cfg, "p16": p16, "p32": p32, "prompts": prompts,
             "forward": T.forward(cfg, p16, seq),
             "forward_f32": T.forward(cfg, p32, seq)}
        for pairing in PAIRINGS:
            case = _case(pairing)
            r[case], r[case + "/dtypes"] = static_run(cfg, p16, pairing,
                                                      prompts, forced)
            r[case + "/f32"], _ = static_run(cfg, p32, pairing, prompts,
                                             forced)
        runs[arch] = r
    return runs


def err(got, want) -> float:
    """E: max |got - want| over max |want|."""
    got, want = got.double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max())


def assert_bf16_close(got, want, witness, what):
    """The port within REL_TOL of the reference, and no farther from the
    f32 witness than E_FACTOR x the reference's distance + E_FLOOR."""
    want = torch.as_tensor(want)
    e = err(got, want)
    assert e <= REL_TOL, f"{what}: {e:.3e} from the reference"
    e_port, e_ref = err(got, witness), err(want, witness)
    assert e_port <= E_FACTOR * e_ref + E_FLOOR, (
        f"{what}: E(port) {e_port:.3e} against E(reference) {e_ref:.3e}")


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(jax_ref, port, arch):
    """The forward in bf16, its logits in the parameters' dtype."""
    r = port[arch]
    assert r["forward"].dtype == torch.bfloat16
    assert jax_ref["dtypes"][f"{arch}/forward"] == "bfloat16"
    assert_bf16_close(r["forward"], jax_ref[f"{arch}/forward"],
                      r["forward_f32"], f"{arch} forward")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_static_logits_match_reference(jax_ref, port, arch, pairing):
    """Prefill and every teacher-forced step, f32 logits on both sides."""
    r, case = port[arch], _case(pairing)
    assert r[case].dtype == torch.float32
    assert jax_ref["dtypes"][f"{arch}/{case}/logits"] == "float32"
    for i in range(STEPS + 1):
        assert_bf16_close(r[case][i], jax_ref[f"{arch}/{case}/logits{i}"],
                          r[case + "/f32"][i], f"{arch} {case} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_cache_dtypes_match_reference(jax_ref, port, arch, pairing):
    """Leaf by leaf: k, v (and prism's kz, vz) in the compute dtype, the
    repeat counts gz and the sums zsum f32."""
    case = _case(pairing)
    got = port[arch][case + "/dtypes"]
    want = jax_ref["dtypes"][f"{arch}/{case}/cache"]
    assert {k: v.replace("torch.", "") for k, v in got.items()} == want
    want_prism = {"k": "bfloat16", "v": "bfloat16", "kz": "bfloat16",
                  "vz": "bfloat16", "gz": "float32", "zsum": "float32"}
    assert want == ({k: want_prism[k] for k in ("k", "v")}
                    if pairing[1] == "exact" else want_prism)


# --------------------------------------------------------------------------
# init and convert
# --------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b"])
def test_init_bf16_is_the_f32_init_rounded(arch):
    """``init(dtype=bf16)`` draws the f32 init and rounds it: every leaf
    equal, bit for bit, but Mamba2's a_log and dt_bias, which stay f32
    (as the reference's); any block kind takes the dtype."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    p32 = T.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    p16 = T.init(cfg, torch.Generator().manual_seed(3), device="cpu",
                 dtype=torch.bfloat16)
    a, b = dict(_leaves(p32)), dict(_leaves(p16))
    assert a.keys() == b.keys()
    for name, t in a.items():
        keep = name.rsplit("/", 1)[-1] in ("a_log", "dt_bias")
        want = t if keep else t.to(torch.bfloat16)
        assert b[name].dtype == want.dtype and torch.equal(b[name], want), \
            name
    with pytest.raises(NotImplementedError, match="parameters in"):
        T.init(cfg, torch.Generator(), device="cpu", dtype=torch.float16)


def test_convert_crosses_bf16_bit_for_bit(jax_ref, port):
    """``to_jax_numpy`` widens bf16 to exact f32 numpy, the reference's
    leaves; ``from_jax_numpy(dtype=bf16)`` rounds them back to the same
    bits; no module of the port nor chip_smoke.py names ml_dtypes (the
    card's machine has none)."""
    import glob
    from repro_torch.convert import from_jax_numpy, to_jax_numpy
    for arch in ("gpt2-small", "olmoe-1b-7b"):
        r = port[arch]
        tree = to_jax_numpy(r["cfg"], r["p16"])
        for name, a in _leaves(tree):
            assert a.dtype == np.float32, name
        want = _unflatten(jax_ref, f"{arch}/params")
        for (n1, a), (n2, b) in zip(sorted(_leaves(tree)),
                                    sorted(_leaves(want))):
            assert n1 == n2 and np.array_equal(a, b), n1
        back = from_jax_numpy(r["cfg"], tree, device="cpu",
                              dtype=torch.bfloat16)
        for (n1, a), (n2, b) in zip(_leaves(back), _leaves(r["p16"])):
            assert n1 == n2 and a.dtype == b.dtype and torch.equal(
                a.view(torch.int16), b.view(torch.int16)), n1
    root = os.path.join(HERE, "..")
    for path in glob.glob(os.path.join(root, "src", "repro_torch", "**",
                                       "*.py"), recursive=True) + [
            os.path.join(root, "chip_smoke.py")]:
        with open(path) as f:
            assert "ml_dtypes" not in f.read(), path


# --------------------------------------------------------------------------
# the ticks and the engine: bf16 weights over the f32 cache
# --------------------------------------------------------------------------

def clear(logits) -> bool:
    """Whether a row of logits picks its token clearly: its top-2 gap
    exceeds REL_TOL of its largest |logit|."""
    top = logits.double().topk(2).values
    return float(top[0] - top[1]) > REL_TOL * float(logits.abs().max())


@pytest.mark.parametrize("arch", ["gpt2-small", "yi-6b"])
def test_engine_keeps_the_f32_cache(port, arch):
    """The engine with bf16 weights: its cache is the reference's, f32
    (``make_kv_cache`` with no dtype), its packed and chunked ticks serve
    the requests, and each token is the bf16 static path's, teacher-
    forced on the engine's tokens, wherever that path picks it clearly
    (``clear``).  In prism mode the engine's first token comes from a
    prism decode at the last prompt position, which the static path does
    not run (its prefill is exact there): its later tokens are checked.
    At least one token is checked a run.  The dense models: the engine's
    rows turn f32 after layer 0's attention over its f32 cache (the
    reference's layers do the same, which its engine's layer scan
    refuses: ``test_reference_engine_refuses_bf16_throughout``) while
    the static path's stay bf16, and on OLMoE that moves a router
    near-tie here (router margins down to 2e-3 on this model), which
    changes a token's experts, not its precision; OLMoE's bf16 static
    path and its engine (``test_engine_matches_reference``) are held to
    the reference."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime.serve import ServeHParams, generate, make_layout
    from repro_torch.serving import EngineConfig, ServingEngine
    r = port[arch]
    cfg, prompts = r["cfg"], r["prompts"]
    cap = N + GEN + (-(N + GEN)) % P
    for (prefill, mode), pairing in ENGINE_RUNS.items():
        hp = ServeHParams(decode_mode=mode, means_cr=CR)
        eng = ServingEngine(cfg, r["p16"], EngineConfig(
            hp=hp, n_slots=B, prefill_len=N, max_cache=cap, chunk_len=8,
            token_budget=B + 8, prefill_mode=prefill), n_seq=P,
            clock=lambda: 0.0)
        for leaf in eng.kv_cache.storage[0].values():
            assert leaf.dtype == torch.float32
        rids = [eng.submit(p.tolist(), max_new_tokens=GEN) for p in prompts]
        out = eng.run()
        tokens = torch.tensor([out[rid] for rid in rids])
        _, logits, _ = generate(
            cfg, r["p16"], prompts, gen=GEN,
            prism=PrismConfig(P=P, cr=CR, mode=pairing[0]),
            lay=make_layout(P, cap, hp, prefill_len=N), hp=hp,
            forced=tokens[:, :-1])
        checked = 0
        for b in range(B):
            for i in range(1 if mode == "prism" else 0, GEN):
                if clear(logits[i, b]):
                    assert int(tokens[b, i]) == int(logits[i, b].argmax()), (
                        prefill, mode, b, i)
                    checked += 1
        assert checked, f"{prefill}/{mode}: no clear token to check"


def engine_rows(cfg, params, run, prompts, forced):
    """The port's engine on one run, forced on ``forced`` (B, GEN):
    its logits rows (B, GEN, V) and its cache's leaf dtypes."""
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    prefill, mode = run
    eng = ServingEngine(cfg, params, engine_config(
        EngineConfig, ServeHParams(decode_mode=mode, means_cr=CR), prefill),
        n_seq=P, clock=lambda: 0.0)
    rids = [eng.submit(p.tolist(), max_new_tokens=GEN) for p in prompts]
    log = record_rows(eng, {rid: [int(t) for t in f]
                            for rid, f in zip(rids, forced)})
    eng.run()
    dtypes = sorted({str(t.dtype).replace("torch.", "")
                     for c in eng.kv_cache.storage for t in c.values()})
    return torch.from_numpy(np.stack([np.stack(log[r]) for r in rids])), \
        dtypes


@pytest.mark.parametrize("prefill", ["packed", "chunked"])
def test_reference_engine_refuses_bf16_throughout(jax_ref, prefill):
    """What the reference's engine does with bf16 parameters throughout:
    its packed tick (serve.py:2058) and chunk call (:1684) raise, because
    the layer scan's carry enters bf16 and leaves f32: a layer's output
    over the engine's f32 cache is f32 (the writes' cast to the cache's
    dtype, serve.py:525, :532).  So the reference has no engine run to
    hold the port's bf16 engine to; the port's engine computes what the
    reference's layers do, the residual f32 from layer 0's output on,
    and ``test_engine_matches_reference`` holds it where the reference
    runs."""
    msg = jax_ref["dtypes"][f"{prefill}/refusal"]
    assert msg is not None and "carry" in msg
    assert "has type bfloat16[" in msg and "has type float32[" in msg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", list(ENGINE_RUNS), ids=_case)
def test_engine_matches_reference(jax_ref, port, arch, run):
    """The engine with bf16 weights against the reference's
    ``ServingEngine`` on the same weights, prompts and schedule, the
    embedding tables widened to f32 on both sides (``f32_embedding``:
    the one bf16 tree the reference's engine runs): both keep an f32
    cache; the port, teacher-forced on the reference's tokens, gives
    every decode row within REL_TOL of the reference's largest |logit|,
    no farther from the f32 witness (the port's engine on the weights
    widened, forced alike) than E_FACTOR x the reference's distance +
    E_FLOOR, and the reference's token wherever the reference picks it
    clearly (``clear``).  OLMoE's routing is held here too."""
    r, key = port[arch], f"{arch}/engine/{_case(run)}"
    assert jax_ref["dtypes"][f"{key}/cache"] == ["float32"]
    tokens, want = jax_ref[f"{key}/tokens"], jax_ref[f"{key}/logits"]
    got, dtypes = engine_rows(r["cfg"], f32_embedding(r["p16"],
                                                      torch.float32),
                              run, r["prompts"], tokens)
    assert dtypes == ["float32"]
    witness, _ = engine_rows(r["cfg"], r["p32"], run, r["prompts"], tokens)
    assert got.shape == want.shape == (B, GEN, r["cfg"].vocab_size)
    assert_bf16_close(got, want, witness, f"{arch} engine {_case(run)}")
    checked = 0
    for b in range(B):
        for i in range(GEN):
            if clear(torch.from_numpy(want[b, i])):
                assert int(got[b, i].argmax()) == int(tokens[b, i]), (b, i)
                checked += 1
    assert checked, "no clear token to check"


# --------------------------------------------------------------------------
# what bf16 does not serve yet: each refuses by name
# --------------------------------------------------------------------------

def _bf16(arch, **over):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return cfg, T.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.bfloat16)


def _prefill(cfg, params, embeds=None, n=64):
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.runtime.serve import ServeHParams, make_layout, prefill
    hp = ServeHParams()
    tokens = (None if cfg.frontend == "encodec_stub"
              else torch.ones(1, n, dtype=torch.long))
    return prefill(cfg, params, tokens, PrismConfig(P=P, cr=CR),
                   make_layout(P, n, hp), hp, embeds)


@pytest.mark.parametrize("arch,match", [
    ("gemma3-1b", r"\['attn_local'\] blocks"),
    ("xlstm-1.3b", r"\['mlstm', 'slstm'\] blocks"),
    ("zamba2-2.7b", r"\['mamba', 'shared_attn'\] blocks"),
    ("paligemma-3b", "siglip_stub frontend"),
    ("musicgen-medium", "encodec_stub frontend"),
])
def test_static_path_refuses_what_bf16_does_not_serve(arch, match):
    """Gemma 3's window ring, the recurrent kinds and an image or frame
    prefix refuse bf16 parameters by name on the static path (and on the
    forward), before any layer runs."""
    from repro_torch.models import transformer as T
    cfg, params = _bf16(arch)
    embeds = None
    if cfg.frontend:
        n = cfg.prefix_len if cfg.arch_type == "vlm" else 64
        embeds = torch.zeros(1, n, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=match):
        _prefill(cfg, params, embeds)
    if not cfg.frontend:
        with pytest.raises(NotImplementedError, match=match):
            T.forward(cfg, params, torch.ones(1, 64, dtype=torch.long))


def test_mesh_train_and_encode_refuse_bf16():
    """The mesh (serving and its engine go through ``mesh_params``), the
    train step (one card and the mesh) and ``encode`` refuse bf16
    parameters by name; f32 parameters pass the same checks."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.serve import ServeHParams, encode, mesh_params
    from repro_torch.runtime.train import make_train_step
    cfg, params = _bf16("gpt2-small")
    with pytest.raises(NotImplementedError, match="a mesh of ranks"):
        mesh_params(cfg, params, None)
    with pytest.raises(NotImplementedError, match="make_train_step"):
        make_train_step(cfg, PrismConfig(P=P, cr=CR), n_shards=P,
                        device="cpu", mesh=object(), params=params)
    step = make_train_step(cfg, PrismConfig(P=P, cr=CR), n_shards=P,
                           device="cpu")
    batch = {"tokens": torch.ones(1, 64, dtype=torch.long),
             "labels": torch.ones(1, 64, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="make_train_step"):
        step(params, adamw_init(params), batch)
    bert, bparams = _bf16("bert-base")
    with pytest.raises(NotImplementedError, match="encode"):
        encode(bert, bparams, torch.ones(1, 64, dtype=torch.long),
               prism=PrismConfig(P=P, cr=CR), n_shards=P, hp=ServeHParams())
    for refused in (None, "a mesh of ranks", "make_train_step", "encode"):
        T.check_dtype(cfg, torch.float32, refused)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--jax-ref":
        jax_reference(sys.argv[2], sys.argv[3])
