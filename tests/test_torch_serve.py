"""The port's serving slice against the JAX reference, on the CPU.

GPT-2 small reduced (d_model 128, 2 layers), B = 2, prompt 32, P = 4
sequence shards, CR 4 (L = 2 means per shard), 4 teacher-forced decode
steps, in each prefill/decode pairing.  A module fixture runs this file
as a subprocess (``--jax-ref OUT.npz``) with four fake host devices set
in the child's environment only: the child runs the reference
``make_prefill_step`` / ``make_serve_step`` on a (1, 4) mesh with the
jnp backend and saves the parameters, the prefill logits, every cache
leaf after prefill and after the last step, and every step's logits.
The port must match them; exact decode must also match the port's own
plain full forward.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
B, N, STEPS, P, CR = 2, 32, 4, 4, 4.0
CAP = N + STEPS + (-(N + STEPS)) % P
# (prefill exchange, decode mode): the launcher's two pairings, plus the
# voltage-prefill / prism-decode pairing that captures the means with the
# segment-means kernel
PAIRINGS = [("voltage", "exact"), ("prism", "prism"), ("voltage", "prism")]
LEAVES = ("k", "v", "kz", "vz", "gz", "zsum")


def _case(pairing):
    return f"{pairing[0]}-{pairing[1]}"


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat, prefix):
    root = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
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


def _inputs(vocab):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, vocab, size=(B, N)).astype(np.int32)
    forced = rng.integers(1, vocab, size=(B, STEPS)).astype(np.int32)
    return prompts, forced


def jax_reference(out_path):
    """Child process: the reference serve path on a (1, 4) host mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.protocol import PrismConfig
    from repro.models import transformer as T
    from repro.runtime.serve import (ServeHParams, make_prefill_step,
                                     make_serve_step)

    cfg = get_config("gpt2-small").reduced(d_model=128)
    mesh = jax.make_mesh((1, P), ("data", "model"))
    params = T.init(cfg, jax.random.PRNGKey(0))
    prompts, forced = _inputs(cfg.vocab_size)
    out = {}
    _flatten(jax.tree.map(np.asarray, params), "params", out)
    for pairing in PAIRINGS:
        case = _case(pairing)
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR, backend="jnp")
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        pre, _, _, _ = make_prefill_step(cfg, mesh, params, prism, batch=B,
                                         n=N, hp=hp, cap=CAP)
        logits, cache = pre(params, {"tokens": jnp.asarray(prompts)})
        out[f"{case}/prefill_logits"] = np.asarray(logits)
        _flatten(cache["scan"][0], f"{case}/cache_prefill", out)
        step, _, _, _ = make_serve_step(cfg, mesh, params, batch=B, cap=CAP,
                                        prefill_len=N, hp=hp)
        for i in range(STEPS):
            pos = jnp.full((B,), N + i, jnp.int32)
            logits, cache = step(params, cache, jnp.asarray(forced[:, i]),
                                 pos)
            out[f"{case}/step{i}_logits"] = np.asarray(logits)
        _flatten(cache["scan"][0], f"{case}/cache_final", out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
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
def port_runs(jax_ref):
    """The port on the CPU with the reference's weights, every pairing."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_numpy
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ServeHParams, make_layout,
                                           prefill, serve_step)

    cfg = get_config("gpt2-small").reduced(d_model=128)
    params = from_jax_numpy(cfg, _unflatten(jax_ref, "params"),
                            device="cpu")
    prompts, forced = (torch.as_tensor(a, dtype=torch.long)
                       for a in _inputs(cfg.vocab_size))
    runs = {}
    for pairing in PAIRINGS:
        hp = ServeHParams(decode_mode=pairing[1], means_cr=CR)
        lay = make_layout(P, CAP, hp, prefill_len=N)
        prism = PrismConfig(P=P, cr=CR, mode=pairing[0])
        logits, cache = prefill(cfg, params, prompts, prism, lay, hp)
        run = {"prefill_logits": logits.numpy(),
               "cache_prefill": [{k: t.clone().numpy() for k, t in c.items()}
                                 for c in cache]}
        for i in range(STEPS):
            pos = torch.full((B,), N + i, dtype=torch.long)
            logits, cache = serve_step(cfg, params, cache, forced[:, i], pos,
                                       lay, hp)
            run[f"step{i}_logits"] = logits.numpy()
        run["cache_final"] = [{k: t.numpy() for k, t in c.items()}
                              for c in cache]
        runs[_case(pairing)] = run
    full = T.forward(cfg, params, torch.cat([prompts, forced], dim=1))
    runs["full_forward"] = full.numpy()
    runs["lay"] = lay
    return runs


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _step_logits(run, i):
    return run["prefill_logits"] if i < 0 else run[f"step{i}_logits"]


@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_prefill_logits_match_reference(jax_ref, port_runs, pairing):
    case = _case(pairing)
    err = _rel_err(port_runs[case]["prefill_logits"],
                   jax_ref[f"{case}/prefill_logits"])
    assert err <= 1e-4, err


@pytest.mark.parametrize("stage", ["prefill", "final"])
@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_cache_leaves_match_reference(jax_ref, port_runs, pairing, stage):
    """Every cache leaf, the reference's (B, cap, ...) leaves viewed as
    the port's (B, P, cap_l, ...), after prefill and after the last
    decode step."""
    case = _case(pairing)
    lay = port_runs["lay"]
    port = port_runs[case][f"cache_{stage}"]
    leaves = LEAVES if pairing[1] == "prism" else LEAVES[:2]
    for name in leaves:
        want = jax_ref[f"{case}/cache_{stage}/{name}"]   # (layers, B, ...)
        assert set(port[0]) == set(leaves)
        for layer, c in enumerate(port):
            w = want[layer]
            if name in ("k", "v"):
                w = w.reshape(B, P, lay.cap_l, *w.shape[2:])
            np.testing.assert_allclose(c[name], w, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name} layer {layer}")


@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_decode_logits_match_reference(jax_ref, port_runs, pairing):
    case = _case(pairing)
    for i in range(STEPS):
        err = _rel_err(port_runs[case][f"step{i}_logits"],
                       jax_ref[f"{case}/step{i}_logits"])
        assert err <= 1e-4, (i, err)


@pytest.mark.parametrize("pairing", PAIRINGS, ids=_case)
def test_greedy_tokens_match_reference(jax_ref, port_runs, pairing):
    """Same argmax wherever the reference's top-2 logit gap exceeds 1e-3."""
    case = _case(pairing)
    checked = 0
    for i in range(-1, STEPS):
        want = jax_ref[f"{case}/prefill_logits" if i < 0
                       else f"{case}/step{i}_logits"]
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        got = _step_logits(port_runs[case], i).argmax(-1)
        np.testing.assert_array_equal(got[clear], want.argmax(-1)[clear])
        checked += int(clear.sum())
    assert checked > 0


def test_exact_decode_matches_full_forward(port_runs):
    """Exact decode, teacher-forced, equals the plain causal forward over
    prompt + forced tokens at every step."""
    run = port_runs[_case(("voltage", "exact"))]
    full = port_runs["full_forward"]
    for i in range(-1, STEPS):
        err = _rel_err(_step_logits(run, i), full[:, N + i])
        assert err <= 1e-4, (i, err)


def test_prism_decode_differs_from_exact(port_runs):
    """Prism decode is approximate by design: its logits must differ from
    exact decode (a guard against the means columns being dropped)."""
    exact = port_runs[_case(("voltage", "exact"))]
    prism = port_runs[_case(("prism", "prism"))]
    assert _rel_err(prism["step0_logits"], exact["step0_logits"]) > 1e-3


def test_device_breakdown_merges_overlapping_kernels():
    """The trace summary chip_smoke.py prints: busy time merges
    overlapping kernels, idle is the rest of the span, kernels are
    classed by name; host events and a path trace's warm-up launch
    (ATen's spin kernel) are ignored."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    _device_breakdown = chip_smoke.device_breakdown

    def ev(name, t0, t1, dev=DeviceType.CUDA):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=t0, end=t1))

    class Prof:
        def events(self):
            return [ev("aten::mm", 0, 100, DeviceType.CPU),
                    ev("at::cuda::(anonymous namespace)::spin_kernel(long)",
                       -60, -50),
                    ev("ampere_sgemm_128x64", 0, 10),
                    ev("prism_attention_kernel<64>", 5, 20),
                    ev("decode_stats_kernel<64>", 30, 40),
                    ev("vectorized_elementwise_kernel", 40, 50)]

    got = _device_breakdown(Prof(), n_steps=2)
    assert got["span_ms"] == pytest.approx(25e-3)
    assert got["busy_ms"] == pytest.approx(20e-3)
    assert got["idle_share"] == pytest.approx(0.2)
    assert got["kernels"] == 2.0
    assert got["by_kind_ms"] == pytest.approx({
        "prism_flash_attention": 7.5e-3, "matmul": 5e-3,
        "flash_decode_stats": 5e-3, "elementwise": 5e-3})
    with pytest.raises(RuntimeError, match="no device activity"):
        _device_breakdown(NS(events=lambda: []), 1)


def test_trace_fillers_and_window_mark():
    """A trace's fillers (spin kernels before and after the traced work)
    and the host mark around the work (nor a device-side copy of it) are
    no kernels of the work; the fillers without a record are counted on
    each side of the work's first and last kernel."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    mark = chip_smoke.WINDOW_MARK
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"

    def ev(name, t0, t1, dev=DeviceType.CUDA):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=t0, end=t1))

    def prof(before, after):
        return NS(events=lambda: (
            [ev(spin, t, t + 1) for t in range(before)]
            + [ev(mark, 100, 200, DeviceType.CPU), ev(mark, 100, 200),
               ev("prism_attention_kernel<64>", 110, 120),
               ev("ampere_sgemm_128x64", 100, 110)]
            + [ev(spin, 300 + t, 301 + t) for t in range(after)]))

    whole = prof(4, 4)
    assert [e.name for e in chip_smoke.device_events(whole)] == [
        "ampere_sgemm_128x64", "prism_attention_kernel<64>"]
    assert chip_smoke.device_breakdown(whole, 1)["kernels"] == 2.0
    assert chip_smoke.fillers_lost(whole, 4) == (0, 0)
    assert chip_smoke.fillers_lost(prof(1, 4), 4) == (3, 0)
    assert chip_smoke.fillers_lost(prof(4, 2), 4) == (0, 2)
    assert chip_smoke.fillers_lost(NS(events=lambda: []), 4) is None


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-ref":
        sys.path.insert(0, os.path.join(HERE, "..", "src"))
        jax_reference(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --jax-ref OUT.npz")
