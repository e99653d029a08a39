"""The port's models against the JAX reference on the CPU, with weights
carried across by ``repro_torch.convert``; and the port's import
hygiene (no ``jax``, nothing of ``repro``)."""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reduced():
    """gpt2-small reduced to d_model 128, reference weights as numpy."""
    cfg = get_config("gpt2-small").reduced(d_model=128)
    j_cfg = j_get_config("gpt2-small").reduced(d_model=128)
    tree = jax.tree.map(np.asarray, JT.init(j_cfg, jax.random.PRNGKey(0)))
    return cfg, j_cfg, tree


def test_convert_roundtrip(reduced):
    """Pins the carry-across every other port test rests on: the scan
    stack unstacks into layers in depth order, dense weights keep their
    (d_in, d_out) orientation, and the head stays tied to the embedding."""
    cfg, _, tree = reduced
    params = from_jax_numpy(cfg, tree, device="cpu")
    assert len(params["layers"]) == cfg.n_layers == 2
    stack = tree["scan"][0]
    for i, layer in enumerate(params["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(
                    layer["attn"][name][leaf].numpy(),
                    stack["attn"][name][leaf][i])
        w_up = layer["mlp"]["up"]["w"]
        assert tuple(w_up.shape) == (cfg.d_model, cfg.d_ff)  # (d_in, d_out)
        np.testing.assert_array_equal(w_up.numpy(),
                                      stack["mlp"]["up"]["w"][i])
        np.testing.assert_array_equal(layer["ln2"]["bias"].numpy(),
                                      stack["ln2"]["bias"][i])
    for name in ("embed", "pos_embed", "final_norm"):
        for leaf, val in tree[name].items():
            np.testing.assert_array_equal(params[name][leaf].numpy(), val)
    assert "lm_head" not in tree and "lm_head" not in params


def test_forward_matches_reference(reduced):
    cfg, j_cfg, tree = reduced
    params = from_jax_numpy(cfg, tree, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48))
    want, _ = JT.forward(j_cfg, jax.tree.map(jnp.asarray, tree),
                         jnp.asarray(tokens))
    got = TT.forward(cfg, params, torch.as_tensor(tokens))
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_streamed_forward_matches_dense(reduced):
    """attn_block > 0 streams attention K/V; same logits as dense."""
    import dataclasses
    cfg, _, tree = reduced
    params = from_jax_numpy(cfg, tree, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 40)))
    dense = TT.forward(cfg, params, tokens)
    streamed = TT.forward(dataclasses.replace(cfg, attn_block=8), params,
                          tokens)
    torch.testing.assert_close(streamed, dense, atol=1e-5, rtol=1e-4)


def test_layers_match_reference():
    """norm (f32, eps 1e-6), the tanh-GELU MLP and dense layers."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 16)) * 1e-3).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    np.testing.assert_allclose(
        TL.norm({k: torch.as_tensor(v) for k, v in p.items()},
                torch.as_tensor(x)).numpy(),
        np.asarray(JL.norm(p, jnp.asarray(x), "layernorm")),
        atol=1e-5, rtol=1e-4)
    m = {"up": {"w": rng.standard_normal((16, 32)).astype(np.float32),
                "b": rng.standard_normal(32).astype(np.float32)},
         "down": {"w": rng.standard_normal((32, 16)).astype(np.float32),
                  "b": rng.standard_normal(16).astype(np.float32)}}
    mt = {k: {n: torch.as_tensor(a) for n, a in d.items()}
          for k, d in m.items()}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TL.mlp(mt, torch.as_tensor(x), "gelu").numpy(),
        np.asarray(JL.mlp(m, jnp.asarray(x), "gelu")), atol=1e-4, rtol=1e-4)


def test_unported_configs_raise():
    with pytest.raises(KeyError, match="not ported"):
        get_config("gemma-7b")
    cfg = get_config("gpt2-small")
    import dataclasses
    with pytest.raises(NotImplementedError):
        TT.check_supported(dataclasses.replace(cfg, pos="rope"))
    with pytest.raises(NotImplementedError):
        TL.norm({}, torch.zeros(2), kind="rmsnorm")


def test_init_is_seeded():
    cfg = get_config("gpt2-small").reduced(d_model=64)
    a = TT.init(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TT.init(cfg, torch.Generator().manual_seed(3), "cpu")
    torch.testing.assert_close(a["layers"][1]["attn"]["wq"]["w"],
                               b["layers"][1]["attn"]["wq"]["w"])
    assert a["embed"]["table"].shape == (cfg.vocab_size, cfg.d_model)
    assert a["pos_embed"]["table"].shape == (cfg.max_seq, cfg.d_model)


@pytest.mark.parametrize("entry", ["init", "from_jax_numpy"])
def test_params_default_to_the_card(reduced, entry):
    """Without a device argument the weights go to the card; with no card
    present that raises instead of quietly running on the CPU."""
    cfg, _, tree = reduced
    make = {"init": lambda: TT.init(cfg, torch.Generator().manual_seed(0)),
            "from_jax_numpy": lambda: from_jax_numpy(cfg, tree)}[entry]
    if torch.cuda.is_available():
        assert make()["embed"]["table"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_port_loads_no_jax():
    """In a fresh interpreter, importing every port module leaves jax out
    of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
