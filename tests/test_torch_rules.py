"""The port's parameter sharding rules against the reference's, on the
CPU, in-process: no mesh is needed, since the rules are pure functions
of (path, shape, mesh axes, vocabulary).

For every architecture of the registry the reference's parameter shapes
come from ``jax.eval_shape`` of its ``init`` (nothing is allocated, so
the full sizes are cheap); its rules (``param_specs``, and the decode-TP
``decode_param_specs``) are carried into the port's one-dict-a-layer
layout by ``convert.port_layout``, the path map of the weights
themselves, a scanned layer's spec without its leading depth dim.  The
port's rules, computed on that layout's shapes (meta tensors), must
equal them leaf by leaf: spec, gather dim, gradient axes and kind.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ARCHS = ("gpt2-small", "yi-6b", "gemma3-1b", "gemma-7b", "olmoe-1b-7b",
         "paligemma-3b", "command-r-35b", "musicgen-medium", "xlstm-1.3b",
         "zamba2-2.7b", "arctic-480b", "bert-base", "vit-b16")
MESHES = ({"data": 1, "model": 4}, {"data": 2, "model": 2},
          {"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2})
RULE_SETS = ("fsdp", "decode_tp")


def _mesh_id(axes):
    return "x".join(f"{k}{v}" for k, v in axes.items())


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    from repro.configs import get_config
    from repro.models import transformer as T
    cfg = get_config(arch)
    return cfg, jax.eval_shape(lambda: T.init(cfg, jax.random.PRNGKey(0)))


def test_every_registry_name_is_covered():
    from repro.configs import _REGISTRY as REF
    from repro_torch.configs import _REGISTRY as PORT
    assert set(ARCHS) == set(REF) == set(PORT)


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("axes", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_reference(arch, axes, rules):
    from repro.sharding import rules as RR
    from repro_torch.configs import get_config
    from repro_torch.convert import port_layout
    from repro_torch.sharding import rules as PR
    ref_cfg, shapes = _reference_shapes(arch)
    cfg = get_config(arch)
    fake_mesh = SimpleNamespace(axis_names=tuple(axes),
                                devices=np.empty(tuple(axes.values())))
    if rules == "fsdp":
        ref = RR.param_specs(shapes, fake_mesh, ref_cfg.vocab_size)
    else:
        ref = RR.decode_param_specs(shapes, fake_mesh, ref_cfg.vocab_size,
                                    ref_cfg)

    # the reference's rules in the port's layout: a scanned layer's rule
    # loses its leading depth dim
    def carry(r, index):
        spec = tuple(r.spec)
        return (spec[1:] if index is not None else spec, r.gather_dim,
                tuple(r.grad_reduce), r.kind)
    want = port_layout(cfg, ref, carry)
    meta = port_layout(cfg, shapes, lambda a, index: torch.empty(
        a.shape[1:] if index is not None else a.shape, device="meta"))
    if rules == "fsdp":
        got = PR.param_specs(meta, axes, cfg.vocab_size)
    else:
        got = PR.decode_param_specs(meta, axes, cfg.vocab_size, cfg)
    got_flat = dict(PR.tree_paths(got))
    want_flat = dict(PR.tree_paths(want, ))
    assert set(got_flat) == set(want_flat)
    kinds = set()
    for path, r in got_flat.items():
        assert (r.spec, r.gather_dim, r.grad_reduce, r.kind) == \
            want_flat[path], path
        kinds.add(r.kind)
    assert kinds                                   # every leaf compared
