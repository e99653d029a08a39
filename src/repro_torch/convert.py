"""Carry parameters across from the JAX reference.

``jax.random`` numbers cannot be replayed in PyTorch, so tests build the
weights on the JAX side and bring them here.  The input is the
reference's parameter pytree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)`` on the JAX side); this module
itself never imports jax.

The reference stores layers as ``{"scan": [u stacked trees], "tail":
[...]}`` (``ModelConfig.scan_split``): layer ``i·u + j`` of the scanned
part is slice ``i`` of ``scan[j]``, and the ``tail`` layers follow.  The
port keeps one dict per layer.  Dense weights stay ``(d_in, d_out)``, a
tied head stays ``embed.table`` and an untied one is ``lm_head``, an
encoder's class head is ``head`` and a stub frontend's projection (ViT's
patches, PaliGemma's image) ``frontend_proj``; a parallel block
(Command-R) has no ``ln2`` on either side, so every leaf is a plain
copy.  A MoE block's stacked expert leaves
``(E, d_in, d_out)`` are ``(n_units, E, ...)`` under the scan, and come
across slice by slice like every other leaf, and so do the recurrent
cells' (xLSTM's ``mlstm`` / ``slstm`` blocks, ``{"ln", "cell"}``; the
sLSTM's raw recurrent blocks ``r`` (4, H, hd, hd)), over xLSTM's 8-layer
unit of 7 mLSTM and 1 sLSTM (``scan_split`` (8, 6, 0)), and Zamba2's
Mamba2 cells (``in``, ``conv``, ``a_log``, ``dt_bias``, ``d_skip``,
``ynorm``, ``out``) over its 6-layer unit of 5 ``mamba`` and 1
``shared_attn`` (``scan_split`` (6, 9, 0)).  A ``shared_attn`` layer is
``{}`` on both sides; the one weight set it reads is ``shared``.

bf16 crosses both ways as exact f32 numpy arrays: every bf16 value is an
f32 value, so ``to_jax_numpy`` widens a bf16 leaf and
``from_jax_numpy(dtype=torch.bfloat16)`` rounds an f32 leaf back, exactly
where it came from bf16.  (A numpy array of the reference's own bf16
dtype is widened the same way, by its own ``astype``.)  Neither side
needs a numpy bf16 type or jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models.transformer import DTYPES, check_supported
from .sharding.rules import local_shard, tree_map


def _map(tree, leaf, index=None):
    """Nested dict of leaves -> the same dict of ``leaf(a, index)``."""
    if isinstance(tree, dict):
        return {k: _map(v, leaf, index) for k, v in tree.items()}
    return leaf(tree, index)


def port_layout(cfg: ModelConfig, tree: dict, leaf) -> dict:
    """The reference's tree (``scan``/``tail``) in the port's layout, one
    dict a layer: each leaf ``a`` becomes ``leaf(a, i)``, ``i`` the slice
    of a scanned layer's leading axis, None for the others.  The one
    path map of ``from_jax_numpy``, of the rules' check against the
    reference's, and of any tree of the reference's structure."""
    u, n_units, n_tail = cfg.scan_split
    layers = [_map(tree["scan"][j], leaf, index=i)
              for i in range(n_units) for j in range(u)]
    layers += [_map(t, leaf) for t in tree.get("tail", [])[:n_tail]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.n_layers}")
    out = {"layers": layers, "final_norm": _map(tree["final_norm"], leaf)}
    # a vocabulary, learned positions, an untied head, an encoder's class
    # head, a stub frontend's projection and Zamba2's shared block only
    # where the model has them
    for name in ("embed", "pos_embed", "lm_head", "head", "frontend_proj",
                 "shared"):
        if name in tree:
            out[name] = _map(tree[name], leaf)
    return out


#: leaves the reference keeps in f32 whatever its ``dtype`` (Mamba2's)
F32_LEAVES = ("a_log", "dt_bias")


def _cast(tree, dtype, name=None):
    """The port's tree with every leaf in ``dtype`` but ``F32_LEAVES``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype, name) for v in tree]
    return tree if name in F32_LEAVES else tree.to(dtype)


def from_jax_numpy(cfg: ModelConfig, tree: dict, device="cuda",
                   dtype=torch.float32) -> dict:
    """The reference's numpy parameter pytree -> the port's parameters in
    ``dtype`` (the reference's ``init`` dtype: f32 or bf16, Mamba2's
    ``a_log`` and ``dt_bias`` f32 in either) on ``device``: the card
    unless the caller asks for the CPU; raises without a card."""
    check_supported(cfg)
    if dtype not in DTYPES:
        raise NotImplementedError(f"parameters in {dtype}; the port takes "
                                  f"{DTYPES}")
    device = resolve_device(device)

    def leaf(a, index):
        a = np.asarray(a)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)             # the reference's bf16
        return torch.tensor(a if index is None else a[index],
                            dtype=torch.float32, device=device)
    return _cast(port_layout(cfg, tree, leaf), dtype)


def shard_params(params: dict, rules: dict, mesh) -> dict:
    """This rank's local parameters: each leaf of the port's whole tree
    ``params`` cut to its block under its rule (``sharding.rules.
    local_shard``) on the mesh's device; ``rules`` matches the tree
    (``rules.param_specs`` or ``rules.decode_param_specs``)."""
    return tree_map(lambda t, r: local_shard(t, r, mesh).to(mesh.device),
                    params, rules)


def _numpy(tree):
    """Leaves as numpy arrays; a bf16 leaf widened to f32, exactly."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _stack(trees):
    """Per-layer dicts of one structure -> one dict of arrays stacked on
    a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def to_jax_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The inverse of ``from_jax_numpy``: the port's parameters -> the
    reference's numpy tree, layer ``i·u + j`` of the scanned part
    stacked as slice ``i`` of ``scan[j]`` and the ``tail`` layers after
    (``ModelConfig.scan_split``).  Leaves keep their dtype, but for bf16,
    which crosses as exact f32."""
    u, n_units, n_tail = cfg.scan_split
    layers = [_numpy(p) for p in params["layers"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the parameters, config "
                         f"has {cfg.n_layers}")
    tree = {k: _numpy(v) for k, v in params.items() if k != "layers"}
    tree["scan"] = [_stack(layers[j:n_units * u:u]) for j in range(u)]
    tree["tail"] = layers[n_units * u:]
    return tree
