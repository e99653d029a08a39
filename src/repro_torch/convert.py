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
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models.transformer import check_supported


def _tensors(tree, device, index=None):
    """Nested dict of numpy arrays -> nested dict of f32 tensors (taking
    slice ``index`` of the leading axis when given)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.tensor(a, dtype=torch.float32, device=device)


def from_jax_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The reference's numpy parameter pytree -> the port's parameters on
    ``device``: the card unless the caller asks for the CPU; raises
    without a card."""
    check_supported(cfg)
    device = resolve_device(device)
    u, n_units, n_tail = cfg.scan_split
    layers = [_tensors(tree["scan"][j], device, index=i)
              for i in range(n_units) for j in range(u)]
    layers += [_tensors(t, device) for t in tree.get("tail", [])[:n_tail]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.n_layers}")
    params = {"layers": layers,
              "final_norm": _tensors(tree["final_norm"], device)}
    # a vocabulary, learned positions, an untied head, an encoder's class
    # head, a stub frontend's projection and Zamba2's shared block only
    # where the model has them
    for name in ("embed", "pos_embed", "lm_head", "head", "frontend_proj",
                 "shared"):
        if name in tree:
            params[name] = _tensors(tree[name], device)
    return params


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


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
    (``ModelConfig.scan_split``).  Leaves keep their dtype."""
    u, n_units, n_tail = cfg.scan_split
    layers = [_numpy(p) for p in params["layers"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the parameters, config "
                         f"has {cfg.n_layers}")
    tree = {k: _numpy(v) for k, v in params.items() if k != "layers"}
    tree["scan"] = [_stack(layers[j:n_units * u:u]) for j in range(u)]
    tree["tail"] = layers[n_units * u:]
    return tree
