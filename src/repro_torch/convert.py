"""Carry parameters across from the JAX reference.

``jax.random`` numbers cannot be replayed in PyTorch, so tests build the
weights on the JAX side and bring them here.  The input is the
reference's parameter pytree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)`` on the JAX side); this module
itself never imports jax.

The reference stores layers as ``{"scan": [u stacked trees], "tail":
[...]}`` (``ModelConfig.scan_split``): layer ``i·u + j`` of the scanned
part is slice ``i`` of ``scan[j]``, and the ``tail`` layers follow.  The
port keeps one dict per layer.  Dense weights stay ``(d_in, d_out)`` and
the head stays tied to ``embed.table``, so every leaf is a plain copy.
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
    return {"layers": layers,
            "final_norm": _tensors(tree["final_norm"], device),
            "embed": _tensors(tree["embed"], device),
            "pos_embed": _tensors(tree["pos_embed"], device)}
