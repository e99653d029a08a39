"""Flat-key .npz checkpoints of a tree of tensors (parameters, optimizer
state), in the reference's format (``repro.checkpoint.io``): one file
``ckpt_{step:08d}.npz`` a step, each leaf under its ``/``-joined path
(dict keys, list indices).  The two packages read each other's files
when the trees have the same paths: the port's parameters go through
``convert.to_jax_numpy`` into the reference's stacked layout first, and
come back through ``convert.from_jax_numpy``."""
from __future__ import annotations

import os
import re

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict:
    """{"/"-joined path: numpy array} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        t = tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree
        return {prefix: np.asarray(t)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save_checkpoint(dirpath: str, step: int, tree) -> str:
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten(tree))
    os.replace(tmp, path)
    return path


def latest_step(dirpath: str) -> int | None:
    if not os.path.isdir(dirpath):
        return None
    steps = [int(m.group(1)) for f in os.listdir(dirpath)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_checkpoint(dirpath: str, step: int, template):
    """The tree saved at ``step``, in ``template``'s structure, each leaf
    in its template leaf's dtype and, for a tensor, on its device."""
    path = os.path.join(dirpath, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        def build(t, key):
            if isinstance(t, dict):
                return {k: build(v, f"{key}/{k}" if key else str(k))
                        for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [build(v, f"{key}/{i}" if key else str(i))
                        for i, v in enumerate(t)]
            a = data[key]
            if torch.is_tensor(t):
                return torch.as_tensor(a, device=t.device).to(t.dtype)
            return a.astype(np.asarray(t).dtype)
        return build(template, "")
