"""Parameter sharding rules over a mesh: the reference's
``sharding/rules.py``, with the train step's ``GradReduce`` (the
gradient psums each rule still needs) and ``opt_state_specs`` (AdamW's
m and v cut over the axes a parameter leaves spare).

Layout (the reference's DESIGN.md §4):

  * expert weights   the expert dim over ``model``, plus FSDP over
                     ``data`` on the widest other dim;
  * embed / lm_head  the vocab dim over ``model`` where it divides
                     (vocab-parallel lookup and logits), else replicated;
  * other >= 2-D     FSDP: over ``data`` on the first dim it divides, and
                     over ``model`` on another where one divides
                     (``fsdp2d``); gathered a layer at a time on use
                     (``gather_tree``);
  * small / 1-D      replicated; ``pod`` replicates everything.

The decode rules (``decode_rule_for``) keep the weights sharded over
``model`` Megatron style instead and never gather them: ``wq`` and the
MLP's up/gate column-parallel, ``wo`` and down row-parallel.

A rule's ``spec`` names the mesh axis of each dim (None: whole); a
replicated leaf's is ().  The port keeps one dict a layer where the
reference stacks its scanned layers: a layer leaf ``layers/<i>/...``
takes the rule of the reference's sliced ``scan/<j>/...`` leaf, computed
on its inner path and shape, with no leading depth dim.  The m/v specs
are the one exception: the reference computes them on the stacked leaf
(n_units, ...), whose size and depth dim they may take, so a scanned
layer's m/v spec is the stacked leaf's, depth entry first
(``opt_state_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..launch.mesh import mesh_axes
from . import comm


@dataclass(frozen=True)
class ParamRule:
    spec: tuple                      # mesh axis name or None, per dim
    gather_dim: int | tuple | None   # dim(s) all-gathered in the body
    grad_reduce: tuple               # axes to psum gradients over
    kind: str   # expert | vocab | fsdp | fsdp2d | replicated | tp_col | ...


# threshold below which a leaf is not sharded
_FSDP_MIN = 1 << 16


def rule_for(path: str, shape: tuple, mesh_axes: dict,
             vocab_size: int) -> ParamRule:
    """The rule of the leaf at ``path``; a layer's leaf takes its inner
    path's (the reference's sliced scan leaf)."""
    if path.startswith("layers/"):
        path = path.split("/", 2)[2]
    return _rule_for_flat(path, tuple(shape), mesh_axes, vocab_size)


def _rule_for_flat(path: str, shape: tuple, mesh_axes: dict,
                   vocab_size: int) -> ParamRule:
    data = mesh_axes.get("data", 1)
    model = mesh_axes.get("model", 1)
    pod = ("pod",) if "pod" in mesh_axes else ()

    # experts: (E, ...) with E % model == 0
    if "/experts/" in path or path.endswith("experts"):
        spec = [None] * len(shape)
        spec[0] = "model"
        gdim = None
        if len(shape) >= 2:
            widest = int(np.argmax(shape[1:])) + 1
            if shape[widest] % data == 0 and np.prod(shape) >= _FSDP_MIN:
                spec[widest] = "data"
                gdim = widest
        return ParamRule(tuple(spec), gdim, pod, "expert")

    # vocab-dimension params: the embed table (V, d), an untied lm_head
    # (d, V); where d == V both dims match, so pick by layout
    if path == "embed/table" or "lm_head" in path:
        cands = [i for i, s in enumerate(shape) if s == vocab_size]
        vdim = (cands[-1] if "lm_head" in path else cands[0]) if cands else 0
        if shape[vdim] % model == 0:
            spec = [None] * len(shape)
            spec[vdim] = "model"
            return ParamRule(tuple(spec), None, pod + ("data",), "vocab")
        return ParamRule((), None, pod + ("data", "model"), "replicated")

    # generic FSDP: 2-D (data x model) when two dims divide
    if len(shape) >= 2 and int(np.prod(shape)) >= _FSDP_MIN:
        dim_d = next((d for d, s in enumerate(shape) if s % data == 0),
                     None)
        if dim_d is not None:
            spec = [None] * len(shape)
            spec[dim_d] = "data"
            dim_m = next((d for d, s in enumerate(shape)
                          if d != dim_d and s % model == 0), None)
            if dim_m is not None:
                spec[dim_m] = "model"
                return ParamRule(tuple(spec), (dim_d, dim_m), pod, "fsdp2d")
            return ParamRule(tuple(spec), dim_d, pod + ("model",), "fsdp")

    return ParamRule((), None, pod + ("data", "model"), "replicated")


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) of every leaf of a tree of dicts and lists, the path
    '/'-joined keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _map_paths(fn, tree, prefix: str = ""):
    """fn(path, leaf) over the leaves of ``tree``, in its structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def param_specs(params, mesh, vocab_size: int):
    """A tree of ``ParamRule`` matching ``params`` (any leaves with a
    ``shape``: tensors, meta tensors); ``mesh`` a ``Mesh`` or its axis
    sizes."""
    axes = mesh_axes(mesh)
    return _map_paths(lambda path, t: rule_for(path, t.shape, axes,
                                               vocab_size), params)


class GradReduce:
    """psum gradients over the axes each rule still needs: those whose
    sum no gather's transpose (a reduce-scatter) has made."""

    @staticmethod
    def axes(rules, mesh):
        """A tree of the axes each leaf's gradient is psummed over, in
        the rule's order, those of the mesh only."""
        names = set(mesh_axes(mesh))
        return tree_map(lambda r: tuple(a for a in r.grad_reduce
                                        if a in names), rules)

    @staticmethod
    def apply(grads, rules, mesh):
        """The gradients psummed by rule, metered ``grad``: the leaves of
        one axis set flattened into one psum."""
        axes = dict(tree_paths(GradReduce.axes(rules, mesh)))
        got = dict(tree_paths(grads))
        for key in sorted(set(axes.values())):
            paths = [p for p in got if axes[p] == key]
            if not key or not paths:
                continue
            flat = comm.psum(torch.cat([got[p].reshape(-1) for p in paths]),
                             mesh.group(key), "grad")
            for p, part in zip(paths, flat.split(
                    [got[p].numel() for p in paths])):
                got[p] = part.view_as(got[p])
        return _map_paths(lambda path, _: got[path], grads)


def scanned_layers(scan_split) -> int:
    """Layers of the reference's stacked scan (the rest are its tail):
    u·n_units of ``ModelConfig.scan_split`` (u, n_units, n_tail)."""
    u, n_units, _ = scan_split
    return u * n_units


def opt_state_specs(rules, params, mesh, scan_split=(1, 1, 0)):
    """AdamW's m/v specs (the reference's ``opt_state_specs``): a leaf's
    parameter spec, and over the first spare axis (``model`` where the
    rule leaves it, then ``pod``) on the first whole dim it divides,
    where the leaf holds at least ``_FSDP_MIN`` elements (ZeRO-style
    optimizer-state sharding).  A layer of the reference's scan (the
    first ``scanned_layers(scan_split)`` layers) is judged as its stacked
    leaf (n_units, ...): its spec has the depth entry first."""
    axes = mesh_axes(mesh)
    n_units = scan_split[1]
    n_scan = scanned_layers(scan_split)

    def spec(path, t):
        r = rule_of[path]
        shape = tuple(t.shape)
        pspec = tuple(r.spec) + (None,) * (len(shape) - len(r.spec))
        if path.startswith("layers/") and int(path.split("/")[1]) < n_scan:
            shape, pspec = (n_units,) + shape, (None,) + pspec
        used = {a for a in pspec if a}
        spare = [a for a in ("model", "pod") if a in axes and a not in used]
        out = list(pspec)
        for dim, size in enumerate(shape):
            if out[dim] is None and spare and size % axes[spare[0]] == 0 \
                    and int(np.prod(shape)) >= _FSDP_MIN:
                out[dim] = spare.pop(0)
                break
        return tuple(out)
    rule_of = dict(tree_paths(rules))
    return _map_paths(spec, params)


def _tile(xs, dims, grp):
    """Each x of ``xs`` tiled along its dim over ``grp``, in one
    collective: their shards flattened into one buffer."""
    if grp.size == 1 or not xs:
        return xs
    flat = torch.cat([x.reshape(-1) for x in xs])
    g = comm.all_gather(flat, grp, "param_gather")        # (n, total)
    out, at = [], 0
    for x, d in zip(xs, dims):
        parts = g[:, at:at + x.numel()].reshape(grp.size, *x.shape)
        out.append(torch.cat(parts.unbind(0), dim=d).to(x.dtype))
        at += x.numel()
    return out


def gather_tree(local, rules, mesh):
    """The per-layer FSDP gather: each leaf's whole tensor from its
    shards, over ``data`` (``fsdp``, ``expert``) or ``data`` then
    ``model`` (``fsdp2d``); leaves with no gather dim as they are.  The
    leaves of a tree gather together, one collective an axis."""
    rule = dict(tree_paths(rules))
    got = dict(tree_paths(local))
    dims = {path: rule[path].gather_dim for path in got
            if rule[path].gather_dim is not None}
    for axis, pick in (("data", 0), ("model", 1)):
        # fsdp2d's (data dim, model dim); a single gather dim is data's
        paths = [path for path, g in dims.items()
                 if isinstance(g, tuple) or pick == 0]
        tiled = _tile([got[path] for path in paths],
                      [g[pick] if isinstance(g, tuple) else g
                       for g in (dims[path] for path in paths)],
                      mesh.group(axis))
        got.update(zip(paths, tiled))
    return _map_paths(lambda path, _: got[path], local)


def local_shard(t: torch.Tensor, rule: ParamRule, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``rule``
    (``cut`` by its spec)."""
    return cut(t, rule.spec, mesh)


def cut(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``: each
    dim named in it cut into the axis's size, at the rank's coordinate;
    a copy of its own."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.size((ax,))
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {ax!r} of {n}")
        s = t.shape[dim] // n
        t = t.narrow(dim, mesh.coords[ax] * s, s)
    return t.clone(memory_format=torch.contiguous_format)


def tp_flags(cfg, mesh) -> tuple[bool, bool]:
    """(attention TP, FFN TP) of the decode layout: the heads, the query
    width and d_ff divide ``model``, and no projection has a bias (a
    row-parallel bias would be summed ``model`` times)."""
    model = mesh_axes(mesh).get("model", 1)
    attn_tp = (cfg.n_heads % model == 0 and not cfg.attn_bias
               and (cfg.n_heads * cfg.hd) % model == 0)
    ffn_tp = bool(cfg.d_ff) and cfg.d_ff % model == 0 and not cfg.attn_bias
    return attn_tp, ffn_tp


def decode_rule_for(path: str, shape: tuple, mesh_axes: dict,
                    vocab_size: int, *, attn_tp: bool, ffn_tp: bool
                    ) -> ParamRule:
    """The decode-time tensor-parallel rule: ``tp_col`` P(None,
    'model') for wq and the MLP's up/gate, ``tp_row`` P('model', None)
    for wo and down, experts expert-parallel over ``model`` (with
    expert-TP over ``data``), the embedding and head by their own rule,
    the rest replicated; no gather dim."""
    if path.startswith("layers/"):
        path = path.split("/", 2)[2]
    shape = tuple(shape)
    model = mesh_axes.get("model", 1)
    data = mesh_axes.get("data", 1)
    if "/experts/" in path or path.endswith("experts"):
        spec = [None] * len(shape)
        spec[0] = "model"
        kind = "expert"
        if len(shape) == 3:
            if path.endswith("down/w") and shape[1] % data == 0:
                spec[1] = "data"
                kind = "expert_tp_row"
            elif shape[2] % data == 0:          # up/gate
                spec[2] = "data"
                kind = "expert_tp_col"
        return ParamRule(tuple(spec), None, (), kind)
    if path == "embed/table" or "lm_head" in path:
        return _rule_for_flat(path, shape, mesh_axes, vocab_size)
    if attn_tp and len(shape) == 2 and path.endswith("wq/w") \
            and shape[1] % model == 0:
        return ParamRule((None, "model"), None, (), "tp_col")
    if attn_tp and len(shape) == 2 and path.endswith("wo/w") \
            and shape[0] % model == 0:
        return ParamRule(("model", None), None, (), "tp_row")
    is_mlp = ("mlp/" in path) and ("cell/" not in path)   # incl. dense_mlp
    if ffn_tp and is_mlp and len(shape) == 2:
        if (path.endswith("up/w") or path.endswith("gate/w")) \
                and shape[1] % model == 0:
            return ParamRule((None, "model"), None, (), "tp_col")
        if path.endswith("down/w") and shape[0] % model == 0:
            return ParamRule(("model", None), None, (), "tp_row")
    return ParamRule((), None, (), "replicated")


def decode_param_specs(params, mesh, vocab_size: int, cfg):
    """A tree of decode-TP ``ParamRule``s matching ``params``."""
    axes = mesh_axes(mesh)
    attn_tp, ffn_tp = tp_flags(cfg, axes)
    return _map_paths(lambda path, t: decode_rule_for(
        path, t.shape, axes, vocab_size, attn_tp=attn_tp, ffn_tp=ffn_tp),
        params)
