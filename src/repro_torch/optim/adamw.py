"""AdamW, the cosine schedule and global-norm clipping over the port's
nested parameter dicts (``repro.optim.adamw``'s numbers).

The optimizer state mirrors the parameter tree: ``m`` and ``v`` in f32,
and the step counter a 0-d int32 tensor on the parameters' device.  A
leaf of rank 1 (norm scales, biases) takes no weight decay.  The update
is functional, as the reference's: it returns new parameters and a new
state and leaves its inputs as they were.
"""
from __future__ import annotations

import math

import torch


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree in a fixed order: dict
    keys as they were inserted, list items in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure, the first's."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *items) for items in zip(*trees)]
    return fn(*trees)


def tree_unflatten(template, leaves):
    """The inverse of ``tree_leaves``: ``leaves`` in ``template``'s
    structure."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def adamw_init(params):
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    device = tree_leaves(params)[0].device
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac`` of it at ``total``: step (int tensor) -> lr, a
    0-d f32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def clip_by_global_norm(grads, max_norm: float, *, total=None):
    """-> (grads scaled to a global L2 norm of at most ``max_norm``, the
    norm before, a 0-d f32 tensor).  The leaves' squared sums and the
    scaling are batched over the leaves (``torch._foreach_*``): a few
    launches, not a few per leaf.  ``total``: over a mesh, the leaves'
    squared sums (n_leaves,) -> the whole tree's (each leaf counted
    once, however many ranks hold it); None: their sum."""
    leaves = [g.float() for g in tree_leaves(grads)]
    sq = torch._foreach_mul(leaves, leaves)
    sums = torch.stack([t.sum() for t in sq])
    gn = torch.sqrt(sums.sum() if total is None else total(sums))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    scaled = torch._foreach_mul(tree_leaves(grads), scale)
    return tree_unflatten(grads, scaled), gn


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One decoupled-weight-decay Adam step -> (new params, new state).
    ``lr`` is a float or a 0-d tensor."""
    step = state["step"] + 1
    sf = step.float()
    c1 = 1 - b1 ** sf
    c2 = 1 - b2 ** sf
    ps, gs = tree_leaves(params), tree_leaves(grads)
    ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
    g32 = [g.float() for g in gs]
    p32 = [p.float() for p in ps]
    # the reference's per-leaf arithmetic in its order, each operation
    # batched over the leaves: m = b1·m + (1 - b1)·g, v = b2·v + (1 -
    # b2)·g², upd = (m / c1) / (sqrt(v / c2) + eps) + decay·p, p - lr·upd
    new_m = torch._foreach_mul(ms, b1)
    torch._foreach_add_(new_m, torch._foreach_mul(g32, 1 - b1))
    new_v = torch._foreach_mul(vs, b2)
    torch._foreach_add_(new_v, torch._foreach_mul(
        torch._foreach_mul(g32, g32), 1 - b2))
    den = torch._foreach_div(new_v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_div(new_m, c1), den)
    # decoupled weight decay; none on 1-D leaves (norms, biases)
    decayed = [i for i, p in enumerate(ps) if p.dim() >= 2]
    if weight_decay and decayed:
        torch._foreach_add_([upd[i] for i in decayed],
                            torch._foreach_mul([p32[i] for i in decayed],
                                               weight_decay))
    new_p = torch._foreach_sub(p32, torch._foreach_mul(upd, lr))
    new_p = [t.to(p.dtype) for t, p in zip(new_p, ps)]
    return (tree_unflatten(params, new_p),
            {"m": tree_unflatten(state["m"], new_m),
             "v": tree_unflatten(state["v"], new_v), "step": step})
