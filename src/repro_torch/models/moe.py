"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Routing: a softmax router over all E experts, the top-k of the
probabilities (not renormalised), capacity ``C = ceil(T·k/E ·
capacity_factor)`` per expert per routing group; a token past its
expert's capacity is dropped (its share of the output is zero, the
residual carries it).  The Switch load-balance loss is returned.

Routing groups are the token sets capacity is counted over: the
reference counts it per device under ``shard_map``.  On one card the
context names them (``SeqContext.expert_groups``): the prefill's P
sequence shards each route their own tokens, a decode step, chunk or
packed tick routes all of its tokens as one group.  Every group's
experts run in one batched product over the stacked (E, ...) weights,
the groups' slots side by side (``SeqContext.expert_exchange``, the
reference's ``all_to_all`` pair).  On a mesh of ranks a rank's own
tokens are its one group, ``p["experts"]`` holds its E / M experts, and
its (E, cap, D) buffer reaches them by the tiled ``all_to_all`` pair
over ``model`` (``sharding/context.py::expert_all_to_all``).

A dropped entry never indexes out of range: the dispatch skips it and
the combine reads a clamped slot and *selects* zero.  Where every value
is finite this is the reference; where an expert's row is not, the
reference's clamped gather (``y_buf[flat_e, slot]`` with ``slot >=
cap``, times a weight of 0) hands the non-finite value to a dropped
token, and the port does not.
"""
from __future__ import annotations

import math

import torch

from .layers import MLP_KINDS, dense, dense_init, mlp, mlp_init


def moe_init(gen: torch.Generator, d: int, n_experts: int, d_ff: int,
             kind: str, *, device, dense_d_ff: int = 0, dtype=torch.float32):
    """The router (d, E), the experts' MLP leaves stacked (E, d_in,
    d_out) with ``mlp_init``'s distributions (drawn stacked, so a large
    model's experts never exist twice), and the dense residual MLP where
    the model has one (arctic); drawn in f32 and cast to ``dtype``.  The
    router's logits are f32 whatever the dtype (``router``), the top-k
    probabilities and the combine weights in x's dtype (``route``,
    ``moe_apply``), as the reference's."""
    if kind not in MLP_KINDS:
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    p = {"router": dense_init(gen, d, n_experts, device=device, dtype=dtype)}

    def stacked(d_in, d_out):
        return {"w": (torch.randn((n_experts, d_in, d_out), generator=gen,
                                  device=gen.device)
                      * d_in ** -0.5).to(device=device, dtype=dtype)}
    p["experts"] = {"up": stacked(d, d_ff), "down": stacked(d_ff, d)}
    if kind in ("geglu", "swiglu"):
        p["experts"]["gate"] = stacked(d, d_ff)
    if dense_d_ff:
        p["dense_mlp"] = mlp_init(gen, d, dense_d_ff, kind, device=device,
                                  dtype=dtype)
    return p


def router(router_p, x, top_k: int):
    """x (..., T, D) -> (logits (..., T, E) in f32, their softmax over
    all E, its top-k (..., T, k) not renormalised, the experts idx
    (..., T, k))."""
    logits = dense(router_p, x).float()
    probs_full = torch.softmax(logits, dim=-1)
    probs, idx = torch.topk(probs_full, top_k, dim=-1)
    return logits, probs_full, probs, idx


def route(router_p, x, top_k: int, n_experts: int):
    """x (..., T, D) -> (probs (..., T, k) in x's dtype, idx (..., T, k),
    aux (...)), every leading index a routing group of its own."""
    _, probs_full, probs, idx = router(router_p, x, top_k)
    return probs.to(x.dtype), idx, switch_loss(probs_full, idx, n_experts)


def switch_loss(probs_full, idx, n_experts: int):
    """E · sum_e f_e · P_e per group: f_e the share of the group's
    assignments to expert e, P_e its mean router probability."""
    t, k = idx.shape[-2:]
    counts = torch.zeros(*idx.shape[:-2], n_experts, device=idx.device)
    counts.scatter_add_(-1, idx.flatten(-2), torch.ones(
        idx.flatten(-2).shape, device=idx.device))
    return n_experts * ((counts / (t * k))
                        * probs_full.mean(dim=-2)).sum(dim=-1)


def capacity(t: int, top_k: int, n_experts: int, factor: float) -> int:
    return max(1, math.ceil(t * top_k / n_experts * factor))


def dispatch_indices(idx, n_experts: int, cap: int):
    """Sort-based slotting of the assignments idx (T, k) -> (expert
    (T·k,), slot (T·k,), keep (T·k,), token (T·k,)): an expert's
    assignments take slots in token order (a stable sort), and those at
    slot ``cap`` or later are not kept."""
    t, k = idx.shape
    flat_e = idx.reshape(-1)
    token = torch.arange(t, device=idx.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=idx.device,
                               dtype=sorted_e.dtype))
    rank_sorted = torch.arange(t * k, device=idx.device) - first[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return flat_e, rank, rank < cap, token


class RoutingLog:
    """The routing decisions of successive ``moe_apply`` calls, for the
    checks alone.  A call's record holds its experts ``idx`` (G, T, k),
    its router ``logits`` (G, T, E) and its capacity ``cap``, kept as the
    call made them, so that recording launches nothing (``record_keep``
    and ``record_margin`` derive the rest afterwards).  Replaying a
    recorded log: call i takes call i's experts in place of its own
    top-k (so capacity drops the same entries) and keeps its own beside
    them (``own_idx``)."""

    def __init__(self, replay: "RoutingLog | None" = None):
        self.replay = replay
        self.calls: list[dict] = []

    def decide(self, logits, idx, cap: int):
        """Record this call; returns the experts it routes to."""
        rec = {"idx": idx, "logits": logits, "cap": cap}
        if self.replay is not None:
            used = self.replay.calls[len(self.calls)]["idx"]
            if used.shape != idx.shape:
                raise ValueError(f"replayed call {len(self.calls)} routed "
                                 f"{tuple(used.shape)}, this one "
                                 f"{tuple(idx.shape)}")
            rec.update(idx=used, own_idx=idx)
        self.calls.append(rec)
        return rec["idx"]


def record_keep(rec, own: bool = False):
    """A record's capacity decisions (G, T·k), each group slotted on its
    own: of the experts it routed to, or with ``own`` of its own top-k."""
    idx = rec["own_idx" if own else "idx"]
    g, e = idx.shape[0], rec["logits"].shape[-1]
    off = torch.arange(g, device=idx.device)[:, None, None] * e
    _, _, keep, _ = dispatch_indices((idx + off).flatten(0, 1), g * e,
                                     rec["cap"])
    return keep.view(g, -1)


def record_margin(rec):
    """Each token's router margin (G, T): its k-th largest router logit
    less its (k+1)-th (inf with k = E)."""
    logits, k = rec["logits"], rec["idx"].shape[-1]
    if k == logits.shape[-1]:
        return torch.full(logits.shape[:-1], math.inf, device=logits.device)
    top = logits.topk(k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


def moe_apply(p, x, cfg, ctx, *, routing: RoutingLog | None = None,
              aux: bool = False):
    """x (B, N, D) -> (y (B, N, D), the Switch loss (G,) or None),
    routed in the context's groups.  The loss is computed where ``aux``
    asks for it: serving discards it (the reference's compiler drops
    it).  ``routing`` (checks only) records or replays the decisions
    (``RoutingLog``)."""
    e, k = cfg.n_experts, cfg.top_k
    xg, ungroup = ctx.expert_groups(x)                       # (G, T, D)
    g, t, d = xg.shape
    cap = capacity(t, k, e, cfg.capacity_factor)
    logits, probs_full, probs, idx = router(p["router"], xg, k)
    if routing is not None:
        idx = routing.decide(logits, idx, cap)
        probs = probs_full.gather(-1, idx)
    loss = switch_loss(probs_full, idx, e) if aux else None

    # one sort over every group: group j's experts are rows j·E.. of the
    # (G·E, cap, D) buffer, so each group takes its own slots
    if g > 1:
        idx = idx + torch.arange(g, device=x.device)[:, None, None] * e
    flat_e, slot, keep, token = dispatch_indices(idx.flatten(0, 1), g * e,
                                                 cap)
    dest = torch.where(keep, flat_e * cap + slot, g * e * cap)  # sink row
    buf = torch.zeros(g * e * cap + 1, d, dtype=x.dtype, device=x.device)
    buf.index_put_((dest,), xg.reshape(g * t, d)[token])
    buf_e, undo = ctx.expert_exchange(buf[:-1].view(g, e, cap, d))
    y_e = ctx.expert_reduce(mlp(p["experts"], buf_e, cfg.mlp_kind))
    y_buf = undo(y_e).reshape(g * e * cap, d)
    # a dropped entry reads a clamped slot and selects zero
    y_tok = y_buf[dest.clamp(max=g * e * cap - 1)]
    y_tok = torch.where(keep[:, None],
                        y_tok * probs.reshape(-1, 1).to(x.dtype), 0.0)
    y = ungroup(y_tok.view(g, t, k, d).sum(dim=2))
    if "dense_mlp" in p:                            # arctic dense residual
        y = y + ctx.ffn_reduce(mlp(p["dense_mlp"], x, cfg.mlp_kind))
    return y, loss
