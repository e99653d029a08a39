"""SeqContext: how a model's sequence-mixing layers see the sequence.

    xq, akv = ctx.augment(x, spec)     # query source + augmented K/V view
    ... attention(xq ..., akv.x_hat ..., akv.g, akv.mask) ...
    out = ctx.finalize(out)            # back to the caller's layout

for linear-recurrence layers (the mLSTM, Mamba2) and the sequential
sLSTM:

    s0 = ctx.state_handoff(log_a_tot, u_tot)   # state entering the shard
    halo = ctx.prev_tail(x, size)              # Mamba2's causal-conv halo
    x_full = ctx.gather_sequence(x)            # the whole sequence (sLSTM)
    y = ctx.take_local(y_full)                 # back to the shard's rows
    s = ctx.last_shard(s_end)                  # the sequence's end state

and for Mixture-of-Experts layers:

    xg, ungroup = ctx.expert_groups(x)     # (G, T, D) routing groups
    buf_e, undo = ctx.expert_exchange(buf) # (G, E, cap, D) -> (E, G·cap, D)

``FullContext`` runs the whole sequence on one executor (the plain full
forward).  ``sharding.context.ShardedPrismContext`` runs the PRISM
protocol over an explicit shard axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.masks import visibility
from .layers import AttnSpec


@dataclass(frozen=True)
class AugmentedKV:
    x_hat: torch.Tensor                # (B', M, D) K/V source
    g: Optional[torch.Tensor]          # repeat counts, or None (exact)
    mask: Optional[torch.Tensor]       # bool (Nq, M), or None
    row_pos: torch.Tensor              # (Nq,) or (P, Nq): q's RoPE
    col_pos: torch.Tensor              # (M,) or (P, M): k's RoPE
    # per-column global position ranges, (M,) or (P, M): the prefill
    # kernel re-derives visibility from them instead of taking a mask
    col_lo: Optional[torch.Tensor] = None
    col_hi: Optional[torch.Tensor] = None


class SeqContext:
    def augment(self, x, spec: AttnSpec):
        raise NotImplementedError

    def finalize(self, out):
        return out

    # ---- recurrent layers: the state handoff and the sequence ------------
    def state_handoff(self, log_a_tot, u_tot):
        """The state entering this executor's span for a linear recurrence
        S' = a·S + u, whose span the totals ``log_a_tot`` (B, H) and
        ``u_tot`` (B, H, dk, dv) summarise.  One executor owns the whole
        sequence, so nothing comes in: zeros."""
        return torch.zeros_like(u_tot)

    def prev_tail(self, x, size: int):
        """The last ``size`` rows of the span before this executor's: the
        halo of a causal convolution (Mamba2's).  One executor owns the
        whole sequence, so it starts at the true start: zeros (B, size,
        C)."""
        return x.new_zeros(x.shape[:-2] + (size,) + x.shape[-1:])

    def gather_sequence(self, x):
        """The whole sequence (B, N, D) (the sLSTM's scan)."""
        return x

    def take_local(self, y_full):
        """Inverse of ``gather_sequence``: this executor's rows."""
        return y_full

    def last_shard(self, x):
        """The value of the executor that holds the sequence's end."""
        return x

    # ---- MoE: routing groups and the expert exchange ---------------------
    def expert_groups(self, x):
        """x (B, N, D) -> (G, T, D), the token sets capacity is counted
        over, and the inverse for the outputs.  One executor routes all
        of its tokens as one group."""
        return x.reshape(1, -1, x.shape[-1]), lambda y: y.reshape(x.shape)

    def expert_exchange(self, buf):
        """(G, E, cap, D), every group's dispatch buffer -> (E, G·cap, D),
        each expert's slots of every group side by side (what the
        reference's tiled ``all_to_all`` gives each expert's device), and
        the inverse for the outputs."""
        g, e, cap, d = buf.shape
        return (buf.transpose(0, 1).reshape(e, g * cap, d),
                lambda y: y.reshape(e, g, cap, d).transpose(0, 1))

    def expert_reduce(self, y):
        """Sum of expert-TP partials: the identity on one card."""
        return y

    def ffn_reduce(self, y):
        """Sum of Megatron-TP FFN partials (the MoE dense residual): the
        identity on one card."""
        return y


class FullContext(SeqContext):
    """Whole sequence visible; standard masks; no compression."""

    def __init__(self, *, start: int = 0, prefix_len: int = 0):
        self.start = start
        self.prefix_len = prefix_len

    def augment(self, x, spec: AttnSpec):
        n = x.shape[-2]
        pos = torch.arange(n, device=x.device) + self.start
        mask = visibility(pos, pos, pos, causal=spec.causal,
                          prefix_len=self.prefix_len, window=spec.window)
        return x, AugmentedKV(x, None, mask, pos, pos, pos, pos)
