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
forward).  ``SimulatedContext`` is the paper's P-device protocol folded
into the batch axis, the accuracy protocol's context and the oracle of
the sharded path.  ``sharding.context.ShardedPrismContext`` runs the
PRISM protocol over an explicit shard axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.masks import visibility
from ..core.protocol import PrismConfig
from ..core.segment_means import segment_bounds, segment_means, segment_sizes
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


class SimulatedContext(SeqContext):
    """The paper's P-device protocol simulated on one executor
    (``repro.models.context.SimulatedContext``).

    N % P == 0 so the partitions stack: x (B, N, D) -> queries (B·P, N/P,
    D), batch row b·P + p holding partition p of sequence b, and back in
    ``finalize``.  Partition p attends over its own rows and every other
    partition's L segment means (prism: repeat counts g = the segment
    sizes; duplicate, as in the reference: the same, which equals the
    duplicated rows by Eq. 12-15; prism_nodup: g = 1), each mean at the
    RoPE position of its segment's midpoint; voltage, and a
    sliding-window layer in any mode, over the whole sequence exactly.
    Only attention layers see the
    partitions: the rest (MoE groups, recurrent layers) run on (B, N, D)
    as one executor, as the reference's do.  Per-partition metadata is
    (P, ·), masks and g (B·P, 1, ·, M)."""

    def __init__(self, cfg: PrismConfig, *, prefix_len: int = 0):
        if cfg.mode == "single":
            # the reference runs it as prism over P partitions
            raise NotImplementedError(
                "SimulatedContext partitions the sequence; 'single' is "
                "FullContext (core.protocol.device_views has all five "
                "modes)")
        self.cfg = cfg
        self.prefix_len = prefix_len
        self._b = None  # remembered for finalize

    def augment(self, x, spec: AttnSpec):
        cfg, p = self.cfg, self.cfg.P
        b, n, d = x.shape
        if n % p:
            raise ValueError(f"SimulatedContext needs N % P == 0, got "
                             f"N={n}, P={p}")
        npart = n // p
        dev = x.device
        self._b = b
        xp = x.reshape(b, p, npart, d)
        xq = xp.reshape(b * p, npart, d)
        row_pos = (torch.arange(p, device=dev)[:, None] * npart
                   + torch.arange(npart, device=dev))              # (P, Np)

        if cfg.mode == "voltage" or spec.window is not None:
            # the whole sequence; a window layer's means would lie out of
            # its window, so it takes the exact rows in either mode
            x_hat = x[:, None].expand(b, p, n, d).reshape(b * p, n, d)
            col = torch.arange(n, device=dev)
            mask = visibility(row_pos, col, col, causal=spec.causal,
                              prefix_len=self.prefix_len,
                              window=spec.window)                 # (P, Np, N)
            return xq, AugmentedKV(
                x_hat, None, self._per_row(mask, b), row_pos,
                col[None].expand(p, n), col, col)

        L = cfg.landmarks(n)
        z = segment_means(xp, L)                                  # (B, P, L, D)
        sizes = torch.as_tensor(segment_sizes(npart, L), dtype=torch.float32,
                                device=dev)
        bounds = [segment_bounds(npart, L, offset=q * npart)
                  for q in range(p)]
        lo = torch.as_tensor(np.stack([bd[0] for bd in bounds]), device=dev)
        hi = torch.as_tensor(np.stack([bd[1] for bd in bounds]), device=dev)
        others = [[q for q in range(p) if q != pi] for pi in range(p)]
        oth = torch.as_tensor(others, device=dev).reshape(p, -1)   # (P, P-1)
        # partition pi's columns: its rows, then the others' means
        remote = z[:, oth].reshape(b, p, (p - 1) * L, d)
        x_hat = torch.cat([xp, remote], dim=2).reshape(b * p, -1, d)
        ones = torch.ones(p, npart, device=dev)
        g_remote = (torch.ones(p, (p - 1) * L, device=dev)
                    if cfg.mode == "prism_nodup"
                    else sizes.repeat(p * (p - 1)).reshape(p, -1))
        g = torch.cat([ones, g_remote], dim=1)                      # (P, M)
        c_lo = torch.cat([row_pos, lo[oth].reshape(p, -1)], dim=1)
        c_hi = torch.cat([row_pos, hi[oth].reshape(p, -1)], dim=1)
        col_pos = torch.cat([row_pos.float(),
                             ((lo + hi) / 2.0)[oth].reshape(p, -1)], dim=1)
        mask = visibility(row_pos, c_lo, c_hi, causal=spec.causal,
                          prefix_len=self.prefix_len)             # (P, Np, M)
        return xq, AugmentedKV(
            x_hat, self._per_row(g[:, None], b),
            self._per_row(mask, b), row_pos, col_pos, c_lo, c_hi)

    @staticmethod
    def _per_row(t, b: int):
        """(P, ...) per-partition metadata -> (B·P, 1, ...): batch row
        b·P + p takes partition p's."""
        return t[None].expand(b, *t.shape).reshape(
            b * t.shape[0], 1, *t.shape[1:])

    def finalize(self, out):
        bp, npart, d = out.shape
        return out.reshape(self._b, (bp // self._b) * npart, d)
