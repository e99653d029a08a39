"""SeqContext: how a model's attention layers see the sequence.

    xq, akv = ctx.augment(x, spec)     # query source + augmented K/V view
    ... attention(xq ..., akv.x_hat ..., akv.g, akv.mask) ...
    out = ctx.finalize(out)            # back to the caller's layout

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
    row_pos: torch.Tensor              # (Nq,) or (P, Nq)
    # per-column global position ranges, (M,) or (P, M): the prefill
    # kernel re-derives visibility from them instead of taking a mask
    col_lo: Optional[torch.Tensor] = None
    col_hi: Optional[torch.Tensor] = None


class SeqContext:
    def augment(self, x, spec: AttnSpec):
        raise NotImplementedError

    def finalize(self, out):
        return out


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
        return x, AugmentedKV(x, None, mask, pos, pos, pos)
