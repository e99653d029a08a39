"""Partition-aware attention masks (paper §IV-D, Eq. 17), generalized.

Every column of the augmented K/V matrix covers a *range* of global
token positions: an exact local token covers ``[i, i]``; a segment mean
covers ``[lo, hi]``.  One rule expresses every mask variant:

    visible(row i, col [lo, hi]) =
        (not causal)            OR  hi <= pos(i)
        OR hi < prefix_len
    AND (window is None OR lo > pos(i) - window)
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps bf16 finite


def visibility(
    row_pos: torch.Tensor,      # (..., Nq) global positions of query rows
    col_lo: torch.Tensor,       # (..., M)  first global position per column
    col_hi: torch.Tensor,       # (..., M)  last global position per column
    *,
    causal: bool,
    prefix_len: int = 0,
    window: int | None = None,
) -> torch.Tensor:
    """Boolean (..., Nq, M) mask; True = attend.  Leading dims (the
    port's shard axis) broadcast between rows and columns."""
    r = row_pos[..., :, None]
    lo = col_lo[..., None, :]
    hi = col_hi[..., None, :]
    if causal:
        vis = hi <= r
        if prefix_len > 0:
            vis = vis | (hi < prefix_len)
    else:
        vis = torch.ones(torch.broadcast_shapes(r.shape, lo.shape),
                         dtype=torch.bool, device=row_pos.device)
    if window is not None:
        vis = vis & (lo > r - window)
    return vis
