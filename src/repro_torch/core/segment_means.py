"""Segment Means compression (paper §IV-B, Algorithm 2).

A partition ``X_p ∈ R^{..., N_p, D}`` is divided into ``L`` contiguous
segments: the first ``L-1`` of size ``s = floor(N_p / L)`` and the last
of size ``s + (N_p mod L)``.  The column-wise mean of each segment is its
*segment mean*.

``segment_means`` is also the plain version of the CUDA segment-means
kernel (``kernels/segment_means.py``).
"""
from __future__ import annotations

import numpy as np
import torch


def segment_sizes(n_p: int, L: int) -> np.ndarray:
    """Per-segment token counts ``n_l`` (paper Eq. 8): [s]*(L-1) + [s+r]."""
    if not 1 <= L <= n_p:
        raise ValueError(f"need 1 <= L <= N_p, got L={L}, N_p={n_p}")
    s, r = divmod(n_p, L)
    sizes = np.full(L, s, dtype=np.int64)
    sizes[-1] += r
    return sizes


def segment_bounds(n_p: int, L: int, offset: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) inclusive global-position bounds of each segment's
    tokens, shifted by ``offset`` (the partition start)."""
    sizes = segment_sizes(n_p, L)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    return starts + offset, ends - 1 + offset


def segment_fill_counts(lo: torch.Tensor, hi: torch.Tensor,
                        filled: torch.Tensor) -> torch.Tensor:
    """Per-segment count of real tokens once positions ``[0, filled)``
    are laid down: ``clip(min(filled, hi + 1) - lo, 0)`` in f32.
    ``lo``/``hi`` (m,) are the inclusive bounds of each segment column;
    ``filled`` has any leading shape, the segment axis is appended.
    These are the repeat counts g of a mean over a partly filled (or
    short) segment, so it never weighs a column with no real token."""
    filled = filled[..., None]
    return torch.clamp(torch.minimum(filled, hi + 1) - lo, min=0).float()


def segment_means(x: torch.Tensor, L: int) -> torch.Tensor:
    """Compress ``x (..., N_p, D)`` to ``(..., L, D)`` segment means,
    accumulated in f32 and returned in ``x``'s dtype."""
    n_p = x.shape[-2]
    if not 1 <= L <= n_p:
        raise ValueError(f"need 1 <= L <= N_p, got L={L}, N_p={n_p}")
    xf = x.float()
    s = n_p // L
    if L == 1:
        return xf.mean(dim=-2, keepdim=True).to(x.dtype)
    head = xf[..., : s * (L - 1), :]
    head = head.reshape(*x.shape[:-2], L - 1, s, x.shape[-1]).mean(dim=-2)
    tail = xf[..., s * (L - 1):, :].mean(dim=-2, keepdim=True)
    return torch.cat([head, tail], dim=-2).to(x.dtype)


def num_landmarks(n: int, cr: float, p: int) -> int:
    """L = floor(N / (CR * P)) (paper Eq. 16), clamped to >= 1."""
    return max(1, int(n // (cr * p)))
