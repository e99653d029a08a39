"""The PRISM per-block exchange protocol (paper §III, Fig. 1): the
exchange configuration and the position-wise partitioning (Alg. 1).

Modes:
    'prism'       Segment-Means exchange, scaling-aware softmax (this paper)
    'voltage'     full-partition exchange, exact attention      (baseline [20])
    'duplicate'   Segment-Means exchange, duplicated rows       (Table II ablation)
    'prism_nodup' Segment-Means exchange, NO duplication (g=1)  (Table II 'No' column)
    'single'      no partitioning                               (no-partition row)
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .segment_means import num_landmarks

MODES = ("prism", "voltage", "duplicate", "prism_nodup", "single")


@dataclass(frozen=True)
class PrismConfig:
    """Everything a device needs to know about the exchange."""
    P: int = 1                    # partitions == sequence shards
    cr: float = 1.0               # compression rate (Eq. 16); L = N/(CR*P)
    L: int | None = None          # explicit landmark count overrides cr
    mode: str = "prism"
    causal: bool = True
    prefix_len: int = 0           # prefix-LM (VLM image prefix)
    window: int | None = None     # sliding-window layers (gemma3 local)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.P < 1:
            raise ValueError("P >= 1 required")

    def landmarks(self, n: int) -> int:
        if self.L is not None:
            return self.L
        return num_landmarks(n, self.cr, self.P)

    def with_(self, **kw) -> "PrismConfig":
        return replace(self, **kw)


def partition_bounds(n: int, p: int) -> list[tuple[int, int]]:
    """Alg. 1: (start, size) per partition; last takes the remainder."""
    s, r = divmod(n, p)
    if s == 0:
        raise ValueError(f"cannot split N={n} into P={p} partitions")
    out, start = [], 0
    for i in range(p):
        size = s + (r if i == p - 1 else 0)
        out.append((start, size))
        start += size
    return out
