"""The PRISM per-block exchange protocol (paper §III, Fig. 1): the
exchange configuration, the position-wise partitioning (Alg. 1), every
device's augmented view of a block's input (``device_views``: a loop
over the P devices, the oracle of the batched contexts) and the
communication accounting (§IV-C).

Modes:
    'prism'       Segment-Means exchange, scaling-aware softmax (this paper)
    'voltage'     full-partition exchange, exact attention      (baseline [20])
    'duplicate'   Segment-Means exchange, duplicated rows       (Table II ablation)
    'prism_nodup' Segment-Means exchange, NO duplication (g=1)  (Table II 'No' column)
    'single'      no partitioning                               (no-partition row)
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .masks import visibility
from .segment_means import (num_landmarks, segment_bounds, segment_means,
                            segment_sizes)

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


def partition(x: torch.Tensor, p: int, axis: int = -2) -> list[torch.Tensor]:
    """Alg. 1 applied to a tensor along the sequence axis: P views."""
    n = x.shape[axis]
    return [x.narrow(axis, start, size)
            for start, size in partition_bounds(n, p)]


def exact_cols(n: int, offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) position ranges of n exact (uncompressed) columns."""
    pos = np.arange(n) + offset
    return pos, pos


def duplicate_means(z: torch.Tensor, n_p: int) -> torch.Tensor:
    """Means (..., L, D) back to (..., N_p, D), each repeated over its
    segment's size (paper Eq. 11, Y_p): the Table II ablation's rows."""
    sizes = segment_sizes(n_p, z.shape[-2])
    idx = torch.as_tensor(np.repeat(np.arange(len(sizes)), sizes),
                          device=z.device)
    return z.index_select(-2, idx)


@dataclass(frozen=True)
class DeviceView:
    """What device ``p`` sees for one block's attention."""
    p: int
    x_p: torch.Tensor             # (..., N_p, D) local partition (queries)
    x_hat: torch.Tensor           # (..., M, D)  augmented K/V source (Eq. 6)
    g: np.ndarray | None          # (M,) repeat counts; None => exact
    col_lo: np.ndarray            # (M,) global position ranges per column
    col_hi: np.ndarray
    row_pos: np.ndarray           # (N_p,) global positions of local rows

    def mask(self, cfg: PrismConfig) -> torch.Tensor:
        """Bool (N_p, M), True = attend (Eq. 17); ``causal`` from the
        PrismConfig, as the reference takes it."""
        dev = self.x_p.device
        return visibility(
            torch.as_tensor(self.row_pos, device=dev),
            torch.as_tensor(self.col_lo, device=dev),
            torch.as_tensor(self.col_hi, device=dev), causal=cfg.causal,
            prefix_len=cfg.prefix_len, window=cfg.window)


def device_views(x: torch.Tensor, cfg: PrismConfig) -> list[DeviceView]:
    """Every device's augmented view of hidden states x (..., N, D), in
    all five modes.  Column order per Eq. 6 / Eq. 17: the local
    partition first, then the other partitions' summaries in ascending
    partition order."""
    n = x.shape[-2]
    bounds = partition_bounds(n, cfg.P)
    parts = partition(x, cfg.P)

    if cfg.mode == "single" or cfg.P == 1:
        lo, hi = exact_cols(n)
        return [DeviceView(0, x, x, None, lo, hi, np.arange(n))]

    if cfg.mode == "voltage":
        lo, hi = exact_cols(n)
        return [DeviceView(p, parts[p], x, None, lo, hi,
                           np.arange(size) + start)
                for p, (start, size) in enumerate(bounds)]

    # prism / duplicate / prism_nodup: compress each partition
    L = cfg.landmarks(n)
    z, sizes, zlo, zhi = [], [], [], []
    for p, (start, size) in enumerate(bounds):
        if L > size:
            raise ValueError(
                f"L={L} exceeds partition size {size}; lower cr or P")
        z.append(segment_means(parts[p], L))
        sizes.append(segment_sizes(size, L))
        lo, hi = segment_bounds(size, L, offset=start)
        zlo.append(lo)
        zhi.append(hi)

    views = []
    for p, (start, size) in enumerate(bounds):
        others = [q for q in range(cfg.P) if q != p]
        if cfg.mode == "duplicate":
            remote = [duplicate_means(z[q], bounds[q][1]) for q in others]
            g = None
            r_lo = [np.repeat(zlo[q], sizes[q]) for q in others]
            r_hi = [np.repeat(zhi[q], sizes[q]) for q in others]
        else:
            remote = [z[q] for q in others]
            if cfg.mode == "prism_nodup":        # Table II 'No' column
                g = np.ones(size + (cfg.P - 1) * L, np.int64)
            else:
                g = np.concatenate(
                    [np.ones(size, np.int64)] + [sizes[q] for q in others])
            r_lo = [zlo[q] for q in others]
            r_hi = [zhi[q] for q in others]
        loc_lo, loc_hi = exact_cols(size, offset=start)
        views.append(DeviceView(
            p, parts[p], torch.cat([parts[p]] + remote, dim=-2), g,
            np.concatenate([loc_lo] + r_lo),
            np.concatenate([loc_hi] + r_hi),
            np.arange(size) + start))
    return views


def comm_elements_per_device_per_layer(n: int, d: int,
                                       cfg: PrismConfig) -> float:
    """Elements each device transmits per Transformer block (§IV-C)."""
    if cfg.P == 1 or cfg.mode == "single":
        return 0.0
    if cfg.mode == "voltage":
        return (cfg.P - 1) * n * d / cfg.P
    return float((cfg.P - 1) * cfg.landmarks(n) * d)


def tensor_parallel_comm(n: int, d: int, p: int) -> float:
    """Megatron-style TP per-device per-layer traffic: 4(P-1)ND/P
    (§II-B2)."""
    return 4 * (p - 1) * n * d / p


def comm_speedup(n: int, d: int, cfg: PrismConfig) -> float:
    """The paper's 'Comm. Speed-up %': 1 - prism / voltage."""
    volt = comm_elements_per_device_per_layer(n, d, cfg.with_(mode="voltage"))
    ours = comm_elements_per_device_per_layer(n, d, cfg)
    return 100.0 * (1.0 - ours / volt) if volt else 0.0
