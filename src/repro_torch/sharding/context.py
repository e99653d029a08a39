"""ShardedPrismContext: the PRISM protocol over an explicit shard axis.

The reference runs P sequence shards under ``shard_map`` and exchanges
with collectives.  On one card the P shards live in one process: the
activations are (B·P, n_loc, D), batch row ``b·P + p`` holding shard
``p`` of sequence ``b`` (the same memory as (B, N, D)), and

  * ``lax.all_gather`` of the per-shard tensors is a reshape that puts
    the shard axis next to the sequence axis;
  * the per-shard metadata (query positions, column ranges, repeat
    counts) gets a leading shard dimension, which the prefill kernel
    reads per batch row;
  * ``last_shard`` is indexing shard P-1.

Exchanges:
  * PRISM:   every shard's (B, L, D) segment means, gathered — the own
             shard's means included but neutralized with g = 0
             (paper Eq. 6 with static shapes);
  * Voltage: the full sequence, shared by all shards (the K/V of the
             full sequence is computed once and read by every shard).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.protocol import PrismConfig
from ..core.segment_means import segment_bounds, segment_sizes
from ..kernels.segment_means import prism_augment_op, segment_means_op
from ..models.context import AugmentedKV, SeqContext
from ..models.layers import AttnSpec


class MeansColumns(NamedTuple):
    """Position metadata of the PRISM exchange, for one (P, n_loc, L)."""
    lo: torch.Tensor        # (P·L,) int32 first position of each mean
    hi: torch.Tensor        # (P·L,) int32 last position of each mean
    g: torch.Tensor         # (P, P·L) f32 repeat counts, own shard's 0
    sizes: torch.Tensor     # (P·L,) f32 segment sizes
    col_lo: torch.Tensor    # (P, n_loc + P·L) int32 x_hat's columns:
    col_hi: torch.Tensor    #   the shard's own rows, then the means
    col_g: torch.Tensor     # (P, n_loc + P·L) f32


@functools.lru_cache(maxsize=16)
def shard_rows(n_shards: int, n_loc: int, device: torch.device):
    """(P, n_loc) global position of every shard's rows."""
    return (torch.arange(n_shards, device=device)[:, None] * n_loc
            + torch.arange(n_loc, device=device))


@functools.lru_cache(maxsize=16)
def means_columns(n_shards: int, n_loc: int, L: int,
                  device: torch.device) -> MeansColumns:
    """The gathered means columns, shard-major: position ranges, per-shard
    repeat counts g where a shard's own means get g = 0 (its exact columns
    are present), and the segment sizes; and the same for every column of
    the PRISM x_hat, the shard's own rows first.  Built once per shape and
    device: a host-to-device copy or a concatenation per layer would
    stall the card."""
    lo0, hi0 = segment_bounds(n_loc, L)
    offs = np.repeat(np.arange(n_shards) * n_loc, L)
    shard_of = np.repeat(np.arange(n_shards), L)
    sizes = np.tile(segment_sizes(n_loc, L), n_shards).astype(np.float32)
    g = np.where(shard_of[None, :] == np.arange(n_shards)[:, None],
                 np.float32(0.0), sizes[None, :])
    lo = np.tile(lo0, n_shards) + offs
    hi = np.tile(hi0, n_shards) + offs
    rows = np.arange(n_shards * n_loc).reshape(n_shards, n_loc)
    col_lo = np.concatenate([rows, np.broadcast_to(lo, (n_shards, lo.size))],
                            axis=1)
    col_hi = np.concatenate([rows, np.broadcast_to(hi, (n_shards, hi.size))],
                            axis=1)
    col_g = np.concatenate([np.ones_like(rows, dtype=np.float32), g], axis=1)
    i32 = functools.partial(torch.as_tensor, dtype=torch.int32, device=device)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=device)
    return MeansColumns(i32(lo), i32(hi), f32(g), f32(sizes), i32(col_lo),
                        i32(col_hi), f32(col_g))


class ShardedPrismContext(SeqContext):
    def __init__(self, cfg: PrismConfig, *, n_shards: int,
                 backend: str = "auto"):
        # bind Eq. 16's P to the shard count
        self.cfg = cfg.with_(P=n_shards) if cfg.P != n_shards else cfg
        self.P = n_shards
        self.backend = backend

    def augment(self, x, spec: AttnSpec):
        """x (B·P, n_loc, D) -> (x, AugmentedKV) with per-shard (P, ·)
        metadata.  Voltage's x_hat is (B, N, D), shared by the P shards;
        PRISM's is (B·P, n_loc + P·L, D), local block first."""
        if spec.window is not None:
            raise NotImplementedError("sliding-window layers are not "
                                      "ported yet")
        n_loc = x.shape[1]
        row_pos = shard_rows(self.P, n_loc, x.device)       # (P, n_loc)
        if self.cfg.mode == "voltage":
            return self._augment_voltage(x, n_loc, row_pos)
        if self.cfg.mode != "prism":
            raise NotImplementedError(f"mode {self.cfg.mode!r} is not "
                                      "ported yet")
        return self._augment_prism(x, n_loc, row_pos)

    def _augment_voltage(self, x, n_loc, row_pos):
        bp, _, d = x.shape
        n = self.P * n_loc
        x_hat = x.reshape(bp // self.P, n, d)         # the all-gather
        col = torch.arange(n, device=x.device)
        return x, AugmentedKV(x_hat, None, None, row_pos,
                              col_lo=col, col_hi=col)

    def gather_means(self, x, L: int):
        """Every shard's L segment means of x (B·P, n_loc, D), gathered
        shard-major: (B, P·L, D).  Computed by the segment-means kernel
        on a card."""
        bp, _, d = x.shape
        z = segment_means_op(x, L=L, backend=self.backend)   # (B·P, L, D)
        return z.reshape(bp // self.P, self.P * L, d)

    def _augment_prism(self, x, n_loc, row_pos):
        L = self.cfg.landmarks(self.P * n_loc)
        # one launch: (B·P, n_loc + P·L, D), the local block first
        x_hat = prism_augment_op(x, L=L, n_shards=self.P,
                                 backend=self.backend)
        cols = means_columns(self.P, n_loc, L, x.device)
        # g = 0 columns need no mask entry: log g = -1e30 already removes
        # them, so (col_lo, col_hi) alone reproduce the Eq. 17 mask
        return x, AugmentedKV(x_hat, cols.col_g, None, row_pos,
                              col_lo=cols.col_lo, col_hi=cols.col_hi)

    def last_shard(self, x):
        """Value held by the shard owning the END of the sequence:
        x (B·P, ...) -> (B, ...)."""
        return x.reshape(-1, self.P, *x.shape[1:])[:, self.P - 1]
