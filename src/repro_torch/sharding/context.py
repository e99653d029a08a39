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
  * ``last_shard`` is indexing shard P-1;
  * a Mixture-of-Experts layer routes each shard's tokens as a group of
    their own, at the capacity of that group, as the reference's
    ``shard_map`` does (``expert_groups``); its ``all_to_all`` pair is
    the exchange every context has (``SeqContext.expert_exchange``).

Alg. 1's uneven split (an encoder's N not a multiple of P, as ViT's 197
tokens): the P - 1 first shards hold s = N // P rows and the last s + r,
each padded to n_loc = s + r, so the batch-folded layout and one
attention launch a layer stay.  A pad row is a query whose output is
discarded (position -1); a pad column is dead (g = 0); a shard's means
are over its real rows, with its own Eq. 8 segment sizes; Voltage's
x_hat is the N real rows.  ``n`` (the real length) arms it; r = 0 is the
even split, unchanged.

Dtypes: the exchanged rows keep x's dtype (bf16 x: the means through the
bf16 instance of ``prism_augment_op``, summed in f32, rounded once, as
the reference's), and the repeat counts g and every position stay f32
and int.

Exchanges:
  * PRISM:   every shard's (B, L, D) segment means, gathered — the own
             shard's means included but neutralized with g = 0
             (paper Eq. 6 with static shapes);
  * prism_nodup: the same columns with g = 1 on the other shards'
             means (Table II's 'No' column);
  * duplicate (Table II's ablation, Eq. 11's Y_p: each other shard's
             means repeated over their segments' sizes): PRISM's
             columns, since g = the segment sizes gives the repeated
             rows' softmax exactly (Eq. 12-15), as in the reference and
             ``SimulatedContext``; ``device_views`` keeps the explicit
             rows as the oracle;
  * Voltage, and 'single' (no partition: every shard attends over the
             whole sequence, which is the unpartitioned result): the
             full sequence, shared by all shards (the K/V of the full
             sequence is computed once and read by every shard);
  * window:  a sliding-window layer (Gemma 3's local layers) in either
             mode: the previous ``hops`` shards' rows as a halo before
             the shard's own (the reference's ring ``ppermute``), halo
             columns before position 0 dead (g = 0); the kernel applies
             the window from the positions;
  * state:   an mLSTM layer's constant-size handoff: each shard's span
             totals (log a, U), gathered, and the exclusive prefix
             S <- exp(log a_p)·S + u_p over the P shards of a sequence
             (the reference's ``all_gather`` and scan);
  * sLSTM:   the whole sequence, (B·P, n_loc, D) viewed as (B, N, D),
             and back (the reference's full-sequence gather);
  * halo:    a Mamba2 layer's causal conv: each shard takes the last
             rows of the shard before it, zeros for shard 0 (the
             reference's ``ppermute`` one shard on).
The recurrent layers take the even split only.

On a mesh of ranks (``mesh=``, ``launch/mesh.py``) each rank holds one
shard of its sequences, (B, n_loc, D): the folded shard axis is the
rank's own, so the per-shard metadata is the row of the rank's sequence
index over ``seq_axes`` (the reference's ``_index``), a gather is
``comm.all_gather`` over that group and ``last_shard`` a broadcast from
its last rank.  The PRISM exchange is the rank's means from the
segment-means kernel, gathered, after its own rows (the fused augment
reads every shard's rows, which one rank does not hold); Voltage's is
the gathered sequence.  The window halo is ``hops`` ``comm.ppermute``s
over the sequence group (on the B 1 layout the group is the flattened
(data, model) index, so one shift replaces the reference's minor/major
pair); the state handoff gathers every rank's (log a, U) and runs the
fold's scan; Mamba2's halo is a ``ppermute`` by one; the sLSTM's
sequence an ``all_gather``.  A MoE layer routes the rank's own B·n_loc
tokens as one group and exchanges them with the tiled ``all_to_all``
pair over ``model``, the experts' axis.  The reference's mesh runs
neither the Table II modes (its ``augment`` serves every non-Voltage
mode as PRISM) nor Alg. 1's uneven split (``shard_map`` takes N a
multiple of the shard count): a mesh refuses both.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.protocol import PrismConfig
from ..core.segment_means import segment_bounds, segment_sizes
from ..kernels.segment_means import prism_augment_op, segment_means_op
from ..models.context import AugmentedKV, SeqContext
from ..models.layers import AttnSpec
from . import comm

# the exchanges a mesh of ranks runs: the reference's mesh has no other
MESH_MODES = ("prism", "voltage")


class MeansColumns(NamedTuple):
    """Position metadata of the PRISM exchange, for one (P, n_loc, L) and
    the last shard's real rows."""
    lo: torch.Tensor        # (P·L,) int32 first position of each mean
    hi: torch.Tensor        # (P·L,) int32 last position of each mean
    g: torch.Tensor         # (P, P·L) f32 repeat counts, own shard's 0
    sizes: torch.Tensor     # (P·L,) f32 segment sizes
    col_lo: torch.Tensor    # (P, n_last + P·L) int32 x_hat's columns:
    col_hi: torch.Tensor    #   the shard's own rows (pad rows -1), then
                            #   the means
    col_g: torch.Tensor     # (P, n_last + P·L) f32, pad rows 0
    mid: torch.Tensor       # (P·L,) f32 each mean's RoPE position, the
                            #   midpoint (lo + hi) / 2 of its segment
    col_pos: torch.Tensor   # (P, n_last + P·L) f32 x_hat's RoPE positions


def _shard_rows_np(n_shards: int, n_loc: int, n_last: int) -> np.ndarray:
    """(P, n_last) global position of every shard's rows: shard p's real
    rows start at p·n_loc; the pad rows of a shorter shard are -1."""
    j = np.arange(n_last)[None, :]
    p = np.arange(n_shards)[:, None]
    size = np.where(p == n_shards - 1, n_last, n_loc)
    return np.where(j < size, p * n_loc + j, -1)


@functools.lru_cache(maxsize=16)
def shard_rows(n_shards: int, n_loc: int, device: torch.device,
               n_last: int | None = None):
    """(P, n_last) global position of every shard's rows, -1 for a pad
    row: the P - 1 first shards hold n_loc real rows, the last
    ``n_last`` (default n_loc, the even split)."""
    n_last = n_loc if n_last is None else n_last
    return torch.as_tensor(_shard_rows_np(n_shards, n_loc, n_last),
                           device=device)


@functools.lru_cache(maxsize=16)
def means_columns(n_shards: int, n_loc: int, L: int, device: torch.device,
                  n_last: int | None = None) -> MeansColumns:
    """The gathered means columns, shard-major: position ranges, per-shard
    repeat counts g where a shard's own means get g = 0 (its exact columns
    are present), the segment sizes and midpoints (a mean's RoPE
    position); and the same for every column of the PRISM x_hat, the
    shard's own rows first (a pad row dead, g = 0).  The P - 1 first
    shards hold n_loc rows, the last ``n_last`` (default n_loc), each cut
    into its own Eq. 8 segments.  Built once per shape and device: a
    host-to-device copy or a concatenation per layer would stall the
    card."""
    n_last = n_loc if n_last is None else n_last
    parts = [segment_bounds(n_loc if q < n_shards - 1 else n_last, L,
                            offset=q * n_loc) for q in range(n_shards)]
    lo = np.concatenate([b[0] for b in parts])
    hi = np.concatenate([b[1] for b in parts])
    shard_of = np.repeat(np.arange(n_shards), L)
    sizes = np.concatenate(
        [segment_sizes(n_loc, L)] * (n_shards - 1)
        + [segment_sizes(n_last, L)]).astype(np.float32)
    g = np.where(shard_of[None, :] == np.arange(n_shards)[:, None],
                 np.float32(0.0), sizes[None, :])
    rows = _shard_rows_np(n_shards, n_loc, n_last)
    col_lo = np.concatenate([rows, np.broadcast_to(lo, (n_shards, lo.size))],
                            axis=1)
    col_hi = np.concatenate([rows, np.broadcast_to(hi, (n_shards, hi.size))],
                            axis=1)
    col_g = np.concatenate([(rows >= 0).astype(np.float32), g], axis=1)
    mid = (lo + hi) / 2.0
    col_pos = np.concatenate(
        [rows, np.broadcast_to(mid, (n_shards, mid.size))], axis=1)
    i32 = functools.partial(torch.as_tensor, dtype=torch.int32, device=device)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=device)
    return MeansColumns(i32(lo), i32(hi), f32(g), f32(sizes), i32(col_lo),
                        i32(col_hi), f32(col_g), f32(mid), f32(col_pos))


class WindowColumns(NamedTuple):
    """Position metadata of the window halo, for one (P, n_loc, hops)."""
    col: torch.Tensor       # (P, m) int32 each column's global position,
                            #   the halo's (negative before the start)
                            #   then the shard's own rows
    g: torch.Tensor         # (P, m) f32 1, or 0 before position 0
    pos: torch.Tensor       # (P, m) int32 RoPE positions, max(col, 0)


@functools.lru_cache(maxsize=16)
def window_columns(n_shards: int, n_loc: int, hops: int,
                   device: torch.device) -> WindowColumns:
    """The window x_hat's columns per shard: ``hops`` shards of halo,
    then the shard's own rows, at positions start - hops·n_loc +
    arange((hops + 1)·n_loc).  Built once per shape and device."""
    m = (hops + 1) * n_loc
    col = (np.arange(n_shards)[:, None] * n_loc - hops * n_loc
           + np.arange(m)[None, :])
    i32 = functools.partial(torch.as_tensor, dtype=torch.int32, device=device)
    return WindowColumns(i32(col), torch.as_tensor(
        (col >= 0).astype(np.float32), device=device),
        i32(np.maximum(col, 0)))


class ShardedPrismContext(SeqContext):
    def __init__(self, cfg: PrismConfig, *, n_shards: int,
                 backend: str = "auto", n: int | None = None, mesh=None,
                 seq_axes: tuple = ("model",)):
        """``n``: the sequence's real length where it may split unevenly
        (Alg. 1; ``shard`` lays it out); None: P·n_loc, the even split.
        ``mesh``: this rank's ``Mesh``, whose ``seq_axes`` carry the
        n_shards sequence shards, one a rank; None: the P shards folded
        into the batch axis of one process."""
        # bind Eq. 16's P to the shard count
        self.cfg = cfg.with_(P=n_shards) if cfg.P != n_shards else cfg
        self.P = n_shards
        self.backend = backend
        self.n = n
        self.group = self.experts = None
        if mesh is not None:
            if self.cfg.mode not in MESH_MODES:
                raise NotImplementedError(
                    f"a mesh runs the {'/'.join(MESH_MODES)} exchanges, "
                    f"not {self.cfg.mode!r}: the reference's mesh serves "
                    "every other mode as prism (the Table II modes run "
                    "folded)")
            if n is not None:
                raise NotImplementedError(
                    f"a mesh takes the even split, not N={n} over "
                    f"{n_shards} shards: the reference's shard_map takes N "
                    "a multiple of the shard count (Alg. 1's uneven split "
                    "runs folded)")
            self.group = mesh.group(seq_axes)
            # the experts' axis: the reference's all_to_all is over model
            self.experts = mesh.group("model")
            if self.group.size != n_shards:
                raise ValueError(f"{n_shards} shards over {seq_axes} of "
                                 f"{self.group.size} ranks")

    def _local(self, t):
        """The rank's row of per-shard (P, ...) metadata on a mesh, (1,
        ...); every row in the fold."""
        if self.group is None:
            return t
        i = self.group.index
        return t[i:i + 1]

    def _gather(self, x):
        """Every rank's x over the sequence group, stacked (P, ...)."""
        return comm.all_gather(x, self.group, "exchange")

    def split(self, n_loc: int) -> tuple[int, int]:
        """(real rows of each of the P - 1 first shards, the sequence's
        real length) for the padded shard width ``n_loc``."""
        if self.n is None:
            return n_loc, self.P * n_loc
        s, r = divmod(self.n, self.P)
        if s == 0 or s + r != n_loc:
            raise ValueError(f"N={self.n} over P={self.P} shards pads to "
                             f"{s + r} rows a shard, got {n_loc}")
        return s, self.n

    def shard(self, x):
        """x (B, N, D) -> (B·P, n_loc, D) under Alg. 1 (``partition_
        bounds``): shard p's rows [p·s, p·s + size_p) at the top of batch
        row b·P + p, the P - 1 first shards zero-padded to the last one's
        s + r rows.  With r = 0 it is a view."""
        b, n, d = x.shape
        s, r = divmod(n, self.P)
        if s == 0:
            raise ValueError(f"cannot split N={n} into P={self.P} "
                             "partitions")
        if not r:
            return x.reshape(b * self.P, s, d)
        head = x[:, :n - s - r].reshape(b, self.P - 1, s, d)
        return torch.cat([F.pad(head, (0, 0, 0, r)),
                          x[:, None, n - s - r:]], dim=1).reshape(
            b * self.P, s + r, d)

    def augment(self, x, spec: AttnSpec):
        """x (B·P, n_loc, D) -> (x, AugmentedKV) with per-shard (P, ·)
        metadata.  Voltage's x_hat is (B, N, D), the real rows, shared by
        the P shards; PRISM's is (B·P, n_loc + P·L, D), local block
        first; a window layer's (B·P, (hops + 1)·n_loc, D), local block
        last, in either mode (even split only)."""
        n_loc = x.shape[1]
        s, n = self.split(n_loc)
        row_pos = self._local(shard_rows(self.P, s, x.device, n_loc))
        if spec.window is not None:
            if s != n_loc:
                raise NotImplementedError("sliding-window layers take the "
                                          "even split only")
            return self._augment_window(x, spec.window, n_loc, row_pos)
        if self.cfg.mode in ("voltage", "single"):
            return self._augment_voltage(x, s, n, row_pos)
        return self._augment_prism(x, s, n, row_pos)

    def _augment_voltage(self, x, s, n, row_pos):
        bp, n_loc, d = x.shape
        b = bp // self.P
        if self.group is not None:          # every rank's rows, gathered
            x_hat = self._gather(x).transpose(0, 1).reshape(bp, n, d)
        elif s == n_loc:
            x_hat = x.reshape(b, n, d)                # the all-gather
        else:                                         # the real rows only
            xs = x.view(b, self.P, n_loc, d)
            x_hat = torch.cat([xs[:, :-1, :s].reshape(b, n - n_loc, d),
                               xs[:, -1]], dim=1)
        col = torch.arange(n, device=x.device)
        return x, AugmentedKV(x_hat, None, None, row_pos, col,
                              col_lo=col, col_hi=col)

    def window_hops(self, window: int, n_loc: int) -> int:
        """Shards of halo a window of ``window`` needs: ceil(W / n_loc),
        at most P - 1."""
        return min(self.P - 1, -(-window // n_loc))

    def _augment_window(self, x, window, n_loc, row_pos):
        """The ring halo: shard p's x_hat is shards p - hops .. p - 1
        (zeros before shard 0, as ``ppermute`` fills them), then its own
        rows."""
        bp, _, d = x.shape
        hops = self.window_hops(window, n_loc)
        if self.group is not None:        # each hop one ppermute
            x_hat = torch.cat([comm.ppermute(x, self.group, "exchange",
                                             shift=h)
                               for h in range(hops, 0, -1)] + [x], dim=1)
        else:
            xs = x.view(bp // self.P, self.P, n_loc, d)
            halo = [F.pad(xs[:, :self.P - h], (0, 0, 0, 0, h, 0))
                    for h in range(hops, 0, -1)]
            x_hat = torch.cat(halo + [xs], dim=2).reshape(
                bp, (hops + 1) * n_loc, d)
        cols = window_columns(self.P, n_loc, hops, x.device)
        return x, AugmentedKV(x_hat, self._local(cols.g), None, row_pos,
                              self._local(cols.pos),
                              col_lo=self._local(cols.col),
                              col_hi=self._local(cols.col))

    def gather_means(self, x, L: int):
        """Every shard's L segment means of x (B·P, n_loc, D), gathered
        shard-major: (B, P·L, D).  Computed by the segment-means kernel
        on a card (even split only)."""
        bp, n_loc, d = x.shape
        if self.split(n_loc)[0] != n_loc:
            raise NotImplementedError("the means cache takes the even "
                                      "split only")
        z = segment_means_op(x.contiguous(), L=L,
                             backend=self.backend)           # (B·P, L, D)
        if self.group is not None:          # the rank's means, gathered
            return self._gather(z).transpose(0, 1).reshape(bp, self.P * L, d)
        return z.reshape(bp // self.P, self.P * L, d)

    def _augment_prism(self, x, s, n, row_pos):
        """PRISM and duplicate, or prism_nodup: the same columns, g = 1
        on the other shards' means."""
        n_loc = x.shape[1]
        L = self.cfg.landmarks(n)          # Eq. 16 over the real length
        if self.group is not None:
            # the means kernel, the exchange, then the concat
            x_hat = torch.cat([x, self.gather_means(x, L)], dim=1)
        else:
            # one launch: (B·P, n_loc + P·L, D), the local block first
            x_hat = prism_augment_op(x, L=L, n_shards=self.P, n_real=s,
                                     backend=self.backend)
        cols = means_columns(self.P, s, L, x.device, n_loc)
        g = self._local(cols.col_g)
        if self.cfg.mode == "prism_nodup":
            g = (g > 0).float()
        # g = 0 columns need no mask entry: log g = -1e30 already removes
        # them, so (col_lo, col_hi) alone reproduce the Eq. 17 mask
        return x, AugmentedKV(x_hat, g, None, row_pos,
                              self._local(cols.col_pos),
                              col_lo=self._local(cols.col_lo),
                              col_hi=self._local(cols.col_hi))

    def expert_groups(self, x):
        """x (B·P, n_loc, D) -> (P, B·n_loc, D): shard p's tokens of every
        sequence, sequence-major (the order of the reference's per-device
        (B, n_loc) block), and the inverse; on a mesh the rank's own
        (1, B·n_loc, D)."""
        bp, n_loc, d = x.shape
        if self.split(n_loc)[0] != n_loc:    # pad rows would take capacity
            raise NotImplementedError("expert routing groups take the "
                                      "even split only")
        if self.group is not None:
            return SeqContext.expert_groups(self, x)
        b = bp // self.P
        xg = x.view(b, self.P, n_loc, d).transpose(0, 1).reshape(
            self.P, b * n_loc, d)
        return xg, lambda y: y.view(self.P, b, n_loc, d).transpose(
            0, 1).reshape(bp, n_loc, d)

    def expert_exchange(self, buf):
        """(G, E, cap, D) -> (E, G·cap, D) folded; on a mesh the rank's
        (1, E, cap, D) -> (E_local, M·cap, D) by the tiled all_to_all
        over ``model``, the senders' slots model-rank-major (the fold's
        group order on the (1, P) mesh), and back."""
        if self.experts is None:
            return SeqContext.expert_exchange(self, buf)
        return expert_all_to_all(buf, self.experts)

    def last_shard(self, x):
        """Value held by the shard owning the END of the sequence:
        x (B·P, ...) -> (B, ...); on a mesh the last rank's, on every
        rank."""
        if self.group is not None:
            return comm.last_shard(x, self.group, "combine")
        return x.reshape(-1, self.P, *x.shape[1:])[:, self.P - 1]

    def _even_only(self, what: str) -> None:
        """Raise for Alg. 1's uneven split: a recurrent layer's state
        would run through the pad rows."""
        if self.n is not None and self.n % self.P:
            raise NotImplementedError(
                f"{what} takes the even split only (N={self.n} over "
                f"P={self.P} shards)")

    def state_handoff(self, log_a_tot, u_tot):
        """The state entering each shard: log_a_tot (B·P, H) and u_tot
        (B·P, H, dk, dv), each shard's span totals -> (B·P, H, dk, dv),
        the exclusive prefix S <- exp(log a_p)·S + u_p over the shards of
        each sequence, zeros for shard 0.  On a mesh every rank's totals
        are gathered, the same scan runs, and the rank keeps its own
        prefix (B, H, dk, dv)."""
        self._even_only("the recurrent state handoff")
        if self.group is not None:
            la = self._gather(log_a_tot).transpose(0, 1)    # (B, P, H)
            u = self._gather(u_tot).transpose(0, 1)
        else:
            la = log_a_tot.reshape(-1, self.P, *log_a_tot.shape[1:])
            u = u_tot.reshape(-1, self.P, *u_tot.shape[1:])
        s, prefix = torch.zeros_like(u[:, 0]), []
        for p in range(self.P):
            prefix.append(s)
            s = la[:, p].exp()[..., None, None] * s + u[:, p]
        prefix = torch.stack(prefix, dim=1)
        if self.group is not None:
            # indexed out of every prefix, so that the gathers' backward
            # runs on every rank (rank 0's own prefix reads none of them)
            return prefix[:, self.group.index]
        return prefix.reshape(u_tot.shape)

    def prev_tail(self, x, size: int):
        """x (B·P, n_loc, C) -> (B·P, size, C): shard p's halo is the last
        ``size`` rows of shard p - 1 of its sequence, zeros for shard 0
        (the reference's ``ppermute`` to the next shard)."""
        self._even_only("prev_tail")
        bp, n_loc = x.shape[:2]
        if self.group is not None:
            return comm.ppermute(x[:, n_loc - size:], self.group,
                                 "exchange", shift=1)
        xs = x.reshape(bp // self.P, self.P, n_loc, *x.shape[2:])
        tail = xs[:, :self.P - 1, n_loc - size:]
        return torch.cat([torch.zeros_like(xs[:, :1, :size]), tail],
                         dim=1).reshape(bp, size, *x.shape[2:])

    def gather_sequence(self, x):
        """x (B·P, n_loc, D) -> the whole sequences (B, P·n_loc, D); on a
        mesh every rank's rows, gathered."""
        self._even_only("gather_sequence")
        bp, n_loc = x.shape[:2]
        if self.group is not None:
            return self._gather(x).transpose(0, 1).reshape(
                bp, self.P * n_loc, *x.shape[2:])
        return x.reshape(bp // self.P, self.P * n_loc, *x.shape[2:])

    def take_local(self, y_full):
        """y_full (B, N, D) -> each shard's rows (B·P, N / P, D); on a
        mesh the rank's own."""
        self._even_only("take_local")
        if self.group is not None:
            n_loc = y_full.shape[1] // self.P
            return y_full[:, self.group.index * n_loc:][:, :n_loc]
        b, n = y_full.shape[:2]
        return y_full.reshape(b * self.P, n // self.P, *y_full.shape[2:])


def expert_all_to_all(buf, grp):
    """A rank's dispatch buffer (1, E, cap, D) -> (E / M, M·cap, D) over
    the ``model`` group ``grp`` of M ranks (the reference's tiled
    ``all_to_all`` with split_axis 0, concat_axis 1): each rank keeps its
    own E / M experts, with every sender's slots in sender order; and
    the inverse for the outputs, -> (1, E, cap, D)."""
    out = comm.all_to_all(buf[0], grp, "expert", split_dim=0, concat_dim=1)
    return out, lambda y: comm.all_to_all(y, grp, "expert", split_dim=1,
                                          concat_dim=0)[None]
