"""Segment-Means standby replicas: the redundancy behind serving on a
degraded mesh (the ``shard_loss`` fault, ``runtime/faults.py``).

Each sequence shard's Segment-Means summary (kz/vz and the repeat counts
gz) is CR times smaller than its exact K/V, so a standby copy of every
live request's per-shard means costs little.  When a shard is lost in
the middle of decoding, the degraded step (``serve_step(lost=...)``)
masks the shard's exact columns out of the shard combine and serves its
positions by the replicated means through the ``+log g`` bias: requests
keep emitting finite tokens at PRISM's quality instead of failing.

One ``MeansReplica`` per engine, armed only when a ``shard_loss`` fault
can fire (paged cache only).  It rides the engine's tick:

  * **capture**: on a slot's first decode tick (and on a bounded
    refresh schedule) the slot's standby is made.  In prism decode mode
    the state row (kz/vz/gz) is copied.  In exact mode no means exist
    yet, so the replica CUTS them from the slot's pages: per shard, the
    filled local K/V columns split into ``L`` contiguous segments
    (``_seg_counts``), their means the standby kz/vz and the real-token
    counts gz, on the shard-major ``P·L`` column grid the prism cache
    uses.  The reference copies the slot's pages to the host and cuts
    there; here the cut runs on the device (one page gather and two
    matrix products a layer) and the standby stays there, so a capture
    moves no bytes to the host.
  * **staleness**: a capture covers the positions written before it;
    positions decoded after it are in no replica column and are lost
    with the shard (``staleness(slot) = written - covered``), bounded by
    the refresh schedule.
  * **assemble**: the degraded exact step's input, one {"kz", "vz",
    "gz"} dict a layer over every slot (gz = 0, dead columns, for a slot
    without a standby), built once per change of the replica set.

A replica never captures during a degraded window: the lost shard's
memory is what the fault declared unreadable.  Recovery (every active
slot prefilled again) drops every replica; captures resume on the
rebuilt K/V.  A copy of the reference's ``runtime/replica.py``.

Over a mesh of ranks (``seq``: the layout's sequence group), where the
reference lets a shard's own device lanes stand in for the neighbour
that would host its standby, the port ships it there: in exact mode
each rank cuts its own shard's L means columns of the slot (every rank
captures the same slot at the same tick) and sends them to its ring
neighbour (s + 1) mod P with one ``comm.ppermute`` over the group, class
``replica``; the rank hosts its lower neighbour's.  When shard s is
lost its neighbour's copy goes back to rank s once (``comm.pass_to``),
and rank s serves it on its lane, so the degraded step's arithmetic is
the fold's and the lost rank's own K/V is never read.  The counts are
the cut's, reckoned on every rank from the layout.  Prism mode moves no
bytes: every rank holds the whole state pool, whose means are the
standby.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.segment_means import segment_sizes
from ..sharding import comm


def _seg_counts(k: int, L: int) -> np.ndarray:
    """Real tokens a segment for ``k`` filled columns over an
    ``L``-segment grid: the paper's split (Eq. 8) when ``k >= L``; one
    token a leading segment (the trailing ones dead, gz = 0) when the
    slot holds fewer columns than segments."""
    if k <= 0:
        return np.zeros(L, np.int64)
    if k < L:
        sizes = np.zeros(L, np.int64)
        sizes[:k] = 1
        return sizes
    return segment_sizes(k, L)


def _filled_local_cols(lay, shard: int, covered: int) -> int:
    """How many LOCAL cache columns of ``shard`` hold real positions once
    [0, covered) are written, under the layout's placement."""
    if covered <= 0:
        return 0
    if lay.placement == "rr":
        # position p -> shard p % n_seq, local column p // n_seq
        return ((covered - shard + lay.n_seq - 1) // lay.n_seq
                if covered > shard else 0)
    # aligned: prefill block [s·n_loc0, (s+1)·n_loc0), then round-robin
    n0, n_loc0 = lay.prefill_len, lay.n_loc0
    pre = int(np.clip(covered - shard * n_loc0, 0, n_loc0))
    extra = covered - n0
    dec = ((extra - shard + lay.n_seq - 1) // lay.n_seq
           if extra > shard else 0)
    return pre + max(0, dec)


def _local_positions(lay, shard: int, n_cols: int) -> np.ndarray:
    """Global position of each local column [0, n_cols) of ``shard`` (the
    inverse of ``runtime.serve._decode_cols``'s column map)."""
    j = np.arange(n_cols)
    if lay.placement == "rr":
        return j * lay.n_seq + shard
    n0, n_loc0 = lay.prefill_len, lay.n_loc0
    return np.where(j < n_loc0, shard * n_loc0 + j,
                    n0 + (j - n_loc0) * lay.n_seq + shard)


def cut_weights(lay, covered: int, n_cols: int) -> tuple:
    """The exact-mode cut as a 0/1 matrix: ``(w (P·L, P·n_cols) f32,
    counts (P·L,) f32)``.  Column ``s·L + c`` of the grid sums the local
    columns of shard ``s``'s segment ``c`` (of the first filled ones,
    split by ``_seg_counts``); its count is the segment's size (0 for a
    dead column).  Local column ``j`` of shard ``s`` is row ``s·n_cols +
    j`` of the slot's K/V laid shard-major."""
    L, P = lay.L, lay.n_seq
    w = np.zeros((P * L, P * n_cols), np.float32)
    counts = np.zeros(P * L, np.float32)
    for s in range(P):
        filled = min(_filled_local_cols(lay, s, covered), n_cols)
        start = 0
        for c, n in enumerate(_seg_counts(filled, L)):
            if n <= 0:
                continue
            w[s * L + c, s * n_cols + start:s * n_cols + start + n] = 1.0
            counts[s * L + c] = n
            start += int(n)
    return w, counts


@dataclass
class _SlotReplica:
    """One slot's standby: per-layer means and their freshness."""
    rid: int
    epoch: int
    covered: int                       # positions the capture covers
    tick: int                          # engine tick of the capture
    layers: list = field(default_factory=list)   # per layer {kz, vz, gz}
    nbytes: int = 0
    # on a mesh (exact mode): the hosted copy of the lower neighbour's
    # columns, (layers, 2, L, Hkv, hd) kz and vz; ``layers`` then holds
    # the counts of every shard alone
    hosted: object = None


class MeansReplica:
    """Standby replica of every live slot's per-shard Segment-Means state
    (see the module docstring), kept on the cache's device."""

    def __init__(self, cfg, lay, hp, paging, n_slots: int,
                 refresh_every: int = 16, seq=None):
        self.cfg, self.lay, self.hp = cfg, lay, hp
        #: the layout's sequence group on a mesh (None folded)
        self.seq = seq
        self.paging = paging
        self.n_slots = int(n_slots)
        self.refresh_every = max(1, int(refresh_every))
        self.m = lay.n_seq * lay.L
        #: shard of each replica column (shard-major, the grid of
        #: ``sharding.context.means_columns``)
        self.shard_of = np.repeat(np.arange(lay.n_seq), lay.L)
        self._slots: dict[int, _SlotReplica] = {}
        self._assembled = None
        self._assembled_for = ()       # the lost shards it was built for
        self.captures = 0
        self.refreshes = 0
        self.returned = 0              # slot standbys sent back at losses

    # -- capture -----------------------------------------------------------
    def has(self, slot: int, st) -> bool:
        rep = self._slots.get(slot)
        return (rep is not None and rep.rid == st.req.rid
                and rep.epoch == st.epoch)

    def staleness(self, slot: int, st) -> int:
        """Positions written since the capture (lost with the shard)."""
        if not self.has(slot, st):
            return 1 << 30
        return max(0, (st.pos + 1) - self._slots[slot].covered)

    def tick(self, kv, states, tick_no: int) -> int:
        """The per-tick piggyback: capture every decoding slot without a
        current replica, plus AT MOST ONE refresh (the stalest slot past
        ``refresh_every``), so the cost stays O(1) a tick at steady
        state.  Returns the captures made."""
        made = 0
        stalest, worst = None, 0
        for st in states:
            if not self.has(st.slot, st):
                self.capture(kv, st, tick_no)
                made += 1
            else:
                s = self.staleness(st.slot, st)
                if s >= self.refresh_every and s > worst:
                    stalest, worst = st, s
        if stalest is not None:
            self.capture(kv, stalest, tick_no)
            self.refreshes += 1
            made += 1
        return made

    def capture(self, kv, st, tick_no: int = 0) -> None:
        """Cut or copy ``st``'s standby means.  ``covered = st.pos + 1``:
        every position a decoding slot has fed is written (the rewind's
        rewrite included)."""
        slot = st.slot
        covered = int(st.pos) + 1
        if kv.storage is None:         # bookkeeping only
            return
        hosted = None
        if self.hp.decode_mode == "prism":
            layers = self._copy_state(kv, slot)
        elif self.seq is not None:
            layers, hosted = self._cut_and_ship(kv, slot, covered)
        else:
            layers = self._cut_means(kv, slot, covered)
        nbytes = (int(sum(t.nbytes for d in layers for t in d.values()))
                  if hosted is None else hosted.nbytes)
        self._slots[slot] = _SlotReplica(
            rid=st.req.rid, epoch=st.epoch, covered=covered,
            tick=int(tick_no), layers=layers, nbytes=nbytes, hosted=hosted)
        self.captures += 1
        self._assembled = None

    def _copy_state(self, kv, slot: int) -> list:
        """Prism: the state row already holds the means; copy it."""
        row = kv.slot_state[slot]
        return [{k: c[k][row].clone() for k in ("kz", "vz", "gz")}
                for c in kv.storage]

    def _cut_means(self, kv, slot: int, covered: int) -> list:
        """Exact mode: the shard-major Segment-Means of the slot's roped
        K/V pages over the shards the cache holds (all P folded, the
        rank's own on a mesh), on the device: per layer one gather of the
        slot's pages a leaf, laid shard-major, and one product with the
        held shards' block of the cut's 0/1 matrix (``cut_weights``),
        then a division by the counts.  gz is every shard's counts."""
        pages = kv.slot_pages[slot]
        pc, L = self.paging.page_cols, self.lay.L
        first, held = ((0, self.lay.n_seq) if self.seq is None
                       else (self.seq.index, 1))
        n_cols = len(pages) * pc
        dev = kv.storage[0]["k"].device
        w, counts = cut_weights(self.lay, covered, n_cols)
        rows = slice(first * L, (first + held) * L)
        w = torch.as_tensor(w[rows, first * n_cols:(first + held) * n_cols],
                            device=dev)
        cnt = torch.as_tensor(counts, device=dev)
        idx = torch.as_tensor(pages, dtype=torch.long, device=dev)
        div = torch.clamp(cnt[rows], min=1.0)[:, None]
        out = []
        for c in kv.storage:
            d = {}
            for name, key in (("k", "kz"), ("v", "vz")):
                x = c[name].index_select(0, idx)  # (n_pg, held, pc, H, hd)
                hkv, hd = x.shape[-2:]
                x = x.transpose(0, 1).reshape(held * n_cols, hkv * hd)
                d[key] = ((w @ x) / div).view(held * L, hkv, hd)
            d["gz"] = cnt.clone()
            out.append(d)
        return out

    def _cut_and_ship(self, kv, slot: int, covered: int) -> tuple:
        """Exact mode on a mesh: the rank's own shard's L columns of the
        cut (``_cut_means``), sent to the ring neighbour; returns (every
        shard's counts a layer, the lower neighbour's columns hosted
        here)."""
        own = self._cut_means(kv, slot, covered)
        hosted = comm.ppermute(
            torch.stack([torch.stack((d["kz"], d["vz"])) for d in own]),
            self.seq, "replica", shift=1, ring=True)
        return [{"gz": d["gz"]} for d in own], hosted

    # -- drop --------------------------------------------------------------
    def drop(self, slot: int) -> None:
        if self._slots.pop(slot, None) is not None:
            self._assembled = None

    def drop_all(self) -> None:
        if self._slots:
            self._assembled = None
        self._slots.clear()

    # -- the degraded exact step's input -----------------------------------
    def lost_mask(self, lost) -> np.ndarray:
        """(n_seq,) f32 mask the degraded step takes: 1.0 marks an
        unreadable shard."""
        m = np.zeros(self.lay.n_seq, np.float32)
        for s in lost:
            m[int(s) % self.lay.n_seq] = 1.0
        return m

    def assemble(self, device, lost=()) -> list:
        """One {"kz" (B, m, Hkv, hd), "vz", "gz" (B, m)} dict a layer, zero
        rows (gz = 0, dead columns) for slots with no standby.  Built
        once per change of the replica set, then reused.  On a mesh the
        ``lost`` shards' columns come back from their neighbours
        (``_return``); every other column is zero there, which the
        degraded step serves on no lane."""
        shards = (tuple(sorted({int(s) % self.lay.n_seq for s in lost}))
                  if self.seq is not None else ())
        if self._assembled is not None and self._assembled_for == shards:
            return self._assembled
        cfg, b, m = self.cfg, self.n_slots, self.m
        hkv, hd = cfg.n_kv_heads, cfg.hd
        out = []
        for i in range(cfg.n_layers):
            d = {"kz": torch.zeros((b, m, hkv, hd), device=device),
                 "vz": torch.zeros((b, m, hkv, hd), device=device),
                 "gz": torch.zeros((b, m), device=device)}
            for slot, rep in self._slots.items():
                for key in d:
                    if key in rep.layers[i]:
                        d[key][slot].copy_(rep.layers[i][key])
            out.append(d)
        for shard in shards:
            self._return(out, shard)
        self._assembled, self._assembled_for = out, shards
        return out

    def _return(self, out: list, shard: int) -> None:
        """A mesh's exact standby of ``shard``, sent back from the rank
        that hosts it, (shard + 1) mod P, to the shard's rank: one
        ``pass_to`` of every slot's copy, written into its columns."""
        slots = sorted(self._slots)
        if not slots:
            return
        grp, L = self.seq, self.lay.L
        host = (shard + 1) % grp.size
        copies = torch.stack([self._slots[s].hosted for s in slots])
        got = comm.pass_to(copies, grp, "replica", src=host, dst=shard)
        if grp.index == host and host != shard:
            self.returned += len(slots)
        if got is None:
            return
        cols = slice(shard * L, (shard + 1) * L)
        for j, slot in enumerate(slots):
            for i, d in enumerate(out):
                d["kz"][slot, cols] = got[j, i, 0]
                d["vz"][slot, cols] = got[j, i, 1]

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        return {"slots": len(self._slots),
                "captures": self.captures,
                "refreshes": self.refreshes,
                "returned": self.returned,
                "bytes": int(sum(r.nbytes for r in self._slots.values())),
                "covered": {s: r.covered
                            for s, r in sorted(self._slots.items())}}
