"""Host-memory KV offload tier.

A :class:`KVStore` holds the spilled cache footprint of preempted (or
suspended) requests: the content of every pool page a slot held plus,
in prism mode, the request's Segment-Means state row (``kz/vz/gz/
zsum``).  Spilling is one gather and one device->host copy per leaf
(``KVCache.spill``); restoring goes back through the page-aware
admission path (``plan_restore`` -> ``reserve`` -> ``bind`` ->
``KVCache.restore``), so a restore is an admission whose covered-token
count comes from the store instead of the prefix cache.

The store is a plain LRU keyed by request id.  Capacity is optional and
counted in bytes; when the payload is None (a ``KVCache`` built with
``storage=None``, as the bookkeeping tests build it) the page count
stands in for bytes.  Entries that do not fit are dropped: a caller
treats a missing entry as host-memory pressure and falls back to a
re-prefill (``ServingEngine._restore_gate``), never as an error that
could touch a neighbour slot.

A copy of the reference's ``runtime/offload.py``; only ``_tree_bytes``
differs, as the payload here is nested lists and dicts of tensors.  On a
mesh of ranks each rank's store holds the rank's shard of a payload, and
``put`` takes the whole payload's byte count from the caller
(``KVCache.spill``), so that capacity, LRU evictions and ``stats()`` are
the reference's, whose ``_tree_bytes`` counts the global array, and the
same on every rank.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any


def _tree_bytes(payload) -> int:
    """Total bytes of the tensors (or numpy arrays) in a payload of
    nested lists, tuples and dicts."""
    if isinstance(payload, dict):
        return sum(_tree_bytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(_tree_bytes(v) for v in payload)
    if hasattr(payload, "nbytes"):
        return int(payload.nbytes)
    return 0


@dataclass
class SpilledEntry:
    """One preempted request's cache footprint, resident on the host.

    ``payload`` mirrors the cache storage (one dict of leaves per
    layer) but holds only this request's slice: its pages gathered
    along the page axis and, in prism mode, its state row.
    ``payload is None`` in host-only bookkeeping mode (no device
    storage attached to the KVCache).
    """

    key: Any
    n_pages: int
    tokens: int            # covered-token count for the restore plan
    payload: Any
    nbytes: int


class KVStore:
    """LRU host store for spilled KV pages + prism state.

    ``capacity_bytes=None`` means unbounded.  ``capacity_bytes=0`` drops
    every put — the fault-injection configuration the restore-failure
    tests use to simulate total host-memory pressure.
    """

    def __init__(self, capacity_bytes: int | None = None, *,
                 injector=None):
        self.capacity_bytes = capacity_bytes
        self._entries: OrderedDict[Any, SpilledEntry] = OrderedDict()
        self.bytes_used = 0
        self.puts = 0
        self.drops = 0          # puts rejected (entry > capacity / fault)
        self.evictions = 0      # LRU entries pushed out by later puts
        self.hits = 0           # pops that found their entry
        self.misses = 0         # pops/peeks that did not
        self.get_retries = 0    # transient read losses retried away
        # seeded chaos hook (runtime/faults.py): a fired
        # ``store_put_loss`` drops the put, a fired ``store_get_loss``
        # loses an existing entry at read time — both surface to the
        # engine as ordinary restore misses
        self._injector = injector

    def _lost(self, kind: str) -> bool:
        return self._injector is not None and self._injector.fire(kind)

    # -- write side ----------------------------------------------------
    def put(self, key, n_pages: int, payload, *, tokens: int = 0,
            nbytes: int | None = None) -> bool:
        """Store a spilled entry; returns False when it was dropped.
        ``nbytes``: the payload's bytes where they are not its tensors'
        (a mesh rank's shard of it); by default counted from them, or the
        page count without a payload."""
        if nbytes is None:
            nbytes = (_tree_bytes(payload) if payload is not None
                      else int(n_pages))
        if key in self._entries:
            self.drop(key)
        self.puts += 1
        if self._lost("store_put_loss"):
            self.drops += 1
            return False
        if self.capacity_bytes is not None and nbytes > self.capacity_bytes:
            self.drops += 1
            return False
        self._entries[key] = SpilledEntry(key=key, n_pages=int(n_pages),
                                          tokens=int(tokens),
                                          payload=payload, nbytes=nbytes)
        self.bytes_used += nbytes
        while (self.capacity_bytes is not None
               and self.bytes_used > self.capacity_bytes):
            _, old = self._entries.popitem(last=False)   # LRU first
            self.bytes_used -= old.nbytes
            self.evictions += 1
        return True

    # -- read side -----------------------------------------------------
    def peek(self, key) -> SpilledEntry | None:
        """Look up without removing (used by ``plan_restore``)."""
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        if self._lost("store_get_loss"):
            self.drop(key)              # torn at read time: entry gone
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        return ent

    def pop(self, key) -> SpilledEntry | None:
        """Remove and return the entry, or None if it was lost."""
        ent = self._entries.pop(key, None)
        if ent is None:
            self.misses += 1
            return None
        if self._lost("store_get_loss"):
            self.bytes_used -= ent.nbytes
            self.misses += 1
            return None
        self.bytes_used -= ent.nbytes
        self.hits += 1
        return ent

    def get(self, key, *, retries: int = 0, backoff_s: float = 0.0,
            consume: bool = False) -> SpilledEntry | None:
        """Bounded retry-with-backoff read — the restore path's front
        door.  An injected ``store_get_loss`` models a TRANSIENT torn
        read, not necessarily permanent loss, so a loss on a non-final
        attempt RETAINS the entry and tries again (each attempt draws
        its own injector opportunity; ``backoff_s`` > 0 sleeps
        ``backoff_s * 2**attempt`` between attempts — the engine passes
        0 under logical clocks).  A loss on the final attempt keeps the
        old torn-read semantics: the entry is dropped and the caller
        downgrades to re-prefill.  ``retries=0`` is exactly ``peek``
        (or ``pop`` with ``consume=True``)."""
        for attempt in range(retries + 1):
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            if not self._lost("store_get_loss"):
                if consume:
                    self._entries.pop(key)
                    self.bytes_used -= ent.nbytes
                    self.hits += 1
                else:
                    self._entries.move_to_end(key)
                return ent
            if attempt < retries:
                self.get_retries += 1
                if backoff_s > 0.0:
                    time.sleep(backoff_s * (2 ** attempt))
        self.drop(key)                  # torn on the last attempt: gone
        self.misses += 1
        return None

    def drop(self, key) -> None:
        """Silently discard an entry (cancelled request, fault inject)."""
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.bytes_used -= ent.nbytes

    # -- snapshot / restore --------------------------------------------
    def entries(self) -> list:
        """The live entries in LRU order (oldest first) — what an
        engine snapshot journals.  The SpilledEntry objects are shared,
        not copied; callers that persist them must deepcopy."""
        return list(self._entries.values())

    def adopt(self, entries) -> None:
        """Re-insert journalled entries verbatim (engine restore).
        Bypasses the counters AND the fault injector: restoring a
        snapshot replays state, it is not a new injection
        opportunity."""
        for ent in entries:
            old = self._entries.pop(ent.key, None)
            if old is not None:
                self.bytes_used -= old.nbytes
            self._entries[ent.key] = ent
            self.bytes_used += ent.nbytes

    # -- introspection -------------------------------------------------
    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"entries": len(self._entries),
                "bytes_used": self.bytes_used,
                "capacity_bytes": self.capacity_bytes,
                "puts": self.puts, "drops": self.drops,
                "evictions": self.evictions,
                "hits": self.hits, "misses": self.misses,
                "get_retries": self.get_retries}
