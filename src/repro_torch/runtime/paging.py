"""Paged KV cache: the host-side page table, prefix reuse and the
``KVCache`` lifecycle object.

A page is a gang of ``page_cols`` cache columns on EVERY sequence shard,
so one page id names the same position span on all shards.  The device
pool of a layer is (n_pages, P, page_cols, Hkv, hd) (``runtime.serve.
layer_cache_shape``); a request's cache "row" is a page list: logical
page ``j`` of its ``cap_l``-column row is physical page ``pages[j]``.
The step programs take the per-slot page map (n_slots, pages_per_row)
each tick and write and read through it; the decode kernel reads the
pool in place through it (its page table).

  * ``PageTable``: free list and per-page refcounts; O(1) alloc/free,
    all-or-nothing; pure bookkeeping.
  * ``PrefixCache``: a finished request registers its prompt's full
    pages under their token prefix; a new request whose prompt starts
    with a registered prefix maps those pages (refcount + 1) and skips
    prefilling the tokens they hold.  Shared pages are never written:
    writes land past the covered prefix, in private pages.
  * In prism decode mode the Segment-Means state (kz, vz, gz, zsum) has
    a state pool of its own, one row per active request, addressed
    through the per-slot state map.

``KVCache`` wraps both cache layouts: ``paging=None`` is the dense
rowset (the ``paged=False`` oracle), ``paging=PagedLayout(...)`` the
pools with the ``plan -> reserve -> bind -> free`` lifecycle the engine
drives.  Page ids follow the reference's allocation order (the free
list pops from its end), so both hand out the same ids.

On a mesh of ranks every rank holds the same host bookkeeping (page
table, prefix cache, maps) over its own device storage: the rank's
sequence shard of every page (the prism state rows whole), or its block
of the dense rows from ``first_row`` on.  The copies, fills, zeroings
and the moves to and from the host (``spill``, ``restore``,
``extract_slot``, ``inject_slot``) act on that storage alone: a rank's
payload is its shard of the slot's pages and the whole state row, and
the store counts the whole payload's bytes (``payload_bytes``), as the
reference's does.

The host offload tier, fault injection and snapshots move a slot's
content: ``spill`` / ``restore`` and ``extract_slot`` / ``inject_slot``
gather a slot's pages and state row to the host and scatter them back
into other pages; ``poison_page`` and ``scrub_slot`` fill a page with
NaN and zero a slot; ``ensure_writable`` forks shared pages before a
write.  These are plain tensor indexing and copies, as the reference's
are plain jnp outside any kernel.

The bookkeeping is host-side, as the reference's is; the device
storage is a list of per-layer dicts of tensors built by
``runtime.serve.make_kv_cache`` (``storage=None`` keeps the bookkeeping
alone).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

#: page id meaning "no page mapped" in the device page maps
NO_PAGE = -1
#: the pool leaves (page axis first) and the prism state leaves (state
#: row axis first) of a layer's storage
KV_LEAVES = ("k", "v")
STATE_LEAVES = ("kz", "vz", "gz", "zsum")


@dataclass(frozen=True)
class PagedLayout:
    """Static shape of the paged pool, derived once per engine.

    A page holds ``page_cols`` per-shard columns on every sequence
    shard: ``span = page_cols * n_seq`` consecutive positions under the
    round-robin placement (exact mode).  Paged prism keeps the
    prefill-aligned column map, where a page still holds ``page_cols``
    columns a shard but a partial page set covers no position prefix,
    so prefixes are not shared there."""
    page_cols: int                    # per-shard columns per page
    n_seq: int                        # sequence shards (gang width)
    pages_per_row: int                # logical pages per request
    n_pages: int                      # physical pages in the pool
    n_state_pages: int = 0            # prism means-state pool rows

    @property
    def span(self) -> int:            # tokens covered per page
        return self.page_cols * self.n_seq


def make_paged_layout(lay, *, page_tokens: int, n_pages: int | None,
                      n_slots: int, n_state_pages: int | None = None
                      ) -> PagedLayout:
    """The pool's shape from a ``ServeLayout``.  ``page_tokens`` is the
    page size in positions: a multiple of the shard count whose
    per-shard ``page_cols`` divides both the prefill region and the
    row, so a row and its prefill region are whole pages."""
    if page_tokens % lay.n_seq:
        raise ValueError(
            f"page_tokens {page_tokens} not a multiple of the "
            f"sequence-shard count {lay.n_seq}")
    pc = page_tokens // lay.n_seq
    if lay.n_loc0 % pc or lay.cap_l % pc:
        raise ValueError(
            f"page_cols {pc} must divide the per-shard prefill region "
            f"{lay.n_loc0} and capacity {lay.cap_l}")
    ppr = lay.cap_l // pc
    if n_pages is None:
        n_pages = n_slots * ppr       # memory parity with the dense rows
    if n_state_pages is None:
        n_state_pages = n_slots
    return PagedLayout(page_cols=pc, n_seq=lay.n_seq, pages_per_row=ppr,
                       n_pages=int(n_pages),
                       n_state_pages=int(n_state_pages))


class PageTable:
    """Free-list page allocator with per-page refcounts.  A page is on
    the free list (refcount 0) or held by one or more holders (a
    request's page list, a prefix entry), each holding one reference."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages {n_pages} < 1")
        self.n_pages = n_pages
        self.refs = np.zeros(n_pages, np.int32)
        self._free: list = list(range(n_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> list | None:
        """``n`` fresh pages (refcount 1 each), or None if the free list
        cannot cover them: never a partial grant."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.refs[pages] += 1
        return pages

    def share(self, pages) -> None:
        """One more reference to each (allocated) page: a shared prefix
        mapped into a new request."""
        pages = list(pages)
        if np.any(self.refs[pages] <= 0):
            raise ValueError(f"share of unallocated page in {pages}")
        self.refs[pages] += 1

    def free(self, pages) -> None:
        """Drop one reference per page; a page at refcount 0 goes back on
        the free list."""
        for p in pages:
            if self.refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)

    def check(self) -> None:
        """Refcounts non-negative; the free list is exactly the pages at
        refcount 0, without duplicates."""
        free = sorted(self._free)
        assert len(set(free)) == len(free), "duplicate free-list entry"
        zero = sorted(np.nonzero(self.refs == 0)[0].tolist())
        assert free == zero, (free, zero)
        assert np.all(self.refs >= 0)


@dataclass
class _PrefixEntry:
    key: tuple
    pages: tuple                       # physical ids, one per full span
    tokens: int                        # positions covered (len(pages)·span)
    last_used: int = 0


class PrefixCache:
    """Token prefix -> shared page prefix.  A finished request registers
    one entry per full-page prefix level of its prompt (each entry holds
    a reference to its pages, so they outlive the request); a lookup
    takes the longest level; ``reclaim`` drops least recently used
    entries when admission runs out of pages: a cache, never a
    reservation."""

    def __init__(self, table: PageTable):
        self.table = table
        self.entries: dict = {}        # key -> _PrefixEntry
        self.hits = 0
        self.misses = 0
        self._tick = 0

    @staticmethod
    def _key(prompt, n_tokens: int) -> tuple:
        return tuple(prompt[:n_tokens])

    def register(self, prompt, pages, span: int) -> int:
        """Register every full-page prefix level of ``prompt`` whose pages
        hold prompt tokens only.  Returns the entries added."""
        k_reg = min(len(prompt) // span, len(pages))
        added = 0
        for k in range(1, k_reg + 1):
            key = self._key(prompt, k * span)
            ent = self.entries.get(key)
            self._tick += 1
            if ent is not None:
                ent.last_used = self._tick
                continue
            share = list(pages[:k])
            self.table.share(share)
            self.entries[key] = _PrefixEntry(
                key=key, pages=tuple(share), tokens=k * span,
                last_used=self._tick)
            added += 1
        return added

    def lookup(self, prompt, span: int) -> _PrefixEntry | None:
        """The longest registered full-page prefix STRICTLY shorter than
        the prompt: the rewind re-feeds the last prompt token, so the page
        holding position ``len(prompt) - 1`` stays private."""
        for k in range((len(prompt) - 1) // span, 0, -1):
            ent = self.entries.get(self._key(prompt, k * span))
            if ent is not None:
                self._tick += 1
                ent.last_used = self._tick
                self.hits += 1
                return ent
        self.misses += 1
        return None

    def reclaim(self, need_free: int) -> int:
        """Drop least recently used entries until the free list holds
        ``need_free`` pages or the cache is empty.  Returns entries
        dropped."""
        dropped = 0
        while self.table.free_pages < need_free and self.entries:
            key = min(self.entries, key=lambda k: self.entries[k].last_used)
            self.table.free(list(self.entries.pop(key).pages))
            dropped += 1
        return dropped

    def clear(self) -> None:
        for ent in self.entries.values():
            self.table.free(list(ent.pages))
        self.entries.clear()


@dataclass
class AdmitPlan:
    """What admitting one request takes and reuses."""
    total_pages: int                   # logical pages the request needs
    fresh_pages: int                   # pages off the free list
    shared: tuple = ()                 # prefix pages mapped shared
    covered: int = 0                   # prompt tokens already cached


@dataclass
class KVCache:
    """One cache object, one lifecycle: ``plan -> reserve -> bind ->
    free``.  ``storage`` is the per-layer list of device leaves (dense
    rows, or the pools); in paged mode the object also holds the
    ``PageTable``, the optional ``PrefixCache`` and the per-slot page
    lists and state rows."""
    storage: list                      # per layer: {leaf: tensor}
    layout: object                     # ServeLayout
    paging: PagedLayout | None = None
    table: PageTable | None = None
    prefix: PrefixCache | None = None
    slot_pages: dict = field(default_factory=dict)   # slot -> [page ids]
    slot_state: dict = field(default_factory=dict)   # slot -> state row
    _state_free: list = field(default_factory=list)
    _reserved: dict = field(default_factory=dict)    # key -> (pages, srow)
    cow_copies: int = 0                # pages forked private on write
    first_row: int = 0                 # a mesh rank's first dense row

    def __post_init__(self):
        if self.paging is not None:
            if self.table is None:
                self.table = PageTable(self.paging.n_pages)
            self._state_free = list(range(self.paging.n_state_pages))

    @property
    def paged(self) -> bool:
        return self.paging is not None

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.paging.span)

    def plan(self, prompt, max_new_tokens: int, use_prefix: bool = True,
             full_row: bool = False) -> AdmitPlan:
        """The pages ``prompt`` plus its generation take, after prefix
        reuse; commits nothing.  ``full_row`` takes the whole logical row
        (paged prism: the means state is defined over the whole prefill
        region, so rows are never partial and prefixes never shared)."""
        total = (self.paging.pages_per_row if full_row
                 else self.pages_needed(len(prompt) + max_new_tokens))
        shared, covered = (), 0
        if use_prefix and not full_row and self.prefix is not None:
            ent = self.prefix.lookup(prompt, self.paging.span)
            if ent is not None:
                shared, covered = ent.pages, ent.tokens
        return AdmitPlan(total_pages=total, fresh_pages=total - len(shared),
                         shared=shared, covered=covered)

    def can_admit(self, plan: AdmitPlan, *, reclaim: bool = True) -> bool:
        """Whether the free list and the state pool cover ``plan``;
        optionally reclaims prefix entries to make room."""
        if self.table.free_pages >= plan.fresh_pages and self._state_free:
            return True
        if reclaim and self.prefix is not None:
            self.prefix.reclaim(plan.fresh_pages)
        return (self.table.free_pages >= plan.fresh_pages
                and bool(self._state_free))

    def reserve(self, key, plan: AdmitPlan) -> bool:
        """Admission, phase one: commit the plan's pages and a state row
        to ``key`` (the request id) before a slot is bound, so several
        admissions in one engine loop never count the free list twice.
        All or nothing: False commits nothing."""
        assert key not in self._reserved, f"double reserve of {key!r}"
        if not self._state_free:
            return False
        fresh = self.table.alloc(plan.fresh_pages)
        if fresh is None:
            return False
        if plan.shared:
            self.table.share(plan.shared)
        self._reserved[key] = (list(plan.shared) + fresh,
                               self._state_free.pop())
        return True

    def bind(self, key, slot: int) -> None:
        """Admission, phase two: attach a reservation to its slot."""
        assert slot not in self.slot_pages, f"slot {slot} already mapped"
        pages, srow = self._reserved.pop(key)
        self.slot_pages[slot] = pages
        self.slot_state[slot] = srow

    def cancel(self, key) -> None:
        """Drop an unbound reservation."""
        pages, srow = self._reserved.pop(key)
        self.table.free(pages)
        self._state_free.append(srow)

    def alloc(self, slot: int, plan: AdmitPlan) -> AdmitPlan:
        """``reserve`` and ``bind`` in one; raises when the plan does not
        fit (``can_admit`` first)."""
        assert slot not in self.slot_pages, f"slot {slot} already mapped"
        if not self.reserve(("__alloc__", slot), plan):
            raise RuntimeError(
                f"out of pages: need {plan.fresh_pages}, "
                f"free {self.table.free_pages}, "
                f"state rows free {len(self._state_free)}")
        self.bind(("__alloc__", slot), slot)
        return plan

    def append(self, slot: int, n_tokens: int) -> None:
        """Grow a live request's page list to cover ``n_tokens`` positions
        (a no-op under the eager allocation admission makes)."""
        need = self.pages_needed(n_tokens)
        have = len(self.slot_pages[slot])
        if need > have:
            extra = self.table.alloc(need - have)
            if extra is None:
                raise RuntimeError(f"out of pages appending slot {slot}")
            self.slot_pages[slot].extend(extra)

    def fork_cow(self, src_pages, slot: int, n_fresh: int) -> list:
        """Map ``src_pages`` copy-on-write into ``slot`` and extend with
        ``n_fresh`` private pages: the share primitive under
        ``alloc(plan)``."""
        assert slot not in self.slot_pages
        fresh = self.table.alloc(n_fresh)
        if fresh is None:
            raise RuntimeError("out of pages in fork_cow")
        self.table.share(src_pages)
        self.slot_pages[slot] = list(src_pages) + fresh
        if not self._state_free:
            raise RuntimeError("out of state pages")
        self.slot_state[slot] = self._state_free.pop()
        return self.slot_pages[slot]

    def ensure_writable(self, slot: int, first_pos: int,
                        last_pos: int) -> int:
        """Copy-on-write fork: every page in the slot's write window
        [first_pos, last_pos] that is still shared (refcount > 1) is
        copied to a fresh private page before a tick writes it (a
        quarantined slot re-prefills from position 0).  Returns pages
        forked."""
        if first_pos > last_pos:
            return 0
        pages = self.slot_pages[slot]
        j0 = first_pos // self.paging.span
        j1 = min(last_pos // self.paging.span, len(pages) - 1)
        forked = 0
        for j in range(j0, j1 + 1):
            if self.table.refs[pages[j]] > 1:
                new = self.table.alloc(1)
                if new is None:
                    raise RuntimeError("out of pages in COW fork")
                self._copy_page(pages[j], new[0])
                self.table.free([pages[j]])
                pages[j] = new[0]
                forked += 1
                self.cow_copies += 1
        return forked

    def free(self, slot: int, prompt=None) -> None:
        """Release a finished request's pages (shared prefix pages live on
        under their entries) and state row.  With ``prompt`` and a prefix
        cache, the prompt's full pages are registered first."""
        pages = self.slot_pages.pop(slot)
        if prompt is not None and self.prefix is not None:
            self.prefix.register(prompt, pages, self.paging.span)
        self.table.free(pages)
        self._state_free.append(self.slot_state.pop(slot))

    # -- host offload tier (spill / restore) -------------------------------
    def spill(self, key, slot: int, store, *, tokens: int = 0) -> int:
        """Spill ``slot``'s whole cache footprint to the host ``store``
        under ``key`` (the request id): one gather and one device->host
        copy per leaf of every page the slot holds and, in prism mode,
        its state row, finished before the store takes it; then the
        pages go back to the table (shared prefix pages just lose a
        reference: their content was copied, so the restored copy is
        private) and the state row to the pool.  ``tokens`` is the
        covered-token count ``plan_restore`` reports.  Returns pages
        spilled."""
        pages = self.slot_pages.pop(slot)
        srow = self.slot_state.pop(slot)
        payload = (self._extract(pages, srow)
                   if self.storage is not None else None)
        store.put(key, len(pages), payload, tokens=tokens,
                  nbytes=self.payload_bytes(payload))
        self.table.free(pages)
        self._state_free.append(srow)
        return len(pages)

    def plan_restore(self, key, store, *, retries: int = 0,
                     backoff_s: float = 0.0) -> AdmitPlan | None:
        """The admission plan of a spilled request: every page fresh (the
        content comes by injection, not sharing), the covered tokens from
        the store.  ``retries`` re-reads through transient store losses.
        None when the store lost the entry for good: the caller falls
        back to a re-prefill plan."""
        ent = store.get(key, retries=retries, backoff_s=backoff_s)
        if ent is None:
            return None
        return AdmitPlan(total_pages=ent.n_pages, fresh_pages=ent.n_pages,
                         covered=ent.tokens)

    def restore(self, key, slot: int, store, *, retries: int = 0,
                backoff_s: float = 0.0) -> bool:
        """Inject the spilled content of ``key`` into the fresh pages and
        state row just bound to ``slot`` (``plan_restore`` -> ``reserve``
        -> ``bind`` first).  The pages differ from the spilled ones; the
        page and state maps each tick takes make that invisible.  False
        when the store dropped the entry between plan and bind: the pages
        stay bound (a restore plan is never smaller than a re-prefill
        plan), and the caller re-prefills into them."""
        ent = store.get(key, retries=retries, backoff_s=backoff_s,
                        consume=True)
        if ent is None:
            return False
        pages = self.slot_pages[slot]
        assert len(pages) == ent.n_pages, (len(pages), ent.n_pages)
        if self.storage is not None and ent.payload is not None:
            self._inject(pages, self.slot_state[slot], ent.payload)
        return True

    def extract_slot(self, slot: int):
        """One live slot's footprint on the host: the snapshot's gather,
        as ``spill``'s but leaving the slot its pages.  None without
        device storage."""
        if self.storage is None:
            return None
        return self._extract(self.slot_pages[slot], self.slot_state[slot])

    def inject_slot(self, slot: int, payload) -> None:
        """Scatter a snapshot's footprint into the (fresh) pages and state
        row bound to ``slot``: the engine restore's path."""
        if self.storage is None or payload is None:
            return
        self._inject(self.slot_pages[slot], self.slot_state[slot], payload)

    def payload_bytes(self, payload) -> int | None:
        """The bytes of the whole payload a rank's shard of it stands for:
        its pages' K/V times the sequence shards the pool is cut over (a
        mesh rank holds one), its state row once (every rank holds it
        whole).  None without a payload (the store counts pages)."""
        if payload is None:
            return None
        lay = self.layout
        cut = lay.n_seq // lay.held if lay is not None else 1
        return sum(t.nbytes * (cut if name in KV_LEAVES else 1)
                   for layer in payload for name, t in layer.items())

    # -- device copies -----------------------------------------------------
    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.long,
                               device=self.storage[0]["k"].device)

    def _extract(self, pages, srow: int) -> list:
        """One request's pages and state row on the host, one dict of
        leaves per layer: per leaf one ``index_select`` gather, then one
        device->host copy into pinned memory, all finished on return so
        the store owns settled bytes."""
        idx, sidx = self._index(pages), self._index([srow])
        out = [{name: t.index_select(0, idx if name in KV_LEAVES else sidx)
                for name, t in c.items()} for c in self.storage]
        if idx.device.type != "cuda":
            return out                 # the gathers are copies already
        host = []
        for layer in out:
            h = {}
            for name, t in layer.items():
                h[name] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                h[name].copy_(t, non_blocking=True)
            host.append(h)
        torch.cuda.current_stream(idx.device).synchronize()
        return host

    def _inject(self, pages, srow: int, payload) -> None:
        """Scatter a payload back into (other) pool pages and a state
        row, in place: the inverse of ``_extract`` up to relocation.  The
        host->device copies run on the current stream, the one the next
        tick's program runs on."""
        idx, sidx = self._index(pages), self._index([srow])
        for c, p in zip(self.storage, payload):
            for name, t in c.items():
                src = p[name].to(t.device, t.dtype, non_blocking=True)
                t.index_copy_(0, idx if name in KV_LEAVES else sidx, src)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one pool page to another on every K/V leaf: the COW
        fork."""
        for c in self.storage:
            for name in KV_LEAVES:
                c[name][dst].copy_(c[name][src])

    def copy_state(self, src_row: int, dst_row: int) -> None:
        """Copy one state-pool row (kz/vz/gz/zsum) to another."""
        for c in self.storage:
            for name in STATE_LEAVES:
                if name in c:
                    c[name][dst_row].copy_(c[name][src_row])

    # -- fault injection and quarantine ------------------------------------
    def poison_page(self, page: int) -> None:
        """NaN-fill one pool page's K/V (the ``page_poison`` fault, a
        simulated device-memory corruption).  Content only: the table,
        the maps and the refcounts are untouched, so only reads through
        this page see the poison."""
        for c in self.storage:
            for name in KV_LEAVES:
                c[name][page].fill_(float("nan"))

    def scrub_slot(self, slot: int) -> int:
        """Zero the slot's private (refcount 1) pages and its state row:
        the step before a quarantined slot re-prefills in place, and
        before failed pages rejoin the free list.  Zero, not just
        overwritten: the plain decode version multiplies masked columns,
        and 0 * NaN is NaN.  Shared pages are skipped (others read them;
        the poison fault never picks one).  Returns pages scrubbed."""
        pages = [p for p in self.slot_pages[slot]
                 if self.table.refs[p] == 1]
        srow = self.slot_state[slot]
        if not pages:
            return 0
        idx = self._index(pages)
        for c in self.storage:
            for name, t in c.items():
                if name in KV_LEAVES:
                    t.index_fill_(0, idx, 0.0)
                else:
                    t[srow].zero_()
        return len(pages)

    def reset_row(self, row: int) -> None:
        """Dense mode: zero one slot's row of every leaf (on a mesh rank,
        where its block holds the row)."""
        local = row - self.first_row
        if not 0 <= local < self.storage[0]["k"].shape[0]:
            return
        for c in self.storage:
            for t in c.values():
                t[local].zero_()

    def insert_row(self, src, src_row: int, dst_row: int) -> None:
        """Dense mode: copy row ``src_row`` of the cache ``src`` (a
        prefill's, with this cache's leaves and row shapes) into row
        ``dst_row`` of every leaf, in place: the padded admission's
        splice (on a mesh rank, where its block holds the row; ``src``
        then holds every row)."""
        local = dst_row - self.first_row
        if not 0 <= local < self.storage[0]["k"].shape[0]:
            return
        for c, s in zip(self.storage, src):
            for name, t in c.items():
                t[local].copy_(s[name][src_row])

    # -- device-side maps --------------------------------------------------
    def page_map(self, n_slots: int) -> np.ndarray:
        """(n_slots, pages_per_row) int32 physical page of every logical
        page of every slot; NO_PAGE where unmapped."""
        m = np.full((n_slots, self.paging.pages_per_row), NO_PAGE, np.int32)
        for slot, pages in self.slot_pages.items():
            m[slot, :len(pages)] = pages
        return m

    def state_map(self, n_slots: int) -> np.ndarray:
        """(n_slots,) int32 state-pool row of every slot; NO_PAGE where
        unmapped."""
        m = np.full((n_slots,), NO_PAGE, np.int32)
        for slot, row in self.slot_state.items():
            m[slot] = row
        return m

    def check(self) -> None:
        """Page accounting: the table is consistent and every page's
        refcount equals the holders (slot page lists, reservations,
        prefix entries) that name it; every state row is held once."""
        self.table.check()
        held = np.zeros(self.paging.n_pages, np.int64)
        for pages in self.slot_pages.values():
            for p in pages:
                held[p] += 1
        for pages, _ in self._reserved.values():
            for p in pages:
                held[p] += 1
        if self.prefix is not None:
            for ent in self.prefix.entries.values():
                for p in ent.pages:
                    held[p] += 1
        assert np.array_equal(held, self.table.refs.astype(np.int64)), \
            (held.tolist(), self.table.refs.tolist())
        srows = (list(self.slot_state.values())
                 + [s for _, s in self._reserved.values()]
                 + list(self._state_free))
        assert sorted(srows) == list(range(self.paging.n_state_pages))

    def stats(self) -> dict:
        if not self.paged:
            return {}
        return {"pages_total": self.paging.n_pages,
                "pages_free": self.table.free_pages,
                "pages_used": self.table.used_pages,
                "prefix_entries": (len(self.prefix.entries)
                                   if self.prefix else 0),
                "prefix_hits": self.prefix.hits if self.prefix else 0}
