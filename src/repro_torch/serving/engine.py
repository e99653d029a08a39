"""Continuous-batching serving engine over the port's cache and tick
programs, on one card or over a mesh of ranks.

Request lifecycle::

    submit ──> [arrival heap] ──> [FIFO queue] ──> admit into a free slot
    (host side: pages reserved, a prefix hit skips the tokens its shared
    pages hold) ──> PACKED PREFILL: each tick, every decode token plus
    prompt tokens of every mid-prefill request in one flat batch, one
    call of ``packed_step`` ──> rewind to pos = len(prompt) - 1 ──>
    decode (packed ticks while anything prefills, ``serve_step``
    otherwise) ──> host sampling ──> finish at EOS or max tokens: pages
    freed (the prompt's full pages registered for prefix reuse), slot
    freed.

Tick programs, plain function dispatch (the reference caches one
compiled program per kind; here nothing is traced):

  * ``packed`` (``prefill_mode='packed'``, the default): a
    ``(token_budget,)`` batch planned by ``FifoScheduler.plan_tick``;
  * ``decode``: ``serve_step`` over every slot with a (B,) position
    vector, for ticks with nothing prefilling;
  * ``chunk`` (``prefill_mode='chunked'``): every mid-prefill row
    advances up to ``chunk_len`` prompt tokens at its own offset,
    interleaved with decodes under ``decode_per_prefill``;
  * the ``padded`` flush (``prefill_mode='padded'``, the dense cache
    only): every admitted prompt right-padded to ``prefill_len``, one
    monolithic ``prefill`` (``prism_flash_attention``; the PRISM
    exchange through ``segment_means`` in prism mode) whose rows come
    out at decode capacity, one row splice (``KVCache.insert_row``) per
    request.  Its prism means count the pad columns (the reference's
    known wart), so its prism tokens are the reference's padded ones.

The cache is one ``KVCache``: the page pool and page table by default
(exact mode stores round-robin and shares prompt prefixes; prism mode
keeps the aligned placement and takes whole rows), or the dense rowset
with ``paged=False``, the oracle.  Attention in every program is exact
(the cross-shard stat combine), so the engine's tokens are the
sequential ones.

Robustness, as the reference serves it:

  * priority classes (``submit(priority=)``); with ``offload=True`` a
    blocked higher-priority candidate preempts lower-priority work into
    the host KV store (``runtime/offload.py``), and the victim restores
    through admission into other pages (``preempt``, ``suspend``,
    ``resume`` by hand too);
  * deadlines (``submit(deadline=)``): a request past its deadline is
    cancelled wherever it is, its pages, slot or store bytes reclaimed;
    ``cancel`` does the same on request;
  * fault injection (``faults=FaultPlan(...)``, ``runtime/faults.py``):
    store losses, poisoned pages, admission stalls, tick delays;
  * NaN quarantine: one isfinite reduction over each tick's logits; a
    decode row that fails quarantines exactly its slot (pages scrubbed,
    the prompt prefilled again, the sampler re-seeded), at most
    ``max_restarts`` times before the request fails;
  * ``snapshot`` / ``restore``: the whole serving state, every live
    slot's pages and state row included, into a fresh engine;
  * the degraded mesh (a ``shard_loss`` fault): one sequence shard's K/V
    is lost; for ``degraded_grace`` ticks the decoding requests go on
    through the Segment-Means standby replicas (``runtime/replica.py``,
    ``serve_step(lost=...)``), held in their slots, then every active
    request is prefilled again from its prompt and its tokens are the
    uninterrupted ones;
  * gang admission (``gang=True``): the static-batching baseline.

``serving/streaming.py`` wraps the engine in the double-buffered
streaming loop.  Other block kinds and frontends are served on the
static path alone, as the reference's engine refuses them too; the
engine refuses them with a ``ValueError`` (ROADMAP queue 3).

Over a mesh of ranks (``params`` a rank's ``MeshParams``), as the
reference's engine runs its programs under ``shard_map``: the layout is
the mesh's (``seq_shards`` sequence shards), the cache the rank's
(``make_kv_cache(mesh=)``), and the engine is SPMD: every rank runs the
same scheduler, page table and host sampling on the same logits.  A
rank's clock may disagree with another's, and two ranks that admit
differently would enter different collectives and hang, so every
reading of the clock on a mesh is rank 0's, broadcast (one 8-byte
``engine`` collective).  On the dense cache a decode step's logits are
the rank's batch rows, gathered over the batch axes (``engine``) so
that every rank samples every slot.  Every mode serves a mesh, on the
paged and the dense cache, in both decode modes, with its robustness
layers:

  * offload and preemption: a rank spills and restores its shard of a
    slot's pages (and the whole state row); its store counts the whole
    payload's bytes, so capacity and evictions are every rank's alike;
  * faults: one injector a rank, seeded alike and consulted at the same
    seams, so every rank draws the same faults; a poisoned page is the
    page's shard on every rank;
  * ``snapshot`` / ``restore``: each rank's snapshot holds its shard,
    and a restore refuses one cut on another mesh shape or rank;
  * the degraded step: the lost shard is a ``model`` index; its rank
    keeps running its lane without reading its K/V, served by the
    standby its ring neighbour hosts (``runtime/replica.py``);
  * the padded flush: the static ``prefill`` over the mesh at decode
    capacity, its rows gathered over the batch axes (``engine``) where a
    slot's block differs from its batch row's;
  * a client's ``cancel``, ``preempt``, ``suspend`` or ``resume`` takes
    rank 0's request id (one ``engine`` broadcast), so every rank acts
    on the same request at the same tick.

On a mesh ``trail`` is a running digest of the host decisions after
every tick (the tick's kind, the slots' requests, the page and state
maps, the injector's draws, the store's outcomes, the counters, the
lost shards): every rank's must be equal, and a desynchronised rank
shows there before it hangs in a collective another rank never enters.
One process keeps no digest.
"""
from __future__ import annotations

import copy
import hashlib
import heapq
import math
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..core.protocol import PrismConfig
from ..models.config import ModelConfig
from ..models.transformer import (check_decoder, check_dtype,
                                  check_supported, params_dtype)
from ..runtime.faults import FaultInjector, FaultPlan
from ..runtime.offload import KVStore
from ..runtime.paging import AdmitPlan, make_paged_layout
from ..runtime.replica import MeansReplica
from ..runtime.serve import (MeshParams, ServeHParams, batch_rows,
                             check_degraded_mesh, gather_logits,
                             make_kv_cache, make_layout, paged_placement,
                             prefill, serve_step)
from ..runtime.ticks import chunk_prefill_step, packed_step
from ..sharding import comm
from .sampling import SamplingParams, sample_token
from .scheduler import EngineStats, FifoScheduler, Request, RequestState


@dataclass(frozen=True)
class EngineConfig:
    """Validated engine configuration, the one construction path of
    ``ServingEngine``.  ``__post_init__`` normalises the derived fields
    as the reference's does: ``chunk_len`` clamps to ``[1,
    prefill_len]``, ``token_budget`` defaults to ``n_slots + chunk_len``,
    ``prefill_mode='padded'`` forces the dense cache (the flush and
    splice predate paging), ``prefix_cache`` defaults on where it is
    sound (the paged exact cache), and ``prism`` (the padded flush's
    prefill exchange) defaults to the decode mode's pairing.
    ``offload`` needs the paged cache and refuses gang admission."""
    n_slots: int
    prefill_len: int
    max_cache: int
    hp: ServeHParams = ServeHParams()
    prism: PrismConfig | None = None
    decode_per_prefill: int = 4
    gang: bool = False
    chunk_len: int = 64
    prefill_mode: str = "packed"
    token_budget: int | None = None
    pad_id: int = 0
    paged: bool = True                 # page-table cache (the default)
    page_tokens: int | None = None     # page size in token positions
    n_pages: int | None = None         # pool size (default: slot parity)
    prefix_cache: bool | None = None   # shared-prefix reuse
    offload: bool = False              # host KVStore tier + preemption
    offload_bytes: int | None = None   # store capacity (None = unbounded)
    faults: FaultPlan | None = None    # seeded chaos plan (None = off)
    max_restarts: int = 3              # reset_for_refill bound per request
    degraded_grace: int = 2            # means-served ticks per shard loss
    replica_refresh: int = 16          # standby staleness refresh period
    restore_retries: int = 2           # KVStore.get retries before refill
    restore_backoff_s: float = 0.0     # exponential backoff base (sleep)

    def __post_init__(self):
        if self.max_restarts < 1:
            raise ValueError(f"max_restarts {self.max_restarts} < 1")
        if self.degraded_grace < 0:
            raise ValueError(f"degraded_grace {self.degraded_grace} < 0")
        if self.replica_refresh < 1:
            raise ValueError(
                f"replica_refresh {self.replica_refresh} < 1")
        if self.restore_retries < 0:
            raise ValueError(
                f"restore_retries {self.restore_retries} < 0")
        if self.restore_backoff_s < 0.0:
            raise ValueError(
                f"restore_backoff_s {self.restore_backoff_s} < 0")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultPlan):
            raise ValueError(
                f"faults must be a FaultPlan, got "
                f"{type(self.faults).__name__}")
        if self.prefill_mode not in ("packed", "chunked", "padded"):
            raise ValueError(f"prefill_mode {self.prefill_mode!r} not in "
                             "('packed', 'chunked', 'padded')")
        if self.n_slots < 1:
            raise ValueError(f"n_slots {self.n_slots} < 1")
        if not 1 <= self.prefill_len <= self.max_cache:
            raise ValueError(
                f"prefill_len {self.prefill_len} not in "
                f"[1, max_cache={self.max_cache}]")
        set_ = lambda k, v: object.__setattr__(self, k, v)   # noqa: E731
        set_("chunk_len", max(1, min(self.chunk_len, self.prefill_len)))
        if self.token_budget is None:
            set_("token_budget", self.n_slots + self.chunk_len)
        if self.token_budget < self.n_slots:
            raise ValueError(
                f"token_budget {self.token_budget} < n_slots "
                f"{self.n_slots}: every decoding slot needs its token "
                "in each tick")
        if self.prefill_mode == "padded" and self.paged:
            set_("paged", False)       # the flush splices dense rows
        ok_prefix = self.paged and self.hp.decode_mode == "exact"
        if self.prefix_cache is None:
            set_("prefix_cache", ok_prefix)
        elif self.prefix_cache and not ok_prefix:
            raise ValueError(
                "prefix_cache requires the paged cache in exact decode "
                f"mode (paged={self.paged}, "
                f"decode_mode={self.hp.decode_mode!r})")
        if self.offload:
            if not self.paged:
                raise ValueError(
                    "offload requires the paged cache (paged=False, "
                    f"prefill_mode={self.prefill_mode!r}): spill and "
                    "restore move pages, not dense rows")
            if self.gang:
                raise ValueError(
                    "offload and preemption do not go with gang (static "
                    "batching) admission")
        if self.prism is None:
            set_("prism", PrismConfig(
                P=1, cr=self.hp.means_cr,
                mode="prism" if self.hp.decode_mode == "prism"
                else "voltage"))


@dataclass
class EngineSnapshot:
    """The whole serving state of one engine, taken between steps
    (``ServingEngine.snapshot``), on the host.  Every live slot's cache
    footprint rides as the offload tier's gather, so an engine restored
    from it (``ServingEngine.restore`` on a fresh engine with the same
    config and weights) gives the tokens of one never stopped, in exact
    and prism decode modes (the prism state row is in the payload).

    ``active`` holds ``(slot, RequestState, payload, n_pages)`` per live
    slot; the sampler RNGs travel inside the deep-copied states."""
    now: float                         # engine-clock time of the cut
    next_rid: int
    active: list                       # [(slot, state, payload, n_pages)]
    queues: dict                       # priority -> [Request] (fresh)
    resume: dict                       # priority -> [RequestState]
    pending: list                      # future arrivals (heap entries)
    suspended: dict                    # rid -> RequestState
    store_entries: list                # the store's SpilledEntry objects
    results: dict                      # rid -> finished RequestState
    failed: dict                       # rid -> failure reason
    stats: EngineStats
    injector: object                   # FaultInjector mid-stream (or None)
    decodes_since_prefill: int
    drain: bool
    has_deadlines: bool
    # the mesh shape and rank whose shard the payloads are (None folded)
    mesh: tuple | None = None


class ServingEngine:
    """Multiplexes independent requests through a fixed pool of decode
    slots backed by one ``KVCache``.  ``n_seq`` is the number of
    sequence shards folded into one process (the reference's mesh
    'model' axis); with a rank's ``MeshParams`` the mesh's layout sets
    it.  The engine runs on the device of ``params``."""

    def __init__(self, cfg: ModelConfig, params, config: EngineConfig, *,
                 n_seq: int = 4, clock=time.monotonic):
        mesh = params.mesh if isinstance(params, MeshParams) else None
        other = sorted(set(cfg.block_kinds) - {"attn", "moe"})
        if other:
            # as the reference's engine: admission relies on a cache
            # addressed purely by global position; the ring of a
            # sliding-window layer (attn_local) holds the padded tail, and
            # a recurrent state (mlstm, slstm, mamba) would take in the
            # pad tokens
            raise ValueError(
                f"the port's engine serves global-attention and moe blocks "
                f"only; arch {cfg.name!r} has {other}, which need a state-"
                f"snapshot admission path (the static serve path serves "
                f"attn_local, mlstm, slstm, mamba and shared_attn): ROADMAP "
                f"queue 3")
        if cfg.arch_type == "vlm" or cfg.frontend:
            # the reference engine's words, then where the port stands
            raise ValueError(
                f"ServingEngine serves token prompts only; arch "
                f"{cfg.name!r} (arch_type={cfg.arch_type!r}, "
                f"frontend={cfg.frontend!r}) needs embedding inputs: "
                "ROADMAP queue 3")
        # where the reference would serve BERT as a decoder (ROADMAP queue
        # 3): an encoder classifies through runtime.serve.encode
        check_decoder(cfg, "ServingEngine")
        check_supported(cfg)
        # bf16 parameters over the reference's cache: make_kv_cache's
        # default, f32.  A layer's rows turn f32 over it from layer 0's
        # attention on, as the reference's layers compute (its engine's
        # layer scan refuses that change of dtype and raises)
        check_dtype(cfg, params_dtype(params))
        self.cfg, self.params, self.config = cfg, params, config
        self.mesh = mesh
        self.device = (params["embed"]["table"].device if mesh is None
                       else mesh.device)
        hp = config.hp
        self.n_slots, self.prefill_len = config.n_slots, config.prefill_len
        self.prefill_mode = config.prefill_mode
        self.chunk_len = config.chunk_len
        self.token_budget = int(config.token_budget)
        self.pad_id, self._clock, self._hp = config.pad_id, clock, hp

        # the paged placement depends on the decode mode alone, so the
        # aligned base layout seeds the page-size derivation
        shards, batch = (n_seq, None) if mesh is None else (mesh,
                                                            self.n_slots)
        base = make_layout(shards, config.max_cache, hp, config.prefill_len,
                           batch=batch)
        self._paging = (self._derive_paging(base, config)
                        if config.paged else None)
        self.layout = make_layout(shards, config.max_cache, hp,
                                  config.prefill_len,
                                  paged_placement(hp, self._paging),
                                  batch=batch)
        self._paged = self._paging is not None
        self._prefix_on = bool(config.prefix_cache) and self._paged
        # paged prism takes whole rows and shares no prefix
        self._full_row = self._paged and hp.decode_mode == "prism"
        self._kv = make_kv_cache(cfg, self.layout, self.n_slots, hp,
                                 device=self.device, paging=self._paging,
                                 prefix_cache=self._prefix_on, mesh=mesh)
        self._sched = FifoScheduler(
            self.n_slots, decode_per_prefill=config.decode_per_prefill,
            gang=config.gang)
        self.stats = EngineStats(n_slots=self.n_slots)
        self._pending: list = []       # heap of (arrival, rid, Request)
        self._results: dict = {}       # rid -> RequestState
        self._plans: dict = {}         # rid -> reserved AdmitPlan
        self._next_rid = 0
        self._t0 = None                # clock origin (first submit/run)
        # seeded chaos: one injector per engine, shared with the store
        self._injector = (FaultInjector(config.faults,
                                        trail=mesh is not None)
                          if config.faults is not None else None)
        # host offload tier: spilled pages and prism state rows by rid
        self._store = (KVStore(capacity_bytes=config.offload_bytes,
                               injector=self._injector)
                       if config.offload else None)
        self._suspended: dict = {}     # rid -> parked RequestState
        self._from_store: set = set()  # rids whose reservation restores
        self._failed: dict = {}        # rid -> reason
        self._has_deadlines = False    # any live request with a deadline
        # the NaN guard rides the packed, chunked and decode ticks; the
        # padded flush cannot prefill an active slot again in place
        self._nan_guard = self.prefill_mode != "padded"
        # the degraded mesh: the standby replica is armed only when a
        # shard_loss fault can fire and the cache is paged (a dense
        # engine never draws the shard_loss stream)
        self._replica = None
        self._lost: set = set()        # sequence shards lost now
        self._degraded_left = 0        # means-served ticks before recovery
        if (self._injector is not None and self._paged
                and config.faults.spec("shard_loss").enabled):
            seq = None
            if mesh is not None:
                check_degraded_mesh(self.layout, hp)
                seq = mesh.group(self.layout.seq_axes)
            self._replica = MeansReplica(
                cfg, self.layout, hp, self._paging, self.n_slots,
                refresh_every=config.replica_refresh, seq=seq)
        self.trail = b""               # digest of the host decisions (mesh)

    @staticmethod
    def _derive_paging(base, config: EngineConfig):
        """Pool geometry from the layout: by default pages of about 16
        positions whose ``page_cols`` divides both the per-shard prefill
        region and the row."""
        if config.page_tokens is None:
            pc = math.gcd(math.gcd(base.n_loc0, base.cap_l),
                          max(1, 16 // base.n_seq))
            page_tokens = pc * base.n_seq
        else:
            page_tokens = config.page_tokens
        return make_paged_layout(base, page_tokens=page_tokens,
                                 n_pages=config.n_pages,
                                 n_slots=config.n_slots)

    @property
    def kv_cache(self):
        """The engine's ``KVCache`` (page table, prefix cache, device
        storage)."""
        return self._kv

    @property
    def kv_store(self):
        """The host offload tier (None unless ``offload=True``)."""
        return self._store

    # ------------------------------------------------------------------
    # the tick programs
    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _maps(self) -> tuple:
        """The paged programs' per-slot (page_map, state_map) int32
        tensors for this tick; nothing for the dense cache."""
        if not self._paged:
            return ()
        return (self._tensor(self._kv.page_map(self.n_slots)),
                self._tensor(self._kv.state_map(self.n_slots)))

    def _decode(self, tok, pos):
        return self._decode_program(self._tensor(tok), self._tensor(pos),
                                    self._maps())

    def _decode_program(self, tok, pos, maps, lost=None, rep=None):
        """``serve_step`` on device tensors (the streaming loop stages
        its own) -> every slot's logits.  On a mesh's dense cache the
        rank decodes its batch rows, gathered over the batch axes."""
        dense = self.mesh is not None and not maps and self.layout.ba
        if dense:
            tok, pos = (batch_rows(t, self.layout, self.mesh)
                        for t in (tok, pos))
        logits = gather_logits(serve_step(
            self.cfg, self.params, self._kv.storage, tok, pos, self.layout,
            self._hp, *maps, lost=lost, rep=rep)[0], self.params)
        if dense:
            logits = comm.all_gather(logits, self.mesh.group(self.layout.ba),
                                     "engine", dim=0)
        return logits

    def _packed_program(self, tok, slot, pos, off, pre, maps):
        """``packed_step`` on device tensors."""
        return gather_logits(packed_step(
            self.cfg, self.params, self._kv.storage, tok, slot, pos, off,
            pre, self.layout, self._hp, *maps)[0], self.params)

    def _decode_degraded(self, tok, pos):
        """The degraded decode step: the lost shards' mask and, in exact
        mode, the assembled standby replica."""
        rep = (self._replica.assemble(self.device, self._lost)
               if self._hp.decode_mode == "exact" else None)
        return self._decode_program(
            self._tensor(tok), self._tensor(pos), self._maps(),
            self._tensor(self._replica.lost_mask(self._lost)), rep)

    def _prefill(self, tokens):
        """The padded flush's prefill: (n_slots, prefill_len) tokens ->
        a dense cache at decode capacity (the engine's layout)."""
        return prefill(self.cfg, self.params, self._tensor(tokens),
                       self.config.prism, self.layout, self._hp)[1]

    def _packed(self, tok, slot, pos, off, pre):
        return self._packed_program(
            *map(self._tensor, (tok, slot, pos, off, pre)), self._maps())

    def _chunk(self, tokens, off, nreal):
        chunk_prefill_step(self.cfg, self.params, self._kv.storage,
                           *map(self._tensor, (tokens, off, nreal)),
                           self.layout, self._hp, *self._maps())

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def _shared(self, value, dtype):
        """Rank 0's ``value`` on every rank of a mesh (one ``engine``
        broadcast); ``value`` itself in one process."""
        if self.mesh is None:
            return value
        world = self.mesh.group(self.mesh.axis_names)
        return comm.broadcast(torch.tensor([value], dtype=dtype,
                                           device=self.device), world,
                              "engine")[0].item()

    def _read_clock(self) -> float:
        """The clock's reading: rank 0's on a mesh."""
        return float(self._shared(self._clock(), torch.float64))

    def _decide(self, rid: int) -> int:
        """A client's choice of request (cancel, preempt, suspend,
        resume): rank 0's on a mesh, so that every rank acts on the same
        request at the same tick."""
        return int(self._shared(int(rid), torch.int64))

    def now(self) -> float:
        """Engine-clock seconds since the first reading: on a mesh rank
        0's reading, shared with every rank (``engine`` class), so that
        every rank releases, admits and expires alike."""
        t = self._read_clock()
        if self._t0 is None:
            self._t0 = t
        return t - self._t0

    def submit(self, prompt, *, max_new_tokens: int, eos_id=None,
               sampling: SamplingParams = SamplingParams(),
               arrival: float | None = None, priority: int = 0,
               deadline: float | None = None) -> int:
        """Queue one request.  ``arrival`` (engine-relative seconds) may
        lie in the future: the run loop holds the request back until the
        clock passes it, which is how Poisson traces are replayed.
        ``priority`` (higher = more urgent) picks the admission class;
        with ``offload=True`` a blocked higher-priority request preempts
        lower-priority work into the host store.  ``deadline`` is an
        absolute engine-clock time: once the clock passes it the request
        is cancelled wherever it is and counted as a miss of its
        class."""
        prompt = tuple(int(t) for t in prompt)
        if not 1 <= len(prompt) <= self.prefill_len:
            raise ValueError(
                f"prompt length {len(prompt)} not in [1, {self.prefill_len}]")
        if len(prompt) + max_new_tokens > self.layout.cap:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"cache capacity {self.layout.cap}")
        if self._paged:
            # a request the whole pool cannot hold would wait at the
            # FIFO head for ever
            need = self._kv.plan(prompt, max_new_tokens, use_prefix=False,
                                 full_row=self._full_row).total_pages
            if need > self._paging.n_pages:
                raise ValueError(
                    f"request needs {need} pages; the pool holds "
                    f"{self._paging.n_pages}")
        arrival = self.now() if arrival is None else arrival
        if deadline is not None:
            if deadline <= arrival:
                raise ValueError(
                    f"deadline {deadline} <= arrival {arrival}")
            self._has_deadlines = True
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id, sampling=sampling, arrival=arrival,
                      priority=priority, deadline=deadline)
        # through the arrival-ordered heap, so a late submit with a past
        # arrival cannot jump earlier arrivals still waiting
        heapq.heappush(self._pending, (req.arrival, rid, req))
        self._release_arrivals()
        return rid

    def _release_arrivals(self):
        now = self.now()
        while self._pending and self._pending[0][0] <= now:
            self._sched.submit(heapq.heappop(self._pending)[2])
        self._sched.drain = not self._pending

    def next_arrival(self) -> float | None:
        """Arrival time of the earliest request not yet released: what a
        logical-clock drive loop jumps to when the engine is idle."""
        return self._pending[0][0] if self._pending else None

    # ------------------------------------------------------------------
    # one engine iteration
    # ------------------------------------------------------------------
    def step(self) -> str:
        """One scheduler decision: a packed tick (chunked mode: a prefill
        chunk; padded mode: an admission flush), a decode step, a stall
        (the ``tick_delay`` fault), a degraded tick or the recovery, or
        nothing.  Returns 'packed', 'prefill', 'decode', 'stalled',
        'degraded', 'recovered' or 'idle'."""
        kind = self._step_inner()
        if kind == "idle":
            self.stats.ticks_idle += 1
        self._after_tick(kind)
        return kind

    def _after_tick(self, kind: str) -> None:
        """The bookkeeping after every tick, the streaming loop's too:
        the fault and store counters, and the standby replica's
        piggyback (capture every newly decoding slot, refresh at most one
        stale one), never while a shard is lost: a capture would read
        it."""
        if self._injector is not None:
            self.stats.faults_injected = self._injector.total_injected
            self.stats.faults_by_kind = dict(self._injector.injected)
        if self._store is not None:
            self.stats.store_get_retries = self._store.get_retries
        if (self._replica is not None and not self._lost
                and kind in ("decode", "packed", "prefill")):
            self._replica.tick(self._kv, self._sched.decoding(),
                               self.stats.decode_steps
                               + self.stats.packed_ticks)
        self._note(kind)

    def _note(self, event: str) -> None:
        """Fold the host decisions after ``event`` into ``trail`` (on a
        mesh; one process has no ranks to hold it to)."""
        if self.mesh is None:
            return
        kv, s = self._kv, self.stats
        h = hashlib.sha256(self.trail)
        h.update(repr((event, sorted((k, st.req.rid, st.pos, st.nprefilled)
                                     for k, st in self._sched.active.items()),
                       sorted(self._lost), s.preemptions, s.restore_hits,
                       s.restore_misses, s.restarts, s.quarantined,
                       s.failed_requests, s.degraded_ticks,
                       None if self._store is None else self._store.stats(),
                       None if self._injector is None
                       else self._injector.trail)).encode())
        if self._paged:
            h.update(kv.page_map(self.n_slots).tobytes())
            h.update(kv.state_map(self.n_slots).tobytes())
        self.trail = h.digest()

    def _step_inner(self) -> str:
        sch = self._sched
        self._release_arrivals()
        if self.stats.t_start is None:
            self.stats.t_start = self.now()
        if self._has_deadlines:
            self._expire()
        if (self._injector is not None and sch.has_work
                and self._injector.fire("tick_delay")):
            return "stalled"           # the whole tick does nothing
        if (self._replica is not None and sch.has_work
                and self._injector.fire("shard_loss")):
            spec = self._injector.plan.spec("shard_loss")
            shard = (spec.shard if spec.shard is not None
                     else self._injector.pick("shard_loss",
                                              self.layout.n_seq))
            self._lose_shard(shard % self.layout.n_seq)
        if self._lost:
            return self._degraded_tick()
        if self.prefill_mode == "padded":
            if sch.want_prefill():
                return self._padded_flush()
        else:
            self._admit_or_preempt()   # host side: slots and pages
            if self.prefill_mode == "chunked":
                if sch.want_chunk():
                    return self._chunk_step()
            elif any(st.prefilling for st in sch.active.values()):
                return self._packed_tick()
        decoding = sch.decoding()
        if not decoding:
            return "idle"
        self._maybe_poison()
        tok = np.zeros(self.n_slots, np.int64)
        pos = np.full(self.n_slots, -1, np.int64)
        for st in decoding:
            tok[st.slot] = st.next_token
            pos[st.slot] = st.pos
        t0 = self.now()
        rows, bad = self._logits_host(self._decode(tok, pos))
        now = self.now()
        self.stats.step_latency.append(now - t0)
        self.stats.occupancy.append(len(sch.active) / self.n_slots)
        self.stats.decode_steps += 1
        for st in decoding:
            if self._nan_guard and bad[st.slot]:
                self._quarantine(st)
            else:
                self._advance_decode(st, rows[st.slot], now)
        sch.note_decode()
        self.stats.t_end = self.now()
        return "decode"

    @staticmethod
    def _logits_host(logits) -> tuple:
        """The tick's logits on the host and, from one isfinite reduction
        over them, which rows hold a non-finite value: a decode row that
        does is quarantined."""
        rows = logits.cpu().numpy()
        return rows, ~np.isfinite(rows).all(axis=-1)

    # ------------------------------------------------------------------
    # admission (page-aware)
    # ------------------------------------------------------------------
    def _admit_gate(self, req) -> bool:
        """Page-aware admission check on the queue's head: plan the
        request's pages (prefix lookup included), reclaim prefix entries
        if the free list is short, and RESERVE the pages before the
        scheduler pops the request."""
        kv = self._kv
        plan = kv.plan(req.prompt, req.max_new_tokens,
                       use_prefix=self._prefix_on, full_row=self._full_row)
        if not kv.can_admit(plan, reclaim=False):
            if kv.prefix is not None:
                kv.prefix.reclaim(plan.fresh_pages)
                # reclaim may have dropped the very entry the plan
                # shares: plan again against the survivors
                plan = kv.plan(req.prompt, req.max_new_tokens,
                               use_prefix=self._prefix_on,
                               full_row=self._full_row)
            if not kv.can_admit(plan, reclaim=False):
                self.stats.out_of_pages += 1
                return False
        if not kv.reserve(req.rid, plan):
            self.stats.out_of_pages += 1
            return False
        self._plans[req.rid] = plan
        return True

    def _restore_gate(self, st: RequestState) -> bool:
        """Admission check for a preempted request coming back from the
        host store: its plan's pages and covered tokens come from the
        spilled entry.  When the store lost the entry, the request
        starts again (``reset_for_refill``) through the fresh-admission
        gate, or fails once its restarts are spent; no other slot is
        touched."""
        kv, rid = self._kv, st.req.rid
        plan = kv.plan_restore(rid, self._store,
                               retries=self.config.restore_retries,
                               backoff_s=self.config.restore_backoff_s)
        if plan is None:
            self.stats.restore_misses += 1
            if st.restarts >= self.config.max_restarts:
                # fail the head here (it holds no pages, slot or store
                # entry) so that it cannot block the queue for ever
                self._sched.cancel(rid)
                self._store.drop(rid)
                self._failed[rid] = "max_restarts"
                self.stats.failed_requests += 1
                return False
            self._note_restart(st)
            return self._admit_gate(st.req)
        if not kv.can_admit(plan, reclaim=False):
            if kv.prefix is not None:
                kv.prefix.reclaim(plan.fresh_pages)
            if not kv.can_admit(plan, reclaim=False):
                self.stats.out_of_pages += 1
                return False
        if not kv.reserve(rid, plan):
            self.stats.out_of_pages += 1
            return False
        self._plans[rid] = plan
        self._from_store.add(rid)
        return True

    def _gate(self, cand) -> bool:
        """The admission gate of a candidate: a fresh Request, or a
        RequestState resuming from the store."""
        if isinstance(cand, RequestState):
            return self._restore_gate(cand)
        return self._admit_gate(cand)

    def _admit(self) -> list:
        """Assign free slots to queued requests; in paged mode each binds
        its reserved pages, then a prefix hit starts its prompt past the
        tokens the shared pages hold, or a resume's spilled content is
        injected into the pages just bound."""
        states = self._sched.admit(
            self.now(), gate=self._gate if self._paged else None)
        for st in states:
            if not self._paged:
                continue
            rid = st.req.rid
            self._kv.bind(rid, st.slot)
            plan = self._plans.pop(rid)
            if rid in self._from_store:
                self._from_store.discard(rid)
                if self._kv.restore(
                        rid, st.slot, self._store,
                        retries=self.config.restore_retries,
                        backoff_s=self.config.restore_backoff_s):
                    self.stats.restore_hits += 1
                else:
                    # the entry went between plan and bind: the bound
                    # pages hold a full re-prefill
                    self.stats.restore_misses += 1
                    if st.restarts >= self.config.max_restarts:
                        self._fail_active(st, "max_restarts")
                        continue
                    self._note_restart(st)
            elif plan.covered:
                st.nprefilled = plan.covered
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_saved += plan.covered
        return states

    def _admit_or_preempt(self) -> None:
        """The tick's admission move: admit what fits, then, with the
        offload tier on, spill strictly lower-priority active work while
        the head candidate is still blocked (no free slot, or out of
        pages).  Each spill is one gather and copy to the host; the
        victim parks on the resume queue and restores through admission
        once the pressure clears.  Equal priorities never preempt (the
        pool drains by itself; swapping would only thrash)."""
        sch = self._sched
        if (self._injector is not None and sch.queued
                and self._injector.fire("admission_stall")):
            return                     # control plane stuck this tick
        if sch.want_admit():
            self._admit()
        if self._store is None:
            return
        while True:
            cand = sch.peek_admit()
            if cand is None:
                return
            prio = (cand.req.priority if isinstance(cand, RequestState)
                    else cand.priority)
            victim = sch.pick_victim(prio, now=self.now())
            if victim is None:
                return
            self._spill(victim)
            self._admit()

    def _spill(self, st: RequestState, *, requeue: bool = True) -> None:
        """Preempt an active request: its pages and state row to the host
        store, its device footprint freed; then park it for resume, or
        hand it to the caller (suspend)."""
        n = self._kv.spill(st.req.rid, st.slot, self._store,
                           tokens=st.nprefilled)
        self.stats.preemptions += 1
        self.stats.spilled_pages += n
        self._drop_replica(st.slot)
        if requeue:
            self._sched.preempt(st)
        else:
            self._sched.remove(st)

    def _find_active(self, rid: int) -> RequestState | None:
        for st in self._sched.active.values():
            if st.req.rid == rid:
                return st
        return None

    # ------------------------------------------------------------------
    # fault injection and quarantine
    # ------------------------------------------------------------------
    def _maybe_poison(self) -> None:
        """The ``page_poison`` fault: NaN-fill the first page of one
        decoding slot whose page is private (refcount 1; a shared prefix
        page is other requests' too).  Page 0 always holds attended
        positions, so in exact decode mode the poison reaches the slot's
        logits in the same tick and the isfinite guard fires.  Prism
        decode reads remote content through the means state, where raw
        page poison can go unseen, so injection is exact mode only.

        Only before decode ticks: there one poisoned page NaNs exactly
        its slot's row.  The packed tick's intra-tick pass folds every
        token's K/V under an additive mask, so a poisoned slot's
        second-layer K/V would NaN every decode row of the tick; the
        same-tick detection here means the scrub lands before a packed
        tick could read the page."""
        if (self._injector is None or not self._paged
                or self._hp.decode_mode != "exact"):
            return
        kv = self._kv
        cands = [st for st in self._sched.decoding()
                 if kv.slot_pages.get(st.slot)
                 and kv.table.refs[kv.slot_pages[st.slot][0]] == 1]
        if not cands or not self._injector.fire("page_poison"):
            return
        st = cands[self._injector.pick("page_poison", len(cands))]
        kv.poison_page(kv.slot_pages[st.slot][0])

    def _note_restart(self, st: RequestState) -> None:
        """The one re-prefill entry point (a lost restore, a quarantine),
        so the engine's restart count never drifts from the requests'."""
        st.reset_for_refill()
        self.stats.restarts += 1

    def _fail_active(self, st: RequestState, reason: str) -> None:
        """Fail an active request: scrub its private pages (NaN must not
        rejoin the free list), release its pages and slot, record the
        failure.  It never reaches ``results()``."""
        if self._paged:
            self._kv.scrub_slot(st.slot)
            self._kv.free(st.slot, None)   # never register the prompt
        else:
            self._kv.reset_row(st.slot)
        self._drop_replica(st.slot)
        self._sched.remove(st)
        self._failed[st.req.rid] = reason
        self.stats.failed_requests += 1

    def _quarantine(self, st: RequestState) -> None:
        """Non-finite logits in a decode row: quarantine exactly that
        slot.  Shared prefix pages are forked private, the slot's pages
        and state row zeroed, and the prompt prefilled again into the
        same pages (seeded sampling gives the same tokens).  After
        ``max_restarts`` the request fails instead."""
        self.stats.quarantined += 1
        if st.restarts >= self.config.max_restarts:
            self._fail_active(st, "max_restarts")
            return
        if self._paged:
            try:
                # the re-prefill writes from position 0 on; a shared
                # page must never see a write
                self._kv.ensure_writable(st.slot, 0,
                                         len(st.req.prompt) - 1)
            except RuntimeError:
                self._fail_active(st, "quarantine_out_of_pages")
                return
            self._kv.scrub_slot(st.slot)
        else:
            self._kv.reset_row(st.slot)
        self._note_restart(st)
        self._drop_replica(st.slot)

    # ------------------------------------------------------------------
    # the degraded mesh (shard loss)
    # ------------------------------------------------------------------
    def _drop_replica(self, slot: int) -> None:
        if self._replica is not None:
            self._replica.drop(slot)

    def _lose_shard(self, shard: int) -> None:
        """A ``shard_loss`` fault fired: one sequence shard's K/V is
        unreadable.  The degraded window opens for ``degraded_grace``
        ticks, and the prefix cache empties: its pages hold content on
        the lost shard, and every later hit would map it."""
        if shard in self._lost:
            return
        self._lost.add(shard)
        self.stats.shard_lost += 1
        self._degraded_left = self.config.degraded_grace
        if self._kv.prefix is not None:
            self._kv.prefix.clear()

    def _degraded_tick(self) -> str:
        """One tick with a sequence shard lost: the decoding requests go
        on through the degraded step (the lost shard's exact columns out
        of the combine, its positions served by Segment-Means columns).
        No admission, no prefill, no capture (it would read the lost
        shard) and NO eviction: a request that looks finished is held in
        its slot, so that its degraded tokens never reach ``results()``;
        recovery prefills it again and regenerates every token.  When the
        window closes, or nothing decodes, the tick recovers instead."""
        sch = self._sched
        decoding = [st for st in sch.decoding() if not st.finished()]
        if self._degraded_left <= 0 or not decoding:
            return self._recover_from_loss()
        self.stats.degraded_ticks += 1
        self._degraded_left -= 1
        tok = np.zeros(self.n_slots, np.int64)
        pos = np.full(self.n_slots, -1, np.int64)
        for st in decoding:
            tok[st.slot] = st.next_token
            pos[st.slot] = st.pos
        t0 = self.now()
        rows, bad = self._logits_host(self._decode_degraded(tok, pos))
        now = self.now()
        self.stats.step_latency.append(now - t0)
        self.stats.occupancy.append(len(sch.active) / self.n_slots)
        for st in decoding:
            if not bad[st.slot]:       # recovery resets it anyway
                self._advance_degraded(st, rows[st.slot], now)
        sch.note_decode()
        self.stats.t_end = self.now()
        return "degraded"

    def _advance_degraded(self, st: RequestState, logits_row, now) -> None:
        """Sample and keep the degraded token, but never finish or evict:
        the slot is held until ``_recover_from_loss`` resets it."""
        t = sample_token(logits_row, st.req.sampling, st.rng)
        st.generated.append(t)
        self.stats.generated_tokens += 1
        if st.ttft is None:
            st.ttft = now - st.req.arrival
            self.stats.ttft.append(st.ttft)
        st.pos += 1
        st.next_token = t

    def _recover_from_loss(self) -> str:
        """Close the degraded window: every active request is prefilled
        again into its own pages (shared prefix pages forked private,
        the pages zeroed, ``reset_for_refill``), or fails if its
        restarts are spent or no page is left for the fork.  Spilled and
        suspended requests live in host memory and restore as usual."""
        for _slot, st in sorted(self._sched.active.items()):
            if st.restarts >= self.config.max_restarts:
                self._fail_active(st, "max_restarts")
                continue
            try:
                self._kv.ensure_writable(st.slot, 0,
                                         len(st.req.prompt) - 1)
            except RuntimeError:
                self._fail_active(st, "degraded_out_of_pages")
                continue
            self._kv.scrub_slot(st.slot)
            self._note_restart(st)
        if self._replica is not None:
            self._replica.drop_all()
        self._lost.clear()
        self._degraded_left = 0
        return "recovered"

    # ------------------------------------------------------------------
    # deadlines
    # ------------------------------------------------------------------
    def _miss(self, req, *, st: RequestState | None = None,
              now: float | None = None) -> None:
        self.stats.deadline_miss += 1
        cls = self.stats.deadline_miss_by_class
        cls[req.priority] = cls.get(req.priority, 0) + 1
        self._failed[req.rid] = "deadline"
        if st is not None and st.t_finish is None and now is not None:
            st.t_finish = now

    def _expire(self) -> None:
        """Cancel every request past its deadline, wherever it is: a
        future arrival, the fresh queue, the resume queue (spilled),
        suspended (spilled) or active.  Each path reclaims what that
        state holds (heap entry, queue place, store bytes, or pages,
        state row and slot), so a storm of deadlines leaks nothing."""
        now = self.now()
        dead = lambda req: (req.deadline is not None       # noqa: E731
                            and now >= req.deadline)
        expired = [e for e in self._pending if dead(e[2])]
        if expired:
            self._pending = [e for e in self._pending if not dead(e[2])]
            heapq.heapify(self._pending)
            for _, _, req in expired:
                self._miss(req)
        sch = self._sched
        for q in sch.queues.values():
            for req in [r for r in q if dead(r)]:
                q.remove(req)
                self._miss(req)
        for q in sch.resume.values():
            for st in [s for s in q if dead(s.req)]:
                q.remove(st)
                if self._store is not None:
                    self._store.drop(st.req.rid)
                self._miss(st.req, st=st, now=now)
        for rid in [r for r, s in self._suspended.items() if dead(s.req)]:
            st = self._suspended.pop(rid)
            self._store.drop(rid)
            self._miss(st.req, st=st, now=now)
        # active: pages, state row, slot; the prompt is never registered
        # for prefix reuse (its pages may be partly prefilled)
        for st in [s for s in list(sch.active.values()) if dead(s.req)]:
            if self._paged:
                self._kv.free(st.slot, None)
            else:
                self._kv.reset_row(st.slot)
            self._drop_replica(st.slot)
            sch.remove(st)
            self._miss(st.req, st=st, now=now)
        self._has_deadlines = any(r.deadline is not None
                                  for r in self._live_requests())

    def _live_requests(self):
        """Every unfinished Request the engine still holds."""
        for _, _, req in self._pending:
            yield req
        for q in self._sched.queues.values():
            yield from q
        for q in self._sched.resume.values():
            for st in q:
                yield st.req
        for st in self._sched.active.values():
            yield st.req
        for st in self._suspended.values():
            yield st.req

    # ------------------------------------------------------------------
    # offload controls
    # ------------------------------------------------------------------
    def preempt(self, rid: int) -> bool:
        """Preempt an active request into the host store; it queues for
        resume.  The tick preempts under priority pressure by itself;
        this is for tests, draining and outside policies."""
        st = self._find_active(self._decide(rid))
        if st is None or self._store is None:
            return False
        self._spill(st, requeue=True)
        return True

    def suspend(self, rid: int) -> bool:
        """Move an idle session to the host tier without queueing it: it
        holds no slot and no pages until ``resume(rid)``; ``run()`` does
        not wait for it."""
        rid = self._decide(rid)
        st = self._find_active(rid)
        if st is None or self._store is None:
            return False
        self._spill(st, requeue=False)
        self._suspended[rid] = st
        return True

    def resume(self, rid: int) -> bool:
        """Queue a suspended session again; its cache restores through
        admission on a tick with room."""
        st = self._suspended.pop(self._decide(rid), None)
        if st is None:
            return False
        self._sched.push_resume(st)
        return True

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it is: pending, queued, parked for
        resume, suspended or active.  Each path reclaims what that state
        holds, as the deadline sweep does (the prompt is never
        registered for prefix reuse).  An active request lands in
        ``failed()`` as 'cancelled'.  False if the rid is not live."""
        rid = self._decide(rid)
        for i, (_, r, _) in enumerate(self._pending):
            if r == rid:
                self._pending.pop(i)
                heapq.heapify(self._pending)
                self.stats.cancelled += 1
                return True
        if self._sched.cancel(rid) is not None:
            if self._store is not None:
                self._store.drop(rid)
            self.stats.cancelled += 1
            return True
        if self._suspended.pop(rid, None) is not None:
            self._store.drop(rid)
            self.stats.cancelled += 1
            return True
        st = self._find_active(rid)
        if st is None:
            return False
        if self._paged:
            self._kv.free(st.slot, None)
        else:
            self._kv.reset_row(st.slot)
        self._drop_replica(st.slot)
        self._sched.remove(st)
        st.t_finish = self.now()
        self._failed[rid] = "cancelled"
        self.stats.cancelled += 1
        return True

    # ------------------------------------------------------------------
    # snapshot and restore
    # ------------------------------------------------------------------
    def snapshot(self) -> EngineSnapshot:
        """The engine's whole serving state on the host: every live
        slot's pages and state row (the offload tier's gather, leaving
        the slot its pages), the queues, pending arrivals, suspended
        sessions, the store's entries, the requests' sampler RNGs (in
        the deep-copied states), stats and the fault injector's place.
        Called between steps.  On a mesh the payloads are the rank's
        shard, and the snapshot names its mesh shape and rank."""
        if not self._paged:
            raise ValueError(
                "snapshot requires the paged cache (paged=True): the "
                "journal rides the page gather")
        assert not self._plans and not self._from_store, (
            "snapshot mid-admission: call between engine steps")
        if self._lost:
            raise ValueError(
                "snapshot during a degraded window (a shard is lost): the "
                "page gather would read the lost shard; recover first")
        active = [(slot, copy.deepcopy(st), self._kv.extract_slot(slot),
                   len(self._kv.slot_pages[slot]))
                  for slot, st in sorted(self._sched.active.items())]
        self._note("snapshot")
        return EngineSnapshot(
            now=self.now(),
            next_rid=self._next_rid,
            active=active,
            queues={p: list(q) for p, q in self._sched.queues.items()
                    if q},
            resume={p: copy.deepcopy(q)
                    for p, q in self._sched.resume.items() if q},
            pending=copy.deepcopy(self._pending),
            suspended=copy.deepcopy(self._suspended),
            store_entries=(copy.deepcopy(self._store.entries())
                           if self._store is not None else []),
            results=copy.deepcopy(self._results),
            failed=dict(self._failed),
            stats=copy.deepcopy(self.stats),
            injector=copy.deepcopy(self._injector),
            decodes_since_prefill=self._sched._decodes_since_prefill,
            drain=self._sched.drain,
            has_deadlines=self._has_deadlines,
            mesh=self._where())

    def _where(self) -> tuple | None:
        """(mesh shape, rank) of this engine, None in one process."""
        return None if self.mesh is None else (self.mesh.shape,
                                               self.mesh.rank)

    def restore(self, snap: EngineSnapshot) -> None:
        """Rebuild a snapshot's serving state in this engine, which must
        be fresh and built with the same config and weights.  Each live
        slot reserves its page count through admission and takes its
        payload; the page ids may differ, which the per-tick maps hide.
        The prefix cache starts cold (losing it costs prefill, never
        tokens).  The snapshot is not consumed.  On a mesh each rank
        restores its own snapshot: one cut on another mesh shape or rank
        (or in one process) is refused."""
        if not self._paged:
            raise ValueError("restore requires the paged cache")
        if snap.mesh != self._where():
            raise ValueError(
                f"a snapshot of (mesh shape, rank) {snap.mesh} restores "
                f"into an engine of the same, not {self._where()}: its "
                "payloads are that rank's shard")
        if self._next_rid or self._sched.active or self._sched.queued:
            raise ValueError("restore target must be a fresh engine")
        snap = copy.deepcopy(snap)     # keep the journal re-restorable
        sch = self._sched
        sch.queues = {p: deque(q) for p, q in snap.queues.items()}
        sch.resume = snap.resume
        sch.drain = snap.drain
        sch._decodes_since_prefill = snap.decodes_since_prefill
        self._pending = snap.pending
        heapq.heapify(self._pending)
        self._suspended = snap.suspended
        if self._store is not None:
            self._store.adopt(snap.store_entries)
        for slot, st, payload, n_pages in snap.active:
            key = ("__restore__", slot)
            if not self._kv.reserve(key, AdmitPlan(total_pages=n_pages,
                                                   fresh_pages=n_pages)):
                raise RuntimeError(
                    f"restore out of pages binding slot {slot}")
            self._kv.bind(key, slot)
            st.slot = slot
            self._kv.inject_slot(slot, payload)
            sch.active[slot] = st
            sch.free_slots.remove(slot)
        self._results = snap.results
        self._failed = snap.failed
        self.stats = snap.stats
        self._next_rid = snap.next_rid
        self._has_deadlines = snap.has_deadlines
        if snap.injector is not None:
            self._injector = snap.injector
            if self._store is not None:
                self._store._injector = snap.injector
        # the clock resumes at the cut, so arrivals and deadlines keep
        # their meaning
        self._t0 = self._read_clock() - snap.now

    def failed(self) -> dict:
        """{rid: reason} of the requests the engine gave up on (deadline,
        max_restarts, cancelled): disjoint from ``results()``."""
        return dict(self._failed)

    # ------------------------------------------------------------------
    # ticks
    # ------------------------------------------------------------------
    def _advance_decode(self, st, logits_row, now):
        """Sample one token for a decode-phase request and advance it."""
        self._advance_token(st, sample_token(logits_row, st.req.sampling,
                                             st.rng), now)

    def _advance_token(self, st, t: int, now):
        """Append a sampled token; record the time to the first token;
        at the end free the pages (registering the prompt's full pages
        for prefix reuse) and the slot."""
        st.generated.append(t)
        self.stats.generated_tokens += 1
        if st.ttft is None:
            st.ttft = now - st.req.arrival
            self.stats.ttft.append(st.ttft)
        st.pos += 1
        st.next_token = t
        if st.finished():
            if self._paged:
                self._kv.free(st.slot, st.req.prompt
                              if self._prefix_on else None)
            self._drop_replica(st.slot)
            self._sched.evict(st, now)
            self._results[st.req.rid] = st
            self.stats.completed += 1

    def _packed_tick(self) -> str:
        """One packed tick: every decode token plus prompt tokens of every
        mid-prefill request in one (token_budget,) batch (dead tail
        entries slot = -1).  Decode rows sample; prefill rows advance
        their request's offset, and the rewind follows the last one."""
        sch = self._sched
        decode, prefill = sch.plan_tick(self.token_budget)
        tb = self.token_budget
        tok = np.zeros(tb, np.int64)
        slot = np.full(tb, -1, np.int64)
        pos = np.full(tb, -1, np.int64)
        off = np.full(tb, -1, np.int64)
        pre = np.zeros(tb, np.int64)
        for i, st in enumerate(decode):
            tok[i], slot[i] = st.next_token, st.slot
            pos[i] = off[i] = st.pos
        i = len(decode)
        n_prefill = 0
        for st, take in prefill:
            o = st.nprefilled
            tok[i:i + take] = st.req.prompt[o:o + take]
            slot[i:i + take] = st.slot
            pos[i:i + take] = np.arange(o, o + take)
            off[i:i + take] = o
            pre[i:i + take] = 1
            i += take
            n_prefill += take
        t0 = self.now()
        rows, bad = self._logits_host(self._packed(tok, slot, pos, off,
                                                   pre))
        now = self.now()
        self.stats.step_latency.append(now - t0)
        self.stats.occupancy.append(len(sch.active) / self.n_slots)
        self.stats.packed_ticks += 1
        self.stats.packed_decode_tokens += len(decode)
        self.stats.packed_prefill_tokens += n_prefill
        self.stats.prefill_tokens += n_prefill
        # only decode rows sample, so only they quarantine
        for j, st in enumerate(decode):
            if self._nan_guard and bad[j]:
                self._quarantine(st)
            else:
                self._advance_decode(st, rows[j], now)
        for st, take in prefill:
            st.nprefilled += take
            if not st.prefilling:
                st.begin_decode()          # rewind: re-feed last token
        self.stats.t_end = self.now()
        return "packed"

    def _chunk_step(self) -> str:
        """Advance every mid-prefill request by one chunk, each at its own
        offset, in one call."""
        sch = self._sched
        states = sch.prefilling()
        c = self.chunk_len
        tokens = np.full((self.n_slots, c), self.pad_id, np.int64)
        off = np.full(self.n_slots, -1, np.int64)
        nreal = np.zeros(self.n_slots, np.int64)
        for st in states:
            take = min(c, len(st.req.prompt) - st.nprefilled)
            tokens[st.slot, :take] = st.req.prompt[
                st.nprefilled:st.nprefilled + take]
            off[st.slot] = st.nprefilled
            nreal[st.slot] = take
        self._chunk(tokens, off, nreal)
        for st in states:
            st.nprefilled += int(nreal[st.slot])
            if not st.prefilling:
                st.begin_decode()          # rewind: re-feed last token
        sch.note_chunk()
        real = int(nreal.sum())
        self.stats.prefills += 1
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += real
        self.stats.chunk_tokens_real += real
        self.stats.chunk_tokens_padded += self.n_slots * c - real
        self.stats.t_end = self.now()
        return "prefill"

    def _padded_flush(self) -> str:
        """The padded admission: every admitted prompt right-padded to
        ``prefill_len``, one monolithic prefill whose rows come out at
        decode capacity, each row spliced into its slot, decoding from
        the rewind."""
        sch = self._sched
        batch = np.full((self.n_slots, self.prefill_len), self.pad_id,
                        np.int64)
        states = sch.admit(self.now())
        for i, st in enumerate(states):
            batch[i, :len(st.req.prompt)] = st.req.prompt
        fresh = self._prefill(batch)
        if self.mesh is not None and self.layout.ba:
            # the rank holds its block of the batch rows and of the
            # slots, which need not be the same rows: every rank takes
            # every row
            grp = self.mesh.group(self.layout.ba)
            fresh = [{k: comm.all_gather(t, grp, "engine", dim=0)
                      for k, t in c.items()} for c in fresh]
        for i, st in enumerate(states):
            self._kv.insert_row(fresh, i, st.slot)
            st.begin_decode()
            self.stats.prefill_tokens += len(st.req.prompt)
        self.stats.prefills += 1
        self.stats.t_end = self.now()
        return "prefill"

    # ------------------------------------------------------------------
    # drive to completion
    # ------------------------------------------------------------------
    def run(self) -> dict:
        """Step until every submitted request (future arrivals included)
        has finished.  Returns {rid: [generated token ids]}."""
        while True:
            if self.step() != "idle":
                continue
            if self._pending:
                # nothing runnable before the next arrival: wait for it,
                # or fast-forward a clock that does not follow wall time
                before = self.now()
                dt = self.next_arrival() - before
                if dt > 0:
                    time.sleep(min(dt, 0.05))
                    if self.now() <= before:
                        self._t0 -= dt
                continue
            if not self._sched.has_work:
                break
        return self.results()

    def results(self) -> dict:
        return {rid: list(st.generated)
                for rid, st in sorted(self._results.items())}

    def request_stats(self) -> dict:
        return {rid: {"ttft_s": st.ttft,
                      "latency_s": (st.t_finish - st.req.arrival
                                    if st.t_finish is not None else None),
                      "tokens": len(st.generated)}
                for rid, st in sorted(self._results.items())}
