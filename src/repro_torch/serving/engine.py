"""Continuous-batching serving engine over the port's cache and tick
programs, on one card.

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
    interleaved with decodes under ``decode_per_prefill``.

The cache is one ``KVCache``: the page pool and page table by default
(exact mode stores round-robin and shares prompt prefixes; prism mode
keeps the aligned placement and takes whole rows), or the dense rowset
with ``paged=False``, the oracle.  Attention in every program is exact
(the cross-shard stat combine), so the engine's tokens are the
sequential ones.

Not served yet (ROADMAP queue 1): the host offload tier and
preemption, fault injection, NaN quarantine, deadlines, snapshots (item
9), streaming (item 10), the degraded mesh (item 11), the padded
admission flush, other block kinds and frontends (item 12).
``EngineConfig`` and the engine refuse the ones a caller can ask for
with a ``ValueError`` that names the item; a tick whose decode logits
are not finite raises.
"""
from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import check_supported
from ..runtime.paging import make_paged_layout
from ..runtime.serve import (ServeHParams, make_kv_cache, make_layout,
                             paged_placement, serve_step)
from ..runtime.ticks import chunk_prefill_step, packed_step
from .sampling import SamplingParams, sample_token
from .scheduler import EngineStats, FifoScheduler, Request


@dataclass(frozen=True)
class EngineConfig:
    """Validated engine configuration, the one construction path of
    ``ServingEngine``.  ``__post_init__`` normalises the derived fields
    as the reference's does: ``chunk_len`` clamps to ``[1,
    prefill_len]``, ``token_budget`` defaults to ``n_slots + chunk_len``,
    ``prefix_cache`` defaults on where it is sound (the paged exact
    cache)."""
    n_slots: int
    prefill_len: int
    max_cache: int
    hp: ServeHParams = ServeHParams()
    decode_per_prefill: int = 4
    chunk_len: int = 64
    prefill_mode: str = "packed"
    token_budget: int | None = None
    pad_id: int = 0
    paged: bool = True                 # page-table cache (the default)
    page_tokens: int | None = None     # page size in token positions
    n_pages: int | None = None         # pool size (default: slot parity)
    prefix_cache: bool | None = None   # shared-prefix reuse
    offload: bool = False              # host offload tier: not ported
    faults: object = None              # fault injection: not ported

    def __post_init__(self):
        if self.offload:
            raise ValueError("offload (the host KV tier and preemption) is "
                             "not ported yet: ROADMAP queue 1, item 9")
        if self.faults is not None:
            raise ValueError("fault injection is not ported yet: ROADMAP "
                             "queue 1, item 9")
        if self.prefill_mode == "padded":
            raise ValueError("prefill_mode='padded' (the padded admission "
                             "flush) is not ported: ROADMAP queue 1, item 8 "
                             "(what is left of it)")
        if self.prefill_mode not in ("packed", "chunked"):
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
        ok_prefix = self.paged and self.hp.decode_mode == "exact"
        if self.prefix_cache is None:
            set_("prefix_cache", ok_prefix)
        elif self.prefix_cache and not ok_prefix:
            raise ValueError(
                "prefix_cache requires the paged cache in exact decode "
                f"mode (paged={self.paged}, "
                f"decode_mode={self.hp.decode_mode!r})")


class ServingEngine:
    """Multiplexes independent requests through a fixed pool of decode
    slots backed by one ``KVCache``.  ``n_seq`` is the number of
    sequence shards (the reference's mesh 'model' axis); the engine runs
    on the device of ``params``."""

    def __init__(self, cfg: ModelConfig, params, config: EngineConfig, *,
                 n_seq: int = 4, clock=time.monotonic):
        other = sorted(set(cfg.block_kinds) - {"attn"})
        if other:
            raise ValueError(
                f"the port's engine serves attention blocks only; arch "
                f"{cfg.name!r} has {other}: ROADMAP queue 1, item 12")
        if cfg.arch_type == "vlm" or cfg.frontend:
            raise ValueError(
                f"the port's engine serves token prompts only; arch "
                f"{cfg.name!r} (frontend={cfg.frontend!r}) needs "
                "embedding inputs: ROADMAP queue 1, item 12")
        check_supported(cfg)
        self.cfg, self.params, self.config = cfg, params, config
        self.device = params["embed"]["table"].device
        hp = config.hp
        self.n_slots, self.prefill_len = config.n_slots, config.prefill_len
        self.prefill_mode = config.prefill_mode
        self.chunk_len = config.chunk_len
        self.token_budget = int(config.token_budget)
        self.pad_id, self._clock, self._hp = config.pad_id, clock, hp

        # the paged placement depends on the decode mode alone, so the
        # aligned base layout seeds the page-size derivation
        base = make_layout(n_seq, config.max_cache, hp, config.prefill_len)
        self._paging = (self._derive_paging(base, config)
                        if config.paged else None)
        self.layout = make_layout(n_seq, config.max_cache, hp,
                                  config.prefill_len,
                                  paged_placement(hp, self._paging))
        self._paged = self._paging is not None
        self._prefix_on = bool(config.prefix_cache) and self._paged
        # paged prism takes whole rows and shares no prefix
        self._full_row = self._paged and hp.decode_mode == "prism"
        self._kv = make_kv_cache(cfg, self.layout, self.n_slots, hp,
                                 device=self.device, paging=self._paging,
                                 prefix_cache=self._prefix_on)
        self._sched = FifoScheduler(
            self.n_slots, decode_per_prefill=config.decode_per_prefill)
        self.stats = EngineStats(n_slots=self.n_slots)
        self._pending: list = []       # heap of (arrival, rid, Request)
        self._results: dict = {}       # rid -> RequestState
        self._plans: dict = {}         # rid -> reserved AdmitPlan
        self._next_rid = 0
        self._t0 = None                # clock origin (first submit/run)

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
        return serve_step(self.cfg, self.params, self._kv.storage,
                          self._tensor(tok), self._tensor(pos), self.layout,
                          self._hp, *self._maps())[0]

    def _packed(self, tok, slot, pos, off, pre):
        return packed_step(self.cfg, self.params, self._kv.storage,
                           *map(self._tensor, (tok, slot, pos, off, pre)),
                           self.layout, self._hp, *self._maps())[0]

    def _chunk(self, tokens, off, nreal):
        chunk_prefill_step(self.cfg, self.params, self._kv.storage,
                           *map(self._tensor, (tokens, off, nreal)),
                           self.layout, self._hp, *self._maps())

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def now(self) -> float:
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    def submit(self, prompt, *, max_new_tokens: int, eos_id=None,
               sampling: SamplingParams = SamplingParams(),
               arrival: float | None = None) -> int:
        """Queue one request.  ``arrival`` (engine-relative seconds) may
        lie in the future: the run loop holds the request back until the
        clock passes it, which is how Poisson traces are replayed."""
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
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id, sampling=sampling, arrival=arrival)
        # through the arrival-ordered heap, so a late submit with a past
        # arrival cannot jump earlier arrivals still waiting
        heapq.heappush(self._pending, (req.arrival, rid, req))
        self._release_arrivals()
        return rid

    def _release_arrivals(self):
        now = self.now()
        while self._pending and self._pending[0][0] <= now:
            self._sched.submit(heapq.heappop(self._pending)[2])

    def next_arrival(self) -> float | None:
        """Arrival time of the earliest request not yet released: what a
        logical-clock drive loop jumps to when the engine is idle."""
        return self._pending[0][0] if self._pending else None

    # ------------------------------------------------------------------
    # one engine iteration
    # ------------------------------------------------------------------
    def step(self) -> str:
        """One scheduler decision: a packed tick (chunked mode: a prefill
        chunk), a decode step, or nothing.  Returns 'packed', 'prefill',
        'decode' or 'idle'."""
        sch = self._sched
        self._release_arrivals()
        if self.stats.t_start is None:
            self.stats.t_start = self.now()
        if sch.want_admit():
            self._admit()
        if self.prefill_mode == "chunked":
            if sch.want_chunk():
                return self._chunk_step()
        elif any(st.prefilling for st in sch.active.values()):
            return self._packed_tick()
        decoding = sch.decoding()
        if not decoding:
            self.stats.ticks_idle += 1
            return "idle"
        tok = np.zeros(self.n_slots, np.int64)
        pos = np.full(self.n_slots, -1, np.int64)
        for st in decoding:
            tok[st.slot] = st.next_token
            pos[st.slot] = st.pos
        t0 = self.now()
        rows = self._logits_host(self._decode(tok, pos),
                                 [st.slot for st in decoding])
        now = self.now()
        self.stats.step_latency.append(now - t0)
        self.stats.occupancy.append(len(sch.active) / self.n_slots)
        self.stats.decode_steps += 1
        for st in decoding:
            self._advance_decode(st, rows[st.slot], now)
        sch.note_decode()
        self.stats.t_end = self.now()
        return "decode"

    @staticmethod
    def _logits_host(logits, decode_rows) -> np.ndarray:
        """The tick's logits on the host; raises if a decode row is not
        finite (there is no quarantine yet, ROADMAP queue 1, item 9)."""
        rows = logits.cpu().numpy()
        bad = [i for i in decode_rows if not np.isfinite(rows[i]).all()]
        if bad:
            raise RuntimeError(f"non-finite decode logits in rows {bad}")
        return rows

    # ------------------------------------------------------------------
    # admission (page-aware)
    # ------------------------------------------------------------------
    def _admit_gate(self, req) -> bool:
        """Page-aware admission check on the FIFO head: plan the
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

    def _admit(self) -> list:
        """Assign free slots to queued requests; in paged mode each binds
        its reserved pages, and a prefix hit starts its prompt past the
        tokens the shared pages hold."""
        states = self._sched.admit(
            self.now(), gate=self._admit_gate if self._paged else None)
        for st in states:
            if not self._paged:
                continue
            rid = st.req.rid
            self._kv.bind(rid, st.slot)
            plan = self._plans.pop(rid)
            if plan.covered:
                st.nprefilled = plan.covered
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_saved += plan.covered
        return states

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
        rows = self._logits_host(self._packed(tok, slot, pos, off, pre),
                                 range(len(decode)))
        now = self.now()
        self.stats.step_latency.append(now - t0)
        self.stats.occupancy.append(len(sch.active) / self.n_slots)
        self.stats.packed_ticks += 1
        self.stats.packed_decode_tokens += len(decode)
        self.stats.packed_prefill_tokens += n_prefill
        self.stats.prefill_tokens += n_prefill
        for j, st in enumerate(decode):
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
