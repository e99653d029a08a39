"""Request-level scheduling for the continuous-batching engine.

FIFO admission within priority classes over a fixed pool of decode
slots.  Admission assigns a slot at once (host bookkeeping); the prompt
is then prefilled *packed* or *in chunks*.

In **packed** mode (the default) ``plan_tick(token_budget)`` gives every
decoding slot its one decode token first, then fills the rest of the
budget with prompt tokens across all mid-prefill requests in ascending
slot order: one flat ragged batch per tick, decode tokens first, at
most one a slot, the contract ``runtime.ticks.packed_step`` assumes.

In **chunked** mode a chunk call runs at most once per
``decode_per_prefill`` decode steps once streams are decoding, and at
once while nothing decodes; every mid-prefill row advances in the one
call, each at its own offset.

**Priority classes and preemption**: every request carries an integer
``priority`` (higher = more urgent; 0 by default keeps the scheduler
exactly FIFO).  Admission serves the highest non-empty class first;
within a class, *resume* candidates (requests preempted earlier, in
order of original arrival) go before fresh ones, and fresh ones stay
FIFO.  ``pick_victim`` is the preempt policy: when a higher-priority
candidate is blocked (no slot, or out of pages) the engine spills the
lowest-priority active request with the most deadline slack and the
most work left to the host KV store (``runtime/offload.py``) and parks
its RequestState on the resume queue.  A preempted request keeps its
RequestState (generated tokens, decode position, sampler RNG), so a
restore continues bit-identically.

**Gang admission** (``gang=True``, the static-batching baseline) admits
only a full gang into an empty pool, or what is left once no more
arrivals come (``drain``).  The padded flush (``want_prefill``) admits
and prefills a whole batch at once under the same interleave bound.

A copy of the reference's ``serving/scheduler.py``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .sampling import SamplingParams


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: tuple
    max_new_tokens: int
    eos_id: int | None = None
    sampling: SamplingParams = SamplingParams()
    arrival: float = 0.0             # absolute clock time of arrival
    priority: int = 0                # higher = more urgent; 0 = default
    deadline: float | None = None    # absolute clock time; None = never


class RequestState:
    """Per-request serving state while a request owns a slot.

    A request starts in the *prefill* phase: ``nprefilled`` counts the
    prompt tokens laid down (a prefix hit starts it past the shared
    pages).  ``begin_decode`` is the *rewind*: the slot decodes from
    ``pos = len(prompt) - 1``, re-feeding the last prompt token, whose
    K/V row the first decode step rewrites in place (the same values)
    while it yields the next-token logits."""
    __slots__ = ("req", "slot", "pos", "next_token", "nprefilled",
                 "generated", "rng", "t_admit", "ttft", "t_finish",
                 "restarts", "epoch", "inflight")

    def __init__(self, req: Request, slot: int, t_admit: float):
        self.req = req
        self.slot = slot
        self.pos = -1                  # decode position; -1 while prefilling
        self.next_token = None
        self.nprefilled = 0            # prompt tokens laid down so far
        self.generated: list = []
        self.rng = req.sampling.make_rng()
        self.t_admit = t_admit
        self.ttft = None
        self.t_finish = None
        self.restarts = 0              # re-prefills (lost restore, NaN)
        # bumped on every rewind to zero: the streaming engine stamps its
        # in-flight rows with it, so a result that raced a quarantine or
        # restart reconciles as stale
        self.epoch = 0
        self.inflight = 0              # rows dispatched, not reconciled

    @property
    def prefilling(self) -> bool:
        return self.nprefilled < len(self.req.prompt)

    @property
    def remaining(self) -> int:
        """Tokens of work left (prompt still to prefill and tokens still
        to generate): the preempt policy's tie-breaker."""
        return ((len(self.req.prompt) - self.nprefilled)
                + (self.req.max_new_tokens - len(self.generated)))

    def reset_for_refill(self):
        """Restart from scratch after the offload store lost this
        request's spilled KV, or a quarantine: re-prefill the prompt and
        regenerate from a fresh sampler RNG (greedy or seeded sampling
        makes the rerun give the same tokens).  ``ttft`` is kept: the
        first token was already seen and is not counted twice."""
        self.pos = -1
        self.next_token = None
        self.nprefilled = 0
        self.generated = []
        self.rng = self.req.sampling.make_rng()
        self.restarts += 1
        self.epoch += 1                # in-flight rows are stale now

    def begin_decode(self):
        """Prefill done: rewind to the last prompt token and decode."""
        self.nprefilled = len(self.req.prompt)
        self.pos = len(self.req.prompt) - 1
        self.next_token = int(self.req.prompt[-1])

    def finished(self) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_id
        return eos is not None and self.generated and self.generated[-1] == eos


#: cap on the per-step and per-request sample lists (a long-running
#: engine keeps the most recent window)
STATS_WINDOW = 65536


@dataclass
class EngineStats:
    """Throughput and latency counters the engine accumulates."""
    n_slots: int = 0
    ttft: deque = field(                               # arrival -> 1st token
        default_factory=lambda: deque(maxlen=STATS_WINDOW))
    step_latency: deque = field(                       # per tick (s)
        default_factory=lambda: deque(maxlen=STATS_WINDOW))
    occupancy: deque = field(                          # active/slots per tick
        default_factory=lambda: deque(maxlen=STATS_WINDOW))
    prefills: int = 0                  # prefill program calls (chunk)
    prefill_chunks: int = 0            # chunked-mode calls among them
    prefill_tokens: int = 0            # REAL prompt tokens laid down
    chunk_tokens_real: int = 0         # real rows x tokens in chunk calls
    chunk_tokens_padded: int = 0       # padded waste in chunk calls
    decode_steps: int = 0
    packed_ticks: int = 0              # packed-program calls
    packed_decode_tokens: int = 0      # real decode tokens packed
    packed_prefill_tokens: int = 0     # real prompt tokens packed
    completed: int = 0
    generated_tokens: int = 0
    out_of_pages: int = 0              # admissions blocked on the free list
    prefix_hits: int = 0               # admissions that mapped a prefix
    prefix_tokens_saved: int = 0       # prompt tokens never prefilled
    preemptions: int = 0               # spills to the host KV store
    spilled_pages: int = 0             # pages gathered device -> host
    restore_hits: int = 0              # resumes injected from the store
    restore_misses: int = 0            # resumes re-prefilled (entry lost)
    restarts: int = 0                  # reset_for_refill invocations
    deadline_miss: int = 0             # requests cancelled past deadline
    deadline_miss_by_class: dict = field(default_factory=dict)
    quarantined: int = 0               # non-finite decode rows caught
    failed_requests: int = 0           # max_restarts / unrecoverable
    faults_injected: int = 0           # chaos faults actually fired
    faults_by_kind: dict = field(default_factory=dict)  # kind -> fired
    store_get_retries: int = 0         # KVStore reads re-tried (restore)
    shard_lost: int = 0                # shard_loss faults that degraded
    degraded_ticks: int = 0            # ticks served on a degraded mesh
    cancelled: int = 0                 # requests cancelled by the caller
    ticks_idle: int = 0                # step() calls that found no work
    tokens_streamed: int = 0           # tokens delivered to TokenStreams
    host_busy_s: float = 0.0           # host bookkeeping (streaming loop)
    loop_wall_s: float = 0.0           # non-idle streaming loop wall time
    t_start: float | None = None
    t_end: float | None = None

    def summary(self) -> dict:
        span = ((self.t_end - self.t_start)
                if self.t_start is not None and self.t_end is not None
                else 0.0)
        pct = (lambda xs, q: float(np.percentile(list(xs), q))
               if xs else 0.0)
        return {
            "requests": self.completed,
            "elapsed_s": span,
            "requests_per_s": self.completed / span if span else 0.0,
            "decode_tokens_per_s": (self.generated_tokens / span
                                    if span else 0.0),
            "ttft_p50_s": pct(self.ttft, 50),
            "ttft_p90_s": pct(self.ttft, 90),
            "ttft_p99_s": pct(self.ttft, 99),
            "ttft_max_s": max(self.ttft) if self.ttft else 0.0,
            "step_ms_p50": 1e3 * pct(self.step_latency, 50),
            "occupancy": (float(np.mean(self.occupancy))
                          if self.occupancy else 0.0),
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "chunk_tokens_real": self.chunk_tokens_real,
            "chunk_tokens_padded": self.chunk_tokens_padded,
            "decode_steps": self.decode_steps,
            "packed_ticks": self.packed_ticks,
            "packed_decode_tokens": self.packed_decode_tokens,
            "packed_prefill_tokens": self.packed_prefill_tokens,
            "out_of_pages": self.out_of_pages,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "preemptions": self.preemptions,
            "spilled_pages": self.spilled_pages,
            "restore_hits": self.restore_hits,
            "restore_misses": self.restore_misses,
            "restarts": self.restarts,
            "deadline_miss": self.deadline_miss,
            "deadline_miss_by_class": {
                str(k): v for k, v
                in sorted(self.deadline_miss_by_class.items())},
            "quarantined": self.quarantined,
            "failed_requests": self.failed_requests,
            "faults_injected": self.faults_injected,
            "faults_by_kind": {k: v for k, v
                               in sorted(self.faults_by_kind.items())},
            "store_get_retries": self.store_get_retries,
            "shard_lost": self.shard_lost,
            "degraded_ticks": self.degraded_ticks,
            "cancelled": self.cancelled,
            "ticks_idle": self.ticks_idle,
            "tokens_streamed": self.tokens_streamed,
            # the host's share of the streaming loop's wall time (0 when
            # the streaming loop never ran)
            "host_overhead_fraction": (self.host_busy_s / self.loop_wall_s
                                       if self.loop_wall_s > 0 else 0.0),
        }


class FifoScheduler:
    """FIFO-within-priority queues, slot pool and interleave policy.

    With every request at priority 0 and no preemption this is a plain
    FIFO scheduler.  Priorities add per-class queues; preemption adds
    per-class resume queues of parked RequestStates."""

    def __init__(self, n_slots: int, *, decode_per_prefill: int = 4,
                 gang: bool = False):
        if n_slots < 1:
            raise ValueError(f"n_slots {n_slots} < 1")
        self.n_slots = n_slots
        self.decode_per_prefill = max(1, decode_per_prefill)
        self.gang = gang
        self.queues: dict = {}         # priority -> deque[Request], FIFO
        self.resume: dict = {}         # priority -> [RequestState] by arrival
        self.free_slots: list = list(range(n_slots))   # ascending order
        self.active: dict = {}                         # slot -> RequestState
        self.drain = False        # no more arrivals expected (gang flushes)
        self._decodes_since_prefill = self.decode_per_prefill

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request):
        self.queues.setdefault(req.priority, deque()).append(req)

    @property
    def queued(self) -> int:
        """Pending admissions: fresh requests and parked preemptees."""
        return (sum(len(q) for q in self.queues.values())
                + sum(len(q) for q in self.resume.values()))

    @property
    def has_work(self) -> bool:
        return bool(self.queued or self.active)

    # -- views -------------------------------------------------------------
    def prefilling(self) -> list:
        """Mid-prefill RequestStates, ascending slot order."""
        return [st for _, st in sorted(self.active.items())
                if st.prefilling]

    def decoding(self) -> list:
        """Decode-phase RequestStates, ascending slot order."""
        return [st for _, st in sorted(self.active.items())
                if not st.prefilling]

    # -- policy ------------------------------------------------------------
    def _gang_ready(self) -> bool:
        """Static batching admits only a full gang into an EMPTY pool (or
        the remainder once no more arrivals come)."""
        return not self.active and (self.queued >= self.n_slots
                                    or self.drain)

    def want_admit(self) -> bool:
        """Admission is host bookkeeping, never rate-limited, except in
        gang mode."""
        if not self.queued or not self.free_slots:
            return False
        return self._gang_ready() if self.gang else True

    def plan_tick(self, token_budget: int) -> tuple:
        """The token-budget plan of one packed tick: every decoding slot's
        token first, then prompt tokens across all mid-prefill requests
        in ascending slot order, each taking min(remaining prompt,
        remaining budget).  Returns ``(decode_states, [(prefill_state,
        n_tokens), ...])``; the total never exceeds ``token_budget``."""
        decode = self.decoding()
        budget = token_budget - len(decode)
        assert budget >= 0, (
            f"token_budget {token_budget} < {len(decode)} decoding "
            "slots: the engine keeps token_budget >= n_slots")
        prefill = []
        for st in self.prefilling():
            if budget <= 0:
                break
            take = min(budget, len(st.req.prompt) - st.nprefilled)
            if take > 0:
                prefill.append((st, take))
                budget -= take
        return decode, prefill

    def want_chunk(self) -> bool:
        """Run a prefill chunk now?  Always while nothing decodes; else at
        most one chunk per ``decode_per_prefill`` decode steps."""
        if not any(st.prefilling for st in self.active.values()):
            return False
        if not any(not st.prefilling for st in self.active.values()):
            return True
        return self._decodes_since_prefill >= self.decode_per_prefill

    def want_prefill(self) -> bool:
        """The padded flush: admit and prefill a whole batch as one step,
        under the same interleave bound (gang mode: a full gang)."""
        if not self.queued or not self.free_slots:
            return False
        if self.gang:
            return self._gang_ready()
        if not self.active:
            return True
        return self._decodes_since_prefill >= self.decode_per_prefill

    def note_decode(self):
        self._decodes_since_prefill += 1

    def note_chunk(self):
        self._decodes_since_prefill = 0

    # -- admission order ---------------------------------------------------
    def peek_admit(self):
        """The next admission candidate without popping it: the highest
        non-empty priority class first; within a class, resume
        candidates (parked RequestStates, by original arrival: they
        already hold progress) before fresh Requests, each FIFO.
        Returns a Request, a RequestState, or None."""
        for prio in sorted(set(self.resume) | set(self.queues),
                           reverse=True):
            if self.resume.get(prio):
                return self.resume[prio][0]
            if self.queues.get(prio):
                return self.queues[prio][0]
        return None

    def _pop_head(self, cand) -> None:
        """Remove the candidate ``peek_admit`` just returned."""
        if isinstance(cand, RequestState):
            q = self.resume[cand.req.priority]
            assert q[0] is cand
            q.pop(0)
        else:
            q = self.queues[cand.priority]
            assert q[0] is cand
            q.popleft()

    # -- transitions -------------------------------------------------------
    def admit(self, now: float, gate=None) -> list:
        """Pop candidates into free slots (lowest slot first) and return
        the admitted RequestStates in admission order, candidates in
        ``peek_admit``'s order.  ``gate(candidate) -> bool`` is the
        page-aware check, consulted on the head before the pop; False
        stops admission for this call (strict order: a later, smaller
        request never jumps an out-of-pages head).  A True gate may
        reserve resources, so the pop follows it.  A candidate is a
        Request (fresh) or a RequestState (a resume from the offload
        store), which keeps its progress and is bound to the new slot."""
        states = []
        while self.free_slots:
            cand = self.peek_admit()
            if cand is None:
                break
            if gate is not None and not gate(cand):
                break
            self._pop_head(cand)
            slot = self.free_slots.pop(0)
            if isinstance(cand, RequestState):
                st = cand
                st.slot = slot
            else:
                st = RequestState(cand, slot, now)
            self.active[slot] = st
            states.append(st)
        if states:
            self._decodes_since_prefill = 0
        return states

    def evict(self, st: RequestState, now: float):
        """Release a finished request's slot back to the pool."""
        assert self.active.get(st.slot) is st
        del self.active[st.slot]
        st.t_finish = now
        self.free_slots.append(st.slot)
        self.free_slots.sort()

    # -- preemption --------------------------------------------------------
    def pick_victim(self, below_priority: int, now: float = 0.0):
        """Preempt policy: among active requests of priority strictly
        below ``below_priority``, the lowest-priority one with the most
        deadline slack (``deadline - now - remaining``; no deadline is
        infinite slack, so work without one goes before anything racing
        a deadline), then the most work left (ties: the highest rid, the
        latest arrival).  Decode-phase requests are preferred (spilling
        one frees a whole row at no recompute); a mid-prefill victim only
        when nothing decodes.  None when no strictly lower-priority
        request is active (equal-priority preemption would thrash)."""
        cands = [st for st in self.active.values()
                 if st.req.priority < below_priority]
        if not cands:
            return None
        decode = [st for st in cands if not st.prefilling]
        pool = decode or cands

        def slack(st):
            if st.req.deadline is None:
                return float("inf")
            return st.req.deadline - now - st.remaining

        return max(pool, key=lambda st: (-st.req.priority, slack(st),
                                         st.remaining, st.req.rid))

    def remove(self, st: RequestState) -> None:
        """Detach an active request from its slot without finishing it
        (the spill half of preempt and suspend; the caller decides
        where the RequestState goes next)."""
        assert self.active.get(st.slot) is st
        del self.active[st.slot]
        self.free_slots.append(st.slot)
        self.free_slots.sort()
        st.slot = -1

    def push_resume(self, st: RequestState) -> None:
        """Park a spilled RequestState for re-admission, its class's
        resume queue kept in order of original arrival (the earliest
        preemptee restores first however often it was bounced)."""
        q = self.resume.setdefault(st.req.priority, [])
        q.append(st)
        q.sort(key=lambda s: (s.req.arrival, s.req.rid))

    def preempt(self, st: RequestState) -> None:
        """Spill-side bookkeeping: free the slot and queue the state for
        resume (the engine has spilled its KV to the store)."""
        self.remove(st)
        self.push_resume(st)

    def cancel(self, rid: int):
        """Remove a request that is not active (queued fresh or parked
        for resume) by rid.  Returns the removed Request or
        RequestState, or None if the rid is not waiting here; the engine
        cancels active requests (``ServingEngine.cancel``)."""
        for q in self.queues.values():
            for req in q:
                if req.rid == rid:
                    q.remove(req)
                    return req
        for q in self.resume.values():
            for st in q:
                if st.req.rid == rid:
                    q.remove(st)
                    return st
        return None
