"""Request-level scheduling for the continuous-batching engine.

FIFO admission over a fixed pool of decode slots.  Admission assigns a slot at once (host bookkeeping);
the prompt is then prefilled *packed* or *in chunks*.

In **packed** mode (the default) ``plan_tick(token_budget)`` gives every
decoding slot its one decode token first, then fills the rest of the
budget with prompt tokens across all mid-prefill requests in ascending
slot order: one flat ragged batch per tick, decode tokens first, at
most one a slot, the contract ``runtime.ticks.packed_step`` assumes.

In **chunked** mode a chunk call runs at most once per
``decode_per_prefill`` decode steps once streams are decoding, and at
once while nothing decodes; every mid-prefill row advances in the one
call, each at its own offset.

A copy of the reference's ``serving/scheduler.py`` without what the
port does not serve yet: priority classes, deadlines, preemption and
resume queues, the padded flush (ROADMAP queue 1, items 9-11) and gang
admission (the static-batching baseline, item 14).
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


class RequestState:
    """Per-request serving state while a request owns a slot.

    A request starts in the *prefill* phase: ``nprefilled`` counts the
    prompt tokens laid down (a prefix hit starts it past the shared
    pages).  ``begin_decode`` is the *rewind*: the slot decodes from
    ``pos = len(prompt) - 1``, re-feeding the last prompt token, whose
    K/V row the first decode step rewrites in place (the same values)
    while it yields the next-token logits."""
    __slots__ = ("req", "slot", "pos", "next_token", "nprefilled",
                 "generated", "rng", "t_admit", "ttft", "t_finish")

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

    @property
    def prefilling(self) -> bool:
        return self.nprefilled < len(self.req.prompt)

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
    ticks_idle: int = 0                # step() calls that found no work
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
            "ticks_idle": self.ticks_idle,
        }


class FifoScheduler:
    """FIFO queue, slot pool and interleave policy."""

    def __init__(self, n_slots: int, *, decode_per_prefill: int = 4):
        if n_slots < 1:
            raise ValueError(f"n_slots {n_slots} < 1")
        self.n_slots = n_slots
        self.decode_per_prefill = max(1, decode_per_prefill)
        self.queue: deque = deque()    # Requests, FIFO
        self.free_slots: list = list(range(n_slots))   # ascending order
        self.active: dict = {}                         # slot -> RequestState
        self._decodes_since_prefill = self.decode_per_prefill

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def queued(self) -> int:
        return len(self.queue)

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
    def want_admit(self) -> bool:
        """Admission is host bookkeeping, never rate-limited."""
        return bool(self.queued and self.free_slots)

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

    def note_decode(self):
        self._decodes_since_prefill += 1

    def note_chunk(self):
        self._decodes_since_prefill = 0

    # -- admission -----------------------------------------------------------
    def peek_admit(self) -> Request | None:
        """The next admission candidate without popping it: the queue's
        head."""
        return self.queue[0] if self.queue else None

    def admit(self, now: float, gate=None) -> list:
        """Pop candidates into free slots (lowest slot first) and return
        the admitted RequestStates in admission order.  ``gate(request)
        -> bool`` is the page-aware check, consulted on the head before
        the pop; False stops admission for this call (strict order: a
        later, smaller request never jumps an out-of-pages head)."""
        states = []
        while self.free_slots:
            req = self.peek_admit()
            if req is None:
                break
            if gate is not None and not gate(req):
                break
            self.queue.popleft()
            st = RequestState(req, self.free_slots.pop(0), now)
            self.active[st.slot] = st
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
