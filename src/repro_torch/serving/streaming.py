"""The streaming front-end: the serving loop with host and device work
overlapped, on one card.

The synchronous loop (``ServingEngine.step``) serialises every tick:
plan on the host, run the tick, copy the whole ``(rows, V)`` logits to
the host, sample, repeat; the card idles while the host plans and
samples.  This loop takes that time out of the card's way:

* **One small copy home a tick.**  The tick's logits are reduced ON THE
  DEVICE to one ``(n_slots, 4)`` int32 array (``runtime/ticks.py::
  pack``): ``[token, valid, length, finite]`` a slot (the greedy argmax,
  whether the slot decoded, its cache length, the NaN verdict).  On the
  card it goes home with a ``non_blocking`` copy into a pinned buffer of
  the tick's pipeline stage, a CUDA event recorded after it; reconcile
  waits on that event and nothing else.
* **Non-blocking inputs.**  A tick's inputs (tokens, positions, slots,
  offsets, flags, the page and state maps) are written into the stage's
  pinned host buffer and go to the card in ONE ``non_blocking`` copy; the
  stage's event guards the buffer until that copy has run.  A plain
  ``torch.as_tensor(..., device=cuda)`` would wait for the tick in
  flight.  On the CPU the same code runs with plain buffers.
* **Double-buffered dispatch.**  Tick N+1 is planned from host state and
  dispatched BEFORE tick N's results are home; a decode token still in
  flight is spliced in on the device from tick N's array (``ticks.py::
  merge``).  The card's stream orders the ticks; the host reconciles
  tick N while tick N+1 computes.
* **Per-request streams.**  ``submit_stream`` returns an
  ``AsyncIterator[int]`` (``TokenStream``) that delivers tokens as their
  tick reconciles; ``cancel`` works in flight through the engine's
  release path.

Dispatching ahead never changes a token: positions and prompt progress
advance deterministically on the host, the device argmax takes the
first maximum as the synchronous engine's ``np.argmax`` does, and every
write ahead lands past the owner's reconciled frontier, masked until
rewritten.  State that rewinds (quarantine, restart) bumps
``RequestState.epoch``, so rows in flight reconcile as stale and are
dropped.

Overlap needs greedy sampling (the splice feeds the device argmax back).
A tick whose decode set holds a ``temperature > 0`` request runs
synchronously: the pipeline drains first and the full logits come home
for host sampling.  A fault plan (``EngineConfig.faults``) also keeps
the loop synchronous, since the faults' blast radii are defined per
synchronous tick; so the degraded mesh's 'degraded' and 'recovered'
ticks only ever run with nothing in flight.  Control-plane operations
that move or free cache state (preemption, suspend, deadline expiry,
snapshot, cancel) drain the pipeline first.  ``overlap`` alone decides
whether the loop dispatches ahead, on the card and on the CPU.

Over a mesh of ranks (an engine over a rank's ``MeshParams``) every
rank runs this loop in step: the result pack is made from the logits
``gather_logits`` gathered, so it is the same on every rank, and a
cancel or preemption in flight takes rank 0's request
(``ServingEngine._decide``) and is applied by every rank at the same
tick.  Rank 0's streams are the user's; every rank's are equal to them.
Over gloo a collective blocks the host until it completes, so the
overlap has little host time to hide there.

A copy of the reference's ``serving/streaming.py`` control flow.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime.ticks import merge, pack
from .engine import ServingEngine


class _Stage:
    """One pipeline stage's buffers: the pinned host staging of a tick's
    inputs and its device copy, and the pinned host buffer its result
    array comes home to, each with an event (on the card) that says when
    its copy has run.  Plain buffers on the CPU."""

    def __init__(self, n_in: int, n_slots: int, device):
        cuda = device.type == "cuda"
        self.host = torch.zeros(n_in, dtype=torch.int64, pin_memory=cuda)
        self.dev = torch.zeros(n_in, dtype=torch.int64, device=device)
        self.out = torch.zeros((n_slots, 4), dtype=torch.int32,
                               pin_memory=cuda)
        self.copied = torch.cuda.Event() if cuda else None
        self.landed = torch.cuda.Event() if cuda else None

    def inputs(self, arrays) -> list:
        """Stage the host ``arrays`` (int) and send them in one
        non-blocking copy; returns their device views, in order."""
        if self.copied is not None:
            self.copied.synchronize()  # the last copy out of ``host`` ran
        sizes = [a.size for a in arrays]
        n = sum(sizes)
        h = self.host.numpy()
        o = 0
        for a in arrays:
            h[o:o + a.size] = a.reshape(-1)
            o += a.size
        self.dev[:n].copy_(self.host[:n], non_blocking=True)
        if self.copied is not None:
            self.copied.record()
        return list(torch.split(self.dev[:n], sizes))

    def result(self, data) -> None:
        """Send the tick's ``(n_slots, 4)`` array home, non-blocking."""
        self.out.copy_(data, non_blocking=True)
        if self.landed is not None:
            self.landed.record()

    def get(self) -> np.ndarray:
        """The tick's array on the host: waits on its copy's event."""
        if self.landed is not None:
            self.landed.synchronize()
        return self.out.numpy().copy()


@dataclass
class ResultTokens:
    """One tick in flight: its device result array and the host records
    that reconcile it.  ``records`` holds ``(slot, state, epoch)`` for
    every decode row of the tick: reconcile drops a row whose state
    rewound (epoch) or left its slot, and advances the rest with the
    device-sampled token."""
    data: torch.Tensor                 # device (n_slots, 4) int32
    stage: _Stage                      # where ``data`` comes home
    records: list                      # [(slot, RequestState, epoch)]
    kind: str                          # 'packed' | 'decode'
    decode_slots: frozenset            # slots with a decode row
    t_dispatch: float                  # engine-clock dispatch time

    def get(self) -> np.ndarray:
        """The one host copy of the tick (waits until it has landed)."""
        return self.stage.get()


class TokenStream:
    """A request's ``AsyncIterator[int]``: tokens arrive as their tick
    reconciles; iteration ends when the request finishes (``finished``
    holds why: 'length', 'eos', 'cancelled', 'deadline', 'max_restarts').

    The engine loop (possibly in an executor thread) calls ``put`` and
    ``finish``; consumers ``async for`` over the stream or poll
    ``drain()``.  Wakeups across threads go through
    ``call_soon_threadsafe``."""

    def __init__(self, rid: int):
        self.rid = rid
        self._q: deque = deque()
        self._fin: str | None = None
        self._loop = None
        self._event: asyncio.Event | None = None

    def put(self, token: int) -> None:
        self._q.append(token)
        self._wake()

    def finish(self, reason: str) -> None:
        self._fin = reason
        self._wake()

    def _wake(self) -> None:
        if self._event is not None:
            self._loop.call_soon_threadsafe(self._event.set)

    @property
    def finished(self) -> str | None:
        """Why the request finished, or None while it runs."""
        return self._fin

    def drain(self) -> list:
        """Pop every token delivered so far."""
        out = []
        while self._q:
            out.append(self._q.popleft())
        return out

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        while True:
            if self._q:
                return self._q.popleft()
            if self._fin is not None:
                raise StopAsyncIteration
            if self._event is None:
                self._loop = asyncio.get_running_loop()
                self._event = asyncio.Event()
            self._event.clear()
            await self._event.wait()


class StreamingEngine:
    """The overlapped streaming loop over a ``ServingEngine``: a FIFO of
    ticks in flight, at most ``depth`` deep (2 = double buffering), one
    ``_Stage`` of buffers each, and the requests' ``TokenStream``s.  The
    engine keeps admission, paging, preemption and faults; this class
    changes WHEN ticks run and HOW their results come home.

    ``step()`` is one iteration: release arrivals, run control-plane work
    that needs a drained pipeline, admit, dispatch a tick if the pipeline
    has room, reconcile the oldest tick if it is full (or nothing was
    dispatched), and hand reconciled tokens to their streams.
    ``run_sync()`` drives to completion; ``serve_stream`` is the asyncio
    front-end."""

    def __init__(self, engine: ServingEngine, *, overlap: bool = True,
                 depth: int = 2):
        self._eng = engine
        self.depth = max(1, int(depth))
        # overlap needs the packed and decode programs and no fault plan
        self.overlap = bool(overlap and engine.prefill_mode == "packed"
                            and engine._injector is None)
        b, tb = engine.n_slots, engine.token_budget
        maps = (b * engine.kv_cache.paging.pages_per_row + b
                if engine.kv_cache.paged else 0)
        n_in = 6 * tb + 3 * b + maps
        self._stages = [_Stage(n_in, b, engine.device)
                        for _ in range(self.depth)]
        self._n_dispatched = 0
        self._pipe: deque = deque()    # ResultTokens in flight, FIFO
        self._streams: dict = {}       # rid -> TokenStream
        self._delivered: dict = {}     # rid -> tokens pushed so far
        self._token_times: dict = {}   # rid -> [engine time of a token]
        self._zero = torch.zeros((b, 4), dtype=torch.int32,
                                 device=engine.device)

    # ------------------------------------------------------------------
    # submission and streams
    # ------------------------------------------------------------------
    @property
    def engine(self) -> ServingEngine:
        return self._eng

    @property
    def has_work(self) -> bool:
        return (bool(self._pipe) or self._eng._sched.has_work
                or bool(self._eng._pending))

    def submit_stream(self, prompt, **kwargs) -> tuple:
        """``ServingEngine.submit`` plus a ``TokenStream``; returns
        ``(rid, stream)``."""
        rid = self._eng.submit(prompt, **kwargs)
        stream = TokenStream(rid)
        self._streams[rid] = stream
        self._delivered[rid] = 0
        return rid, stream

    def cancel(self, rid: int) -> bool:
        """Cancel anywhere in the lifecycle, mid-decode included: the
        pipeline drains first, so no row in flight targets the freed
        slot, then the engine releases the request."""
        self.drain()
        ok = self._eng.cancel(rid)
        self._flush_streams()
        return ok

    def preempt(self, rid: int) -> bool:
        self.drain()
        return self._eng.preempt(rid)

    def suspend(self, rid: int) -> bool:
        self.drain()
        return self._eng.suspend(rid)

    def resume(self, rid: int) -> bool:
        return self._eng.resume(rid)

    def snapshot(self):
        self.drain()
        return self._eng.snapshot()

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def step(self) -> str:
        """One loop iteration.  Returns the kind of tick dispatched
        ('packed' / 'decode'), 'reconcile' when it only retired a tick in
        flight, a synchronous tick's kind, or 'idle'."""
        t0 = time.perf_counter()
        kind = self._step_inner()
        if kind != "idle":
            self._eng.stats.loop_wall_s += time.perf_counter() - t0
        return kind

    def _step_inner(self) -> str:
        eng = self._eng
        eng._release_arrivals()
        if eng.stats.t_start is None:
            eng.stats.t_start = eng.now()
        if not self.overlap:
            kind = eng.step()          # synchronous ticks, still streamed
            self._flush_streams()
            return kind
        # control-plane work that frees or moves slots sees a drained
        # pipeline
        if eng._has_deadlines and self._deadline_due():
            self.drain()
            eng._expire()
        if any(st.req.sampling.temperature > 0.0
               for st in eng._sched.active.values() if not st.prefilling):
            # host sampling needs the full logits row: one synchronous
            # tick, the pipeline drained first
            self.drain()
            kind = eng.step()
            self._flush_streams()
            return kind
        if eng._store is not None and eng._sched.queued and self._pipe:
            # a blocked admission may preempt (a gather to the host):
            # drain, so no spill races a tick in flight
            self.drain()
        eng._admit_or_preempt()
        dispatched = None
        if len(self._pipe) < self.depth:
            dispatched = self._dispatch()
        if dispatched is not None:
            eng._after_tick(dispatched)
        if self._pipe and (dispatched is None
                           or len(self._pipe) >= self.depth):
            self._reconcile_one()
            self._flush_streams()
            return dispatched or "reconcile"
        if dispatched is None:
            eng.stats.ticks_idle += 1
            return "idle"
        return dispatched

    def drain(self) -> None:
        """Reconcile every tick in flight (waits on the card)."""
        while self._pipe:
            self._reconcile_one()
            self._flush_streams()

    def run_sync(self) -> dict:
        """Drive to completion; returns ``ServingEngine.results()``."""
        eng = self._eng
        while True:
            if self.step() != "idle":
                continue
            if eng._pending:
                before = eng.now()
                dt = eng.next_arrival() - before
                if dt > 0:
                    time.sleep(min(dt, 0.05))
                    if eng.now() <= before:    # a clock that stands still
                        eng._t0 -= dt
                continue
            if not self.has_work:
                break
        self.drain()
        self._flush_streams()
        return eng.results()

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _dispatch(self):
        sch = self._eng._sched
        if any(st.prefilling for st in sch.active.values()):
            return self._dispatch_packed()
        if sch.decoding():
            return self._dispatch_decode()
        return None

    def _can_decode(self, st) -> bool:
        """A slot may not overrun its token budget with rows in flight (an
        EOS overrun, at most one row, reconciles as stale instead)."""
        return len(st.generated) + st.inflight < st.req.max_new_tokens

    def _spec_token(self, st, tok, src, i) -> None:
        """Row i's token: the previous tick's on-device sample when the
        slot has a row in flight, else the host-known token (the first
        decode after a reconcile, or the rewind's re-feed)."""
        if st.inflight > 0:
            assert st.slot in self._pipe[-1].decode_slots, (
                "double-buffer gap: a decode row in flight without a "
                "sample in the previous tick")
            src[i] = st.slot
        else:
            tok[i] = st.next_token

    def _stage(self) -> _Stage:
        st = self._stages[self._n_dispatched % self.depth]
        self._n_dispatched += 1
        return st

    def _maps(self) -> list:
        kv, b = self._eng.kv_cache, self._eng.n_slots
        if not kv.paged:
            return []
        return [kv.page_map(b), kv.state_map(b)]

    def _device_maps(self, views) -> tuple:
        """The page and state maps, int32 as the programs take them."""
        if not views:
            return ()
        b = self._eng.n_slots
        return views[0].view(b, -1).int(), views[1].int()

    def _dispatch_packed(self):
        eng = self._eng
        sch = eng._sched
        t0 = time.perf_counter()
        decode, prefill = sch.plan_tick(eng.token_budget)
        decode = [st for st in decode if self._can_decode(st)]
        if not decode and not prefill:
            return None
        tb, b = eng.token_budget, eng.n_slots
        tok = np.zeros(tb, np.int64)
        slot = np.full(tb, -1, np.int64)
        pos = np.full(tb, -1, np.int64)
        off = np.full(tb, -1, np.int64)
        pre = np.zeros(tb, np.int64)
        src = np.full(tb, -1, np.int64)
        lengths = np.zeros(b, np.int64)
        records = []
        i = 0
        for st in decode:
            p = st.pos + st.inflight
            self._spec_token(st, tok, src, i)
            slot[i] = st.slot
            pos[i] = off[i] = p
            lengths[st.slot] = p + 1
            records.append((st.slot, st, st.epoch))
            st.inflight += 1
            i += 1
        n_dec, n_prefill = i, 0
        for st, take in prefill:
            o = st.nprefilled
            tok[i:i + take] = st.req.prompt[o:o + take]
            slot[i:i + take] = st.slot
            pos[i:i + take] = np.arange(o, o + take)
            off[i:i + take] = o
            pre[i:i + take] = 1
            i += take
            n_prefill += take
            # prompt progress is known on the host: advance it at
            # dispatch, so the next tick plans past it
            st.nprefilled += take
            if not st.prefilling:
                st.begin_decode()
        # the packed tick's LM head covers its first min(B, T) entries
        # (decode rows pack first)
        n_rows = min(b, tb)
        is_dec = np.zeros(n_rows, np.int64)
        is_dec[:n_dec] = 1
        stage = self._stage()
        prev = self._pipe[-1].data if self._pipe else self._zero
        v = stage.inputs([tok, src, slot, pos, off, pre, slot[:n_rows],
                          is_dec, lengths] + self._maps())
        eng.stats.host_busy_s += time.perf_counter() - t0
        tok_d = merge(v[0], v[1], prev)
        logits = eng._packed_program(tok_d, *v[2:6],
                                     self._device_maps(v[9:]))
        data = pack(logits, v[6], v[7], v[8])
        stage.result(data)
        t1 = time.perf_counter()
        self._push(data, stage, records, "packed")
        eng.stats.packed_ticks += 1
        eng.stats.packed_decode_tokens += n_dec
        eng.stats.packed_prefill_tokens += n_prefill
        eng.stats.prefill_tokens += n_prefill
        eng.stats.host_busy_s += time.perf_counter() - t1
        return "packed"

    def _dispatch_decode(self):
        eng = self._eng
        sch = eng._sched
        t0 = time.perf_counter()
        decode = [st for st in sch.decoding() if self._can_decode(st)]
        if not decode:
            return None
        b = eng.n_slots
        tok = np.zeros(b, np.int64)
        pos = np.full(b, -1, np.int64)
        src = np.full(b, -1, np.int64)
        is_dec = np.zeros(b, np.int64)
        lengths = np.zeros(b, np.int64)
        records = []
        for st in decode:
            p = st.pos + st.inflight
            self._spec_token(st, tok, src, st.slot)
            pos[st.slot] = p
            is_dec[st.slot] = 1
            lengths[st.slot] = p + 1
            records.append((st.slot, st, st.epoch))
            st.inflight += 1
        stage = self._stage()
        prev = self._pipe[-1].data if self._pipe else self._zero
        v = stage.inputs([tok, src, pos, np.arange(b), is_dec, lengths]
                         + self._maps())
        eng.stats.host_busy_s += time.perf_counter() - t0
        tok_d = merge(v[0], v[1], prev)
        logits = eng._decode_program(tok_d, v[2], self._device_maps(v[6:]))
        data = pack(logits, v[3], v[4], v[5])
        stage.result(data)
        t1 = time.perf_counter()
        self._push(data, stage, records, "decode")
        eng.stats.decode_steps += 1
        sch.note_decode()
        eng.stats.host_busy_s += time.perf_counter() - t1
        return "decode"

    def _push(self, data, stage, records, kind: str) -> None:
        eng = self._eng
        eng.stats.occupancy.append(len(eng._sched.active) / eng.n_slots)
        self._pipe.append(ResultTokens(
            data=data, stage=stage, records=records, kind=kind,
            decode_slots=frozenset(s for s, _, _ in records),
            t_dispatch=eng.now()))

    # ------------------------------------------------------------------
    # reconcile
    # ------------------------------------------------------------------
    def _reconcile_one(self) -> None:
        eng = self._eng
        tick = self._pipe.popleft()
        data = tick.get()              # THE host copy: waits on its event
        t0 = time.perf_counter()
        now = eng.now()
        eng.stats.step_latency.append(now - tick.t_dispatch)
        for slot, st, epoch in tick.records:
            st.inflight -= 1
            if st.epoch != epoch:
                continue               # rewound (quarantine, restart)
            if eng._sched.active.get(slot) is not st:
                continue               # evicted, preempted or cancelled
            token, valid, _, finite = data[slot]
            if not valid:
                continue
            if eng._nan_guard and not finite:
                eng._quarantine(st)    # bumps the epoch: later rows stale
                continue
            eng._advance_token(st, int(token), now)
        eng.stats.t_end = eng.now()
        eng.stats.host_busy_s += time.perf_counter() - t0

    def _deadline_due(self) -> bool:
        now = self._eng.now()
        return any(r.deadline is not None and now >= r.deadline
                   for r in self._eng._live_requests())

    # ------------------------------------------------------------------
    # delivery
    # ------------------------------------------------------------------
    def _flush_streams(self) -> None:
        eng = self._eng
        if not self._streams:
            return
        done = []
        now = eng.now()
        for rid, stream in self._streams.items():
            fin = None
            st = eng._results.get(rid)
            if st is not None:
                fin = ("eos" if (st.req.eos_id is not None and st.generated
                                 and st.generated[-1] == st.req.eos_id)
                       else "length")
            elif rid in eng._failed:
                fin = eng._failed[rid]
            else:
                st = eng._find_active(rid)
            if st is not None:
                sent = self._delivered.get(rid, 0)
                fresh = st.generated[sent:]
                if fresh:
                    for t in fresh:
                        stream.put(int(t))
                    self._delivered[rid] = sent + len(fresh)
                    eng.stats.tokens_streamed += len(fresh)
                    self._token_times.setdefault(rid, []).extend(
                        [now] * len(fresh))
            if fin is not None:
                stream.finish(fin)
                done.append(rid)
        for rid in done:
            del self._streams[rid]
            self._delivered.pop(rid, None)

    def itl_samples(self) -> dict:
        """{rid: [inter-token latencies]} on the engine clock, from the
        delivery times (tokens delivered in one flush add zero)."""
        return {rid: [b - a for a, b in zip(ts, ts[1:])]
                for rid, ts in self._token_times.items() if len(ts) > 1}


async def serve_stream(seng: StreamingEngine, requests: list, *,
                       idle_sleep: float = 0.002) -> dict:
    """Asyncio front-end: submit every request (dicts of
    ``submit_stream`` keyword arguments, with ``arrival`` times), run the
    blocking loop in the default executor so that consumers interleave
    with device work, and collect each stream.  Returns ``{rid:
    {"tokens": [...], "times": [...], "finished": reason}}`` with wall
    clock delivery times."""
    loop = asyncio.get_running_loop()
    out: dict = {}

    async def consume(rid: int, stream: TokenStream) -> None:
        toks, times = [], []
        async for t in stream:
            toks.append(t)
            times.append(time.perf_counter())
        out[rid] = {"tokens": toks, "times": times,
                    "finished": stream.finished}

    tasks = []
    for kw in requests:
        rid, stream = seng.submit_stream(**kw)
        tasks.append(asyncio.ensure_future(consume(rid, stream)))
    while seng.has_work:
        if await loop.run_in_executor(None, seng.step) == "idle":
            await asyncio.sleep(idle_sleep)
    seng.drain()
    seng._flush_streams()
    await asyncio.gather(*tasks)
    return out
