"""Deterministic fault injection for the serving engine.

A copy of the reference's ``runtime/faults.py`` (numpy only).  A seeded
:class:`FaultInjector` replays a declarative :class:`FaultPlan` at the
engine's seams:

  ===================  ==================================================
  fault kind           seam (where the engine consults the injector)
  ===================  ==================================================
  ``store_put_loss``   ``KVStore.put``: the spilled entry vanishes (host
                       memory pressure); the request later takes the
                       restore-miss -> ``reset_for_refill`` path.
  ``store_get_loss``   ``KVStore.peek``/``pop``/``get``: the entry
                       existed but is lost at read time (a torn read).
  ``page_poison``      ``ServingEngine`` before a decode tick: NaN-fill
                       one live, private (refcount 1) cache page of a
                       decoding slot; the isfinite guard must quarantine
                       exactly that slot.
  ``admission_stall``  ``ServingEngine`` admission: skip this tick's
                       admissions (a stuck control plane).
  ``tick_delay``       ``ServingEngine.step``: the whole tick does
                       nothing (a stalled device, a dropped heartbeat).
  ``shard_loss``       one sequence shard's KV becomes unreadable (the
                       degraded mesh).  ``ServingEngine`` arms its
                       ``MeansReplica`` for it and serves through the
                       loss: the lost shard's columns come from the
                       replicated means (``runtime/replica.py``).
  ===================  ==================================================

Every decision is a pure function of ``(seed, kind, op index)``: the
same plan over the same request trace injects the same faults, so chaos
runs replay, and a run can be held token-equal to a clean one
(per-request seeded sampling makes tokens independent of timing, slots
and restarts).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, fields

import numpy as np


#: the closed set of injectable fault kinds (taxonomy in docs/serving.md)
KINDS = ("store_put_loss", "store_get_loss", "page_poison",
         "admission_stall", "tick_delay", "shard_loss")


@dataclass(frozen=True)
class FaultSpec:
    """Injection schedule for ONE fault kind.

    ``p`` fires Bernoulli(p) per opportunity from the injector's seeded
    stream; ``at`` fires at exactly those 0-based opportunity indices
    (both may be active — a fault fires if either says so).  The
    default ``FaultSpec()`` never fires.

    ``shard`` is meaningful for ``shard_loss`` only: it pins which
    sequence shard dies when the fault fires (schedulable per shard
    index — the CI soak kills each shard in turn).  ``None`` leaves the
    victim to the injector's seeded ``pick``."""
    p: float = 0.0
    at: tuple = ()
    shard: int | None = None

    def __post_init__(self):
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability {self.p} not in [0, 1]")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))
        if self.shard is not None:
            if int(self.shard) < 0:
                raise ValueError(f"shard index {self.shard} < 0")
            object.__setattr__(self, "shard", int(self.shard))

    @property
    def enabled(self) -> bool:
        return self.p > 0.0 or bool(self.at)


@dataclass(frozen=True)
class FaultPlan:
    """Declarative chaos plan: one :class:`FaultSpec` per fault kind
    plus the seed that makes the whole run replayable."""
    seed: int = 0
    store_put_loss: FaultSpec = field(default_factory=FaultSpec)
    store_get_loss: FaultSpec = field(default_factory=FaultSpec)
    page_poison: FaultSpec = field(default_factory=FaultSpec)
    admission_stall: FaultSpec = field(default_factory=FaultSpec)
    tick_delay: FaultSpec = field(default_factory=FaultSpec)
    shard_loss: FaultSpec = field(default_factory=FaultSpec)

    def spec(self, kind: str) -> FaultSpec:
        if kind not in KINDS:
            raise KeyError(f"unknown fault kind {kind!r}; "
                           f"known: {KINDS}")
        return getattr(self, kind)

    @property
    def any_enabled(self) -> bool:
        return any(self.spec(k).enabled for k in KINDS)

    @classmethod
    def chaos(cls, seed: int, **overrides) -> "FaultPlan":
        """The all-kinds soak plan the CI chaos step and ``--chaos
        SEED`` use: every fault kind enabled at rates aggressive enough
        to fire many times over a short trace while leaving the engine
        able to finish it."""
        base = dict(
            store_put_loss=FaultSpec(p=0.30),
            store_get_loss=FaultSpec(p=0.20),
            page_poison=FaultSpec(p=0.02),
            admission_stall=FaultSpec(p=0.10),
            tick_delay=FaultSpec(p=0.05),
            # rare but catastrophic: each hit costs a degraded-serving
            # window plus a re-prefill of every active request, so the
            # soak keeps it an order of magnitude below the others
            shard_loss=FaultSpec(p=0.02),
        )
        base.update(overrides)
        return cls(seed=seed, **base)


class FaultInjector:
    """Seeded runtime half of the fault plan.

    One injector per engine.  Each seam calls ``fire(kind)`` once per
    opportunity; the injector counts opportunities per kind and decides
    deterministically from its own ``(seed, kind)``-keyed RNG stream —
    per-kind streams, so enabling one fault kind never perturbs the
    schedule of another.  With ``trail=True`` (a mesh's engine) ``trail``
    is a running digest of every draw (kind, opportunity, outcome, and
    each ``pick``): the engines of a mesh's ranks, seeded alike and
    consulted at the same seams, must keep equal trails."""

    def __init__(self, plan: FaultPlan, trail: bool = False):
        self.plan = plan
        self._rngs = {k: np.random.default_rng(
            np.random.SeedSequence(entropy=plan.seed,
                                   spawn_key=(i,)))
            for i, k in enumerate(KINDS)}
        self.ops = {k: 0 for k in KINDS}        # opportunities seen
        self.injected = {k: 0 for k in KINDS}   # faults actually fired
        self.trail = b""                        # digest of every draw
        self._keep_trail = trail

    def _note(self, *what) -> None:
        if self._keep_trail:
            self.trail = hashlib.sha256(self.trail
                                        + repr(what).encode()).digest()

    def fire(self, kind: str) -> bool:
        """One injection opportunity for ``kind``; True = inject."""
        spec = self.plan.spec(kind)
        i = self.ops[kind]
        self.ops[kind] += 1
        # always draw when p > 0 so the stream position tracks the op
        # index — scheduled ``at`` hits never shift later Bernoulli
        # decisions
        hit = bool(self._rngs[kind].random() < spec.p) if spec.p > 0.0 \
            else False
        if i in spec.at:
            hit = True
        if hit:
            self.injected[kind] += 1
        self._note("fire", kind, i, hit)
        return hit

    def pick(self, kind: str, n: int) -> int:
        """Deterministic victim index in [0, n) for a fired fault
        (e.g. which decoding slot's page to poison)."""
        assert n >= 1
        k = int(self._rngs[kind].integers(n))
        self._note("pick", kind, n, k)
        return k

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def stats(self) -> dict:
        return {"seed": self.plan.seed,
                "ops": dict(self.ops),
                "injected": dict(self.injected),
                "total_injected": self.total_injected}


def _spec_fields():
    return tuple(f.name for f in fields(FaultPlan)
                 if f.name != "seed")


assert _spec_fields() == KINDS, (_spec_fields(), KINDS)
