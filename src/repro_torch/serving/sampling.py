"""Per-request token sampling on final logits (host side).

The engine copies each tick's decode logits to the host and samples
there, with a numpy Generator per request seeded at submit time, so
sampling is reproducible under any interleaving of requests through the
slot pool.  A copy of the reference's ``serving/sampling.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy; top_k == 0 -> full vocabulary."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def make_rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)


def sample_token(logits: np.ndarray, sp: SamplingParams,
                 rng: np.random.Generator) -> int:
    """One token id from a (V,) float logits row.  Greedy ties break at
    the first maximum (``np.argmax``)."""
    if sp.temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits.astype(np.float64) / sp.temperature
    if sp.top_k > 0:
        k = min(sp.top_k, z.shape[0])
        kth = np.partition(z, -k)[-k]
        z = np.where(z >= kth, z, -np.inf)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(z.shape[0], p=p))
