"""Deterministic offline data: the reference's synthetic corpus and
batch iterators, draw for draw.

The char-level LM runs on a synthetic but structured corpus (a Zipf
word stream with sentence structure and long-range phrase repeats), so
a small LM's bits per character respond to the quality of its
attention: what the accuracy-vs-CR protocol measures.  Every function
makes the same ``np.random.default_rng`` calls in the same order as
``repro.data.pipeline``, so equal seeds give equal numpy arrays; the
port keeps its own copy of the word list.
"""
from __future__ import annotations

import numpy as np

_WORDS = (
    "the of and a to in is was he for it with as his on be at by had not "
    "are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "time up go about than into could state only new year some take come "
    "these know see use get like then first any work now may such give over "
    "think most even find day also after way many must look before great "
    "back through long where much should well people down own just because "
    "good each those feel seem how high too place little world very still "
    "nation hand old life tell write become here show house both between "
    "need mean call develop under last right move thing general school never "
    "same another begin while number part turn real leave might want point"
).split()


class CharTokenizer:
    """Byte-level tokenizer over printable ASCII (vocab 97 + pad)."""

    def __init__(self):
        self.chars = ["<pad>"] + [chr(c) for c in range(32, 127)] + ["\n"]
        self.vocab = len(self.chars)
        self._enc = {c: i for i, c in enumerate(self.chars)}

    def encode(self, text: str) -> np.ndarray:
        return np.asarray([self._enc.get(c, 1) for c in text], np.int32)

    def decode(self, ids) -> str:
        return "".join(self.chars[int(i)] for i in ids if int(i) > 0)


def synthetic_text(n_chars: int, seed: int = 0) -> str:
    """Zipf-weighted word stream with sentence structure and long-range
    phrase repeats."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(_WORDS) + 1, dtype=np.float64)
    probs = (1 / ranks) / (1 / ranks).sum()
    out, phrases = [], []
    count = 0
    while count < n_chars:
        if phrases and rng.random() < 0.15:           # long-range repeat
            words = phrases[rng.integers(len(phrases))]
        else:
            words = list(rng.choice(_WORDS, size=rng.integers(4, 9), p=probs))
            if len(phrases) < 64:
                phrases.append(words)
        s = " ".join(words)
        if rng.random() < 0.2:
            s += "."
        out.append(s)
        count += len(s) + 1
    return " ".join(out)[:n_chars]


def lm_batches(tokens: np.ndarray, *, batch: int, seq: int, seed: int = 0):
    """Infinite iterator of (inputs, labels) next-char pairs, (batch, seq)
    int32 each."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    if n <= 0:
        raise ValueError("corpus shorter than seq_len")
    while True:
        starts = rng.integers(0, n, size=batch)
        x = np.stack([tokens[s:s + seq] for s in starts])
        y = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
        yield x, y


def classification_batches(*, batch: int, seq: int, n_classes: int,
                           vocab: int, seed: int = 0):
    """Synthetic sequence classification (an encoder's smoke task): the
    label is the token sum modulo ``n_classes``, so it is learnable."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.integers(1, vocab, size=(batch, seq), dtype=np.int64)
        y = (x.sum(axis=1) % n_classes).astype(np.int64)
        yield x.astype(np.int32), y.astype(np.int32)
