"""Losses (``repro.runtime.losses``).  The LM loss is vocab-chunked: at
a large vocabulary the full (B, N, V) logits would dwarf the rest of a
train step's memory, so it runs over sequence chunks and never holds
more than (B, chunk, V) logits."""
from __future__ import annotations

import torch


def softmax_xent(logits, labels):
    """(..., V) against int labels (...,) -> mean negative log-likelihood,
    computed in f32 (f64 for f64 logits)."""
    x = logits if logits.dtype == torch.float64 else logits.float()
    lse = torch.logsumexp(x, dim=-1)
    gold = torch.gather(x, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def chunked_lm_loss(features, embed_table, labels, *, chunk: int = 256,
                    softcap=None):
    """features (B, N, D) @ tableᵀ (V, D) -> mean xent over the B·N
    positions, the logits made ``chunk`` positions at a time; ``softcap``
    caps them at softcap·tanh(logits / softcap) first."""
    b, n, d = features.shape
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"N={n} is not a multiple of the chunk {chunk}")
    table = embed_table.T.to(features.dtype)
    total = features.new_zeros((), dtype=torch.promote_types(
        features.dtype, torch.float32))
    for c0 in range(0, n, chunk):
        logits = features[:, c0:c0 + chunk] @ table
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        x = logits if logits.dtype == torch.float64 else logits.float()
        lse = torch.logsumexp(x, dim=-1)
        gold = torch.gather(x, -1,
                            labels[:, c0:c0 + chunk, None].long())[..., 0]
        total = total + (lse - gold).sum()
    return total / (b * n)
