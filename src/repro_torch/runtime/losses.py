"""Losses (``repro.runtime.losses``).  The LM loss is vocab-chunked: at
a large vocabulary the full (B, N, V) logits would dwarf the rest of a
train step's memory, so it runs over sequence chunks and never holds
more than (B, chunk, V) logits.

Over a mesh of ranks, the reference's vocab-parallel embedding and loss
(``repro.runtime.train``'s ``embed_vp`` and ``vp_lm_loss``): the table
cut over ``model`` on its vocabulary, the activations over ``model`` on
the sequence; their collectives are metered ``tp``."""
from __future__ import annotations

import torch

from ..sharding import comm


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


def embed_vp(table, tokens, grp, *, sharded_vocab: bool):
    """The vocab-parallel lookup (the reference's ``embed_vp``): tokens
    (B, n_loc) a sequence shard and the table (V_loc, D) a vocab shard,
    both over the ``model`` group ``grp``.  Each rank gathers the group's
    token ids, looks up the rows its vocab shard holds (zeros for the
    others) over the group's whole block of the sequence, and a
    ``psum_scatter`` sums the partials and hands each rank its own
    sequence shard back.  A replicated table looks its rows up alone."""
    if not sharded_vocab:
        return table[tokens]
    v_loc = table.shape[0]
    t = comm.all_gather(tokens, grp, "tp", dim=1) - grp.index * v_loc
    valid = (t >= 0) & (t < v_loc)
    emb = torch.where(valid[..., None], table[t.clamp(0, v_loc - 1)], 0.0)
    return comm.psum_scatter(emb, grp, "tp", dim=1)


def vp_lm_loss(x, table, labels, grp, *, softcap=None, sharded_vocab: bool,
               n_chunks: int = 16, global_tokens: int):
    """The vocab-parallel LM loss (the reference's ``vp_lm_loss``): x
    (B, n_loc, D) a sequence shard over the ``model`` group ``grp``,
    table (V_loc, D) a vocab shard of it (or whole), labels (B, n_loc).
    Over chunks of the shard's positions, the rank gathers the chunk's
    activations and labels over the group, scores them against its vocab
    shard and combines the log-sum-exp (its max a ``pmax``, which passes
    no gradient, its sum a psum) and the gold logit (a psum).  Returns
    the rank's share: the negative log-likelihood summed over the tokens
    it scored, divided by ``global_tokens`` and, where the vocabulary is
    sharded, by the group's size (every rank of it scored the same
    tokens), so that a psum over the mesh is the global mean.  The logits
    are f32 (f64 for f64 activations)."""
    b, n_loc, d = x.shape
    v_loc = table.shape[0]
    n_chunks = min(n_chunks, n_loc)
    while n_loc % n_chunks:
        n_chunks -= 1
    c = n_loc // n_chunks
    vstart = grp.index * v_loc if sharded_vocab else 0
    w = table.T.to(x.dtype)
    total = x.new_zeros((), dtype=torch.promote_types(x.dtype,
                                                      torch.float32))
    for c0 in range(0, n_loc, c):
        x_c, y_c = x[:, c0:c0 + c], labels[:, c0:c0 + c]
        if sharded_vocab:
            x_c = comm.all_gather(x_c, grp, "tp", dim=1)
            y_c = comm.all_gather(y_c, grp, "tp", dim=1)
        logits = x_c @ w
        if logits.dtype != torch.float64:
            logits = logits.float()
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        mx = logits.detach().amax(-1, keepdim=True)
        if sharded_vocab:
            mx = comm.pmax(mx, grp, "tp")
        ssum = torch.exp(logits - mx).sum(-1)
        if sharded_vocab:
            ssum = comm.psum(ssum, grp, "tp")
        lse = mx[..., 0] + torch.log(ssum)
        t = y_c.long() - vstart
        valid = (t >= 0) & (t < v_loc)
        gold = torch.gather(logits, -1, t.clamp(0, v_loc - 1)[..., None])
        gold = torch.where(valid, gold[..., 0], 0.0)
        if sharded_vocab:
            gold = comm.psum(gold, grp, "tp")
        total = total + (lse - gold).sum()
    if sharded_vocab:
        total = total / grp.size
    return total / global_tokens
