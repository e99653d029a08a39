"""PRISM attention: scaling-aware softmax over compressed K/V (paper §IV-C).

Given per-column repeat counts ``g`` (1 for exact local tokens, ``n_l``
for a mean that summarizes ``n_l`` tokens):

    Ψ = exp(Q K̂ᵀ / √d)            (Eq. 13)
    E = Ψ ⊙ g                      (Eq. 14, column-wise)
    A = rownorm(E) · V̂            (Eq. 15)

which equals softmax attention over the row-duplicated K/V.  The scaling
is folded into the logits as ``+ log g`` (``g · e^x = e^{x + log g}``),
which is also what the CUDA kernels stream.

All functions take multi-head tensors with GQA layout:
    q: (B, Nq, Hq, hd)    k, v: (B, M, Hkv, hd)     Hq % Hkv == 0
"""
from __future__ import annotations

import torch

from .masks import NEG_INF


def at_least_f32(x):
    """x in f32, or as it is where it is f64: the f32 steps of the
    reference (norms, gates, softmax logits) keep a float64 forward in
    float64."""
    return x if x.dtype == torch.float64 else x.float()


def promoted(x: torch.Tensor, y: torch.Tensor):
    """x and y in their promoted dtype, as JAX's mixed-dtype products
    take them (a bf16 query over an f32 cache: f32)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _gqa_logits(q: torch.Tensor, k: torch.Tensor, scale: float
                ) -> torch.Tensor:
    """(B, Hq, Nq, M) attention logits with KV-head grouping, in the
    inputs' (promoted) dtype."""
    b, nq, hq, hd = q.shape
    _, m, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    grp = hq // hkv
    q, k = promoted(q, k)
    qg = q.reshape(b, nq, hkv, grp, hd)
    logits = torch.einsum("bnkgh,bmkh->bkgnm", qg, k) * scale
    return logits.reshape(b, hq, nq, m)


def _gqa_output(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, Hq, Nq, M) @ (B, M, Hkv, hd) -> (B, Nq, Hq, hd)."""
    b, hq, nq, m = weights.shape
    hkv = v.shape[2]
    grp = hq // hkv
    weights, v = promoted(weights, v)
    wg = weights.reshape(b, hkv, grp, nq, m)
    out = torch.einsum("bkgnm,bmkh->bnkgh", wg, v)
    return out.reshape(b, nq, hq, v.shape[-1])


def log_repeats(g: torch.Tensor) -> torch.Tensor:
    """Repeat counts -> additive logit bias: log g, with g = 0 columns
    sent to NEG_INF (dead: own-shard means, padding, not-yet-covered
    segments)."""
    g = g.float()
    return torch.where(g > 0, torch.log(torch.clamp(g, min=1e-30)),
                       torch.full_like(g, NEG_INF))


def scaling_softmax(
    logits: torch.Tensor,              # (..., M)
    log_g: torch.Tensor | None,        # broadcastable; None => all-ones g
    mask: torch.Tensor | None,         # bool, broadcastable; True = attend
) -> torch.Tensor:
    """Stable softmax of ``logits + log g`` with masking (Eq. 14)."""
    x = at_least_f32(logits)
    if log_g is not None:
        x = x + log_g.float()
    if mask is not None:
        x = torch.where(mask, x, torch.full_like(x, NEG_INF))
    x = x - x.amax(dim=-1, keepdim=True)
    e = torch.exp(x)
    if mask is not None:
        # fully-masked rows: max-subtraction turns NEG_INF-NEG_INF into 0,
        # so re-zero masked entries -> such rows yield 0, not uniform
        e = torch.where(mask, e, torch.zeros_like(e))
    denom = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp(denom, min=1e-30)


def prism_attention(
    q: torch.Tensor,                   # (B, Nq, Hq, hd)
    k_hat: torch.Tensor,               # (B, M, Hkv, hd) augmented K
    v_hat: torch.Tensor,               # (B, M, Hkv, hd)
    g: torch.Tensor | None = None,     # (M,) or broadcastable; None = exact
    mask: torch.Tensor | None = None,  # bool (Nq, M) or (B, 1|Hq, Nq, M)
    *,
    scale: float | None = None,
    block: int = 0,                    # >0: stream K/V in blocks
) -> torch.Tensor:
    """Scaling-aware attention (Eq. 15).  With g=None and a causal mask
    this is exact softmax attention.

    ``block``: stream the K/V columns in blocks with a running
    max/normalizer, never materializing the (B, Hq, Nq, M) logits; taken
    for M > 2·block with a 1-D ``g`` and a 2-D (or no) mask."""
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    if (block and k_hat.shape[1] > 2 * block
            and (mask is None or mask.dim() == 2)
            and (g is None or g.dim() == 1)):
        return _streamed_attention(q, k_hat, v_hat, g, mask,
                                   scale=scale, block=block)
    logits = _gqa_logits(q, k_hat, scale)
    log_g = None if g is None else torch.log(g.float())
    if mask is not None and mask.dim() == 2:
        mask = mask[None, None]
    w = scaling_softmax(logits, log_g, mask)
    return _gqa_output(w.to(v_hat.dtype), v_hat)


def _streamed_attention(q, k_hat, v_hat, g, mask, *, scale, block):
    """Loop over K/V column blocks with running (m, l, acc): the Eq. 13-15
    softmax in streaming form (the same algorithm as the CUDA kernel)."""
    b, nq, hq, hd = q.shape
    m_cols = k_hat.shape[1]
    dev = q.device
    pad = (-m_cols) % block
    if g is None:
        g = torch.ones(m_cols, dtype=torch.float32, device=dev)
    if pad:
        k_hat = torch.nn.functional.pad(k_hat, (0, 0, 0, 0, 0, pad))
        v_hat = torch.nn.functional.pad(v_hat, (0, 0, 0, 0, 0, pad))
        g = torch.nn.functional.pad(g.float(), (0, pad))    # pad g=0 -> dead
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (0, pad))
    log_g = log_repeats(g)
    m_run = torch.full((b, hq, nq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, hq, nq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, hq, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, k_hat.shape[1], block):
        k_c = k_hat[:, c0:c0 + block]
        v_c = v_hat[:, c0:c0 + block]
        s = _gqa_logits(q, k_c, scale).float()
        s = s + log_g[c0:c0 + block]
        if mask is not None:
            s = torch.where(mask[None, None, :, c0:c0 + block], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new)
        p = torch.where(s > NEG_INF / 2, p, torch.zeros_like(p))
        l_run = l_run * corr + p.sum(dim=-1, keepdim=True)
        part = _gqa_output(p.to(v_c.dtype), v_c).float()
        acc = acc * corr[..., 0].transpose(1, 2)[..., None] + part
        m_run = m_new
    denom = torch.clamp(l_run[..., 0].transpose(1, 2)[..., None], min=1e-30)
    return (acc / denom).to(v_hat.dtype)
