"""Public entry point of the prefill attention kernel.

``prism_attention_op`` takes repeat counts ``g`` (0 = dead / padding
column) and position metadata in the reference's layout, or with a
leading shard dimension, turns ``g`` into the ``+log g`` bias, and routes
to the CUDA kernel or its plain version (``kernels.dispatch``).  Ragged
Nq and M need no padding: the kernel masks its own edges.
"""
from __future__ import annotations

import torch

from ..core.attention import log_repeats
from .dispatch import use_kernel
from .prism_attention import prism_attention_reference, prism_flash_attention


def _per_shard(t: torch.Tensor, dtype: torch.dtype, p: int) -> torch.Tensor:
    """(n,) or (1|p, n) metadata -> contiguous (p, n) of ``dtype``."""
    t = t.to(dtype)
    t = t[None] if t.dim() == 1 else t
    return t.expand(p, t.shape[1]).contiguous()


def prism_attention_op(
    q,            # (B, Nq, Hq, hd)
    k,            # (B / rep, M, Hkv, hd)
    v,            # (B / rep, M, Hkv, hd)
    g,            # (M,) or (P, M) repeat counts (0 = masked/padding)
    col_lo,       # (M,) or (P, M)
    col_hi,       # (M,) or (P, M)
    row_pos,      # (Nq,) or (P, Nq)
    *,
    causal: bool = True,
    prefix_len: int = 0,
    window: int | None = None,
    scale: float | None = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Scaling-aware flash attention -> (B, Nq, Hq, hd).  With (P, ·)
    metadata, batch row ``b`` reads metadata row ``b % P``."""
    p = max(t.shape[0] if t.dim() == 2 else 1
            for t in (g, col_lo, col_hi, row_pos))
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            _per_shard(log_repeats(g), torch.float32, p),
            _per_shard(col_lo, torch.int32, p),
            _per_shard(col_hi, torch.int32, p),
            _per_shard(row_pos, torch.int32, p))
    kw = dict(causal=causal, prefix_len=prefix_len, window=window,
              scale=scale)
    if use_kernel(backend, q):
        return prism_flash_attention(*args, **kw)
    return prism_attention_reference(*args, **kw)
