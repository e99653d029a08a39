"""PRISM scaling-aware flash attention (prefill): the CUDA kernels
(``csrc/prism_attention.cu`` for f32, ``csrc/prism_attention_bf16.cu``
for bf16) and their plain PyTorch version.

All take the same arguments:

    q          (B, Nq, Hq, hd)         f32 or bf16, the output's dtype
    k, v       (B / rep, M, Hkv, hd)   q's dtype; batch row b reads K/V
                                       row b // rep
    log_g      (P, M) f32              +log g column bias; -1e30 = dead
    col_lo/hi  (P, M) int32            global position range per column
    row_pos    (P, Nq) int32           global position per query row

Batch row ``b`` reads metadata row ``b % P``: with the port's explicit
shard axis folded into the batch (row ``b·P + p`` is shard ``p`` of
sequence ``b``), one launch serves every shard with its own columns.
``P = 1`` is the reference's single-device (1, M) / (Nq, 1) layout.
The Eq. 17 mask is evaluated from the positions; none is passed in.
"""
from __future__ import annotations

import ctypes

import torch

from .dispatch import check_tensor, launch
from ..core.attention import _gqa_logits, _gqa_output, at_least_f32
from ..core.masks import NEG_INF, visibility

NEG = NEG_INF
#: head dims both sources build, at each dtype
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: q / k / v dtype -> (library, C entry point)
ENTRIES = {torch.float32: ("prism_attention", "prism_attention_f32"),
           torch.bfloat16: ("prism_attention_bf16", "prism_attention_bf16")}

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
             + [ctypes.c_float, ctypes.c_void_p])


def _shapes(q, k, v, log_g, col_lo, col_hi, row_pos):
    b, nq, hq, hd = q.shape
    bk, m, hkv, hd_k = k.shape
    p = log_g.shape[0]
    if hd_k != hd or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if b % bk or hq % hkv:
        raise ValueError(f"batch {b} must be a multiple of K/V batch {bk}"
                         f" and Hq={hq} of Hkv={hkv}")
    if (b % p or log_g.shape != (p, m) or col_lo.shape != (p, m)
            or col_hi.shape != (p, m) or row_pos.shape != (p, nq)):
        raise ValueError("metadata must be (P, M) and (P, Nq) with P "
                         "dividing the batch")
    return b, nq, hq, hd, bk, m, hkv, p


def prism_attention_reference(q, k, v, log_g, col_lo, col_hi, row_pos, *,
                              causal: bool, prefix_len: int = 0,
                              window: int | None = None,
                              scale: float | None = None) -> torch.Tensor:
    """Plain version: the full (Nq, M) logits with the +log g bias and the
    position-range mask, then a stable softmax (paper Eq. 13-15, 17).  In
    the reference's dtypes: bf16 logits (the einsum in the inputs' dtype)
    taken to f32, the weights cast to v's dtype before the output's
    einsum."""
    b, nq, hq, hd, bk, m, hkv, p = _shapes(q, k, v, log_g, col_lo, col_hi,
                                           row_pos)
    scale = (hd ** -0.5) if scale is None else scale
    if bk != b:
        k = k.repeat_interleave(b // bk, dim=0)
        v = v.repeat_interleave(b // bk, dim=0)
    s = at_least_f32(_gqa_logits(q, k, scale)).view(b // p, p, hq, nq, m)
    s = s + log_g.float()[None, :, None, None, :]
    vis = visibility(row_pos, col_lo, col_hi, causal=causal,
                     prefix_len=prefix_len, window=window)[None, :, None]
    s = torch.where(vis, s, torch.full_like(s, NEG))
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    live = vis & (log_g > NEG / 2)[None, :, None, None, :]
    e = torch.where(live, e, torch.zeros_like(e))   # fully-masked rows -> 0
    w = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return _gqa_output(w.view(b, hq, nq, m).to(v.dtype), v)


def prism_flash_attention(q, k, v, log_g, col_lo, col_hi, row_pos, *,
                          causal: bool, prefix_len: int = 0,
                          window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The CUDA kernel of q's dtype, f32 or bf16 (k and v in the same);
    raises on anything it does not take.  Launches on the current stream
    and does not synchronise.  A launch with a window counts also under
    ``prism_flash_attention.window``, a bf16 one under
    ``prism_flash_attention.bf16``."""
    dev = q.device
    if q.dtype not in ENTRIES:
        raise TypeError(f"q: kernel takes torch.float32 or torch.bfloat16, "
                        f"got {q.dtype}")
    for name, t, dt, ndim in (("q", q, q.dtype, 4),
                              ("k", k, q.dtype, 4),
                              ("v", v, q.dtype, 4),
                              ("log_g", log_g, torch.float32, 2),
                              ("col_lo", col_lo, torch.int32, 2),
                              ("col_hi", col_hi, torch.int32, 2),
                              ("row_pos", row_pos, torch.int32, 2)):
        check_tensor(t, name, dtype=dt, ndim=ndim, device=dev)
    b, nq, hq, hd, bk, m, hkv, p = _shapes(q, k, v, log_g, col_lo, col_hi,
                                           row_pos)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    scale = (hd ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    counts = (("prism_flash_attention.window",) if window is not None
              else ()) + (("prism_flash_attention.bf16",)
                          if q.dtype == torch.bfloat16 else ())
    launch("prism_flash_attention", *ENTRIES[q.dtype], _ARGTYPES, dev,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), log_g.data_ptr(),
           col_lo.data_ptr(), col_hi.data_ptr(), row_pos.data_ptr(),
           out.data_ptr(), b, nq, m, hq, hkv, hd, b // bk, p, int(causal),
           prefix_len, int(window is not None),
           0 if window is None else window, ctypes.c_float(scale),
           counts=counts)
    return out
