"""Single-token flash-decode partial stats: the CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Both return the running softmax statistics ``(m, l, acc)`` — m, l
(B, Hq, 1, 1) f32 and acc (B, 1, Hq, hd) f32 — over one local KV shard,
with per-row column validity, plus (prism mode) the Segment-Means
columns ``kz``/``vz`` under a per-row ``+log g`` bias.  A row with no
live column gives ``(NEG, 0, 0)``.  The cross-shard combine is the
caller's (``runtime.serve``).

Shapes, with the shard axis folded into the batch (``B = B_q · rep``;
output row ``b`` is shard ``b % rep`` of query row ``b // rep``):

    q        (B_q, 1, Hq, hd)
    k, v     (R · rep, M, Hkv, hd)  R cache rows, each of rep shards
    valid    (B, M) bool            per output row
    log_gz   (B, m) f32             per output row: its means bias
    kz, vz   (R, m, Hkv, hd)        the means, shared by the shards
    rows     (B_q,) int32 or None   the cache row of each query row

Without ``rows`` query row ``i`` reads cache row ``i`` (``R = B_q``).
With it, query row ``i`` reads cache row ``rows[i]`` (clamped to
``[0, R)``): the packed tick's tokens read their slot's cache row in
place, where the reference gathers a copy per token.  ``rep = 1`` is the
reference's single-shard signature.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import LAUNCHES, check_tensor, raise_on_error, use_kernel
from ..core.attention import _gqa_logits, _gqa_output
from ..core.masks import NEG_INF

NEG = NEG_INF
HEAD_DIMS = (64,)              # the head dims csrc/decode_attention.cu builds

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])
_TILE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_void_p])


# --------------------------------------------------------------------------
# plain version: two-pass partial stats + merge (no concatenate)
# --------------------------------------------------------------------------

def partial_softmax_stats(q, k, v, bias, scale):
    """Softmax partial stats over one column set.  q (B,1,Hq,hd);
    k,v (B,M,Hkv,hd); bias (B,M) additive logits (NEG = dead column).
    Returns m, l: (B,Hq,1,1) f32 and acc: (B,1,Hq,hd) f32."""
    s = _gqa_logits(q, k, scale).float()                  # (B,Hq,1,M)
    s = s + bias[:, None, None, :].float()
    m_p = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m_p)
    p = torch.where(s > NEG / 2, p, torch.zeros_like(p))  # all-dead -> l=0
    l_p = p.sum(dim=-1, keepdim=True)
    acc_p = _gqa_output(p.to(v.dtype), v).float()
    return m_p, l_p, acc_p


def merge_stats(a, b):
    """Combine two partial-stat triples over disjoint column sets (the
    associative flash-softmax merge).  m, l (B,Hq,Nq,1), acc
    (B,Nq,Hq,hd)."""
    m_a, l_a, acc_a = a
    m_b, l_b, acc_b = b
    m = torch.maximum(m_a, m_b)
    c_a = torch.exp(m_a - m)
    c_b = torch.exp(m_b - m)
    l = l_a * c_a + l_b * c_b
    acc = (acc_a * c_a[..., 0].transpose(1, 2)[..., None]
           + acc_b * c_b[..., 0].transpose(1, 2)[..., None])
    return m, l, acc


def chunk_softmax_stats(q, k, v, bias, scale):
    """Multi-query softmax partial stats with a per-query additive bias:
    the intra-chunk pass of chunked prefill and of a packed tick.
    q (B,C,Hq,hd); k,v (B,M,Hkv,hd); bias (B,C,M) (NEG = dead column).
    Returns m, l: (B,Hq,C,1) f32 and acc: (B,C,Hq,hd) f32."""
    s = _gqa_logits(q, k, scale).float()                  # (B,Hq,C,M)
    s = s + bias[:, None].float()
    m_p = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m_p)
    p = torch.where(s > NEG / 2, p, torch.zeros_like(p))  # all-dead -> l=0
    l_p = p.sum(dim=-1, keepdim=True)
    acc_p = _gqa_output(p.to(v.dtype), v).float()
    return m_p, l_p, acc_p


def gather_rows(rows, rep, k, v, kz=None, vz=None):
    """The row map made explicit: each query row's ``rep`` cache shards
    (and means row) gathered into a copy, as the reference's per-token
    ``take`` does."""
    rows = rows.long().clamp(0, k.shape[0] // rep - 1)
    idx = (rows[:, None] * rep + torch.arange(rep, device=rows.device)
           ).reshape(-1)
    k, v = k.index_select(0, idx), v.index_select(0, idx)
    if kz is not None:
        kz, vz = kz.index_select(0, rows), vz.index_select(0, rows)
    return k, v, kz, vz


def decode_stats_reference(q, k, v, valid, log_gz=None, kz=None, vz=None,
                           *, scale, rows=None):
    """Plain version of ``flash_decode_stats``: local columns masked by
    ``valid`` (g = 1), then the optional means columns with their per-row
    ``log_gz`` bias, merged without concatenating K/V.  A row map is
    applied as an explicit gather first."""
    rep = valid.shape[0] // q.shape[0]
    if rows is not None:
        k, v, kz, vz = gather_rows(rows, rep, k, v, kz, vz)
    if rep > 1:
        q = q.repeat_interleave(rep, dim=0)
        if kz is not None:
            kz = kz.repeat_interleave(rep, dim=0)
            vz = vz.repeat_interleave(rep, dim=0)
    bias = torch.where(valid, 0.0, NEG)
    stats = partial_softmax_stats(q, k, v, bias, scale)
    if kz is not None:
        stats = merge_stats(stats, partial_softmax_stats(
            q, kz.to(k.dtype), vz.to(v.dtype), log_gz, scale))
    return stats


# --------------------------------------------------------------------------
# CUDA kernel: two routes, picked by a fixed rule
# --------------------------------------------------------------------------

#: the tile route takes a call from this many query heads a KV head: the
#: measured crossover (``chip_smoke.py``'s ``crossover``, NVIDIA H100 at
#: the chunk layout's cache rows): the tile route is 17% faster at a
#: group of 4, 1.6x at 8, 2.6x at 16 and 6.1x at 64; the two tie at 2
#: and the row route is 12% faster at 1
TILE_MIN_GROUP = 4
ROUTES = ("row", "tile")


def decode_route(hq: int, hkv: int, no_rows: bool) -> str:
    """Which kernel of ``csrc/decode_attention.cu`` takes a call with
    ``hq`` query heads over ``hkv`` KV heads, ``no_rows`` when it has no
    row map.

    ``"tile"`` (``decode_stats_mq_kernel``): 64 query heads a block on
    the tensor cores, each K/V tile read once for all of them; for a
    group of at least ``TILE_MIN_GROUP`` heads (the measured crossover)
    and no row map: the chunked prefill's folded queries.  ``"row"``
    (``decode_stats_kernel``) for every other call: one token a row
    (static decode, group 1) and every packed call (a row map), whose
    per-token ``valid`` rows do not share a tile.  The rule is fixed;
    nothing else selects a route."""
    return "tile" if no_rows and hq // hkv >= TILE_MIN_GROUP else "row"


def flash_decode_stats(q, k, v, valid, log_gz=None, kz=None, vz=None, *,
                       scale, rows=None):
    """The CUDA kernel, on the route ``decode_route`` picks from the
    shapes and the row map.  f32 only; raises on anything it does not
    take.  Launches on the current stream and does not synchronise."""
    check_tensor(q, "q", dtype=torch.float32, ndim=4, device=k.device)
    check_tensor(k, "k", dtype=torch.float32, ndim=4, device=k.device)
    return launch_route(decode_route(q.shape[2], k.shape[2], rows is None),
                        q, k, v, valid, log_gz, kz, vz, scale=scale,
                        rows=rows)


def launch_route(route, q, k, v, valid, log_gz=None, kz=None, vz=None, *,
                 scale, rows=None):
    """One launch of the named route, whatever ``decode_route`` would
    pick: ``chip_smoke.py`` times both routes at one layout with it; the
    serving path calls ``flash_decode_stats``.  Every launch counts under
    ``flash_decode_stats``, the tile route's also under
    ``flash_decode_stats.mq``."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    dev = k.device
    check_tensor(q, "q", dtype=torch.float32, ndim=4, device=dev)
    check_tensor(k, "k", dtype=torch.float32, ndim=4, device=dev)
    check_tensor(v, "v", dtype=torch.float32, ndim=4, device=dev)
    check_tensor(valid, "valid", dtype=torch.bool, ndim=2, device=dev)
    bq, nq, hq, hd = q.shape
    n_kv, m_loc, hkv, hd_k = k.shape
    b = valid.shape[0]                       # output rows
    rep = b // bq
    if nq != 1:
        raise ValueError(f"decode kernel is single-token (got Nq={nq})")
    if (hd_k != hd or v.shape != k.shape or b % bq or hq % hkv
            or valid.shape != (b, m_loc) or n_kv % rep
            or (rows is None and n_kv != b)):
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, valid {tuple(valid.shape)}")
    n_rows = n_kv // rep                     # cache rows
    rows_ptr = None
    if rows is not None:
        if route == "tile":
            raise ValueError("the tile route takes no row map")
        check_tensor(rows, "rows", dtype=torch.int32, ndim=1, device=dev)
        if rows.shape != (bq,):
            raise ValueError(f"rows {tuple(rows.shape)} != ({bq},)")
        rows = rows.clamp(0, n_rows - 1)
        rows_ptr = rows.data_ptr()
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    mz, ptrs = 0, (None, None, None)
    if kz is not None:
        check_tensor(log_gz, "log_gz", dtype=torch.float32, ndim=2,
                     device=dev)
        check_tensor(kz, "kz", dtype=torch.float32, ndim=4, device=dev)
        check_tensor(vz, "vz", dtype=torch.float32, ndim=4, device=dev)
        mz = kz.shape[1]
        if (kz.shape != (n_rows, mz, hkv, hd) or vz.shape != kz.shape
                or log_gz.shape != (b, mz)):
            raise ValueError(f"means shapes do not fit: kz "
                             f"{tuple(kz.shape)}, log_gz "
                             f"{tuple(log_gz.shape)}")
        ptrs = (log_gz.data_ptr(), kz.data_ptr(), vz.data_ptr())
    m_p = torch.empty((b, hq, 1, 1), dtype=torch.float32, device=dev)
    l_p = torch.empty((b, hq, 1, 1), dtype=torch.float32, device=dev)
    acc_p = torch.empty((b, 1, hq, hd), dtype=torch.float32, device=dev)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
              *ptrs)
    outputs = (m_p.data_ptr(), l_p.data_ptr(), acc_p.data_ptr())
    sizes = (b, m_loc, mz, hq, hkv, hd, rep, ctypes.c_float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if route == "tile":
        fn = build.function("decode_attention", "flash_decode_stats_mq_f32",
                            _TILE_ARGTYPES)
        rc = fn(*inputs, *outputs, *sizes)
    else:
        fn = build.function("decode_attention", "flash_decode_stats_f32",
                            _ARGTYPES)
        rc = fn(*inputs, rows_ptr, *outputs, *sizes)
    raise_on_error(rc, f"flash_decode_stats ({route} route)")
    LAUNCHES["flash_decode_stats"] += 1
    if route == "tile":
        LAUNCHES["flash_decode_stats.mq"] += 1
    return m_p, l_p, acc_p


def decode_stats(q, k, v, valid, log_gz=None, kz=None, vz=None, *, scale,
                 rows=None, backend: str = "auto"):
    """Partial stats from the kernel (CUDA tensors) or the plain version
    (CPU tensors, or ``backend='plain'``)."""
    if use_kernel(backend, k):
        return flash_decode_stats(q, k, v, valid, log_gz, kz, vz,
                                  scale=scale, rows=rows)
    return decode_stats_reference(q, k, v, valid, log_gz, kz, vz,
                                  scale=scale, rows=rows)
