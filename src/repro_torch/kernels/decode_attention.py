"""Single-token flash-decode partial stats: the CUDA kernels
(``csrc/decode_attention.cuh``, built over an f32 cache by
``csrc/decode_attention.cu`` and over a bf16 one by
``csrc/decode_attention_bf16.cu``) and their plain PyTorch version.

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

Dtypes, as the reference's kernel takes them: q f32 or bf16; k and v
f32 or bf16, the cache's (the kernel of k's dtype runs); kz and vz in
any of the two, cast to k's dtype (the reference's ``kz.astype(k.dtype)``);
the stats f32.  The kernels read q in f32: the wrapper widens a bf16
query (exact), so a bf16 query over an f32 cache (an engine's bf16
model) and over a bf16 one (a bf16 static path) take the same kernels.

Without ``rows`` query row ``i`` reads cache row ``i`` (``R = B_q``).
With it, query row ``i`` reads cache row ``rows[i]`` (clamped to
``[0, R)``): the packed tick's tokens read their slot's cache row in
place, where the reference gathers a copy per token.  ``rep = 1`` is the
reference's single-shard signature.

The paged cache: with a page table ``pages (R, ppr)`` int32, k and v
are the page pool ``(n_pages · rep, pc, Hkv, hd)`` (``M = ppr · pc``):
column ``j`` of cache row ``r`` on shard ``s`` is pool row
``(pages[r, j // pc] · rep + s) · pc + j % pc``, and a page id below 0
makes its columns dead whatever ``valid`` says.  ``zrows (R,)`` int32
maps cache row ``r`` to its means row in kz/vz (a state pool of any
number of rows), as ``rows`` maps query rows to cache rows.  The kernel
clamps both maps as the reference's takes clip: a page id past the pool
reads its last page, a means row lies in the state pool.
The kernel reads both in place, where the reference gathers each row's
pages and means into a dense copy first.
"""
from __future__ import annotations

import ctypes

import torch

from .dispatch import check_tensor, launch, use_kernel
from ..core.attention import _gqa_logits, _gqa_output, at_least_f32
from ..core.masks import NEG_INF

NEG = NEG_INF
#: head dims csrc/decode_attention.cuh builds, on both routes and caches
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: the cache's dtype -> (library, C entry points of the row and tile
#: routes)
ENTRIES = {torch.float32: ("decode_attention", "flash_decode_stats_f32",
                           "flash_decode_stats_mq_f32"),
           torch.bfloat16: ("decode_attention_bf16", "flash_decode_stats_bf16",
                            "flash_decode_stats_mq_bf16")}
DTYPES = tuple(ENTRIES)

_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_void_p])
_TILE_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                  + [ctypes.c_float, ctypes.c_void_p])


# --------------------------------------------------------------------------
# plain version: two-pass partial stats + merge (no concatenate)
# --------------------------------------------------------------------------

def partial_softmax_stats(q, k, v, bias, scale):
    """Softmax partial stats over one column set.  q (B,1,Hq,hd);
    k,v (B,M,Hkv,hd); bias (B,M) additive logits (NEG = dead column).
    Returns m, l: (B,Hq,1,1) f32 and acc: (B,1,Hq,hd) f32 (f64 for f64
    inputs)."""
    s = at_least_f32(_gqa_logits(q, k, scale))                  # (B,Hq,1,M)
    s = s + bias[:, None, None, :].float()
    m_p = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m_p)
    p = torch.where(s > NEG / 2, p, torch.zeros_like(p))  # all-dead -> l=0
    l_p = p.sum(dim=-1, keepdim=True)
    acc_p = at_least_f32(_gqa_output(p.to(v.dtype), v))
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
    Returns m, l: (B,Hq,C,1) f32 and acc: (B,C,Hq,hd) f32 (f64 for f64
    inputs)."""
    s = at_least_f32(_gqa_logits(q, k, scale))                  # (B,Hq,C,M)
    s = s + bias[:, None].float()
    m_p = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m_p)
    p = torch.where(s > NEG / 2, p, torch.zeros_like(p))  # all-dead -> l=0
    l_p = p.sum(dim=-1, keepdim=True)
    acc_p = at_least_f32(_gqa_output(p.to(v.dtype), v))
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


def gather_pages(pool, pages, rep):
    """The page table made explicit, as the reference's ``_gather_pages``
    does per shard: pool (n_pages · rep, pc, Hkv, hd), pages (R, ppr) ->
    dense rows (R · rep, ppr · pc, Hkv, hd) and ``mapped`` (R, ppr · pc).
    An unmapped page's columns are zero in the copy: they are dead, and
    no byte of a page that no row maps reaches a result."""
    n_pages, pc = pool.shape[0] // rep, pool.shape[1]
    r, ppr = pages.shape
    pg = pages.long().clamp(0, n_pages - 1)
    idx = pg[:, None, :] * rep + torch.arange(rep, device=pool.device
                                              )[None, :, None]
    mapped = pages >= 0                                      # (R, ppr)
    g = pool.view(n_pages * rep, -1)[idx.reshape(-1)].view(
        r, rep, ppr, *pool.shape[1:])
    g = torch.where(mapped[:, None, :, None, None, None], g,
                    torch.zeros((), dtype=g.dtype, device=g.device))
    return (g.reshape(r * rep, ppr * pc, *pool.shape[2:]),
            mapped.repeat_interleave(pc, dim=1))


def decode_stats_reference(q, k, v, valid, log_gz=None, kz=None, vz=None,
                           *, scale, rows=None, pages=None, zrows=None):
    """Plain version of ``flash_decode_stats``: local columns masked by
    ``valid`` (g = 1), then the optional means columns with their per-row
    ``log_gz`` bias, merged without concatenating K/V.  A page table, a
    means-row map and a row map are applied as explicit gathers first."""
    rep = valid.shape[0] // q.shape[0]
    if pages is not None:
        k, mapped = gather_pages(k, pages, rep)
        v, _ = gather_pages(v, pages, rep)
        sel = (torch.arange(q.shape[0], device=q.device) if rows is None
               else rows.long().clamp(0, pages.shape[0] - 1))
        valid = valid & mapped[sel].repeat_interleave(rep, dim=0)
    if zrows is not None:
        zr = zrows.long().clamp(0, kz.shape[0] - 1)
        kz, vz = kz.index_select(0, zr), vz.index_select(0, zr)
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
    (``decode_stats_kernel``) for every other call: one token a row at a
    group below 4 (GPT-2's static decode, group 1; Yi-6B's group of 8
    takes the tile route) and every packed call (a row map), whose
    per-token ``valid`` rows do not share a tile.  The rule is fixed;
    nothing else selects a route."""
    return "tile" if no_rows and hq // hkv >= TILE_MIN_GROUP else "row"


def flash_decode_stats(q, k, v, valid, log_gz=None, kz=None, vz=None, *,
                       scale, rows=None, pages=None, zrows=None):
    """The CUDA kernel of the cache's dtype, on the route ``decode_route``
    picks from the shapes and the row map; raises on anything it does not
    take.  Launches on the current stream and does not synchronise."""
    check_tensor(q, "q", dtype=DTYPES, ndim=4, device=k.device)
    check_tensor(k, "k", dtype=DTYPES, ndim=4, device=k.device)
    return launch_route(decode_route(q.shape[2], k.shape[2], rows is None),
                        q, k, v, valid, log_gz, kz, vz, scale=scale,
                        rows=rows, pages=pages, zrows=zrows)


def _check_map(t, name, shape, dev):
    """Raise unless ``t`` is an int32 map of ``shape`` on ``dev``."""
    check_tensor(t, name, dtype=torch.int32, ndim=len(shape), device=dev)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} {tuple(t.shape)} != {shape}")


def launch_route(route, q, k, v, valid, log_gz=None, kz=None, vz=None, *,
                 scale, rows=None, pages=None, zrows=None):
    """One launch of the named route, whatever ``decode_route`` would
    pick: ``chip_smoke.py`` times both routes at one layout with it; the
    serving path calls ``flash_decode_stats``.  Every launch counts under
    ``flash_decode_stats``, the tile route's also under
    ``flash_decode_stats.mq``, a launch with a page table also under
    ``flash_decode_stats.paged``, one with a bf16 query or cache also
    under ``flash_decode_stats.bf16``, and one over a bf16 cache (the
    bf16 library) also under ``flash_decode_stats.kv_bf16``."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    dev = k.device
    check_tensor(q, "q", dtype=DTYPES, ndim=4, device=dev)
    check_tensor(k, "k", dtype=DTYPES, ndim=4, device=dev)
    check_tensor(v, "v", dtype=k.dtype, ndim=4, device=dev)
    check_tensor(valid, "valid", dtype=torch.bool, ndim=2, device=dev)
    bq, nq, hq, hd = q.shape
    n_kv, pc, hkv, hd_k = k.shape
    b, m_loc = valid.shape                   # output rows, cache columns
    rep = b // bq
    if nq != 1:
        raise ValueError(f"decode kernel is single-token (got Nq={nq})")
    if (hd_k != hd or v.shape != k.shape or b % bq or hq % hkv
            or n_kv % rep):
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, valid {tuple(valid.shape)}")
    if pages is None:
        n_rows, ppr = n_kv // rep, 1         # cache rows; M = pc
        ok = pc == m_loc and (rows is not None or n_kv == b)
    else:
        check_tensor(pages, "pages", dtype=torch.int32, ndim=2, device=dev)
        n_rows, ppr = pages.shape
        # the row route's page index is exact below 2^21 columns
        ok = (ppr * pc == m_loc < 1 << 21
              and (rows is not None or n_rows == bq))
    if not ok:
        got = None if pages is None else tuple(pages.shape)
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, valid {tuple(valid.shape)}, "
                         f"pages {got}")
    ptr = {"rows": None, "pages": None, "zrows": None}
    if rows is not None:
        if route == "tile":
            raise ValueError("the tile route takes no row map")
        _check_map(rows, "rows", (bq,), dev)
        rows = rows.clamp(0, n_rows - 1)
        ptr["rows"] = rows.data_ptr()
    if pages is not None:
        ptr["pages"] = pages.data_ptr()
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    mz, means = 0, (None, None, None)
    if kz is not None:
        check_tensor(log_gz, "log_gz", dtype=torch.float32, ndim=2,
                     device=dev)
        check_tensor(kz, "kz", dtype=DTYPES, ndim=4, device=dev)
        check_tensor(vz, "vz", dtype=DTYPES, ndim=4, device=dev)
        kz, vz = kz.to(k.dtype), vz.to(k.dtype)     # the reference's cast
        mz = kz.shape[1]
        if (kz.shape[1:] != (mz, hkv, hd) or vz.shape != kz.shape
                or log_gz.shape != (b, mz)
                or (zrows is None and kz.shape[0] != n_rows)):
            raise ValueError(f"means shapes do not fit: kz "
                             f"{tuple(kz.shape)}, log_gz "
                             f"{tuple(log_gz.shape)}")
        if zrows is not None:
            _check_map(zrows, "zrows", (n_rows,), dev)
            ptr["zrows"] = zrows.data_ptr()
        means = (log_gz.data_ptr(), kz.data_ptr(), vz.data_ptr())
    bf16 = torch.bfloat16 in (q.dtype, k.dtype)
    q = q.float()                       # exact: the kernels read f32
    m_p = torch.empty((b, hq, 1, 1), dtype=torch.float32, device=dev)
    l_p = torch.empty((b, hq, 1, 1), dtype=torch.float32, device=dev)
    acc_p = torch.empty((b, 1, hq, hd), dtype=torch.float32, device=dev)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
              *means)
    outputs = (m_p.data_ptr(), l_p.data_ptr(), acc_p.data_ptr())
    sizes = (b, m_loc, mz, hq, hkv, hd, rep, ppr, pc, n_kv // rep,
             0 if kz is None else kz.shape[0], ctypes.c_float(scale))
    counts = tuple(f"flash_decode_stats.{c}" for c, on in (
        ("mq", route == "tile"), ("paged", pages is not None),
        ("bf16", bf16), ("kv_bf16", k.dtype == torch.bfloat16)) if on)
    lib, row_entry, tile_entry = ENTRIES[k.dtype]
    if route == "tile":
        launch("flash_decode_stats", lib, tile_entry, _TILE_ARGTYPES, dev,
               *inputs, ptr["pages"], ptr["zrows"], *outputs, *sizes,
               counts=counts)
    else:
        launch("flash_decode_stats", lib, row_entry, _ARGTYPES, dev,
               *inputs, ptr["rows"], ptr["pages"], ptr["zrows"], *outputs,
               *sizes, counts=counts)
    return m_p, l_p, acc_p


def decode_stats(q, k, v, valid, log_gz=None, kz=None, vz=None, *, scale,
                 rows=None, pages=None, zrows=None, backend: str = "auto"):
    """Partial stats from the kernel (CUDA tensors) or the plain version
    (CPU tensors, or ``backend='plain'``)."""
    kw = dict(scale=scale, rows=rows, pages=pages, zrows=zrows)
    if use_kernel(backend, k, q, v, kz, vz):
        return flash_decode_stats(q, k, v, valid, log_gz, kz, vz, **kw)
    return decode_stats_reference(q, k, v, valid, log_gz, kz, vz, **kw)
