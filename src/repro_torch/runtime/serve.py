"""Serving runtime on one card: prefill + single-token greedy decode with
a sequence-sharded KV cache.

The reference shards the sequence over P devices under ``shard_map``;
here the P shards are an explicit axis inside one process:

  * activations in prefill are (B·P, n_loc, D), shard ``p`` of sequence
    ``b`` in batch row ``b·P + p``;
  * the cache leaf ``k`` is (B, P, cap_l, Hkv, hd) — the reference's
    global (B, cap, Hkv, hd) leaf, sharded on dim 1, viewed per shard;
  * the decode kernel computes every shard's partial softmax stats in
    one launch, and the cross-shard ``pmax``/``psum`` combine is a max and
    a sum over the shard axis.

Decode modes:
  * ``exact``  — distributed flash-decoding: each shard's stats over its
    own cache shard, combined exactly (voltage prefill);
  * ``prism``  — each shard attends to its exact local cache plus the
    cached Segment-Means K/V of the other shards (scaling-aware softmax);
    the output is the view of the shard that owns the newest position.
    Every shard's view is computed; only the owner's is used.

Only the unpaged, attention-only path with the ``aligned`` placement is
ported: positions [0, n0) lie prefill-aligned (shard s holds
[s·n_loc0, (s+1)·n_loc0) in slots [0, n_loc0)); decoded positions
p >= n0 go round-robin to shard (p - n0) % P, slot
n_loc0 + (p - n0) // P.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..core.attention import log_repeats
from ..core.protocol import PrismConfig
from ..kernels.decode_attention import decode_stats
from ..kernels.ops import prism_attention_op
from ..models.config import ModelConfig
from ..models.layers import (AttnSpec, attn_output, attn_project_kv,
                             attn_project_q, embed, mlp, norm)
from ..models.transformer import (attn_spec, check_supported,
                                  embed_inputs)
from ..sharding.context import ShardedPrismContext, means_columns


@dataclass(frozen=True)
class ServeHParams:
    decode_mode: str = "exact"       # 'exact' | 'prism'
    means_cr: float = 16.0           # CR for the prism decode means cache
    backend: str = "auto"            # kernel dispatch: 'auto'|'kernel'|'plain'


# --------------------------------------------------------------------------
# layout and cache
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeLayout:
    """Cache placement (the reference's ``'aligned'`` placement)."""
    n_seq: int                       # sequence shards (PRISM's P)
    cap: int                         # global cache capacity (tokens)
    cap_l: int                       # per-shard capacity
    prefill_len: int                 # tokens laid down by prefill (n0)
    L: int                           # segment means per shard (prism cache)

    @property
    def n_loc0(self) -> int:
        return self.prefill_len // self.n_seq


def make_layout(n_seq: int, cap: int, hp: ServeHParams,
                prefill_len: int | None = None) -> ServeLayout:
    n0 = cap if prefill_len is None else prefill_len
    if cap % n_seq or n0 % n_seq or n0 > cap:
        raise ValueError(f"cap={cap} and prefill_len={n0} must be "
                         f"multiples of n_seq={n_seq}, prefill_len <= cap")
    L = max(1, int(n0 // (hp.means_cr * n_seq)))
    L = min(L, n0 // n_seq)
    return ServeLayout(n_seq, cap, cap // n_seq, n0, L)


def init_cache(cfg: ModelConfig, lay: ServeLayout, batch: int,
               hp: ServeHParams, device) -> list:
    """An all-zero f32 decode-layout cache, one dict of leaves per layer
    (``layer_cache_shape``): what the chunked and packed ticks admit
    requests into."""
    shapes = layer_cache_shape(cfg, lay, batch, hp)
    return [{name: torch.zeros(shape, device=device)
             for name, shape in shapes.items()}
            for _ in range(cfg.n_layers)]


def layer_cache_shape(cfg: ModelConfig, lay: ServeLayout, batch: int,
                      hp: ServeHParams) -> dict:
    """Per-layer cache leaves: k, v (B, P, cap_l, Hkv, hd); prism mode
    adds the means K/V kz, vz (B, P·L, Hkv, hd), their per-request
    repeat counts gz (B, P·L) and the per-segment activation sums
    zsum (B, P·L, D)."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    c = {"k": (batch, lay.n_seq, lay.cap_l, hkv, hd),
         "v": (batch, lay.n_seq, lay.cap_l, hkv, hd)}
    if hp.decode_mode == "prism":
        m = lay.n_seq * lay.L
        c["kz"] = (batch, m, hkv, hd)
        c["vz"] = (batch, m, hkv, hd)
        c["gz"] = (batch, m)
        c["zsum"] = (batch, m, cfg.d_model)
    return c


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def _prefill_attention(q, k, v, akv, spec: AttnSpec, cfg: ModelConfig,
                       hp: ServeHParams):
    """The prefill kernel (or its plain version) over the augmented view,
    every shard in one launch with its own position metadata."""
    g = (akv.g if akv.g is not None
         else torch.ones(k.shape[1], device=k.device))
    return prism_attention_op(
        q, k, v, g, akv.col_lo, akv.col_hi, akv.row_pos,
        causal=spec.causal, prefix_len=cfg.prefix_len, window=spec.window,
        backend=hp.backend)


def prefill_attn(p, spec: AttnSpec, cfg: ModelConfig, x, ctx, lay,
                 hp: ServeHParams, prism_augment: bool, shapes: dict):
    """Attention sublayer over x (B·P, n_loc, D) that also captures this
    layer's decode cache, whose leaves have ``shapes``
    (``layer_cache_shape``)."""
    xq, akv = ctx.augment(x, spec)
    xq_n = norm(p["ln1"], xq, cfg.norm_kind)
    xh_n = norm(p["ln1"], akv.x_hat, cfg.norm_kind)
    q = attn_project_q(p["attn"], spec, xq_n)
    k, v = attn_project_kv(p["attn"], spec, xh_n)
    o = attn_output(p["attn"], _prefill_attention(q, k, v, akv, spec, cfg,
                                                  hp))

    bp, n_loc, d = x.shape
    P = lay.n_seq
    b = bp // P
    hkv, hd = k.shape[2:]
    # prism: the local block comes first in every shard's K/V; voltage: K/V
    # is the full sequence, whose shard-p slice is batch row b·P + p
    k_loc = k[:, :n_loc] if prism_augment else k.reshape(bp, n_loc, hkv, hd)
    v_loc = v[:, :n_loc] if prism_augment else v.reshape(bp, n_loc, hkv, hd)
    cache = {}
    for name, t in (("k", k_loc), ("v", v_loc)):
        c = torch.zeros(shapes[name], dtype=t.dtype, device=t.device)
        c[:, :, :n_loc] = t.reshape(b, P, n_loc, hkv, hd)
        cache[name] = c
    if hp.decode_mode == "prism":
        m = P * lay.L
        if prism_augment:
            # the means columns follow the local block, equal on all shards
            def means_cols(t):
                return t.reshape(b, P, *t.shape[1:])[:, P - 1,
                                                     n_loc:n_loc + m]
            kz, vz = means_cols(k).contiguous(), means_cols(v).contiguous()
            z_all = means_cols(akv.x_hat)
        else:                            # voltage prefill: compute means-KV
            z_all = ctx.gather_means(x, lay.L)               # (B, P·L, D)
            kz, vz = attn_project_kv(
                p["attn"], spec, norm(p["ln1"], z_all, cfg.norm_kind))
        # monolithic prefill covers every position of [0, n0): the repeat
        # counts are the full segment sizes, the sums means × sizes
        sizes = means_columns(P, n_loc, lay.L, x.device).sizes
        cache["kz"], cache["vz"] = kz, vz
        cache["gz"] = sizes[None].expand(b, m).contiguous()
        cache["zsum"] = z_all.float() * sizes[None, :, None]
    return ctx.finalize(o), cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            prism: PrismConfig, lay: ServeLayout, hp: ServeHParams):
    """tokens (B, n0) -> (last-token logits (B, V) f32, decode cache).

    ``prism.mode`` picks the exchange: 'prism' (Segment-Means) or
    'voltage' (full)."""
    check_supported(cfg)
    b, n = tokens.shape
    P = lay.n_seq
    if n != lay.prefill_len:
        raise ValueError(f"prompt length {n} != layout prefill_len "
                         f"{lay.prefill_len}")
    n_loc = n // P
    prism_cfg = prism.with_(P=P, L=lay.L if hp.decode_mode == "prism"
                            else prism.L)
    ctx = ShardedPrismContext(prism_cfg, n_shards=P, backend=hp.backend)
    prism_augment = prism_cfg.mode == "prism"
    spec = attn_spec(cfg)
    x = embed_inputs(cfg, params, tokens).reshape(b * P, n_loc, cfg.d_model)
    shapes = layer_cache_shape(cfg, lay, b, hp)
    cache = []
    for p in params["layers"]:
        o, c = prefill_attn(p, spec, cfg, x, ctx, lay, hp, prism_augment,
                            shapes)
        x = x + o
        x = x + mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_kind), cfg.mlp_kind)
        cache.append(c)
    return lm_head(cfg, params, ctx.last_shard(x[:, -1])), cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _decode_cols(lay: ServeLayout, pos: torch.Tensor):
    """(write slot (..., P), owner (..., P), col_pos (P, cap_l)) for the
    positions ``pos`` of any shape (-1 = dead entry: owner False on every
    shard)."""
    n0, n_loc0, n_seq = lay.prefill_len, lay.n_loc0, lay.n_seq
    idx = torch.arange(n_seq, device=pos.device)                 # (P,)
    extra = (pos - n0)[..., None]                                # (..., 1)
    slot = torch.where(extra >= 0, n_loc0 + extra // n_seq,
                       pos[..., None] - idx * n_loc0)
    wr_shard = torch.where(extra >= 0, extra % n_seq,
                           torch.clamp(pos[..., None] // max(n_loc0, 1),
                                       0, n_seq - 1))
    owner = (wr_shard == idx) & (slot >= 0) & (slot < lay.cap_l)
    j = torch.arange(lay.cap_l, device=pos.device)[None, :]
    col_pos = torch.where(j < n_loc0, idx[:, None] * n_loc0 + j,
                          n0 + (j - n_loc0) * n_seq + idx[:, None])
    return slot, owner, col_pos


def write_plan(row, slot, owner, n_seq: int, cap_l: int):
    """Flat cache addresses of N new K/V rows, computed once per step for
    every layer and leaf: entry ``n`` goes to batch row ``row[n]``, column
    ``slot[n, p]`` of the one shard ``p`` where ``owner[n, p]``.  Returns
    (addr (N,), ok (N,), first (1,)): an entry that no shard owns (dead
    token, idle row) is not ``ok`` and takes the address of the first
    entry that is (``first``), so ``_write_kv`` drops it, as the
    reference's out-of-range ``mode='drop'`` scatter does."""
    ok = owner.any(dim=-1)
    shard = owner.int().argmax(dim=-1)
    col = slot.gather(-1, shard[:, None])[:, 0].clamp(0, cap_l - 1)
    addr = (row * n_seq + shard) * cap_l + col
    first = ok.int().argmax(dim=0, keepdim=True)
    return torch.where(ok, addr, addr[first]), ok, first


def _write_kv(cache_kv, new_rows, plan):
    """Scatter (N, Hkv, hd) rows into the (B, P, cap_l, Hkv, hd) cache
    IN PLACE at the addresses of ``plan`` (``write_plan``).  A dropped
    entry rewrites the first owned entry's address with that entry's
    value (the current value if no entry is owned), so every duplicate
    address gets the same bytes.  O(N), no host synchronisation."""
    addr, ok, first = plan
    flat = cache_kv.view(-1, *cache_kv.shape[3:])
    new_rows = new_rows.to(cache_kv.dtype)
    keep = torch.where(ok[first][:, None, None], new_rows[first],
                       flat[addr[first]])
    flat[addr] = torch.where(ok[:, None, None], new_rows, keep)


def _combine_exact(m_p, l_p, acc_p):
    """Cross-shard flash-softmax combine over the shard axis (dim 1) for
    Nq queries: m, l (B, P, Hq, Nq), acc (B, P, Nq, Hq, hd) ->
    (B, Nq, Hq, hd).  Any disjoint column sets combine the same way (the
    chunked and packed ticks add their intra-tick columns as one more
    entry of the axis).  Sets with no valid column (m = NEG) cancel via
    corr = 0."""
    m_g = m_p.amax(dim=1, keepdim=True)
    corr = torch.exp(m_p - m_g)                                  # (B,P,Hq,Nq)
    l_c = (l_p * corr).sum(dim=1)                                # (B,Hq,Nq)
    acc_c = (acc_p * corr.transpose(2, 3)[..., None]).sum(dim=1)
    return acc_c / torch.clamp(l_c, min=1e-30).transpose(1, 2)[..., None]


def shard_stats(q, k, v, valid, scale, *, log_gz=None, kz=None, vz=None,
                rows=None, backend="auto"):
    """The decode kernel's partial stats of every (query row, shard),
    shaped for ``_combine_exact``: q (Bq,1,Hq,hd); k, v (R,P,M,Hkv,hd)
    the whole cache; valid (Bq,P,M); log_gz (Bq,P,m); kz, vz
    (R,m,Hkv,hd); rows (Bq,) int32, the cache row of each query row
    (None: row i reads row i).  Returns m, l (Bq,P,Hq,1) and acc
    (Bq,P,1,Hq,hd)."""
    bq, _, hq, hd = q.shape
    r, p, m_loc, hkv = k.shape[:4]
    m_p, l_p, acc_p = decode_stats(
        q, k.view(r * p, m_loc, hkv, hd), v.view(r * p, m_loc, hkv, hd),
        valid.reshape(bq * p, m_loc),
        None if log_gz is None else log_gz.reshape(bq * p, -1), kz, vz,
        scale=scale, rows=rows, backend=backend)
    return (m_p.view(bq, p, hq, 1), l_p.view(bq, p, hq, 1),
            acc_p.view(bq, p, 1, hq, hd))


def decode_attention(q, k, v, valid, scale, *, gz=None, kz=None, vz=None,
                     owner=None, mode="exact", rows=None, backend="auto"):
    """Per-token decode attention over the shard-stacked cache.

    q (Bq,1,Hq,hd); k, v (R,P,M,Hkv,hd); valid (Bq,P,M) bool; rows
    (Bq,) int32 maps query rows to cache rows (None: the identity).
    Prism extras: gz (Bq,P,m) per-row, per-shard means repeat counts
    (0 = dead column), kz/vz (R,m,Hkv,hd), owner (Bq,P) bool.  Returns
    (Bq,1,Hq,hd)."""
    log_gz = log_repeats(gz) if kz is not None else None
    m_p, l_p, acc_p = shard_stats(q, k, v, valid, scale, log_gz=log_gz,
                                  kz=kz, vz=vz, rows=rows, backend=backend)
    if mode == "prism":
        # scaling-aware softmax already folded into the stats: normalize
        # per shard and take the owner's view (the reference's psum of the
        # owner-masked outputs)
        out = acc_p / torch.clamp(l_p, min=1e-30).transpose(2, 3)[..., None]
        out = torch.where(owner[:, :, None, None, None], out,
                          torch.zeros_like(out)).sum(dim=1)
    else:
        out = _combine_exact(m_p, l_p, acc_p)
    return out.to(v.dtype)


def prism_gz(cols, counts, pos):
    """The repeat counts (Bq, P, m) under which each query's shards see
    the means columns: ``counts`` (Bq, m) or (m,) the means' filled sizes,
    ``pos`` (Bq,) the query positions (-1 = dead entry, which sees none).
    A shard's own means are masked (its columns are exact), and a mean is
    visible once every position it covers, [lo, lo + count), is in the
    query's past."""
    cnt = counts[..., None, :]                               # (Bq, 1, m)
    live = (cols.g > 0) & (cols.lo + cnt <= pos[:, None, None] + 1)
    return torch.where(live, cnt, torch.zeros_like(cnt))


def lm_head(cfg: ModelConfig, params, x):
    """Final norm and the tied-embedding LM head: x (..., D) -> logits
    (..., V) f32."""
    x = norm(params["final_norm"], x, cfg.norm_kind)
    return (x @ params["embed"]["table"].T.to(x.dtype)).float()


def attn_decode(p, spec: AttnSpec, cfg: ModelConfig, x, c, pos,
                lay: ServeLayout, hp: ServeHParams, cols):
    """x (B,1,D), pos (B,) -> out (B,1,D); writes this token's K/V into
    the layer cache ``c`` in place.  ``cols`` = (write plan, owner,
    valid)."""
    plan, owner, valid = cols
    xn = norm(p["ln1"], x, cfg.norm_kind)
    q = attn_project_q(p["attn"], spec, xn)
    k_new, v_new = attn_project_kv(p["attn"], spec, xn)
    scale = spec.head_dim ** -0.5
    _write_kv(c["k"], k_new[:, 0], plan)
    _write_kv(c["v"], v_new[:, 0], plan)
    if hp.decode_mode == "prism" and "kz" in c:
        # repeat counts ride in the cache
        cols = means_columns(lay.n_seq, lay.n_loc0, lay.L, x.device)
        gz = prism_gz(cols, c["gz"], pos)                    # (B, P, m)
        out = decode_attention(q, c["k"], c["v"], valid, scale, gz=gz,
                               kz=c["kz"], vz=c["vz"], owner=owner,
                               mode="prism", backend=hp.backend)
    else:
        out = decode_attention(q, c["k"], c["v"], valid, scale,
                               backend=hp.backend)
    return attn_output(p["attn"], out)


def block_decode(cfg: ModelConfig, p, x, c, pos, lay: ServeLayout,
                 hp: ServeHParams, cols):
    """One residual ``attn`` block, single-token decode."""
    x = x + attn_decode(p, attn_spec(cfg), cfg, x, c, pos, lay, hp, cols)
    return x + mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_kind), cfg.mlp_kind)


def embed_tokens(cfg: ModelConfig, params, token, pos):
    """token (B, T), pos (B, T) -> x (B, T, D) with learned positions,
    per request and per token.  A dead entry (pos = -1) still embeds
    (its position clamped) but never reaches the cache."""
    tbl = params["pos_embed"]["table"]
    x = embed(params["embed"], token)
    return x + tbl[torch.clamp(pos, 0, tbl.shape[0] - 1)].to(x.dtype)


def serve_step(cfg: ModelConfig, params, cache, token, pos,
               lay: ServeLayout, hp: ServeHParams):
    """(token (B,), pos (B,)) -> (logits (B, V) f32, cache).  The cache is
    updated in place and returned."""
    slot, owner, col_pos = _decode_cols(lay, pos)
    valid = col_pos[None] <= pos[:, None, None]              # (B, P, cap_l)
    rows = torch.arange(pos.shape[0], device=pos.device)
    cols = (write_plan(rows, slot, owner, lay.n_seq, lay.cap_l), owner,
            valid)
    x = embed_tokens(cfg, params, token[:, None], pos[:, None])
    for p, c in zip(params["layers"], cache):
        x = block_decode(cfg, p, x, c, pos, lay, hp, cols)
    return lm_head(cfg, params, x[:, 0]), cache


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, *, gen: int,
             prism: PrismConfig, lay: ServeLayout, hp: ServeHParams,
             forced: torch.Tensor | None = None):
    """Prefill, then ``gen - 1`` greedy decode steps.

    ``forced`` (B, gen - 1) teacher-forces the decoded tokens instead of
    feeding back the argmax.  Returns (tokens (B, gen), logits
    (gen, B, V), times): tokens[:, i] is the argmax of logits[i];
    ``times`` holds prefill_ms and decode_ms_per_token, from CUDA events
    on a card and from the host clock on the CPU (``times['clock']``)."""
    b, n = prompts.shape
    on_card = prompts.is_cuda
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        mark = [e.record for e in ev]
    else:
        stamps = []
        mark = [lambda: stamps.append(time.perf_counter())] * 3
    mark[0]()
    logits, cache = prefill(cfg, params, prompts, prism, lay, hp)
    mark[1]()
    out = [logits]
    for i in range(gen - 1):
        tok = out[-1].argmax(dim=-1) if forced is None else forced[:, i]
        pos = torch.full((b,), n + i, dtype=torch.long,
                         device=prompts.device)
        logits, cache = serve_step(cfg, params, cache, tok, pos, lay, hp)
        out.append(logits)
    mark[2]()
    logits = torch.stack(out)
    if on_card:
        torch.cuda.synchronize(prompts.device)
        t_pre, t_dec = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        clock = "cuda_events"
    else:
        t_pre = 1e3 * (stamps[1] - stamps[0])
        t_dec = 1e3 * (stamps[2] - stamps[1])
        clock = "host"
    times = {"prefill_ms": t_pre,
             "decode_ms_per_token": t_dec / max(1, gen - 1), "clock": clock}
    return logits.argmax(dim=-1).T, logits, times
