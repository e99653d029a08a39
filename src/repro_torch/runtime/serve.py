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
    last = norm(params["final_norm"], ctx.last_shard(x[:, -1]),
                cfg.norm_kind)                               # (B, D)
    logits = last @ params["embed"]["table"].T.to(last.dtype)
    return logits.float(), cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _decode_cols(lay: ServeLayout, pos: torch.Tensor):
    """(write slot (B, P), owner (B, P), col_pos (P, cap_l)) for the
    (B,) positions ``pos`` (-1 = idle row: owner False everywhere)."""
    n0, n_loc0, n_seq = lay.prefill_len, lay.n_loc0, lay.n_seq
    idx = torch.arange(n_seq, device=pos.device)[None, :]       # (1, P)
    extra = (pos - n0)[:, None]                                  # (B, 1)
    slot = torch.where(extra >= 0, n_loc0 + extra // n_seq,
                       pos[:, None] - idx * n_loc0)
    wr_shard = torch.where(extra >= 0, extra % n_seq,
                           torch.clamp(pos[:, None] // max(n_loc0, 1),
                                       0, n_seq - 1))
    owner = (wr_shard == idx) & (slot >= 0) & (slot < lay.cap_l)
    j = torch.arange(lay.cap_l, device=pos.device)[None, :]
    col_pos = torch.where(j < n_loc0, idx.T * n_loc0 + j,
                          n0 + (j - n_loc0) * n_seq + idx.T)
    return slot, owner, col_pos


def _write_slot(cache_kv, new_row, slot, owner):
    """Write (B, 1, Hkv, hd) rows into the (B, P, cap_l, Hkv, hd) cache at
    per-request slots, IN PLACE.  Non-owner (row, shard) pairs get their
    current column written back unchanged: an O(B·P) scatter with no
    host synchronisation, independent of the cache capacity."""
    b, p, cap_l = cache_kv.shape[:3]
    rows = torch.arange(b, device=slot.device)[:, None].expand(b, p)
    shards = torch.arange(p, device=slot.device)[None, :].expand(b, p)
    cols = torch.clamp(slot, 0, cap_l - 1)
    cur = cache_kv[rows, shards, cols]                      # (B, P, Hkv, hd)
    upd = torch.where(owner[..., None, None],
                      new_row[:, 0][:, None].to(cache_kv.dtype), cur)
    cache_kv[rows, shards, cols] = upd


def _combine_exact(m_p, l_p, acc_p):
    """Cross-shard flash-softmax combine over the shard axis (dim 1):
    m, l (B, P, Hq), acc (B, P, Hq, hd) -> (B, Hq, hd).  Shards with no
    valid column (m = NEG) cancel via corr = 0."""
    m_g = m_p.amax(dim=1, keepdim=True)
    corr = torch.exp(m_p - m_g)
    l_c = (l_p * corr).sum(dim=1)
    acc_c = (acc_p * corr[..., None]).sum(dim=1)
    return acc_c / torch.clamp(l_c, min=1e-30)[..., None]


def decode_attention(q, k, v, valid, scale, *, gz=None, kz=None, vz=None,
                     owner=None, mode="exact", backend="auto"):
    """Per-token decode attention over the shard-stacked cache.

    q (B,1,Hq,hd); k, v (B,P,M,Hkv,hd); valid (B,P,M) bool.  Prism extras:
    gz (B,P,m) per-row, per-shard means repeat counts (0 = dead column),
    kz/vz (B,m,Hkv,hd), owner (B,P) bool.  Returns (B,1,Hq,hd)."""
    b, p, m_loc, hkv, hd = k.shape
    hq = q.shape[2]
    log_gz = (log_repeats(gz).reshape(b * p, -1) if kz is not None
              else None)
    m_p, l_p, acc_p = decode_stats(
        q, k.reshape(b * p, m_loc, hkv, hd), v.reshape(b * p, m_loc, hkv, hd),
        valid.reshape(b * p, m_loc), log_gz, kz, vz, scale=scale,
        backend=backend)
    m_p, l_p = m_p.reshape(b, p, hq), l_p.reshape(b, p, hq)
    acc_p = acc_p.reshape(b, p, hq, hd)
    if mode == "prism":
        # scaling-aware softmax already folded into the stats: normalize
        # per shard and take the owner's view (the reference's psum of the
        # owner-masked outputs)
        out = acc_p / torch.clamp(l_p, min=1e-30)[..., None]
        out = torch.where(owner[:, :, None, None], out,
                          torch.zeros_like(out)).sum(dim=1)
    else:
        out = _combine_exact(m_p, l_p, acc_p)
    return out[:, None].to(v.dtype)


def attn_decode(p, spec: AttnSpec, cfg: ModelConfig, x, c, pos,
                lay: ServeLayout, hp: ServeHParams, cols):
    """x (B,1,D), pos (B,) -> out (B,1,D); writes this token's K/V into
    the layer cache ``c`` in place.  ``cols`` = (slot, owner, valid)."""
    slot, owner, valid = cols
    xn = norm(p["ln1"], x, cfg.norm_kind)
    q = attn_project_q(p["attn"], spec, xn)
    k_new, v_new = attn_project_kv(p["attn"], spec, xn)
    scale = spec.head_dim ** -0.5
    _write_slot(c["k"], k_new, slot, owner)
    _write_slot(c["v"], v_new, slot, owner)
    if hp.decode_mode == "prism" and "kz" in c:
        # repeat counts ride in the cache; a shard's own means are masked
        # (its columns are exact), and a mean is visible once every
        # position it covers, [lo, lo + gz), is in the query's past
        cols = means_columns(lay.n_seq, lay.n_loc0, lay.L, x.device)
        cnt = c["gz"][:, None, :]                            # (B, 1, m)
        live = (cols.g > 0) & (cols.lo + cnt <= pos[:, None, None] + 1)
        gz = torch.where(live, cnt, torch.zeros_like(cnt))   # (B, P, m)
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


def embed_token(cfg: ModelConfig, params, token, pos):
    """token (B,), pos (B,) -> x (B,1,D) with learned positions."""
    tbl = params["pos_embed"]["table"]
    x = embed(params["embed"], token)
    x = x + tbl[torch.clamp(pos, 0, tbl.shape[0] - 1)].to(x.dtype)
    return x[:, None]


def serve_step(cfg: ModelConfig, params, cache, token, pos,
               lay: ServeLayout, hp: ServeHParams):
    """(token (B,), pos (B,)) -> (logits (B, V) f32, cache).  The cache is
    updated in place and returned."""
    slot, owner, col_pos = _decode_cols(lay, pos)
    valid = col_pos[None] <= pos[:, None, None]              # (B, P, cap_l)
    cols = (slot, owner, valid)
    x = embed_token(cfg, params, token, pos)
    for p, c in zip(params["layers"], cache):
        x = block_decode(cfg, p, x, c, pos, lay, hp, cols)
    x = norm(params["final_norm"], x, cfg.norm_kind)
    logits = x[:, 0] @ params["embed"]["table"].T.to(x.dtype)
    return logits.float(), cache


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
