"""The engine's tick programs on one card: chunked prefill and the
token-packed tick, unpaged, for the ``attn`` block kind.

Both write straight into the decode-layout cache (``init_cache``) IN
PLACE, at per-token (row, shard, column) addresses, so a request is
admitted into its decode slot with no grow or insert step.  Attention is
exact and has two disjoint column sets, combined over the explicit shard
axis with ``_combine_exact``:

  * the **prior columns**, everything a request laid down before the
    tick (``col_pos < off``), through the single-token decode kernel:
    the chunk's C·Hq queries folded into its GQA head axis, or the
    packed tokens as its batch, each reading its slot's cache row in
    place through the kernel's row map;
  * the **intra-tick columns**, the tick's own just-projected K/V under
    a per-query causal bias (``chunk_softmax_stats``), a small dense
    pass.  The reference counts each such column on the one shard that
    owns it and sums over shards; in one process the columns enter the
    combine as one more entry of the shard axis, the same function.

In prism decode mode both programs also advance each request's
Segment-Means state (``zsum``, the repeat counts ``gz``, and ``kz``/``vz``
projected from the means) over its REAL prompt tokens only, so a short
prompt's means never average empty columns.  The packed tick serves its
decode tokens the prism owner view over the means cache, through a
second kernel launch, as ``serve_step`` does.

Neither program samples a prompt token: once a request's prompt is
cached, the rewind re-feeds its last prompt token at ``pos = n - 1`` as
its first decode token (an idempotent rewrite of that K/V column), which
gives the next-token logits.
"""
from __future__ import annotations

import torch

from ..core.masks import NEG_INF
from ..core.segment_means import segment_fill_counts
from ..kernels.decode_attention import chunk_softmax_stats
from ..models.config import ModelConfig
from ..models.layers import (attn_output, attn_project_kv, attn_project_q,
                             mlp, norm)
from ..models.transformer import attn_spec, check_supported
from ..sharding.context import means_columns
from .serve import (ServeHParams, ServeLayout, _combine_exact,
                    _decode_cols, _write_kv, decode_attention, embed_tokens,
                    lm_head, prism_gz, shard_stats, write_plan)


def _with_self(prior, self_stats):
    """Append the intra-tick stats to the per-shard prior stats as one
    more entry of the shard axis: m, l (B,P,Hq,Nq) and (B,1,Hq,Nq); acc
    (B,P,Nq,Hq,hd) and (B,1,Nq,Hq,hd)."""
    return tuple(torch.cat([a, b], dim=1) for a, b in zip(prior, self_stats))


def _capture_means(p, spec, cfg: ModelConfig, c, inc, cnt, restart, act):
    """Advance the Segment-Means state of the rows ``act`` (B,) IN PLACE.

    ``inc`` (B, m, D) f32 sums the tick's layer inputs into each row's
    segment columns; ``cnt`` (B, m) counts each segment's real tokens
    after the tick (``segment_fill_counts``) and ``restart`` (B,) marks
    the rows whose running sums start over (offset 0)."""
    zsum = torch.where(restart[:, None, None], 0.0, c["zsum"]) + inc
    z = (zsum / torch.clamp(cnt, min=1.0)[..., None]).to(c["kz"].dtype)
    kz, vz = attn_project_kv(p["attn"], spec,
                             norm(p["ln1"], z, cfg.norm_kind))
    sel = act[:, None, None, None]
    c["kz"].copy_(torch.where(sel, kz.to(c["kz"].dtype), c["kz"]))
    c["vz"].copy_(torch.where(sel, vz.to(c["vz"].dtype), c["vz"]))
    c["gz"].copy_(torch.where(act[:, None], cnt, c["gz"]))
    c["zsum"].copy_(zsum)


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------

def chunk_attention(q, k, v, valid, bias_self, k_new, v_new, scale,
                    backend="auto"):
    """Exact attention for one prefill chunk.  q (B,C,Hq,hd); k, v
    (B,P,cap_l,Hkv,hd) the whole cache, passed in place (the prior
    columns are each shard's leading ``n_loc0``; ``valid`` (B,P,cap_l)
    is ``col_pos < off``, False past them); k_new, v_new (B,C,Hkv,hd)
    the chunk's own rows under ``bias_self`` (B,C,C).  The C·Hq queries
    are folded KV-head-major into the kernel's GQA head axis, so query
    head i reads KV head i // (C·grp).  Returns (B,C,Hq,hd)."""
    b, c, hq, hd = q.shape
    p, hkv = k.shape[1], k.shape[3]
    grp = hq // hkv
    qf = (q.reshape(b, c, hkv, grp, hd).transpose(1, 2)
          .reshape(b, 1, c * hq, hd))
    m1, l1, a1 = shard_stats(qf, k, v, valid, scale, backend=backend)

    def unfold_stat(s):                        # (B,P,C·Hq,1) -> (B,P,Hq,C)
        return (s.reshape(b, p, hkv, c, grp).transpose(3, 4)
                .reshape(b, p, hq, c))
    a1 = (a1.reshape(b, p, hkv, c, grp, hd).permute(0, 1, 3, 2, 4, 5)
          .reshape(b, p, c, hq, hd))
    m2, l2, a2 = chunk_softmax_stats(q, k_new, v_new, bias_self, scale)
    m, l, acc = _with_self((unfold_stat(m1), unfold_stat(l1), a1),
                           (m2[:, None, ..., 0], l2[:, None, ..., 0],
                            a2[:, None]))
    return _combine_exact(m, l, acc).to(v.dtype)


def chunk_prefill_step(cfg: ModelConfig, params, cache, tokens, off, nreal,
                       lay: ServeLayout, hp: ServeHParams):
    """Advance every mid-prefill row by up to C prompt tokens at its own
    offset: row i's ``tokens[i, :nreal[i]]`` land at positions
    ``[off[i], off[i] + nreal[i])``; a row not prefilling passes
    ``off = -1``.  tokens (B, C), off (B,), nreal (B,).  Updates and
    returns ``cache``; no logits (see the module docstring's rewind)."""
    check_supported(cfg)
    b, c = tokens.shape
    j = torch.arange(c, device=tokens.device)
    alive = (off[:, None] >= 0) & (j[None, :] < nreal[:, None])   # (B, C)
    row_pos = torch.where(alive, off[:, None] + j, -1)
    slot, owner, col_pos = _decode_cols(lay, row_pos.reshape(-1))
    plan = write_plan(torch.arange(b, device=tokens.device)
                      .repeat_interleave(c), slot, owner, lay.n_seq,
                      lay.cap_l)
    valid = col_pos[None] < torch.clamp(off, min=0)[:, None, None]
    bias_self = torch.where((j[None, :] <= j[:, None])[None]
                            & alive[:, :, None] & alive[:, None, :],
                            0.0, NEG_INF)                        # (B, C, C)
    prism = hp.decode_mode == "prism"
    if prism:
        cols = means_columns(lay.n_seq, lay.n_loc0, lay.L, tokens.device)
        seg = ((cols.lo <= row_pos[..., None])
               & (row_pos[..., None] <= cols.hi)).float()        # (B, C, m)
        cnt = segment_fill_counts(
            cols.lo, cols.hi, torch.clamp(off, min=0) + alive.sum(dim=1))
    spec = attn_spec(cfg)
    scale = spec.head_dim ** -0.5
    x = embed_tokens(cfg, params, tokens, row_pos)               # (B, C, D)
    for p, cc in zip(params["layers"], cache):
        xn = norm(p["ln1"], x, cfg.norm_kind)
        q = attn_project_q(p["attn"], spec, xn)
        k_new, v_new = attn_project_kv(p["attn"], spec, xn)
        _write_kv(cc["k"], k_new.flatten(0, 1), plan)
        _write_kv(cc["v"], v_new.flatten(0, 1), plan)
        o = chunk_attention(q, cc["k"], cc["v"], valid, bias_self, k_new,
                            v_new, scale, backend=hp.backend)
        if prism:
            inc = torch.einsum("bcm,bcd->bmd", seg, x.float())
            _capture_means(p, spec, cfg, cc, inc, cnt, off == 0, off >= 0)
        x = x + attn_output(p["attn"], o)
        x = x + mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_kind), cfg.mlp_kind)
    return cache


# --------------------------------------------------------------------------
# token-packed tick
# --------------------------------------------------------------------------

def packed_attention(q, k, v, valid, bias_self, k_new, v_new, rows, scale,
                     backend="auto"):
    """Exact attention for one packed tick.  q (T,1,Hq,hd); k, v
    (B,P,cap_l,Hkv,hd) the whole cache, each token reading its slot's
    row ``rows`` (T,) int32 in place; valid (T,P,cap_l) is
    ``col_pos < off``; k_new, v_new (T,1,Hkv,hd) under ``bias_self``
    (1,T,T), which keeps tokens of different requests apart.  Returns
    (T,1,Hq,hd)."""
    m1, l1, a1 = shard_stats(q, k, v, valid, scale, rows=rows,
                             backend=backend)
    m2, l2, a2 = chunk_softmax_stats(q[:, 0][None], k_new[:, 0][None],
                                     v_new[:, 0][None], bias_self, scale)
    # (1,Hq,T,1) / (1,T,Hq,hd) -> one more shard entry of each token
    m, l, acc = _with_self(
        (m1, l1, a1), (m2[0].transpose(0, 1)[:, None],
                       l2[0].transpose(0, 1)[:, None],
                       a2[0][:, None, None]))
    return _combine_exact(m, l, acc).to(v.dtype)


def packed_step(cfg: ModelConfig, params, cache, tokens, slot, pos, off,
                is_prefill, lay: ServeLayout, hp: ServeHParams):
    """One tick over a flat batch of T mixed prefill and decode tokens.

    Entry t of the (T,) vectors: ``slot`` its request's cache row (-1 =
    dead entry; ragged ticks leave the tail dead), ``pos`` its position,
    ``off`` the first position its request packs this tick (a decode
    token has ``off == pos``), ``is_prefill`` 1 for prompt tokens, 0 for
    decode tokens.  Decode tokens come first (at most one per slot), so
    the LM head runs over the first min(B, T) entries only.  Returns
    (logits (min(B, T), V) f32, cache), the cache updated in place."""
    check_supported(cfg)
    b = cache[0]["k"].shape[0]
    dev = tokens.device
    alive = (slot >= 0) & (pos >= 0)
    rows = torch.clamp(slot, 0, b - 1)
    col, owner, col_pos = _decode_cols(lay, pos)                 # (T, P)
    owner = owner & alive[:, None]
    plan = write_plan(rows, col, owner, lay.n_seq, lay.cap_l)
    rows32 = rows.to(torch.int32)
    valid = alive[:, None, None] & (
        col_pos[None] < torch.clamp(off, min=0)[:, None, None])
    bias_self = torch.where(
        (slot[None, :] == slot[:, None]) & (pos[None, :] <= pos[:, None])
        & alive[:, None] & alive[None, :], 0.0, NEG_INF)[None]   # (1, T, T)
    prism = hp.decode_mode == "prism"
    if prism:
        cols = means_columns(lay.n_seq, lay.n_loc0, lay.L, dev)
        pos_alive = torch.where(alive, pos, -1)
        valid_le = col_pos[None] <= pos_alive[:, None, None]
        is_dec = (is_prefill == 0)[:, None, None, None]
        sel = owner & (is_prefill == 0)[:, None]
        # the Segment-Means capture over the tick's real prompt tokens
        upd = (is_prefill != 0) & alive
        r_upd = torch.where(upd, slot, b)                        # b: sink
        big = torch.iinfo(off.dtype).max
        off_b = torch.full((b + 1,), big, dtype=off.dtype,
                           device=dev).scatter_reduce(
            0, r_upd, torch.where(upd, off, big), "amin")[:b]
        filled = torch.zeros(b + 1, dtype=pos.dtype, device=dev
                             ).scatter_reduce(
            0, r_upd, torch.where(upd, pos + 1, 0), "amax")[:b]
        act = filled > 0
        cnt = segment_fill_counts(cols.lo, cols.hi, filled)
        seg = ((r_upd[None, :] == torch.arange(b, device=dev)[:, None])
               [:, :, None] & (cols.lo <= pos[:, None])
               & (pos[:, None] <= cols.hi)).float()              # (B, T, m)
    spec = attn_spec(cfg)
    scale = spec.head_dim ** -0.5
    x = embed_tokens(cfg, params, tokens[:, None], pos[:, None])  # (T,1,D)
    for p, c in zip(params["layers"], cache):
        xn = norm(p["ln1"], x, cfg.norm_kind)
        q = attn_project_q(p["attn"], spec, xn)
        k_new, v_new = attn_project_kv(p["attn"], spec, xn)
        _write_kv(c["k"], k_new[:, 0], plan)
        _write_kv(c["v"], v_new[:, 0], plan)
        o = packed_attention(q, c["k"], c["v"], valid, bias_self, k_new,
                             v_new, rows32, scale, backend=hp.backend)
        if prism:
            # decode tokens take the owner view over the means cache, as
            # serve_step does; prompt tokens keep the exact result
            gz = prism_gz(cols, c["gz"][rows], pos_alive)        # (T,P,m)
            o_pz = decode_attention(q, c["k"], c["v"], valid_le, scale,
                                    gz=gz, kz=c["kz"], vz=c["vz"], owner=sel,
                                    mode="prism", rows=rows32,
                                    backend=hp.backend)
            o = torch.where(is_dec, o_pz, o)
            inc = torch.einsum("btm,td->bmd", seg, x[:, 0].float())
            _capture_means(p, spec, cfg, c, inc, cnt, act & (off_b == 0),
                           act)
        x = x + attn_output(p["attn"], o)
        x = x + mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_kind), cfg.mlp_kind)
    return lm_head(cfg, params, x[:min(b, x.shape[0]), 0]), cache


# --------------------------------------------------------------------------
# result packing (the engine's one small device-to-host copy per tick)
# --------------------------------------------------------------------------

def pack(logits, row_slot, is_decode, lengths):
    """logits (L, V), row_slot (L,), is_decode (L,), lengths (S,) ->
    (S, 4) int32, per slot ``[token, valid, length, finite]``: the
    greedy token of the slot's decode row (ties break at the first
    maximum, as ``np.argmax``), 1 if the slot decoded this tick, its
    cache length, and 0 if its row held a non-finite logit.  A slot
    without a decode row gives ``[0, 0, length, 1]``."""
    s = lengths.shape[0]
    dev = logits.device
    out = torch.zeros((s + 1, 4), dtype=torch.int32, device=dev)
    out[:, 3] = 1
    idx = torch.where(is_decode > 0, row_slot.long(), s)     # s: sink row
    out[idx, 0] = logits.argmax(dim=-1).to(torch.int32)
    out[idx, 1] = 1
    out[idx, 3] = torch.isfinite(logits).all(dim=-1).to(torch.int32)
    out[:s, 2] = lengths.to(torch.int32)
    return out[:s]


def merge(tok_host, src, prev):
    """The double-buffer splice: entry i takes ``prev[src[i], 0]``, the
    token its slot sampled last tick (still on the device), where
    ``src[i] >= 0``, else the host-planned ``tok_host[i]``."""
    pick = prev[torch.clamp(src, 0, prev.shape[0] - 1).long(), 0]
    return torch.where(src >= 0, pick.to(tok_host.dtype), tok_host)
