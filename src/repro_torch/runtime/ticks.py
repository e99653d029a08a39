"""The engine's tick programs on one card or a mesh's rank: chunked
prefill and the token-packed tick, for the ``attn`` and ``moe`` block
kinds, on the dense cache or the paged one (a page map (B, ppr) and, in
prism mode, a state map (B,) given; see ``runtime/serve.py``).  A moe
block routes all of a call's tokens as one group: a chunk call's B·C, a
packed tick's T entries, dead and padding entries included, as the
reference's do.

Both write straight into the decode-layout cache (``init_cache``) IN
PLACE, at per-token (row or page, shard, column) addresses, so a request
is admitted into its decode slot with no grow or insert step.  Attention is
exact and has two disjoint column sets, combined over the explicit shard
axis with ``_combine_exact``:

  * the **prior columns**, everything a request laid down before the
    tick (``col_pos < off``), through the single-token decode kernel:
    the chunk's C·Hq queries folded into its GQA head axis, or the
    packed tokens as its batch, each reading its slot's cache row in
    place through the kernel's row map (and the paged pool through its
    page table);
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

Over a mesh of ranks (``params`` a rank's ``MeshParams``, the layout the
mesh's), as the reference's ``make_chunk_prefill_step`` /
``make_packed_step`` run under ``shard_map``: the rank holds its
sequence shard of the cache, each layer's weights are gathered on use,
the table embeds and the head answers over the vocabulary shard
(``gather_logits`` whole).  The tick's tokens ride whole on every rank,
but for a chunk call on the dense cache, which takes the rank's batch
rows.  Each new K/V row is written, and counted in the intra-tick pass,
by the one shard that owns its column; the prior columns' stats are the
rank's own, combined over the sequence group, and for a packed tick on
the dense cache over the batch axes too (a rank that does not hold a
token's row gives it empty stats).  The prism means of the tick's
tokens are projected on the rank's own columns and gathered over the
sequence group (``exchange``).
"""
from __future__ import annotations

import torch

from ..core.masks import NEG_INF
from ..core.segment_means import segment_fill_counts
from ..kernels.decode_attention import chunk_softmax_stats
from ..models.config import ModelConfig
from ..models.layers import (attn_output, attn_project_kv, attn_project_q,
                             norm)
from ..models.transformer import (attn_spec, block_residual, check_decoder,
                                  check_supported)
from ..sharding import comm
from ..sharding.context import means_columns
from .serve import (ServeHParams, ServeLayout, _check_on_mesh, _combine_exact,
                    _decode_cols, _layers, _mesh, _tree, _write_kv,
                    batch_rows, decode_attention, decode_moe_ctx,
                    embed_tokens, lm_head, prism_gz, shard_stats, state_rows,
                    write_plan)


def _with_self(prior, self_stats):
    """Append the intra-tick stats to the per-shard prior stats as one
    more entry of the shard axis: m, l (B,P,Hq,Nq) and (B,1,Hq,Nq); acc
    (B,P,Nq,Hq,hd) and (B,1,Nq,Hq,hd)."""
    return tuple(torch.cat([a, b], dim=1) for a, b in zip(prior, self_stats))


def state_plan(c, state_map, act):
    """Where a step reads and writes the Segment-Means state of a paged
    cache, made once a step (every layer's state pool has the same rows):
    ``(sr, dst)`` (B,) int64, the clamped rows read (``state_rows``) and
    the rows written, the sink (the pool's last row) for a row not
    advanced (``act`` False) or unmapped (-1).  None for a dense cache."""
    if state_map is None:
        return None
    dst = torch.where(act & (state_map >= 0), state_map.long(),
                      c["gz"].shape[0] - 1)
    return state_rows(c, state_map), dst


def _capture_means(p, spec, cfg: ModelConfig, c, inc, cnt, restart, act,
                   mid, splan=None, seq=None):
    """Advance the Segment-Means state of the rows ``act`` (B,) IN PLACE.

    ``inc`` (B, m, D) f32 sums the tick's layer inputs into each row's
    segment columns; ``cnt`` (B, m) counts each segment's real tokens
    after the tick (``segment_fill_counts``) and ``restart`` (B,) marks
    the rows whose running sums start over (offset 0).  The means' keys
    take RoPE at ``mid`` (m,), their segments' midpoints.  With ``splan``
    (``state_plan``) the state lives in the state pool: row b reads pool
    row ``sr[b]`` and writes ``dst[b]``; each active slot has a row of
    its own, and the rest share the sink, whose bytes nothing reads.
    ``seq`` (a mesh's sequence group): the rank projects the means of its
    own shard's columns, and the keys and values of every shard's are
    gathered over the group."""
    prev = c["zsum"] if splan is None else c["zsum"][splan[0]]
    zsum = torch.where(restart[:, None, None], 0.0, prev) + inc
    z = (zsum / torch.clamp(cnt, min=1.0)[..., None]).to(c["kz"].dtype)
    if seq is not None:
        n = z.shape[1] // seq.size
        own = slice(seq.index * n, (seq.index + 1) * n)
        z, mid = z[:, own], mid[own]
    kz, vz = attn_project_kv(p["attn"], spec,
                             norm(p["ln1"], z, cfg.norm_kind), mid)
    if seq is not None:
        kv = comm.all_gather(torch.stack([kz, vz]), seq, "exchange", dim=2)
        kz, vz = kv[0], kv[1]
    if splan is None:
        sel = act[:, None, None, None]
        c["kz"].copy_(torch.where(sel, kz.to(c["kz"].dtype), c["kz"]))
        c["vz"].copy_(torch.where(sel, vz.to(c["vz"].dtype), c["vz"]))
        c["gz"].copy_(torch.where(act[:, None], cnt, c["gz"]))
        c["zsum"].copy_(zsum)
        return
    for name, rows in (("kz", kz), ("vz", vz), ("gz", cnt), ("zsum", zsum)):
        c[name].index_put_((splan[1],), rows.to(c[name].dtype))


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------

def chunk_attention(q, k, v, valid, bias_self, k_new, v_new, scale,
                    backend="auto", pages=None, seq=None):
    """Exact attention for one prefill chunk.  q (B,C,Hq,hd); k, v
    (B,P,cap_l,Hkv,hd) the whole cache, passed in place (the prior
    columns are each shard's leading ``n_loc0``; ``valid`` (B,P,cap_l)
    is ``col_pos < off``, False past them), or the page pool with
    ``pages`` (B, n_loc0 // pc), the rows' prefill pages, and valid
    (B,P,n_loc0); k_new, v_new (B,C,Hkv,hd) the chunk's own rows under
    ``bias_self`` (B,C,C).  The C·Hq queries are folded KV-head-major
    into the kernel's GQA head axis, so query head i reads KV head
    i // (C·grp).  ``seq``: a mesh's sequence group, the combine's ranks.
    Returns (B,C,Hq,hd)."""
    b, c, hq, hd = q.shape
    p, hkv = k.shape[1], k.shape[3]
    grp = hq // hkv
    qf = (q.reshape(b, c, hkv, grp, hd).transpose(1, 2)
          .reshape(b, 1, c * hq, hd))
    m1, l1, a1 = shard_stats(qf, k, v, valid, scale, pages=pages,
                             backend=backend)

    def unfold_stat(s):                        # (B,P,C·Hq,1) -> (B,P,Hq,C)
        return (s.reshape(b, p, hkv, c, grp).transpose(3, 4)
                .reshape(b, p, hq, c))
    a1 = (a1.reshape(b, p, hkv, c, grp, hd).permute(0, 1, 3, 2, 4, 5)
          .reshape(b, p, c, hq, hd))
    m2, l2, a2 = chunk_softmax_stats(q, k_new, v_new, bias_self, scale)
    m, l, acc = _with_self((unfold_stat(m1), unfold_stat(l1), a1),
                           (m2[:, None, ..., 0], l2[:, None, ..., 0],
                            a2[:, None]))
    return _combine_exact(m, l, acc, seq).to(v.dtype)


def check_tick_kinds(cfg: ModelConfig, program: str) -> None:
    """Raise unless every block has a position-addressed attention cache:
    a sliding-window layer's ring holds the last W positions, which a
    chunk or a packed tick does not address, as the reference's
    ``make_chunk_prefill_step`` / ``make_packed_step`` refuse it.  Also
    raise for a model whose prompt carries embeddings (a frontend, an
    image prefix): the programs take tokens only.  The reference's would
    run such a model on its placeholder tokens and drop the image; the
    port refuses it in its engine's words (ROADMAP queue 3)."""
    check_supported(cfg)
    check_decoder(cfg, program)
    if cfg.arch_type == "vlm" or cfg.frontend or cfg.prefix_len:
        raise ValueError(
            f"{program} serves token prompts only; arch {cfg.name!r} "
            f"(arch_type={cfg.arch_type!r}, frontend={cfg.frontend!r}) "
            f"needs embedding inputs")
    for kind in cfg.block_kinds:
        if kind not in ("attn", "moe"):
            raise ValueError(
                f"{program} needs position-addressed attention caches; "
                f"arch {cfg.name!r} has block kind {kind!r}")


def _tick_mesh(cfg: ModelConfig, params, lay: ServeLayout,
               hp: ServeHParams):
    """(mesh, the sequence group, the first shard held) of a tick call,
    (None, None, 0) in one process."""
    mesh = _mesh(params)
    _check_on_mesh(cfg, hp, mesh, lay)
    if hp.decode_tp:
        raise ValueError("the tick programs decode over the FSDP rules: "
                         "decode_tp serves the static path only, as the "
                         "reference's packed step refuses it")
    if mesh is None:
        return None, None, 0
    seq = mesh.group(lay.seq_axes)
    return mesh, seq, seq.index


def chunk_prefill_step(cfg: ModelConfig, params, cache, tokens, off, nreal,
                       lay: ServeLayout, hp: ServeHParams, page_map=None,
                       state_map=None):
    """Advance every mid-prefill row by up to C prompt tokens at its own
    offset: row i's ``tokens[i, :nreal[i]]`` land at positions
    ``[off[i], off[i] + nreal[i])``; a row not prefilling passes
    ``off = -1``.  tokens (B, C), off (B,), nreal (B,); a paged cache
    takes page_map (B, ppr) and state_map (B,) int32.  Updates and
    returns ``cache``; no logits (see the module docstring's rewind).

    On a mesh the vectors are the whole batch's; the dense cache holds
    the rank's batch rows, whose tokens alone the call takes
    (``batch_rows``)."""
    check_tick_kinds(cfg, "chunked prefill")
    mesh, seq, shard0 = _tick_mesh(cfg, params, lay, hp)
    if page_map is None:
        tokens, off, nreal = (batch_rows(t, lay, mesh)
                              for t in (tokens, off, nreal))
    b, c = tokens.shape
    j = torch.arange(c, device=tokens.device)
    alive = (off[:, None] >= 0) & (j[None, :] < nreal[:, None])   # (B, C)
    row_pos = torch.where(alive, off[:, None] + j, -1)
    slot, owner, col_pos = _decode_cols(lay, row_pos.reshape(-1), shard0)
    plan = write_plan(torch.arange(b, device=tokens.device)
                      .repeat_interleave(c), slot, owner, lay.held,
                      lay.cap_l, page_map)
    # the chunk columns this process holds: every live one folded, on a
    # mesh its shard's, so the ranks' intra-tick passes are disjoint
    own = owner.any(dim=-1).view(b, c)
    pages = None
    if page_map is not None:
        # the prior columns lie in the rows' prefill pages under both
        # placements (a position p < n0 has its column below n_loc0)
        pc = cache[0]["k"].shape[2]
        pages = page_map[:, :lay.n_loc0 // pc].contiguous()
        col_pos = col_pos[:, :lay.n_loc0]
    valid = col_pos[None] < torch.clamp(off, min=0)[:, None, None]
    bias_self = torch.where((j[None, :] <= j[:, None])[None]
                            & alive[:, :, None] & own[:, None, :],
                            0.0, NEG_INF)                        # (B, C, C)
    prism = hp.decode_mode == "prism"
    if prism:
        cols = means_columns(lay.n_seq, lay.n_loc0, lay.L, tokens.device)
        seg = ((cols.lo <= row_pos[..., None])
               & (row_pos[..., None] <= cols.hi)).float()        # (B, C, m)
        cnt = segment_fill_counts(
            cols.lo, cols.hi, torch.clamp(off, min=0) + alive.sum(dim=1))
        restart, act = off == 0, off >= 0
        splan = state_plan(cache[0], state_map, act)
    spec = attn_spec(cfg)
    scale = spec.head_dim ** -0.5
    moe_ctx = decode_moe_ctx(cfg, params, hp)
    x = embed_tokens(cfg, params, tokens, row_pos)               # (B, C, D)
    for (kind, p), cc in zip(_layers(cfg, params), cache):
        xn = norm(p["ln1"], x, cfg.norm_kind)
        q = attn_project_q(p["attn"], spec, xn, row_pos)
        k_new, v_new = attn_project_kv(p["attn"], spec, xn, row_pos)
        _write_kv(cc["k"], k_new.flatten(0, 1), plan)
        _write_kv(cc["v"], v_new.flatten(0, 1), plan)
        o = chunk_attention(q, cc["k"], cc["v"], valid, bias_self, k_new,
                            v_new, scale, backend=hp.backend, pages=pages,
                            seq=seq)
        if prism:
            inc = torch.einsum("bcm,bcd->bmd", seg, x.float())
            _capture_means(p, spec, cfg, cc, inc, cnt, restart, act,
                           cols.mid, splan, seq)
        x = block_residual(cfg, kind, p, x, attn_output(p["attn"], o), xn,
                           moe_ctx, hp.routing)
    return cache


# --------------------------------------------------------------------------
# token-packed tick
# --------------------------------------------------------------------------

def packed_attention(q, k, v, valid, bias_self, k_new, v_new, rows, scale,
                     backend="auto", pages=None, group=None):
    """Exact attention for one packed tick.  q (T,1,Hq,hd); k, v
    (B,P,cap_l,Hkv,hd) the whole cache, or the page pool with ``pages``
    (B, ppr), each token reading its slot's row ``rows`` (T,) int32 in
    place; valid (T,P,cap_l) is ``col_pos < off``; k_new, v_new
    (T,1,Hkv,hd) under ``bias_self`` (1,T,T), which keeps tokens of
    different requests apart.  ``group``: a mesh's ranks the combine
    runs over.  Returns (T,1,Hq,hd)."""
    m1, l1, a1 = shard_stats(q, k, v, valid, scale, rows=rows, pages=pages,
                             backend=backend)
    m2, l2, a2 = chunk_softmax_stats(q[:, 0][None], k_new[:, 0][None],
                                     v_new[:, 0][None], bias_self, scale)
    # (1,Hq,T,1) / (1,T,Hq,hd) -> one more shard entry of each token
    m, l, acc = _with_self(
        (m1, l1, a1), (m2[0].transpose(0, 1)[:, None],
                       l2[0].transpose(0, 1)[:, None],
                       a2[0][:, None, None]))
    return _combine_exact(m, l, acc, group).to(v.dtype)


def packed_step(cfg: ModelConfig, params, cache, tokens, slot, pos, off,
                is_prefill, lay: ServeLayout, hp: ServeHParams,
                page_map=None, state_map=None):
    """One tick over a flat batch of T mixed prefill and decode tokens.

    Entry t of the (T,) vectors: ``slot`` its request's cache row (-1 =
    dead entry; ragged ticks leave the tail dead), ``pos`` its position,
    ``off`` the first position its request packs this tick (a decode
    token has ``off == pos``), ``is_prefill`` 1 for prompt tokens, 0 for
    decode tokens.  Decode tokens come first (at most one per slot), so
    the LM head runs over the first min(B, T) entries only.  A paged
    cache takes the slots' page_map (B, ppr) and state_map (B,) int32.
    Returns (logits (min(B, T), V) f32, cache), the cache updated in
    place.

    On a mesh every rank packs every token; a dense cache's rank holds
    the slots of its batch block and gives the others' tokens empty
    stats, combined over the batch axes as well as the sequence group.
    The logits are over the rank's vocabulary shard (``gather_logits``).
    """
    check_tick_kinds(cfg, "packed serving")
    mesh, seq, shard0 = _tick_mesh(cfg, params, lay, hp)
    dev = tokens.device
    n_rows = (cache[0]["k"].shape[0] if page_map is None
              else page_map.shape[0])            # the slots this rank holds
    n_slots, row0, group = n_rows, 0, seq
    if mesh is not None and page_map is None and lay.ba:
        bg = mesh.group(lay.ba)
        n_slots, row0 = n_rows * bg.size, bg.index * n_rows
        group = mesh.group(lay.ba + lay.seq_axes)
    alive = (slot >= 0) & (pos >= 0)
    held = alive & (slot >= row0) & (slot < row0 + n_rows)
    rows = torch.clamp(slot - row0, 0, n_rows - 1)
    col, owner, col_pos = _decode_cols(lay, pos, shard0)         # (T, P)
    owner = owner & held[:, None]
    plan = write_plan(rows, col, owner, lay.held, lay.cap_l, page_map)
    rows32 = rows.to(torch.int32)
    valid = held[:, None, None] & (
        col_pos[None] < torch.clamp(off, min=0)[:, None, None])
    own = owner.any(dim=-1)            # the tokens whose column it holds
    bias_self = torch.where(
        (slot[None, :] == slot[:, None]) & (pos[None, :] <= pos[:, None])
        & alive[:, None] & own[None, :], 0.0, NEG_INF)[None]     # (1, T, T)
    prism = hp.decode_mode == "prism"
    if prism:
        cols = means_columns(lay.n_seq, lay.n_loc0, lay.L, dev)
        held_cols = cols if seq is None else cols._replace(
            g=cols.g[shard0:shard0 + 1])
        pos_held = torch.where(held, pos, -1)
        valid_le = col_pos[None] <= pos_held[:, None, None]
        is_dec = (is_prefill == 0)[:, None, None, None]
        sel = owner & (is_prefill == 0)[:, None]
        # the Segment-Means capture over the tick's real prompt tokens
        upd = (is_prefill != 0) & held
        r_upd = torch.where(upd, rows, n_rows)                   # sink row
        big = torch.iinfo(off.dtype).max
        off_b = torch.full((n_rows + 1,), big, dtype=off.dtype,
                           device=dev).scatter_reduce(
            0, r_upd, torch.where(upd, off, big), "amin")[:n_rows]
        filled = torch.zeros(n_rows + 1, dtype=pos.dtype, device=dev
                             ).scatter_reduce(
            0, r_upd, torch.where(upd, pos + 1, 0), "amax")[:n_rows]
        act = filled > 0
        cnt = segment_fill_counts(cols.lo, cols.hi, filled)
        seg = ((r_upd[None, :] == torch.arange(n_rows, device=dev)[:, None])
               [:, :, None] & (cols.lo <= pos[:, None])
               & (pos[:, None] <= cols.hi)).float()              # (B, T, m)
        restart = act & (off_b == 0)
        splan = state_plan(cache[0], state_map, act)
        zr = rows if splan is None else splan[0][rows]   # gz row per token
    spec = attn_spec(cfg)
    scale = spec.head_dim ** -0.5
    moe_ctx = decode_moe_ctx(cfg, params, hp)
    x = embed_tokens(cfg, params, tokens[:, None], pos[:, None])  # (T,1,D)
    for (kind, p), c in zip(_layers(cfg, params), cache):
        xn = norm(p["ln1"], x, cfg.norm_kind)
        q = attn_project_q(p["attn"], spec, xn, pos[:, None])
        k_new, v_new = attn_project_kv(p["attn"], spec, xn, pos[:, None])
        _write_kv(c["k"], k_new[:, 0], plan)
        _write_kv(c["v"], v_new[:, 0], plan)
        o = packed_attention(q, c["k"], c["v"], valid, bias_self, k_new,
                             v_new, rows32, scale, backend=hp.backend,
                             pages=page_map, group=group)
        if prism:
            # decode tokens take the owner view over the means cache, as
            # serve_step does; prompt tokens keep the exact result
            cnt_t = c["gz"][zr]
            gz = prism_gz(held_cols, cnt_t, pos_held)            # (T,P,m)
            o_pz = decode_attention(q, c["k"], c["v"], valid_le, scale,
                                    gz=gz, kz=c["kz"], vz=c["vz"], owner=sel,
                                    mode="prism", rows=rows32,
                                    pages=page_map, zrows=state_map,
                                    backend=hp.backend, seq=group)
            o = torch.where(is_dec, o_pz, o)
            inc = torch.einsum("btm,td->bmd", seg, x[:, 0].float())
            _capture_means(p, spec, cfg, c, inc, cnt, restart, act,
                           cols.mid, splan, seq)
        x = block_residual(cfg, kind, p, x, attn_output(p["attn"], o), xn,
                           moe_ctx, hp.routing)
    head = x[:min(n_slots, x.shape[0]), 0]
    return lm_head(cfg, _tree(params), head), cache


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
    # index_fill_ takes the 1 as a scalar argument: ``out[idx, 1] = 1``
    # would copy it to the card as a tensor and wait for the copy
    out[:, 1].index_fill_(0, idx, 1)
    out[idx, 3] = torch.isfinite(logits).all(dim=-1).to(torch.int32)
    out[:s, 2] = lengths.to(torch.int32)
    return out[:s]


def merge(tok_host, src, prev):
    """The double-buffer splice: entry i takes ``prev[src[i], 0]``, the
    token its slot sampled last tick (still on the device), where
    ``src[i] >= 0``, else the host-planned ``tok_host[i]``."""
    pick = prev[torch.clamp(src, 0, prev.shape[0] - 1).long(), 0]
    return torch.where(src >= 0, pick.to(tok_host.dtype), tok_host)
