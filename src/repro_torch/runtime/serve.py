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

Placements (``ServeLayout.placement``), attention-only:
  * ``aligned`` (the default): positions [0, n0) lie prefill-aligned
    (shard s holds [s·n_loc0, (s+1)·n_loc0) in slots [0, n_loc0));
    decoded positions p >= n0 go round-robin to shard (p - n0) % P, slot
    n_loc0 + (p - n0) // P;
  * ``rr`` (the paged exact cache): every position round-robin, shard
    p % P, slot p // P, so a page of consecutive slots on every shard
    holds a contiguous block of positions (a prefix can be shared).

Sliding-window layers (Gemma 3's ``attn_local``) keep a ring of the
last W positions, (B, W, Hkv, hd), position p in slot p % W, read by
every shard as one column set: exact in both decode modes, as the
reference's static path serves them.  The paged cache, the tick
programs and the engine refuse the kind, as the reference's do.

Recurrent blocks (xLSTM's ``mlstm`` / ``slstm``, Zamba2's ``mamba``)
keep their state after the last position, {"s"}: the mLSTM's (B, H, hd,
hd + 1) f32 matrix memory with its normaliser column, the sLSTM's (B, 3,
H, hd) f32 (c, n, h), Mamba2's (B, H, d_state, hd) f32 beside its conv's
last pre-convolution rows "tail" (B, conv - 1, d_in); prefill captures
them (``ctx.last_shard``: the state handed across the shards, the
sLSTM's scan over the gathered sequence, the conv's halo from the
previous shard), a decode step updates them in place, in either decode
mode.  Zamba2's ``shared_attn`` layers are attention over one shared
weight set, each with a cache of its own (``transformer.layer_blocks``).
The paged cache, the tick programs and the engine refuse the recurrent
kinds, as the reference's do.

An audio model (MusicGen) prefills from frame embeddings (B, n0, D)
alone, through ``frontend_proj`` with sinusoidal positions; its decode
steps feed the generated codes through ``embed``.

A Mixture-of-Experts block (``moe``) has a global-attention cache; its
experts route in groups that count capacity (``models/moe.py``): in
prefill each sequence shard's B·n_loc tokens (the sharded context's
groups, as the reference's ``shard_map``), in a decode step all B tokens
(``DECODE_MOE_CTX``).

The paged cache (``runtime/paging.py``): the layer cache is a page pool
(n_pages, P, pc, Hkv, hd) with, in prism mode, a state pool of means
rows; ``serve_step`` and the tick programs take the per-slot page map
(B, ppr) and state map (B,), write through them and read the pool in
place (the decode kernel's page table).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.utils.checkpoint

from ..core.attention import log_repeats
from ..core.protocol import PrismConfig
from ..kernels.decode_attention import decode_stats
from ..kernels.ops import prism_attention_op
from ..models.config import ModelConfig
from ..models.context import SeqContext
from ..models.layers import (AttnSpec, attn_output, attn_project_kv,
                             attn_project_q, embed, norm)
from ..models.moe import RoutingLog
from ..models.transformer import (RECURRENT_KINDS, attn_spec,
                                  block_residual, check_decoder,
                                  check_supported, classify, embed_inputs,
                                  embed_scale, head, layer_blocks,
                                  recurrent_block, recurrent_decode, sincos)
from ..sharding.context import ShardedPrismContext, means_columns
from .paging import KVCache, PrefixCache


@dataclass(frozen=True)
class ServeHParams:
    decode_mode: str = "exact"       # 'exact' | 'prism'
    means_cr: float = 16.0           # CR for the prism decode means cache
    backend: str = "auto"            # kernel dispatch: 'auto'|'kernel'|'plain'
    # the reference's tensor-parallel decode over a data axis (expert-TP
    # for MoE blocks): multi-card work, refused
    decode_tp: bool = False
    ssm_chunk: int = 128             # an mLSTM prefill's chunk length
    # the checks' record or replay of the MoE routing decisions
    routing: RoutingLog | None = field(default=None, compare=False,
                                       repr=False)

    def __post_init__(self):
        if self.decode_tp:
            raise NotImplementedError(
                "decode_tp (tensor-parallel decode, expert-TP for MoE "
                "blocks) needs more than one card: ROADMAP queue 1, "
                "item 15")


# the expert exchange of a decode step, a chunk call or a packed tick
# (the reference's DecodeMoeCtx with tp=False; its expert-TP form is
# decode_tp's): all of the call's tokens are one routing group, as the
# reference's all_to_all over tokens every shard holds gives
DECODE_MOE_CTX = SeqContext()


# --------------------------------------------------------------------------
# layout and cache
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeLayout:
    """Cache placement (see the module docstring)."""
    n_seq: int                       # sequence shards (PRISM's P)
    cap: int                         # global cache capacity (tokens)
    cap_l: int                       # per-shard capacity
    prefill_len: int                 # tokens laid down by prefill (n0)
    L: int                           # segment means per shard (prism cache)
    placement: str = "aligned"       # 'aligned' | 'rr' (paged exact)

    @property
    def n_loc0(self) -> int:
        return self.prefill_len // self.n_seq


def make_layout(n_seq: int, cap: int, hp: ServeHParams,
                prefill_len: int | None = None,
                placement: str = "aligned") -> ServeLayout:
    n0 = cap if prefill_len is None else prefill_len
    if cap % n_seq or n0 % n_seq or n0 > cap:
        raise ValueError(f"cap={cap} and prefill_len={n0} must be "
                         f"multiples of n_seq={n_seq}, prefill_len <= cap")
    if placement not in ("aligned", "rr"):
        raise ValueError(f"placement {placement!r} not in ('aligned', 'rr')")
    L = max(1, int(n0 // (hp.means_cr * n_seq)))
    L = min(L, n0 // n_seq)
    return ServeLayout(n_seq, cap, cap // n_seq, n0, L, placement)


def paged_placement(hp: ServeHParams, paging) -> str:
    """Paged exact mode stores round-robin, so that pages cover
    contiguous position blocks (prefix sharing); paged prism keeps the
    aligned placement the Segment-Means shard ownership is defined
    over."""
    return "rr" if (paging is not None
                    and hp.decode_mode == "exact") else "aligned"


def init_cache(cfg: ModelConfig, lay: ServeLayout, batch: int,
               hp: ServeHParams, device, paging=None) -> list:
    """An all-zero f32 decode-layout cache, one dict of leaves per layer
    (``layer_cache_shape``): what the chunked and packed ticks admit
    requests into."""
    return [{name: torch.zeros(shape, device=device)
             for name, shape in layer_cache_shape(cfg, lay, batch, hp,
                                                  paging, kind).items()}
            for kind in cfg.block_kinds]


def ring_width(cfg: ModelConfig, lay: ServeLayout) -> int:
    """W, the ring cache's slots of a sliding-window layer."""
    return min(cfg.window or lay.cap, lay.cap)


def layer_cache_shape(cfg: ModelConfig, lay: ServeLayout, batch: int,
                      hp: ServeHParams, paging=None,
                      kind: str = "attn") -> dict:
    """Per-layer cache leaves: k, v (B, P, cap_l, Hkv, hd); prism mode
    adds the means K/V kz, vz (B, P·L, Hkv, hd), their per-request
    repeat counts gz (B, P·L) and the per-segment activation sums
    zsum (B, P·L, D).  With ``paging`` (a ``PagedLayout``) k, v are the
    page pool (n_pages, P, pc, Hkv, hd) and the prism leaves have one
    row per state page in place of the batch, and one more that no slot
    maps: a sink for the writes of the slots a call does not advance
    (where the reference drops them out of range).  A sliding-window
    layer (``kind`` 'attn_local') has the ring k, v (B, W, Hkv, hd) alone,
    in either decode mode, and no paged form; a recurrent one its state
    s: the mLSTM's (B, H, hd, hd + 1), the sLSTM's (B, 3, H, hd), Mamba2's
    (B, H, d_state, hd) with its conv's tail (B, conv - 1, d_in).  A
    ``shared_attn`` layer has the attention leaves of its own."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    if kind in ("attn_local",) + RECURRENT_KINDS and paging is not None:
        raise ValueError(f"paged caches support position-addressed "
                         f"attention kinds only (got block kind {kind!r})")
    if kind == "attn_local":
        ring = (batch, ring_width(cfg, lay), hkv, hd)
        return {"k": ring, "v": ring}
    if kind == "mlstm":
        h = cfg.n_ssm_heads
        hdm = cfg.d_model * cfg.ssm_expand // h
        return {"s": (batch, h, hdm, hdm + 1)}
    if kind == "slstm":
        h = cfg.n_ssm_heads
        return {"s": (batch, 3, h, cfg.d_model // h)}
    if kind == "mamba":
        h, d_in = cfg.n_ssm_heads, cfg.d_model * cfg.ssm_expand
        return {"s": (batch, h, cfg.ssm_state, d_in // h),
                "tail": (batch, cfg.ssm_conv - 1, d_in)}
    if paging is None:
        kv = (batch, lay.n_seq, lay.cap_l, hkv, hd)
        rows = batch
    else:
        kv = (paging.n_pages, lay.n_seq, paging.page_cols, hkv, hd)
        rows = paging.n_state_pages + 1
    c = {"k": kv, "v": kv}
    if hp.decode_mode == "prism":
        m = lay.n_seq * lay.L
        c["kz"] = (rows, m, hkv, hd)
        c["vz"] = (rows, m, hkv, hd)
        c["gz"] = (rows, m)
        c["zsum"] = (rows, m, cfg.d_model)
    return c


def make_kv_cache(cfg: ModelConfig, lay: ServeLayout, batch: int,
                  hp: ServeHParams, *, device, paging=None,
                  prefix_cache: bool = False) -> KVCache:
    """The engine's one cache object: zero-filled device storage in a
    ``KVCache`` (paged: the pools, a ``PageTable`` and, if asked, a
    ``PrefixCache``; dense, ``paging=None``: the rowset of ``batch``
    rows)."""
    kv = KVCache(storage=init_cache(cfg, lay, batch, hp, device, paging),
                 layout=lay, paging=paging)
    if paging is not None and prefix_cache:
        kv.prefix = PrefixCache(kv.table)
    return kv


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


def sharded_attn(p, spec: AttnSpec, cfg: ModelConfig, x, ctx,
                 hp: ServeHParams):
    """Attention sublayer over x (B·P, n_loc, D), every shard in one
    launch: -> (output (B·P, n_loc, D), k, v, the augmented view, the
    normed local rows (a parallel block's MLP reads them))."""
    xq, akv = ctx.augment(x, spec)
    xq_n = norm(p["ln1"], xq, cfg.norm_kind)
    xh_n = norm(p["ln1"], akv.x_hat, cfg.norm_kind)
    q = attn_project_q(p["attn"], spec, xq_n, akv.row_pos)
    k, v = attn_project_kv(p["attn"], spec, xh_n, akv.col_pos)
    o = attn_output(p["attn"], _prefill_attention(q, k, v, akv, spec, cfg,
                                                  hp))
    return o, k, v, akv, xq_n


def prefill_attn(p, spec: AttnSpec, cfg: ModelConfig, x, ctx, lay,
                 hp: ServeHParams, prism_augment: bool, shapes: dict):
    """Attention sublayer over x (B·P, n_loc, D) that also captures this
    layer's decode cache, whose leaves have ``shapes``
    (``layer_cache_shape``).  Returns (output, cache, the normed local
    rows)."""
    o, k, v, akv, xq_n = sharded_attn(p, spec, cfg, x, ctx, hp)

    bp, n_loc, d = x.shape
    P = lay.n_seq
    b = bp // P
    hkv, hd = k.shape[2:]
    if spec.window is not None:
        return ctx.finalize(o), ring_capture(k, v, b, lay, shapes), xq_n
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
        means = means_columns(P, n_loc, lay.L, x.device)
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
                p["attn"], spec, norm(p["ln1"], z_all, cfg.norm_kind),
                means.mid)                   # each mean at its midpoint
        # monolithic prefill covers every position of [0, n0): the repeat
        # counts are the full segment sizes, the sums means × sizes
        sizes = means.sizes
        cache["kz"], cache["vz"] = kz, vz
        cache["gz"] = sizes[None].expand(b, m).contiguous()
        cache["zsum"] = z_all.float() * sizes[None, :, None]
    return ctx.finalize(o), cache, xq_n


def ring_capture(k, v, b: int, lay: ServeLayout, shapes: dict) -> dict:
    """A sliding-window layer's ring cache after prefill: the last W
    prompt positions, position p in slot p % W (placed by the prompt
    length, where the reference's ``cap - W`` placement is right only
    when cap = n0 mod W).  k, v (B·P, m, Hkv, hd) hold each shard's own
    rows last."""
    n0, n_loc = lay.prefill_len, lay.n_loc0
    w = shapes["k"][1]
    first = max(0, n0 - w)
    slots = torch.arange(first, n0, device=k.device) % w
    cache = {}
    for name, t in (("k", k), ("v", v)):
        seq = t[:, t.shape[1] - n_loc:].reshape(b, n0, *t.shape[2:])
        c = torch.zeros(shapes[name], dtype=t.dtype, device=t.device)
        c[:, slots] = seq[:, first:]
        cache[name] = c
    return cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor | None,
            prism: PrismConfig, lay: ServeLayout, hp: ServeHParams,
            embeds: torch.Tensor | None = None):
    """tokens (B, n0) -> (last-token logits (B, V) f32, decode cache).

    ``prism.mode`` picks the exchange: 'prism' (Segment-Means) or
    'voltage' (full).  A vlm's image embeds (B, prefix_len, D) overwrite
    the first prefix_len positions (``embed_inputs``, over the whole
    sequence before it is cut into shards: the reference's overwrite of
    each shard's rows by global position), and the prefix attends
    bidirectionally in the kernel (``cfg.prefix_len``).  An audio model
    takes ``tokens=None`` and its frames, embeds (B, n0, D).  A recurrent
    block hands its state across the shards and keeps the sequence's end
    state (an mLSTM or Mamba2 recurrence in chunks of ``hp.ssm_chunk``;
    Mamba2's conv takes the previous shard's rows as its halo)."""
    check_supported(cfg)
    check_decoder(cfg, "prefill")
    b, n = (tokens if tokens is not None else embeds).shape[:2]
    P = lay.n_seq
    if n != lay.prefill_len:
        raise ValueError(f"prompt length {n} != layout prefill_len "
                         f"{lay.prefill_len}")
    n_loc = n // P
    prism_cfg = prism.with_(P=P, L=lay.L if hp.decode_mode == "prism"
                            else prism.L)
    ctx = ShardedPrismContext(prism_cfg, n_shards=P, backend=hp.backend)
    prism_augment = prism_cfg.mode == "prism"
    x = embed_inputs(cfg, params, tokens, embeds=embeds).reshape(
        b * P, n_loc, cfg.d_model)
    cache = []
    for kind, p in layer_blocks(cfg, params):
        if kind in RECURRENT_KINDS:
            x, c = recurrent_block(cfg, kind, p, x, ctx, chunk=hp.ssm_chunk,
                                   return_state=True)
            cache.append(c)
            continue
        o, c, xn = prefill_attn(p, attn_spec(cfg, kind), cfg, x, ctx, lay,
                                hp, prism_augment,
                                layer_cache_shape(cfg, lay, b, hp, kind=kind))
        # a moe block routes each shard's tokens as a group (ctx's groups)
        x = block_residual(cfg, kind, p, x, o, xn, ctx, hp.routing)
        cache.append(c)
    return lm_head(cfg, params, ctx.last_shard(x[:, -1])), cache


def sharded_block(cfg: ModelConfig, kind: str, p, x, ctx, hp: ServeHParams,
                  aux: bool = False):
    """One block over x (B·P, n_loc, D): attention through the prefill
    kernel or its plain version (``hp.backend``), then the rest of the
    block (``block_residual``; with ``aux`` -> (x, its load-balance
    loss)); a recurrent block through the context's state handoff."""
    if kind in RECURRENT_KINDS:
        x = recurrent_block(cfg, kind, p, x, ctx, chunk=hp.ssm_chunk)
        return (x, x.new_zeros((), dtype=torch.float32)) if aux else x
    o, _, _, _, xn = sharded_attn(p, attn_spec(cfg, kind), cfg, x, ctx, hp)
    return block_residual(cfg, kind, p, x, o, xn, ctx, hp.routing, aux=aux)


def sharded_layers(cfg: ModelConfig, params, x, ctx, hp: ServeHParams, *,
                   aux: bool = False, remat: bool = False):
    """Every layer over x (B·P, n_loc, D) with no cache capture: the layer
    loop of ``encode``, ``score`` and the train step's forward.  With
    ``aux`` -> (x, the load-balance loss summed over the blocks); with
    ``remat`` each layer is recomputed in the backward pass
    (``torch.utils.checkpoint``, one call a layer)."""
    total = x.new_zeros((), dtype=torch.float32)
    for kind, p in layer_blocks(cfg, params):
        if remat:
            out = torch.utils.checkpoint.checkpoint(
                sharded_block, cfg, kind, p, x, ctx, hp, aux,
                use_reentrant=False)
        else:
            out = sharded_block(cfg, kind, p, x, ctx, hp, aux)
        x, total = (out[0], total + out[1]) if aux else (out, total)
    return (x, total) if aux else x


def score(cfg: ModelConfig, params, tokens=None, *, embeds=None,
          prism: PrismConfig, n_shards: int, hp: ServeHParams):
    """Teacher-forced logits of every position of a causal decoder over
    ``n_shards`` sequence shards: tokens (B, N) (or a vlm's tokens and
    image, an audio model's frames) -> (B, N, V) f32, N a multiple of the
    shard count.  ``prefill``'s layer loop with no cache capture and the
    head over every row, under ``torch.no_grad``: attention through the
    prefill kernel, the means through the segment-means kernel on a card
    (``hp.backend``).  What the reference's ``T.forward`` under its
    ``SimulatedContext`` computes, for the accuracy protocol's bits per
    character."""
    check_supported(cfg)
    check_decoder(cfg, "score")
    with torch.no_grad():
        x = embed_inputs(cfg, params, tokens, embeds=embeds)
        b, n, _ = x.shape
        if n % n_shards:
            raise ValueError(f"score takes N a multiple of the shard count,"
                             f" got N={n} over {n_shards}")
        ctx = ShardedPrismContext(prism, n_shards=n_shards,
                                  backend=hp.backend)
        x = sharded_layers(cfg, params, ctx.shard(x), ctx, hp)
        return lm_head(cfg, params, x).reshape(b, n, -1)


def encode(cfg: ModelConfig, params, tokens=None, *, embeds=None,
           prism: PrismConfig, n_shards: int, hp: ServeHParams):
    """An encoder's classification over ``n_shards`` sequence shards:
    tokens (B, N) or stub-frontend embeds (B, N, D) -> class logits
    (B, num_classes) f32.

    The layer loop is ``prefill``'s (attention through the prefill kernel,
    here without the causal mask, then the feed-forward) with no cache
    capture; then the final norm and the class head on the CLS row,
    global position 0, which shard 0 holds first.  N need not be a
    multiple of P: Alg. 1's last shard takes the remainder
    (``ShardedPrismContext.shard``).  ``prism.mode`` picks the exchange:
    'prism' (Segment-Means, L from ``prism.cr`` or ``prism.L``) or
    'voltage' (full)."""
    check_supported(cfg)
    if not cfg.num_classes:
        raise ValueError(f"encode classifies; arch {cfg.name!r} has no "
                         "class head (num_classes 0)")
    x = embed_inputs(cfg, params, tokens, embeds=embeds)
    b, n, _ = x.shape
    ctx = ShardedPrismContext(prism, n_shards=n_shards, backend=hp.backend,
                              n=n)
    x = sharded_layers(cfg, params, ctx.shard(x), ctx, hp)
    cls = x.view(b, n_shards, *x.shape[1:])[:, 0, 0]
    return classify(cfg, params, cls).float()


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _decode_cols(lay: ServeLayout, pos: torch.Tensor):
    """(write slot (..., P), owner (..., P), col_pos (P, cap_l)) for the
    positions ``pos`` of any shape under the layout's placement (-1 =
    dead entry: owner False on every shard)."""
    n0, n_loc0, n_seq = lay.prefill_len, lay.n_loc0, lay.n_seq
    idx = torch.arange(n_seq, device=pos.device)                 # (P,)
    if lay.placement == "rr":
        slot = (pos // n_seq)[..., None].expand(*pos.shape, n_seq)
        owner = (((pos % n_seq)[..., None] == idx) & (slot >= 0)
                 & (slot < lay.cap_l))
        col_pos = (torch.arange(lay.cap_l, device=pos.device)[None, :]
                   * n_seq + idx[:, None])
        return slot, owner, col_pos
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


def write_plan(row, slot, owner, n_seq: int, cap_l: int, page_map=None):
    """Flat cache addresses of N new K/V rows, computed once per step for
    every layer and leaf: entry ``n`` goes to batch row ``row[n]``, column
    ``slot[n, p]`` of the one shard ``p`` where ``owner[n, p]``.  With
    ``page_map`` (B, ppr) the address is in the page pool: column ``j``
    of row ``r`` is offset ``j % pc`` of page ``page_map[r, j // pc]``
    on the shard.  Returns (addr (N,), ok (N,), first (1,)): an entry
    that no shard owns (dead token, idle row) or whose page is unmapped
    (id < 0) is not ``ok`` and takes the address of the first entry that
    is (``first``), so ``_write_kv`` drops it, as the reference's
    out-of-range ``mode='drop'`` scatter does."""
    ok = owner.any(dim=-1)
    shard = owner.int().argmax(dim=-1)
    col = slot.gather(-1, shard[:, None])[:, 0].clamp(0, cap_l - 1)
    if page_map is None:
        addr = (row * n_seq + shard) * cap_l + col
    else:
        pc = cap_l // page_map.shape[1]
        page = page_map[row, col // pc].long()
        ok = ok & (page >= 0)
        addr = (page.clamp(min=0) * n_seq + shard) * pc + col % pc
    first = ok.int().argmax(dim=0, keepdim=True)
    return torch.where(ok, addr, addr[first]), ok, first


def _write_kv(cache_kv, new_rows, plan):
    """Scatter (N, Hkv, hd) rows into the (B, P, cap_l, Hkv, hd) cache,
    the (n_pages, P, pc, Hkv, hd) pool or the (B, W, Hkv, hd) ring IN
    PLACE at the addresses of ``plan`` (``write_plan``).  A dropped entry
    rewrites the first owned entry's address with that entry's value
    (the current value if no entry is owned), so every duplicate address
    gets the same bytes.
    O(N), no host synchronisation."""
    addr, ok, first = plan
    flat = cache_kv.view(-1, *cache_kv.shape[-2:])
    new_rows = new_rows.to(cache_kv.dtype)
    keep = torch.where(ok[first][:, None, None], new_rows[first],
                       flat[addr[first]])
    flat[addr] = torch.where(ok[:, None, None], new_rows, keep)


def state_rows(c, state_map):
    """The state-pool rows of the slots (clamped to the state pages, as
    the reference's take clips; the sink row is never read): (B,) int64,
    or None for a dense cache (row = slot).  Every layer's state pool has
    the same rows, so a step computes this once, from any layer ``c``."""
    if state_map is None:
        return None
    return state_map.long().clamp(0, c["gz"].shape[0] - 2)


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
                rows=None, pages=None, zrows=None, backend="auto"):
    """The decode kernel's partial stats of every (query row, shard),
    shaped for ``_combine_exact``: q (Bq,1,Hq,hd); k, v (R,P,M,Hkv,hd)
    the whole cache, or with ``pages`` (R, ppr) int32 the page pool
    (n_pages,P,pc,Hkv,hd), M = ppr·pc; valid (Bq,P,M); log_gz (Bq,P,m);
    kz, vz (R,m,Hkv,hd), or any number of rows with ``zrows`` (R,) int32
    naming each cache row's; rows (Bq,) int32, the cache row of each
    query row (None: row i reads row i).  Returns m, l (Bq,P,Hq,1) and
    acc (Bq,P,1,Hq,hd)."""
    bq, _, hq, hd = q.shape
    r, p, m_loc, hkv = k.shape[:4]
    m_p, l_p, acc_p = decode_stats(
        q, k.view(r * p, m_loc, hkv, hd), v.view(r * p, m_loc, hkv, hd),
        valid.reshape(bq * p, -1),
        None if log_gz is None else log_gz.reshape(bq * p, -1), kz, vz,
        scale=scale, rows=rows, pages=pages, zrows=zrows, backend=backend)
    return (m_p.view(bq, p, hq, 1), l_p.view(bq, p, hq, 1),
            acc_p.view(bq, p, 1, hq, hd))


def decode_attention(q, k, v, valid, scale, *, gz=None, kz=None, vz=None,
                     owner=None, mode="exact", rows=None, pages=None,
                     zrows=None, backend="auto"):
    """Per-token decode attention over the shard-stacked cache.

    q (Bq,1,Hq,hd); k, v (R,P,M,Hkv,hd) or the page pool with ``pages``
    (as ``shard_stats``); valid (Bq,P,M) bool; rows (Bq,) int32 maps
    query rows to cache rows (None: the identity).  Prism extras: gz
    (Bq,P,m) per-row, per-shard means repeat counts (0 = dead column),
    kz/vz (R,m,Hkv,hd) or the state pool with ``zrows``, owner (Bq,P)
    bool.  Returns (Bq,1,Hq,hd)."""
    log_gz = log_repeats(gz) if kz is not None else None
    m_p, l_p, acc_p = shard_stats(q, k, v, valid, scale, log_gz=log_gz,
                                  kz=kz, vz=vz, rows=rows, pages=pages,
                                  zrows=zrows, backend=backend)
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


def prism_gz(cols, counts, pos, lost=None):
    """The repeat counts (Bq, P, m) under which each query's shards see
    the means columns: ``counts`` (Bq, m) or (m,) the means' filled sizes,
    ``pos`` (Bq,) the query positions (-1 = dead entry, which sees none).
    A shard's own means are masked (its columns are exact), and a mean is
    visible once every position it covers, [lo, lo + count), is in the
    query's past.  ``lost`` (P,) marks the shards a degraded step cannot
    read (> 0): the means of a lost shard open on every shard, its own
    included, since the state rows they come from are not on it."""
    cnt = counts[..., None, :]                               # (Bq, 1, m)
    served = cols.g > 0                                      # (P, m)
    if lost is not None:
        served = served | lost_columns(lost, cols.g.shape[1])[None, :]
    live = served & (cols.lo + cnt <= pos[:, None, None] + 1)
    return torch.where(live, cnt, torch.zeros_like(cnt))


def replica_gz(counts, lost):
    """The repeat counts (B, P, m) under which the degraded exact step's
    shards see the standby replica's columns: ``counts`` (B, m) the
    replica's, shard-major; each lost shard's lane sees its own columns,
    and nothing else sees any, so the shard combine counts each mean
    once."""
    p, m = lost.shape[0], counts.shape[1]
    lane = (torch.arange(p, device=counts.device)[:, None]
            == torch.arange(m, device=counts.device)[None, :] // (m // p))
    serve = lane & lost_columns(lost, m)[None, :]                # (P, m)
    return torch.where(serve[None], counts[:, None, :], 0.0)


def lost_columns(lost, m: int):
    """(m,) bool: the shard-major means columns of the lost shards, from
    ``lost`` (P,) (> 0 = lost)."""
    p = lost.shape[0]
    return (lost > 0).repeat_interleave(m // p)


def lm_head(cfg: ModelConfig, params, x):
    """Final norm and the LM head (tied or untied): x (..., D) -> logits
    (..., V) f32."""
    return head(cfg, params,
                norm(params["final_norm"], x, cfg.norm_kind)).float()


def ring_cols(w: int, window: int, pos):
    """(write plan, valid (B, 1, w)) of a sliding-window layer's ring at
    the positions ``pos`` (B,), made once a step for every such layer:
    position p goes to slot p % w (live rows only), and slot j holds
    position pos - ((pos - j) % w), visible when it is at least 0 and
    inside the window."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    plan = write_plan(rows, (pos % w)[:, None], (pos >= 0)[:, None], 1, w)
    j = torch.arange(w, device=pos.device)
    col_pos = pos[:, None] - ((pos[:, None] - j) % w)
    valid = (col_pos >= 0) & (col_pos > pos[:, None] - window)
    return plan, valid[:, None]


def attn_decode(p, spec: AttnSpec, cfg: ModelConfig, x, c, pos,
                lay: ServeLayout, hp: ServeHParams, cols, lost=None,
                rep=None):
    """x (B,1,D), pos (B,) -> (out (B,1,D), the normed input x (a
    parallel block's MLP reads it)); writes this token's K/V into the
    layer cache ``c`` in place.  ``cols`` = (write plan, owner,
    valid, page map, state map, state rows), all made once a step; the
    last three are None for a dense cache.  A sliding-window layer's
    ``cols`` is its ring's (``ring_cols``): the ring is one column set,
    attended exactly in either decode mode.

    ``lost`` (P,) arms the degraded step (``serve_step``): the write
    plan and ``valid`` already leave the lost shards out, and their
    positions are served by Segment-Means columns instead: in exact mode
    the standby replica ``rep`` ({"kz" (B,m,Hkv,hd), "vz", "gz" (B,m)},
    ``MeansReplica.assemble``) on the lost shard's own lane only, so the
    shard combine counts each mean once; in prism mode the means the
    state rows already hold, the lost shard's own gate opened."""
    if spec.window is not None:
        plan, valid = cols                           # the ring's
    else:
        plan, owner, valid, page_map, state_map, sr = cols
    xn = norm(p["ln1"], x, cfg.norm_kind)
    rp = pos[:, None]                                # (B, 1) row positions
    q = attn_project_q(p["attn"], spec, xn, rp)
    k_new, v_new = attn_project_kv(p["attn"], spec, xn, rp)
    scale = spec.head_dim ** -0.5
    _write_kv(c["k"], k_new[:, 0], plan)
    _write_kv(c["v"], v_new[:, 0], plan)
    if spec.window is not None:                  # the ring, one shard
        out = decode_attention(q, c["k"][:, None], c["v"][:, None], valid,
                               scale, backend=hp.backend)
    elif hp.decode_mode == "prism" and "kz" in c:
        # repeat counts ride in the cache (the state pool when paged)
        means = means_columns(lay.n_seq, lay.n_loc0, lay.L, x.device)
        cnt = c["gz"] if sr is None else c["gz"][sr]
        gz = prism_gz(means, cnt, pos, lost)                 # (B, P, m)
        out = decode_attention(q, c["k"], c["v"], valid, scale, gz=gz,
                               kz=c["kz"], vz=c["vz"], owner=owner,
                               mode="prism", pages=page_map, zrows=state_map,
                               backend=hp.backend)
    elif rep is not None:
        gz = replica_gz(rep["gz"], lost)                         # (B, P, m)
        out = decode_attention(q, c["k"], c["v"], valid, scale, gz=gz,
                               kz=rep["kz"], vz=rep["vz"], pages=page_map,
                               backend=hp.backend)
    else:
        out = decode_attention(q, c["k"], c["v"], valid, scale,
                               pages=page_map, backend=hp.backend)
    return attn_output(p["attn"], out), xn


def block_decode(cfg: ModelConfig, kind: str, p, x, c, pos,
                 lay: ServeLayout, hp: ServeHParams, cols, lost=None,
                 rep=None):
    """One residual block, single-token decode (a moe block routes the
    step's B tokens as one group; a recurrent block updates its state in
    place)."""
    if kind in RECURRENT_KINDS:
        return recurrent_decode(cfg, kind, p, x, c)
    o, xn = attn_decode(p, attn_spec(cfg, kind), cfg, x, c, pos, lay, hp,
                        cols, lost, rep)
    return block_residual(cfg, kind, p, x, o, xn, DECODE_MOE_CTX,
                          hp.routing)


def embed_tokens(cfg: ModelConfig, params, token, pos):
    """token (B, T), pos (B, T) -> x (B, T, D), scaled by sqrt(d_model)
    where the model says so, with learned or sinusoidal positions per
    request and per token where the model has them (a RoPE model rotates
    q and k at ``pos`` in its attention layers instead).  A dead
    entry (pos = -1) still embeds (its position clamped) but never
    reaches the cache."""
    x = embed_scale(cfg, embed(params["embed"], token))
    if cfg.pos == "sincos":
        return x + sincos(pos, cfg.d_model).to(x.dtype)
    if cfg.pos != "learned":
        return x
    tbl = params["pos_embed"]["table"]
    return x + tbl[torch.clamp(pos, 0, tbl.shape[0] - 1)].to(x.dtype)


def serve_step(cfg: ModelConfig, params, cache, token, pos,
               lay: ServeLayout, hp: ServeHParams, page_map=None,
               state_map=None, lost=None, rep=None):
    """(token (B,), pos (B,)) -> (logits (B, V) f32, cache).  The cache is
    updated in place and returned.  A paged cache takes the slots' page
    map (B, ppr) and, in prism mode, state map (B,), int32 (-1 =
    unmapped).

    The degraded step (a sequence shard lost, ``runtime/replica.py``):
    ``lost`` (P,) f32 marks the unreadable shards (> 0).  Their exact
    columns leave ``valid``, writes to them are dropped, and their
    positions are served by Segment-Means columns (``attn_decode``): in
    exact mode from ``rep``, one {"kz", "vz", "gz"} dict a layer (the
    assembled standby replica), in prism mode from the cache's own state
    rows.  It requires the paged cache."""
    check_decoder(cfg, "serve_step")
    slot, owner, col_pos = _decode_cols(lay, pos)
    valid = col_pos[None] <= pos[:, None, None]              # (B, P, cap_l)
    wr_owner = owner
    if lost is not None:
        if page_map is None:
            raise ValueError("the degraded step requires the paged cache")
        if (rep is None) != (hp.decode_mode == "prism"):
            raise ValueError("the degraded step takes the replica in exact "
                             "decode mode, and only there")
        dead = lost > 0                                          # (P,)
        wr_owner = owner & ~dead
        valid = valid & ~dead[None, :, None]
    rows = torch.arange(pos.shape[0], device=pos.device)
    # the prism state rows, from a global layer (a local one has none)
    glob = next((c for c in cache if "kz" in c), None)
    cols = (write_plan(rows, slot, wr_owner, lay.n_seq, lay.cap_l,
                       page_map),
            owner, valid, page_map, state_map,
            None if glob is None else state_rows(glob, state_map))
    ring = (ring_cols(ring_width(cfg, lay), cfg.window, pos)
            if "attn_local" in cfg.block_kinds else None)
    x = embed_tokens(cfg, params, token[:, None], pos[:, None])
    for i, ((kind, p), c) in enumerate(zip(layer_blocks(cfg, params),
                                           cache)):
        x = block_decode(cfg, kind, p, x, c, pos, lay, hp,
                         ring if kind == "attn_local" else cols, lost,
                         None if rep is None else rep[i])
    return lm_head(cfg, params, x[:, 0]), cache


def generate(cfg: ModelConfig, params, prompts: torch.Tensor | None, *,
             gen: int, prism: PrismConfig, lay: ServeLayout,
             hp: ServeHParams, forced: torch.Tensor | None = None,
             embeds: torch.Tensor | None = None):
    """Prefill (a vlm's image ``embeds`` over its prefix; an audio
    model's frames ``embeds`` (B, n0, D) with ``prompts`` None), then
    ``gen - 1`` greedy decode steps.

    ``forced`` (B, gen - 1) teacher-forces the decoded tokens instead of
    feeding back the argmax.  Returns (tokens (B, gen), logits
    (gen, B, V), times): tokens[:, i] is the argmax of logits[i];
    ``times`` holds prefill_ms and decode_ms_per_token, from CUDA events
    on a card and from the host clock on the CPU (``times['clock']``)."""
    check_decoder(cfg, "generate")
    first = prompts if prompts is not None else embeds
    b, n = first.shape[:2]
    on_card = first.is_cuda
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        mark = [e.record for e in ev]
    else:
        stamps = []
        mark = [lambda: stamps.append(time.perf_counter())] * 3
    mark[0]()
    logits, cache = prefill(cfg, params, prompts, prism, lay, hp, embeds)
    mark[1]()
    out = [logits]
    for i in range(gen - 1):
        tok = out[-1].argmax(dim=-1) if forced is None else forced[:, i]
        pos = torch.full((b,), n + i, dtype=torch.long,
                         device=first.device)
        logits, cache = serve_step(cfg, params, cache, tok, pos, lay, hp)
        out.append(logits)
    mark[2]()
    logits = torch.stack(out)
    if on_card:
        torch.cuda.synchronize(first.device)
        t_pre, t_dec = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        clock = "cuda_events"
    else:
        t_pre = 1e3 * (stamps[1] - stamps[0])
        t_dec = 1e3 * (stamps[2] - stamps[1])
        clock = "host"
    times = {"prefill_ms": t_pre,
             "decode_ms_per_token": t_dec / max(1, gen - 1), "clock": clock}
    return logits.argmax(dim=-1).T, logits, times
