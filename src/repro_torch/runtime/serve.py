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
(``DECODE_MOE_CTX``; on a mesh ``MeshMoeCtx``).

The paged cache (``runtime/paging.py``): the layer cache is a page pool
(n_pages, P, pc, Hkv, hd) with, in prism mode, a state pool of means
rows; ``serve_step`` and the tick programs take the per-slot page map
(B, ppr) and state map (B,), write through them and read the pool in
place (the decode kernel's page table).

Over a mesh of ranks (``launch/mesh.py``), as the reference's
``make_prefill_step`` / ``make_serve_step`` run under ``shard_map``:
``prefill``, ``serve_step`` and ``generate`` take a rank's
``MeshParams`` (its local parameters and their rules) and a layout from
``make_layout(mesh, ...)``.  The batch splits over ``data`` where it
divides, else the sequence over every axis (the reference's
``_layout_axes``); the sequence over ``model``, one shard a rank, so the
cache's shard axis holds the rank's own (``ServeLayout.held``).  Each
layer's parameters are gathered on use (``rules.gather_tree``); a
vocab-sharded table embeds by a masked take and a psum over ``model``,
and its logits come back sharded (``gather_logits``).  The exact combine
is a ``pmax``, then one ``psum`` of the rescaled (l, acc), over the
sequence group, the prism owner select a psum of the owner-masked
outputs.  With ``decode_tp`` the decode keeps the Megatron layout
(``rules.decode_param_specs``): column-parallel wq and up/gate, a head
gather of q, row-parallel wo and down, one activation psum each, no
parameter gather.  A MoE layer's experts live E / M a rank over
``model`` and exchange the routed tokens by an ``all_to_all`` pair
(``MeshMoeCtx``); with ``decode_tp`` each expert's d_ff is also cut over
``data`` (expert-TP: the tokens gathered over ``data``, the down
partials psummed).  A sliding-window layer's ring and a recurrent
layer's state are replicated over the sequence ranks: prefill captures
the last shard's (``ctx.last_shard``), and every rank's decode updates
its copy alike.  A vlm's image and an audio model's frames come in
whole and each rank embeds the rows of its positions.  The paged cache
serves a mesh too: its pool and state pool are replicated over the batch
axes (every batch replica writes the same pages), each rank holding its
sequence shard of every page, and ``serve_step`` takes every slot's
token and position.  The degraded step serves a mesh whose sequence
group is ``model``: the rank's lane is its index there; a lost rank's
exact columns leave ``valid``, its writes are dropped, and its K/V is
never read (the lane attends over a zero page in its place, which the
masked columns make exact); in exact mode the standby columns of the
lost shard come back to that rank from its ring neighbour
(``runtime/replica.py``).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace

import torch
import torch.utils.checkpoint

from ..convert import from_jax_numpy, shard_params
from ..core.attention import log_repeats
from ..core.protocol import PrismConfig
from ..kernels.decode_attention import decode_stats
from ..kernels.ops import prism_attention_op
from ..launch.mesh import Mesh, batch_axes, mesh_axes
from ..models.config import ModelConfig
from ..models.context import SeqContext
from ..models.layers import (AttnSpec, attn_output, attn_project_kv,
                             attn_project_q, dense, embed, mlp, norm)
from ..models.moe import RoutingLog
from ..models.transformer import (RECURRENT_KINDS, attn_spec,
                                  block_residual, check_decoder,
                                  check_dtype, check_supported, classify,
                                  embed_inputs, embed_scale, head,
                                  layer_blocks, params_dtype,
                                  recurrent_block, recurrent_decode, sincos)
from ..sharding import comm
from ..sharding.context import (ShardedPrismContext, expert_all_to_all,
                                means_columns)
from ..sharding.rules import (decode_param_specs, gather_tree, param_specs,
                              tp_flags)
from .paging import KVCache, PrefixCache


@dataclass(frozen=True)
class ServeHParams:
    decode_mode: str = "exact"       # 'exact' | 'prism'
    means_cr: float = 16.0           # CR for the prism decode means cache
    backend: str = "auto"            # kernel dispatch: 'auto'|'kernel'|'plain'
    # the reference's tensor-parallel decode over the mesh's model axis,
    # expert-TP over data for MoE blocks (``check_mesh_serving``)
    decode_tp: bool = False
    ssm_chunk: int = 128             # an mLSTM prefill's chunk length
    # the checks' record or replay of the MoE routing decisions
    routing: RoutingLog | None = field(default=None, compare=False,
                                       repr=False)


# the expert exchange of a decode step, a chunk call or a packed tick in
# one process (the reference's DecodeMoeCtx with tp=False; on a mesh
# ``MeshMoeCtx``): all of the call's tokens are one routing group, as the
# reference's all_to_all over tokens every shard holds gives
DECODE_MOE_CTX = SeqContext()


class MeshMoeCtx(SeqContext):
    """The expert exchange of a decode step on a mesh (the reference's
    ``DecodeMoeCtx``): the rank's B_loc tokens are one routing group;
    its (E, cap, D) buffer goes to the experts' ranks by the
    ``all_to_all`` pair over ``model``.  With ``tp`` (expert-TP, the
    decode-TP rules' ``expert_tp_col`` / ``expert_tp_row``) each expert's
    d_ff is cut over ``data``: the received slots are gathered over
    ``data``, every rank computes its d_ff slice's partials, which are
    psummed over ``data``, and the rank's own slots go back.  With
    ``dense_tp`` a dense residual MLP cut Megatron style over ``model``
    (arctic's) psums its partials there."""

    def __init__(self, mesh: Mesh, tp: bool = False,
                 dense_tp: bool = False):
        self.experts = mesh.group("model")
        self.data = mesh.group("data") if tp else None
        self.dense = self.experts if dense_tp else None

    def expert_exchange(self, buf):
        out, back = expert_all_to_all(buf, self.experts)
        if self.data is None:
            return out, back
        n = out.shape[1]
        own = slice(self.data.index * n, (self.data.index + 1) * n)
        return (comm.all_gather(out, self.data, "expert", dim=1),
                lambda y: back(y[:, own]))

    def expert_reduce(self, y):
        return y if self.data is None else comm.psum(y, self.data, "expert")

    def ffn_reduce(self, y):
        return y if self.dense is None else comm.psum(y, self.dense, "tp")


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshParams:
    """One rank's parameters on a mesh: ``params`` the local tree, each
    leaf its block under ``rules`` (``mesh_params``); ``decode_tp``:
    cut by the decode-TP rules."""
    mesh: Mesh
    rules: dict
    params: dict
    decode_tp: bool = False


def mesh_params(cfg: ModelConfig, params: dict, mesh: Mesh, *,
                decode_tp: bool = False) -> MeshParams:
    """This rank's ``MeshParams`` from the whole parameters (the port's
    tree, or the reference's numpy tree): the FSDP rules of prefill and
    of the FSDP decode (``rules.param_specs``), or the decode-TP rules
    (``rules.decode_param_specs``).  Rules are computed on the port's
    tree, so a reference tree is carried across first.  bf16 parameters
    are refused (``transformer.check_dtype``)."""
    check_dtype(cfg, params_dtype(params), refused=(
        "a mesh of ranks (launch/mesh.py, sharding/comm.py: the gloo "
        "collectives and the meter's byte counts are f32's)"))
    if "scan" in params:
        params = from_jax_numpy(cfg, params, device=mesh.device)
    rules = (decode_param_specs(params, mesh, cfg.vocab_size, cfg)
             if decode_tp else param_specs(params, mesh, cfg.vocab_size))
    return MeshParams(mesh, rules, shard_params(params, rules, mesh),
                      decode_tp)


def check_mesh_serving(cfg: ModelConfig, hp: ServeHParams, mesh) -> None:
    """Raise for ``decode_tp`` where the reference's mesh cannot run it:
    off a mesh whose ``model`` axis is over 1, in prism decode, or over
    experts whose d_ff does not split over ``data`` (the decode-TP rule
    would cut ``down/w`` across d_model, on which the reference's
    expert-TP fails).  ``mesh``: a ``Mesh``, its axis sizes, or None (the
    fold)."""
    if not hp.decode_tp:
        return
    _check_tp_axis(mesh)
    if hp.decode_mode != "exact":
        raise ValueError(
            "decode_tp decodes exactly: the reference's attn_decode_tp "
            "reads no means cache; take decode_mode='exact'")
    cut = sorted(set(cfg.block_kinds) & {"attn_local", "mlstm", "slstm"})
    if cut:
        raise NotImplementedError(
            f"decode_tp over {cut} blocks: the decode-TP rules cut their "
            "wq (or a cell's projections) column-parallel, which a ring or "
            "a cell's decode does not read as such; the reference's "
            "decode fails on them too")
    data = mesh_axes(mesh).get("data", 1)
    if "moe" in cfg.block_kinds and cfg.expert_d_ff % data:
        raise NotImplementedError(
            f"expert-TP cuts each expert's d_ff over data: d_ff "
            f"{cfg.expert_d_ff} does not split over {data}, so the "
            "decode-TP rule would cut the experts' down/w across d_model "
            f"({cfg.d_model}), where the reference's DecodeMoeCtx(tp=True) "
            "fails")


def _check_tp_axis(mesh) -> None:
    if mesh is None or mesh_axes(mesh).get("model", 1) <= 1:
        raise NotImplementedError("decode_tp (tensor-parallel decode) needs "
                                  "a mesh whose model axis is over 1")


def check_degraded_mesh(lay, hp: ServeHParams) -> None:
    """Raise for the degraded step where a mesh cannot serve it: a
    sequence group other than ``model`` alone (the reference's degraded
    runs are on (1, 4), its lost shard a ``model`` index, and a lane
    over every axis would mix batch replicas into the shard ring), and
    decode_tp (its attention reads no means)."""
    if lay.seq_axes and tuple(lay.seq_axes) != ("model",):
        raise NotImplementedError(
            f"the degraded step over a sequence group of {lay.seq_axes}: "
            "a lost shard is a 'model' index, and the standby ring runs "
            "over 'model' alone; take a batch that divides the data axis")
    if hp.decode_tp:
        raise NotImplementedError(
            "the degraded step under decode_tp: the tensor-parallel "
            "attention reads no Segment-Means columns")


def layout_axes(mesh, batch: int) -> tuple:
    """(batch axes, sequence axes) of a mesh layout: ``model`` shards the
    sequence when the batch divides over the batch axes; otherwise (the
    long_500k case, B = 1) the batch is replicated and the sequence
    shards over every axis (the reference's ``_layout_axes``)."""
    axes = mesh_axes(mesh)
    ba = batch_axes(mesh)
    if batch % math.prod(axes[a] for a in ba) == 0:
        return ba, ("model",)
    return (), tuple(axes)


def seq_shards(mesh, batch: int) -> int:
    """The sequence shards of ``make_layout`` for (mesh, batch): prompt
    and cache lengths must be multiples of it."""
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in layout_axes(mesh, batch)[1])


def _mesh(params):
    """The rank's mesh of ``MeshParams``, None for whole parameters."""
    return params.mesh if isinstance(params, MeshParams) else None


def _tree(params):
    """The parameter tree a layer reads: the local tree on a mesh."""
    return params.params if isinstance(params, MeshParams) else params


def _layers(cfg: ModelConfig, params):
    """Each layer's (kind, parameters), gathered on a mesh (FSDP) as the
    layer is reached."""
    if not isinstance(params, MeshParams):
        yield from layer_blocks(cfg, params)
        return
    for (kind, p), (_, r) in zip(layer_blocks(cfg, params.params),
                                 layer_blocks(cfg, params.rules)):
        yield kind, gather_tree(p, r, params.mesh)


def batch_rows(t, lay, mesh):
    """This rank's rows of a whole-batch tensor: its block over the batch
    axes, all of them where the batch is replicated (None: None)."""
    if t is None or mesh is None or not lay.ba:
        return t
    grp = mesh.group(lay.ba)
    n = t.shape[0] // grp.size
    return t[grp.index * n:(grp.index + 1) * n]


def vocab_lookup(params, tokens):
    """The embedding rows of ``tokens``; a vocab-sharded table (a
    ``MeshParams`` whose table rule is ``vocab``) looks up its own rows,
    zeros for the others, and psums over ``model``."""
    tree = _tree(params)
    table = tree["embed"]["table"]
    if (not isinstance(params, MeshParams)
            or params.rules["embed"]["table"].kind != "vocab"):
        return embed(tree["embed"], tokens)
    mg = params.mesh.group("model")
    v_loc = table.shape[0]
    t = tokens - mg.index * v_loc
    ok = (t >= 0) & (t < v_loc)
    e = table[t.clamp(0, v_loc - 1)]
    return comm.psum(torch.where(ok[..., None], e, torch.zeros_like(e)), mg,
                     "tp")


def gather_logits(logits, params):
    """Logits over the whole vocabulary: a vocab-sharded head's (the
    rule of the tied table or of ``lm_head``), gathered over ``model``."""
    if not isinstance(params, MeshParams):
        return logits
    r = params.rules
    rule = r["embed"]["table"] if "lm_head" not in r else r["lm_head"]["w"]
    if rule.kind != "vocab":
        return logits
    return comm.all_gather(logits, params.mesh.group("model"), "tp", dim=-1)


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
    ba: tuple = ()                   # mesh axes of the batch
    seq_axes: tuple = ()             # mesh axes of the sequence; () folded

    @property
    def n_loc0(self) -> int:
        return self.prefill_len // self.n_seq

    @property
    def held(self) -> int:
        """The shards a process holds: all P folded, its own on a mesh."""
        return 1 if self.seq_axes else self.n_seq


def make_layout(shards, cap: int, hp: ServeHParams,
                prefill_len: int | None = None,
                placement: str = "aligned", *,
                batch: int | None = None) -> ServeLayout:
    """The layout of ``shards`` sequence shards folded into one process,
    or, with a ``Mesh`` and the whole ``batch``, of the mesh's ranks
    (``layout_axes``)."""
    ba, seq = (), ()
    if isinstance(shards, Mesh):
        if batch is None:
            raise ValueError("a mesh layout needs the whole batch")
        ba, seq = layout_axes(shards, batch)
        n_seq = shards.size(seq)
    else:
        n_seq = shards
        if hp.decode_tp:
            _check_tp_axis(None)
    n0 = cap if prefill_len is None else prefill_len
    if cap % n_seq or n0 % n_seq or n0 > cap:
        raise ValueError(f"cap={cap} and prefill_len={n0} must be "
                         f"multiples of n_seq={n_seq}, prefill_len <= cap")
    if placement not in ("aligned", "rr"):
        raise ValueError(f"placement {placement!r} not in ('aligned', 'rr')")
    L = max(1, int(n0 // (hp.means_cr * n_seq)))
    L = min(L, n0 // n_seq)
    return ServeLayout(n_seq, cap, cap // n_seq, n0, L, placement, ba, seq)


def paged_placement(hp: ServeHParams, paging) -> str:
    """Paged exact mode stores round-robin, so that pages cover
    contiguous position blocks (prefix sharing); paged prism keeps the
    aligned placement the Segment-Means shard ownership is defined
    over."""
    return "rr" if (paging is not None
                    and hp.decode_mode == "exact") else "aligned"


#: the cache leaves in the cache's dtype; the others (the repeat counts
#: gz, the segment sums zsum, a recurrent state) are f32 in any, as the
#: reference's ``layer_cache_shape``
DTYPE_LEAVES = ("k", "v", "kz", "vz")


def init_cache(cfg: ModelConfig, lay: ServeLayout, batch: int,
               hp: ServeHParams, device, paging=None,
               dtype=torch.float32) -> list:
    """An all-zero decode-layout cache, one dict of leaves per layer
    (``layer_cache_shape``), k, v, kz, vz in ``dtype`` (the reference's
    ``init_cache(..., dtype)``, f32 by default) and the other leaves f32:
    what the chunked and packed ticks admit requests into."""
    return [{name: torch.zeros(shape, device=device,
                               dtype=dtype if name in DTYPE_LEAVES
                               else torch.float32)
             for name, shape in layer_cache_shape(cfg, lay, batch, hp,
                                                  paging, kind).items()}
            for kind in cfg.block_kinds]


def ring_width(cfg: ModelConfig, lay: ServeLayout) -> int:
    """W, the ring cache's slots of a sliding-window layer."""
    return min(cfg.window or lay.cap, lay.cap)


def layer_cache_shape(cfg: ModelConfig, lay: ServeLayout, batch: int,
                      hp: ServeHParams, paging=None,
                      kind: str = "attn") -> dict:
    """Per-layer cache leaves: k, v (B, P, cap_l, Hkv, hd) (on a mesh
    the rank's batch rows and its one shard, (B, 1, cap_l, Hkv, hd));
    prism mode adds the means K/V kz, vz (B, P·L, Hkv, hd), their
    per-request repeat counts gz (B, P·L) and the per-segment activation
    sums zsum (B, P·L, D).  With ``paging`` (a ``PagedLayout``) k, v are the
    page pool (n_pages, P, pc, Hkv, hd) (on a mesh the rank's shard of
    every page, (n_pages, 1, pc, Hkv, hd)) and the prism leaves have one
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
        kv = (batch, lay.held, lay.cap_l, hkv, hd)
        rows = batch
    else:
        kv = (paging.n_pages, lay.held, paging.page_cols, hkv, hd)
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
                  prefix_cache: bool = False, mesh=None,
                  dtype=torch.float32) -> KVCache:
    """The engine's one cache object: zero-filled device storage in a
    ``KVCache`` (paged: the pools, a ``PageTable`` and, if asked, a
    ``PrefixCache``; dense, ``paging=None``: the rowset of ``batch``
    rows), its k, v, kz, vz in ``dtype`` (``init_cache``).  The engine
    takes the default, f32, whatever its parameters' dtype, as the
    reference's (its ``make_kv_cache`` call passes no dtype), so a bf16
    model writes every K/V row into an f32 cache.  With a mesh layout, this rank's storage on ``mesh``: the
    pools replicated over the batch axes (the reference's specs), or its
    block of the dense rows over them; every rank holds the same page
    table and prefix cache, since page ids name the same span on every
    rank."""
    rows, first = batch, 0
    if mesh is not None and paging is None and lay.ba:
        grp = mesh.group(lay.ba)
        rows = batch // grp.size
        first = grp.index * rows
    kv = KVCache(storage=init_cache(cfg, lay, rows, hp, device, paging,
                                    dtype),
                 layout=lay, paging=paging, first_row=first)
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
    P = lay.held                        # the shards this process holds
    b = bp // P
    hkv, hd = k.shape[2:]
    if spec.window is not None:
        return ctx.finalize(o), ring_capture(k, v, ctx, lay, shapes), xq_n
    # prism: the local block comes first in every shard's K/V; voltage: K/V
    # is the full sequence, whose shard-p slice is batch row b·P + p
    k_loc = k[:, :n_loc] if prism_augment else ctx.take_local(k)
    v_loc = v[:, :n_loc] if prism_augment else ctx.take_local(v)
    cache = {}
    for name, t in (("k", k_loc), ("v", v_loc)):
        c = torch.zeros(shapes[name], dtype=t.dtype, device=t.device)
        c[:, :, :n_loc] = t.reshape(b, P, n_loc, hkv, hd)
        cache[name] = c
    if hp.decode_mode == "prism":
        m = lay.n_seq * lay.L
        means = means_columns(lay.n_seq, n_loc, lay.L, x.device)
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


def ring_capture(k, v, ctx, lay: ServeLayout, shapes: dict) -> dict:
    """A sliding-window layer's ring cache after prefill: the last W
    prompt positions, position p in slot p % W (placed by the prompt
    length, where the reference's ``cap - W`` placement is right only
    when cap = n0 mod W).  k, v (B·P, m, Hkv, hd) hold each shard's own
    rows last, after ``hops`` shards of halo, so the last shard's m
    columns cover the last min(W, n0) positions: they are the ring,
    taken by ``ctx.last_shard`` (on a mesh broadcast from the last rank,
    so every sequence rank holds the same ring)."""
    n0 = lay.prefill_len
    w = shapes["k"][1]
    first = max(0, n0 - w)
    slots = torch.arange(first, n0, device=k.device) % w
    cache = {}
    for name, t in (("k", k), ("v", v)):
        tail = ctx.last_shard(t[:, t.shape[1] - (n0 - first):])
        c = torch.zeros(shapes[name], dtype=t.dtype, device=t.device)
        c[:, slots] = tail
        cache[name] = c
    return cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor | None,
            prism: PrismConfig, lay: ServeLayout, hp: ServeHParams,
            embeds: torch.Tensor | None = None):
    """tokens (B, n0) -> (last-token logits (B, V) f32, decode cache).
    The cache's k, v, kz, vz come out in the parameters' (compute) dtype,
    gz and zsum in f32, as the reference's; bf16 parameters serve what
    ``transformer.check_dtype`` lets them.

    ``prism.mode`` picks the exchange: 'prism' (Segment-Means) or
    'voltage' (full).  A vlm's image embeds (B, prefix_len, D) overwrite
    the first prefix_len positions (``embed_inputs``, over the whole
    sequence before it is cut into shards: the reference's overwrite of
    each shard's rows by global position), and the prefix attends
    bidirectionally in the kernel (``cfg.prefix_len``).  An audio model
    takes ``tokens=None`` and its frames, embeds (B, n0, D).  A recurrent
    block hands its state across the shards and keeps the sequence's end
    state (an mLSTM or Mamba2 recurrence in chunks of ``hp.ssm_chunk``;
    Mamba2's conv takes the previous shard's rows as its halo).

    On a mesh (``params`` a rank's ``MeshParams``, ``lay`` the mesh's):
    ``tokens`` and ``embeds`` are the whole batch, and the rank answers for
    its batch rows (B_loc, V) over its vocab shard (``gather_logits``)
    with the cache of its rows and sequence shard."""
    check_supported(cfg)
    check_decoder(cfg, "prefill")
    mesh = _mesh(params)
    check_dtype(cfg, params_dtype(params))     # a mesh's: mesh_params
    _check_on_mesh(cfg, hp, mesh, lay)
    b, n = (tokens if tokens is not None else embeds).shape[:2]
    P = lay.n_seq
    if n != lay.prefill_len:
        raise ValueError(f"prompt length {n} != layout prefill_len "
                         f"{lay.prefill_len}")
    n_loc = n // P
    prism_cfg = prism.with_(P=P, L=lay.L if hp.decode_mode == "prism"
                            else prism.L)
    ctx = ShardedPrismContext(prism_cfg, n_shards=P, backend=hp.backend,
                              mesh=mesh, seq_axes=lay.seq_axes)
    prism_augment = prism_cfg.mode == "prism"
    if mesh is None:
        x = embed_inputs(cfg, params, tokens, embeds=embeds).reshape(
            b * P, n_loc, cfg.d_model)
    else:
        x = _embed_shard(cfg, params, batch_rows(tokens, lay, mesh), lay,
                         batch_rows(embeds, lay, mesh))
        b = x.shape[0]
    cache = []
    for kind, p in _layers(cfg, params):
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
    return lm_head(cfg, _tree(params), ctx.last_shard(x[:, -1])), cache


def _check_on_mesh(cfg: ModelConfig, hp: ServeHParams, mesh, lay) -> None:
    """Raise unless parameters and layout agree on the mesh, and for
    what a mesh does not serve."""
    if (mesh is None) != (not lay.seq_axes):
        raise ValueError("a mesh's parameters (MeshParams) take a mesh's "
                         "layout (make_layout(mesh, ...)), and only they do")
    check_mesh_serving(cfg, hp, mesh)


def _embed_shard(cfg: ModelConfig, mp: MeshParams, tokens, lay,
                 embeds=None):
    """The rank's rows of the prompt's embedding: tokens (B_loc, N), or
    an audio model's frames (B_loc, N, D), -> (B_loc, n_loc, D) at
    positions [start, start + n_loc).  A vocab-sharded table looks up the
    rows of the rank's ``model`` group (a contiguous block of the
    sequence) and keeps its own after the psum; a vlm's image (B_loc,
    prefix_len, D), projected whole, overwrites the rank's positions below
    the prefix (the reference's per-shard overwrite); learned positions
    come from the gathered table, sinusoids at the rank's start."""
    seq = mp.mesh.group(lay.seq_axes)
    n = (tokens if tokens is not None else embeds).shape[1]
    n_loc = n // seq.size
    start = seq.index * n_loc
    if tokens is None:                    # the frames are the prompt
        x = dense(_frontend(mp), embeds[:, start:start + n_loc])
    # the lookups' outputs follow their indices' strides: the token
    # blocks are copied contiguous, as the kernels take the rows
    elif mp.rules["embed"]["table"].kind == "vocab":
        mg = mp.mesh.group("model")
        first = start - mg.index * n_loc
        x = vocab_lookup(mp, tokens[:, first:first + mg.size * n_loc]
                         .contiguous())
        x = x[:, mg.index * n_loc:(mg.index + 1) * n_loc].contiguous()
    else:
        x = vocab_lookup(mp, tokens[:, start:start + n_loc].contiguous())
    if tokens is not None and embeds is not None:      # a vlm's image
        fe = dense(_frontend(mp), embeds).to(x.dtype)
        m = max(0, min(n_loc, cfg.prefix_len - start))
        x = torch.cat([fe[:, start:start + m], x[:, m:]], dim=1)
    x = embed_scale(cfg, x)
    if cfg.pos == "learned":
        tbl = gather_tree(mp.params["pos_embed"], mp.rules["pos_embed"],
                          mp.mesh)["table"]
        return x + tbl[start:start + n_loc].to(x.dtype)
    if cfg.pos == "sincos":
        return x + sincos(torch.arange(n_loc, device=x.device) + start,
                          cfg.d_model).to(x.dtype)
    return x


def _frontend(mp: MeshParams):
    """The stub frontend's projection, gathered."""
    return gather_tree(mp.params["frontend_proj"], mp.rules["frontend_proj"],
                       mp.mesh)


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
    check_dtype(cfg, params_dtype(params))
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
    check_dtype(cfg, params_dtype(params),
                refused="encode (the encoders' classification)")
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

def _decode_cols(lay: ServeLayout, pos: torch.Tensor, shard0: int = 0):
    """(write slot (..., P), owner (..., P), col_pos (P, cap_l)) for the
    positions ``pos`` of any shape under the layout's placement (-1 =
    dead entry: owner False on every shard); P the shards held, from
    ``shard0`` (a mesh rank's sequence index) on."""
    n0, n_loc0, n_seq = lay.prefill_len, lay.n_loc0, lay.n_seq
    idx = shard0 + torch.arange(lay.held, device=pos.device)     # (P,)
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


def _combine_exact(m_p, l_p, acc_p, seq=None):
    """Cross-shard flash-softmax combine over the shard axis (dim 1) for
    Nq queries: m, l (B, P, Hq, Nq), acc (B, P, Nq, Hq, hd) ->
    (B, Nq, Hq, hd).  Any disjoint column sets combine the same way (the
    chunked and packed ticks add their intra-tick columns as one more
    entry of the axis).  Sets with no valid column (m = NEG) cancel via
    corr = 0.  ``seq`` (a mesh's sequence group) extends the axis over
    its ranks: the reference's ``pmax``, then one ``psum`` of the
    rescaled (l, acc)."""
    m_g = m_p.amax(dim=1, keepdim=True)
    if seq is not None:
        m_g = comm.pmax(m_g, seq, "combine")
    corr = torch.exp(m_p - m_g)                                  # (B,P,Hq,Nq)
    l_c = (l_p * corr).sum(dim=1)                                # (B,Hq,Nq)
    acc_c = (acc_p * corr.transpose(2, 3)[..., None]).sum(dim=1)
    if seq is not None:
        both = comm.psum(torch.cat([l_c.flatten(), acc_c.flatten()]), seq,
                         "combine")
        l_c = both[:l_c.numel()].view_as(l_c)
        acc_c = both[l_c.numel():].view_as(acc_c)
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
                     zrows=None, backend="auto", seq=None):
    """Per-token decode attention over the shard-stacked cache.

    q (Bq,1,Hq,hd); k, v (R,P,M,Hkv,hd) or the page pool with ``pages``
    (as ``shard_stats``); valid (Bq,P,M) bool; rows (Bq,) int32 maps
    query rows to cache rows (None: the identity).  Prism extras: gz
    (Bq,P,m) per-row, per-shard means repeat counts (0 = dead column),
    kz/vz (R,m,Hkv,hd) or the state pool with ``zrows``, owner (Bq,P)
    bool.  ``seq``: a mesh's sequence group, whose ranks hold the other
    shards (the combine and the owner select run over it).  Returns
    (Bq,1,Hq,hd)."""
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
        if seq is not None:
            out = comm.psum(out, seq, "combine")
    else:
        out = _combine_exact(m_p, l_p, acc_p, seq)
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


def replica_gz(counts, lost, first: int = 0, held: int | None = None):
    """The repeat counts (B, held, m) under which the degraded exact
    step's shards see the standby replica's columns: ``counts`` (B, m)
    the replica's, shard-major; each lost shard's lane sees its own
    columns, and nothing else sees any, so the shard combine counts each
    mean once.  The lanes are the shards held, ``first`` on (a mesh
    rank's: its own); all P by default."""
    p, m = lost.shape[0], counts.shape[1]
    lanes = first + torch.arange(p if held is None else held,
                                 device=counts.device)
    lane = (lanes[:, None]
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
                rep=None, seq=None):
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
    state rows already hold, the lost shard's own gate opened.

    ``seq``: a mesh's sequence group; the layer cache holds the rank's
    shard, combined over the group's ranks.  A write plan of None writes
    nothing (a lost rank's lane)."""
    if spec.window is not None:
        plan, valid = cols                           # the ring's
    else:
        plan, owner, valid, page_map, state_map, sr = cols
    xn = norm(p["ln1"], x, cfg.norm_kind)
    rp = pos[:, None]                                # (B, 1) row positions
    q = attn_project_q(p["attn"], spec, xn, rp)
    k_new, v_new = attn_project_kv(p["attn"], spec, xn, rp)
    scale = spec.head_dim ** -0.5
    if plan is not None:
        _write_kv(c["k"], k_new[:, 0], plan)
        _write_kv(c["v"], v_new[:, 0], plan)
    if spec.window is not None:                  # the ring, one shard
        out = decode_attention(q, c["k"][:, None], c["v"][:, None], valid,
                               scale, backend=hp.backend)
    elif hp.decode_mode == "prism" and "kz" in c:
        # repeat counts ride in the cache (the state pool when paged)
        means = means_columns(lay.n_seq, lay.n_loc0, lay.L, x.device)
        if seq is not None:              # the rank's shard's repeat counts
            means = means._replace(g=means.g[seq.index:seq.index + 1])
        cnt = c["gz"] if sr is None else c["gz"][sr]
        gz = prism_gz(means, cnt, pos, lost)                 # (B, P, m)
        out = decode_attention(q, c["k"], c["v"], valid, scale, gz=gz,
                               kz=c["kz"], vz=c["vz"], owner=owner,
                               mode="prism", pages=page_map, zrows=state_map,
                               backend=hp.backend, seq=seq)
    elif rep is not None:
        gz = replica_gz(rep["gz"], lost, 0 if seq is None else seq.index,
                        lay.held)                             # (B, P, m)
        out = decode_attention(q, c["k"], c["v"], valid, scale, gz=gz,
                               kz=rep["kz"], vz=rep["vz"], pages=page_map,
                               backend=hp.backend, seq=seq)
    else:
        out = decode_attention(q, c["k"], c["v"], valid, scale,
                               pages=page_map, backend=hp.backend, seq=seq)
    return attn_output(p["attn"], out), xn


def mlp_tp(p, x, kind: str, mg):
    """The feed-forward over column-parallel up/gate and row-parallel
    down (the rank's d_ff slice): one psum of the partial outputs over
    the ``model`` group ``mg``."""
    return comm.psum(mlp(p, x, kind), mg, "tp")


def attn_decode_tp(p, spec: AttnSpec, cfg: ModelConfig, x, c, pos,
                   lay: ServeLayout, hp: ServeHParams, cols, seq, tp):
    """Tensor-parallel single-token attention, exact decode: with
    attention TP the rank projects its Hq / tp heads through its columns
    of wq, gathers every head over ``model`` (flash-decode needs them all
    against its sequence shard), attends, and projects its own heads'
    output through its rows of wo, psummed; wk / wv are whole.  ``tp`` =
    (attention TP, FFN TP, the ``model`` group).  -> (out (B,1,D), the
    normed input)."""
    attn_tp, _, mg = tp
    plan, _, valid = cols[:3]
    xn = norm(p["ln1"], x, cfg.norm_kind)
    rp = pos[:, None]
    b = x.shape[0]
    hq_loc = spec.n_heads // mg.size
    if attn_tp:
        q = attn_project_q(p["attn"], replace(spec, n_heads=hq_loc), xn, rp)
        q = comm.all_gather(q, mg, "tp", dim=2)
    else:
        q = attn_project_q(p["attn"], spec, xn, rp)
    k_new, v_new = attn_project_kv(p["attn"], spec, xn, rp)
    _write_kv(c["k"], k_new[:, 0], plan)
    _write_kv(c["v"], v_new[:, 0], plan)
    out = decode_attention(q, c["k"], c["v"], valid, spec.head_dim ** -0.5,
                           backend=hp.backend, seq=seq)
    if not attn_tp:
        return attn_output(p["attn"], out), xn
    own = out[:, :, mg.index * hq_loc:(mg.index + 1) * hq_loc]
    o = dense(p["attn"]["wo"], own.reshape(b, 1, -1))
    return comm.psum(o, mg, "tp"), xn


def block_decode(cfg: ModelConfig, kind: str, p, x, c, pos,
                 lay: ServeLayout, hp: ServeHParams, cols, lost=None,
                 rep=None, seq=None, tp=None, moe_ctx=DECODE_MOE_CTX):
    """One residual block, single-token decode (a moe block routes the
    step's B tokens as one group, exchanged through ``moe_ctx``; a
    recurrent block updates its state in place).  ``seq``: a mesh's
    sequence group; ``tp``: decode_tp's (attention TP, FFN TP, ``model``
    group)."""
    if kind in RECURRENT_KINDS:
        return recurrent_decode(cfg, kind, p, x, c)
    if tp is not None:
        o, xn = attn_decode_tp(p, attn_spec(cfg, kind), cfg, x, c, pos, lay,
                               hp, cols, seq, tp)
        if kind == "moe":
            return block_residual(cfg, kind, p, x, o, xn, moe_ctx,
                                  hp.routing)

        def ffn(h):
            return (mlp_tp(p["mlp"], h, cfg.mlp_kind, tp[2]) if tp[1]
                    else mlp(p["mlp"], h, cfg.mlp_kind))
        if cfg.parallel_block:
            return x + (o + ffn(xn))
        x = x + o
        return x + ffn(norm(p["ln2"], x, cfg.norm_kind))
    o, xn = attn_decode(p, attn_spec(cfg, kind), cfg, x, c, pos, lay, hp,
                        cols, lost, rep, seq)
    return block_residual(cfg, kind, p, x, o, xn, moe_ctx, hp.routing)


def embed_tokens(cfg: ModelConfig, params, token, pos):
    """token (B, T), pos (B, T) -> x (B, T, D), scaled by sqrt(d_model)
    where the model says so, with learned or sinusoidal positions per
    request and per token where the model has them (a RoPE model rotates
    q and k at ``pos`` in its attention layers instead).  A dead
    entry (pos = -1) still embeds (its position clamped) but never
    reaches the cache.  On a mesh (``MeshParams``) a vocab-sharded table
    looks up by ``vocab_lookup`` and learned positions are gathered."""
    x = embed_scale(cfg, vocab_lookup(params, token))
    if cfg.pos == "sincos":
        return x + sincos(pos, cfg.d_model).to(x.dtype)
    if cfg.pos != "learned":
        return x
    if isinstance(params, MeshParams):
        tbl = gather_tree(params.params["pos_embed"],
                          params.rules["pos_embed"], params.mesh)["table"]
    else:
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
    rows.  It requires the paged cache.  On a mesh ``lost`` and ``rep``
    are the whole mesh's (P,) and (B, m): the rank's lane is its index in
    the sequence group, and a lost rank reads a zero page in place of
    its K/V and writes nothing.

    On a mesh (``params`` a rank's ``MeshParams``) token and pos are the
    rank's batch rows (a paged cache's: every slot's, as its pool is
    replicated over the batch axes), and the logits its vocab shard
    (``gather_logits``); with ``hp.decode_tp`` the parameters are the
    decode-TP rules' (``mesh_params(decode_tp=True)``)."""
    check_decoder(cfg, "serve_step")
    mesh = _mesh(params)
    _check_on_mesh(cfg, hp, mesh, lay)
    seq = tp = None
    blind = False                    # this rank's shard is lost
    if mesh is not None:
        seq = mesh.group(lay.seq_axes)
        if lost is not None:
            check_degraded_mesh(lay, hp)
            blind = bool(lost[seq.index] > 0)
        if hp.decode_tp != params.decode_tp:
            raise ValueError("decode_tp takes the decode-TP rules' "
                             "parameters (mesh_params(decode_tp=True)), "
                             "and only it does")
        if hp.decode_tp:
            tp = (*tp_flags(cfg, mesh), mesh.group("model"))
    moe_ctx = decode_moe_ctx(cfg, params, hp)
    slot, owner, col_pos = _decode_cols(lay, pos,
                                        0 if seq is None else seq.index)
    valid = col_pos[None] <= pos[:, None, None]              # (B, P, cap_l)
    wr_owner = owner
    if lost is not None:
        if page_map is None:
            raise ValueError("the degraded step requires the paged cache")
        if (rep is None) != (hp.decode_mode == "prism"):
            raise ValueError("the degraded step takes the replica in exact "
                             "decode mode, and only there")
        dead = lost > 0                                          # (P,)
        if seq is not None:
            dead = dead[seq.index:seq.index + 1]
        wr_owner = owner & ~dead
        valid = valid & ~dead[None, :, None]
    rows = torch.arange(pos.shape[0], device=pos.device)
    # the prism state rows, from a global layer (a local one has none)
    glob = next((c for c in cache if "kz" in c), None)
    plan = write_plan(rows, slot, wr_owner, lay.held, lay.cap_l, page_map)
    if blind:              # the lane reads a zero page and writes nothing
        plan, page_map = None, torch.zeros_like(page_map)
    cols = (plan, owner, valid, page_map, state_map,
            None if glob is None else state_rows(glob, state_map))
    ring = (ring_cols(ring_width(cfg, lay), cfg.window, pos)
            if "attn_local" in cfg.block_kinds else None)
    x = embed_tokens(cfg, params, token[:, None], pos[:, None])
    for i, ((kind, p), c) in enumerate(zip(_layers(cfg, params), cache)):
        if blind and "k" in c and kind != "attn_local":
            blank = torch.zeros_like(c["k"][:1])
            c = dict(c, k=blank, v=blank)
        x = block_decode(cfg, kind, p, x, c, pos, lay, hp,
                         ring if kind == "attn_local" else cols, lost,
                         None if rep is None else rep[i], seq, tp, moe_ctx)
    return lm_head(cfg, _tree(params), x[:, 0]), cache


def decode_moe_ctx(cfg: ModelConfig, params, hp: ServeHParams):
    """The expert exchange of a decode step or a tick: the call's tokens
    as one routing group, on a mesh exchanged by ``MeshMoeCtx``."""
    mesh = _mesh(params)
    if mesh is None or "moe" not in cfg.block_kinds:
        return DECODE_MOE_CTX
    return MeshMoeCtx(mesh, hp.decode_tp, _dense_tp(params))


def _dense_tp(mp: MeshParams) -> bool:
    """Whether the MoE layers' dense residual MLP (arctic's) is cut
    Megatron style over ``model`` (the decode-TP rules' ``tp_row``
    down), so that its partial outputs psum there."""
    rule = next((r["moe"].get("dense_mlp") for r in mp.rules["layers"]
                 if "moe" in r), None)
    return rule is not None and rule["down"]["w"].kind == "tp_row"


def generate(cfg: ModelConfig, params, prompts: torch.Tensor | None, *,
             gen: int, prism: PrismConfig, lay: ServeLayout,
             hp: ServeHParams, forced: torch.Tensor | None = None,
             embeds: torch.Tensor | None = None,
             decode_params: MeshParams | None = None):
    """Prefill (a vlm's image ``embeds`` over its prefix; an audio
    model's frames ``embeds`` (B, n0, D) with ``prompts`` None), then
    ``gen - 1`` greedy decode steps.

    ``forced`` (B, gen - 1) teacher-forces the decoded tokens instead of
    feeding back the argmax.  Returns (tokens (B, gen), logits
    (gen, B, V), times): tokens[:, i] is the argmax of logits[i];
    ``times`` holds prefill_ms and decode_ms_per_token, from CUDA events
    on a card and from the host clock on the CPU (``times['clock']``).

    On a mesh (``params`` a rank's ``MeshParams``) the prompts and
    ``forced`` are the whole batch and the rank returns its batch rows,
    the logits gathered over the vocabulary before the greedy pick;
    ``decode_params`` are the decode steps' (the decode-TP rules' with
    ``hp.decode_tp``; by default ``params``); ``times`` adds
    ``sent_after_prefill``, the bytes by class the rank's ``Meter`` had
    counted when the prefill ended."""
    check_decoder(cfg, "generate")
    mesh = _mesh(params)
    step_params = params if decode_params is None else decode_params
    first = prompts if prompts is not None else embeds
    n = first.shape[1]
    if forced is not None:
        forced = batch_rows(forced, lay, mesh)
    b = batch_rows(first, lay, mesh).shape[0]
    on_card = first.is_cuda
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        mark = [e.record for e in ev]
    else:
        stamps = []
        mark = [lambda: stamps.append(time.perf_counter())] * 3
    mark[0]()
    logits, cache = prefill(cfg, params, prompts, prism, lay, hp, embeds)
    out = [gather_logits(logits, params)]
    mark[1]()
    sent = None if mesh is None else mesh.meter.snapshot()["sent"]
    for i in range(gen - 1):
        tok = out[-1].argmax(dim=-1) if forced is None else forced[:, i]
        pos = torch.full((b,), n + i, dtype=torch.long,
                         device=first.device)
        logits, cache = serve_step(cfg, step_params, cache, tok, pos, lay,
                                   hp)
        out.append(gather_logits(logits, step_params))
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
    if sent is not None:
        times["sent_after_prefill"] = sent
    return logits.argmax(dim=-1).T, logits, times
