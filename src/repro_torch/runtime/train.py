"""The train step: the PRISM forward over an explicit shard axis, the
LM loss with the MoE load-balance term, autograd, global-norm clipping,
the cosine schedule and AdamW (``repro.runtime.train``), on one card or
over a mesh of ranks.

On one card the P sequence shards are an axis of the activations, (B·P,
n_loc, D) as on the serving path: the parameters are whole, the loss is
over the whole vocabulary and autograd sums the shards' gradients.  A
batch split over a data axis takes a mesh.

Over a (data, model) mesh of ranks (``launch/mesh.py``; ``mesh=``) the
step is the reference's ``make_train_step`` under ``shard_map``.  Each
rank holds its block of the parameters under the FSDP rules
(``rules.param_specs``) and of AdamW's m and v under
``rules.opt_state_specs``, and takes its block of the batch (the
reference's ``batch_spec``: the batch over ``data``, the sequence over
``model``, a vlm's image prefix whole, an audio model's frames like the
tokens).  The forward embeds through the vocab-parallel lookup
(``losses.embed_vp``), gathers each layer's parameters on use
(``rules.gather_tree``, inside the remat so the backward gathers again)
and scores through the vocab-parallel loss (``losses.vp_lm_loss``),
whose value is the rank's share of the global mean; the collectives'
backwards (``sharding/comm.py``) carry the gradients across ranks, the
gathers' as reduce-scatters, and ``rules.GradReduce`` psums what no
gather summed.  The clip's norm is the whole tree's, each leaf counted
once; AdamW updates the rank's m/v block and, where that block cuts the
parameter further, gathers the parameter back over the spare axis
(``param_gather``).  The metrics are the same on every rank.

The forward's context runs with ``backend="plain"``: the CUDA kernels
have no backward, and ``kernels.dispatch`` refuses a kernel call under
autograd.  Attention is the prefill kernel's plain version (the Eq.
13-15 softmax over the Eq. 17 mask, built from ``core.attention``) and
the means its plain version, both differentiated by autograd, as the
reference differentiates its jnp attention.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.utils.checkpoint

from ..core.protocol import PrismConfig
from ..device import resolve_device
from ..launch.mesh import Mesh, batch_axes
from ..models.config import ModelConfig
from ..models.layers import dense, norm
from ..models.transformer import (check_decoder, check_dtype,
                                  check_supported, params_dtype,
                                  embed_inputs, embed_scale, layer_blocks,
                                  sincos)
from ..optim.adamw import (adamw_init, adamw_update, clip_by_global_norm,
                           cosine_schedule, tree_leaves, tree_unflatten)
from ..sharding import comm
from ..sharding.context import ShardedPrismContext
from ..sharding.rules import (GradReduce, _map_paths, _tile, cut,
                              gather_tree, opt_state_specs, param_specs,
                              scanned_layers, tree_map, tree_paths)
from .losses import chunked_lm_loss, embed_vp, vp_lm_loss
from .serve import ServeHParams, sharded_block, sharded_layers

#: the train step names itself when it refuses bf16 parameters
TRAIN_REFUSED = "make_train_step (the train step and its AdamW state)"


@dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0
    weight_decay: float = 0.1
    loss_chunks: int = 16
    remat: bool = True
    ssm_chunk: int = 128


def output_table(cfg: ModelConfig, params):
    """The LM head as a (V, D) table: the tied embedding, or the untied
    head's (D, V) weight transposed."""
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["lm_head"]["w"].T


def to_batch(batch: dict, device) -> dict:
    """numpy or tensor leaves -> tensors on ``device``: token ids and
    labels int64, embeds f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        out[k] = t.to(device=device, dtype=(t.dtype if k == "embeds"
                                            else torch.int64))
    return out


def sharded_forward(cfg: ModelConfig, params, batch: dict,
                    ctx: ShardedPrismContext, hp: TrainHParams):
    """batch {"tokens" (B, N), and "embeds" where the model takes them}
    -> (final-normed features (B, N, D), the load-balance loss summed
    over the blocks, each the mean over its routing groups).
    ``embed_inputs`` over the whole sequence, ``ctx.shard`` to (B·P, N/P,
    D), the layers (``serve.sharded_layers``, under ``hp.remat``), the
    final norm, and back to (B, N, D)."""
    x = embed_inputs(cfg, params, batch.get("tokens"),
                     embeds=batch.get("embeds"))
    b, n, d = x.shape
    shp = ServeHParams(backend=ctx.backend, ssm_chunk=hp.ssm_chunk)
    x, aux = sharded_layers(cfg, params, ctx.shard(x), ctx, shp, aux=True,
                            remat=hp.remat)
    return norm(params["final_norm"], x, cfg.norm_kind).reshape(b, n, d), aux


def loss_chunk(n: int, n_chunks: int) -> int:
    """Positions a chunk of the LM loss: N over the largest divisor of N
    not above ``n_chunks``."""
    n_chunks = min(n_chunks, n)
    while n % n_chunks:
        n_chunks -= 1
    return n // n_chunks


def loss_and_grads(cfg: ModelConfig, params, batch: dict, ctx, hp:
                   TrainHParams):
    """-> (nll, moe_aux, gradients of nll + router_aux_weight · moe_aux
    in ``params``' structure).  ``params`` are left as they are."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        feats, aux = sharded_forward(cfg, p, batch, ctx, hp)
        labels = batch["labels"]
        nll = chunked_lm_loss(feats, output_table(cfg, p), labels,
                              chunk=loss_chunk(labels.shape[1],
                                               hp.loss_chunks),
                              softcap=cfg.logit_softcap)
        loss = nll + cfg.router_aux_weight * aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return nll.detach(), aux.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, prism: PrismConfig,
                    hp: TrainHParams = TrainHParams(), *,
                    n_shards: int | None = None, device="cuda",
                    n_data: int = 1, mesh: Mesh | None = None,
                    params: dict | None = None):
    """-> ``step(params, opt, batch) -> (params, opt, metrics)``: the loss
    over ``n_shards`` sequence shards, its gradients, clipping to
    ``hp.grad_clip``, the cosine learning rate at the optimizer's step,
    then AdamW.  ``metrics``: ``loss`` (the LM loss), ``moe_aux`` (the
    load-balance loss, the reference's mean over the routing groups),
    ``gnorm`` (before clipping) and ``lr``, 0-d tensors on ``device``.

    With ``mesh`` (this rank's ``Mesh``) the step is the reference's
    over the mesh (``mesh_train_step``): ``params`` is the whole tree
    (or any tree of its shapes) the rules are computed on, the step
    takes and returns the rank's local parameters and AdamW state
    (``shard_train_state``) and the whole batch, of which it reads the
    rank's block; ``n_shards`` is the mesh's ``model`` size."""
    check_supported(cfg)
    check_decoder(cfg, "the train step")
    if mesh is not None:
        if params is not None:           # mesh_train_step refuses None
            check_dtype(cfg, params_dtype(params), refused=TRAIN_REFUSED)
        return mesh_train_step(cfg, prism, hp, mesh, params,
                               n_shards=n_shards)
    if n_data != 1:
        raise NotImplementedError(
            f"a batch split over a data axis of {n_data} runs over a mesh "
            "of ranks: make_train_step(..., mesh=Mesh((data, model), "
            "...), params=...)")
    device = resolve_device(device)
    # a vlm's prefix rule is the model's (cfg.prefix_len), as on the
    # serving path
    ctx = ShardedPrismContext(prism, n_shards=n_shards, backend="plain")

    def step(params, opt, batch):
        # the one-card step's parameters enter here
        check_dtype(cfg, params_dtype(params), refused=TRAIN_REFUSED)
        batch = to_batch(batch, device)
        nll, aux, grads = loss_and_grads(cfg, params, batch, ctx, hp)
        grads, gnorm = clip_by_global_norm(grads, hp.grad_clip)
        lr = cosine_schedule(opt["step"], base_lr=hp.lr, warmup=hp.warmup,
                             total=hp.total_steps)
        params, opt = adamw_update(params, grads, opt, lr=lr,
                                   weight_decay=hp.weight_decay)
        return params, opt, {"loss": nll, "moe_aux": aux, "gnorm": gnorm,
                             "lr": lr}

    return step


# --------------------------------------------------------------------------
# over a mesh of ranks
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainLayout:
    """How a mesh step lays a model out: this rank's mesh, the
    parameters' rules and AdamW's m/v specs (a scanned layer's with the
    reference's depth entry first)."""
    mesh: Mesh
    rules: dict
    opt_specs: dict
    n_scan: int                     # layers of the reference's scan


def train_layout(cfg: ModelConfig, params: dict, mesh: Mesh) -> TrainLayout:
    """The layout of ``params`` (the whole tree, or any tree of its
    shapes) over ``mesh``; raises where the m/v would be cut over the
    depth of the reference's stacked layers (its opt_state_specs picks
    the depth dim of a stacked leaf that no rule cuts, e.g. reduced
    arctic's dense residual on (2, 2)), which one dict a layer cannot
    hold."""
    rules = param_specs(params, mesh, cfg.vocab_size)
    specs = opt_state_specs(rules, params, mesh, cfg.scan_split)
    n_scan = scanned_layers(cfg.scan_split)
    for path, spec in tree_paths(specs):
        if _stacked(path, n_scan) and spec[0] is not None:
            raise NotImplementedError(
                f"{path}: the reference cuts its m/v over {spec[0]!r} on "
                "the depth of its stacked layers, which the port's one "
                "dict a layer does not hold")
    return TrainLayout(mesh, rules, specs, n_scan)


def _stacked(path: str, n_scan: int) -> bool:
    return path.startswith("layers/") and int(path.split("/")[1]) < n_scan


def _opt_spec(layout: TrainLayout, path: str, spec: tuple) -> tuple:
    """The m/v spec over the leaf's own dims (a scanned layer's without
    its depth entry)."""
    return spec[1:] if _stacked(path, layout.n_scan) else spec


def _whole(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block of it under ``spec``,
    gathered over each axis it names (metered ``param_gather``)."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = comm.all_gather(t, mesh.group(ax), "param_gather", dim=dim)
    return t


def _param_specs(layout: TrainLayout) -> dict:
    return tree_map(lambda r: tuple(r.spec), layout.rules)


def _opt_specs(layout: TrainLayout) -> dict:
    return _map_paths(lambda path, s: _opt_spec(layout, path, s),
                      layout.opt_specs)


def shard_train_state(layout: TrainLayout, params: dict, opt=None):
    """A whole tree and its AdamW state (``adamw_init``'s, or a restored
    one; None: a fresh one) -> this rank's (local parameters, local
    state) on the mesh's device: the parameters cut by their rules, m
    and v by their specs."""
    mesh = layout.mesh
    if opt is None:
        opt = adamw_init(params)

    def local(tree, specs):
        return tree_map(lambda t, s: cut(t, s, mesh).to(mesh.device), tree,
                        specs)
    specs = _opt_specs(layout)
    return local(params, _param_specs(layout)), {
        "m": local(opt["m"], specs), "v": local(opt["v"], specs),
        "step": opt["step"].to(mesh.device)}


def gather_train_state(layout: TrainLayout, params: dict, opt=None):
    """The inverse of ``shard_train_state``: a rank's local parameters
    (and state) -> the whole tree (and state) on every rank; every rank
    calls it (the gathers are metered ``param_gather``)."""
    def whole(tree, specs):
        return tree_map(lambda t, s: _whole(t, s, layout.mesh), tree, specs)
    p = whole(params, _param_specs(layout))
    if opt is None:
        return p
    specs = _opt_specs(layout)
    return p, {"m": whole(opt["m"], specs), "v": whole(opt["v"], specs),
               "step": opt["step"]}


def batch_block(cfg: ModelConfig, batch: dict, mesh: Mesh) -> dict:
    """This rank's block of a whole batch (the reference's
    ``batch_spec``): tokens and labels (B, N) over (data, model), a vlm's
    image (B, prefix_len, D) over data alone, an audio model's frames (B,
    N, D) over (data, model) (it has no tokens)."""
    bg = mesh.group(batch_axes(mesh))
    mg = mesh.group("model")
    out = {}
    for k, t in batch.items():
        b, n = t.shape[:2]
        if b % bg.size or (not (k == "embeds" and cfg.arch_type == "vlm")
                           and n % mg.size):
            raise ValueError(f"{k} {tuple(t.shape)} does not split over "
                             f"the mesh {mesh.shape}")
        rows = t[bg.index * (b // bg.size):][:b // bg.size]
        if k != "embeds" or cfg.arch_type != "vlm":
            n_loc = n // mg.size
            rows = rows[:, mg.index * n_loc:][:, :n_loc]
        out[k] = rows.contiguous()
    return out


def _mesh_block(cfg, kind, p_local, rule, x, ctx, shp, mesh):
    """One block, its parameters gathered first (inside the remat, so
    the recompute gathers again, as the reference's)."""
    return sharded_block(cfg, kind, gather_tree(p_local, rule, mesh), x, ctx,
                         shp, aux=True)


def mesh_forward(cfg: ModelConfig, params, layout: TrainLayout, batch: dict,
                 ctx: ShardedPrismContext, hp: TrainHParams):
    """The reference's ``sharded_forward`` on this rank's block: tokens
    (B_loc, n_loc) -> (final-normed features (B_loc, n_loc, D), the
    rank's load-balance loss summed over its blocks)."""
    mesh, rules = layout.mesh, layout.rules
    mg = mesh.group("model")
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    n_loc = (tokens if tokens is not None else embeds).shape[1]
    start = mg.index * n_loc
    if tokens is not None:
        x = embed_vp(params["embed"]["table"], tokens, mg,
                     sharded_vocab=rules["embed"]["table"].kind == "vocab")
    else:
        x = dense(gather_tree(params["frontend_proj"],
                              rules["frontend_proj"], mesh), embeds)
    if cfg.arch_type == "vlm" and embeds is not None and tokens is not None:
        # the image prefix: the projected rows of the rank's positions
        fe = dense(gather_tree(params["frontend_proj"],
                               rules["frontend_proj"], mesh), embeds)
        pos = torch.arange(start, start + n_loc, device=x.device)
        rows = fe[:, pos.clamp(max=cfg.prefix_len - 1)].to(x.dtype)
        x = torch.where((pos < cfg.prefix_len)[None, :, None], rows, x)
    x = embed_scale(cfg, x)
    if cfg.pos == "learned":
        tbl = gather_tree(params["pos_embed"], rules["pos_embed"],
                          mesh)["table"]
        x = x + tbl[start:start + n_loc].to(x.dtype)
    elif cfg.pos == "sincos":
        x = x + sincos(torch.arange(n_loc, device=x.device) + start,
                       cfg.d_model).to(x.dtype)
    shp = ServeHParams(backend=ctx.backend, ssm_chunk=hp.ssm_chunk)
    aux = x.new_zeros((), dtype=torch.float32)
    for (kind, p), (_, r) in zip(layer_blocks(cfg, params),
                                 layer_blocks(cfg, rules)):
        if hp.remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _mesh_block, cfg, kind, p, r, x, ctx, shp, mesh,
                use_reentrant=False)
        else:
            x, a = _mesh_block(cfg, kind, p, r, x, ctx, shp, mesh)
        aux = aux + a
    return norm(params["final_norm"], x, cfg.norm_kind), aux


def mesh_train_step(cfg: ModelConfig, prism: PrismConfig, hp: TrainHParams,
                    mesh: Mesh, params: dict, *, n_shards: int | None = None):
    """The reference's ``make_train_step`` on this rank of ``mesh`` (see
    ``make_train_step``); ``step.layout`` is its ``TrainLayout``."""
    if params is None:
        raise ValueError("a mesh step computes its rules on the whole "
                         "parameters' shapes: pass params=")
    layout = train_layout(cfg, params, mesh)
    axes = dict(zip(mesh.axis_names, mesh.shape))
    n_model = axes["model"]
    if n_shards not in (None, n_model):
        raise ValueError(f"{n_shards} sequence shards over a model axis of "
                         f"{n_model}")
    n_devices = math.prod(mesh.shape)
    world = mesh.group(mesh.axis_names)
    rules = layout.rules
    out_rule = (rules["embed"]["table"] if cfg.tie_embeddings
                else rules["lm_head"]["w"])
    vocab_sharded = out_rule.kind == "vocab"
    ctx = ShardedPrismContext(prism, n_shards=n_model, backend="plain",
                              mesh=mesh, seq_axes=("model",))
    mg = mesh.group("model")
    pspecs = dict(tree_paths(_param_specs(layout)))
    ospecs = dict(tree_paths(_opt_specs(layout)))
    # a leaf's squared sum counts on the ranks at coordinate 0 of every
    # axis its spec does not cut: once over the mesh
    counted = torch.tensor(
        [all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in s)
         for s in pspecs.values()], dtype=torch.float32, device=mesh.device)
    # each leaf's further cut of m/v: (dim, axis) or None
    extra = {}
    for path, ps in pspecs.items():
        os_ = ospecs[path]
        ps = ps + (None,) * (len(os_) - len(ps))
        more = [(d, a) for d, (x, a) in enumerate(zip(ps, os_)) if x != a]
        extra[path] = more[0] if more else None

    def loss_and_grads_mesh(params, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        labels = batch["labels"]
        with torch.enable_grad():
            feats, aux = mesh_forward(cfg, p, layout, batch, ctx, hp)
            nll = vp_lm_loss(feats, output_table(cfg, p), labels, mg,
                             softcap=cfg.logit_softcap,
                             sharded_vocab=vocab_sharded,
                             n_chunks=hp.loss_chunks,
                             global_tokens=labels.numel() * n_devices)
            # aux is the rank's statistic: its mean over the mesh is the
            # objective's
            loss = nll + cfg.router_aux_weight * aux / n_devices
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return nll.detach(), aux.detach(), tree_unflatten(params, grads)

    def step(params, opt, batch):
        batch = batch_block(cfg, to_batch(batch, mesh.device), mesh)
        nll, aux, grads = loss_and_grads_mesh(params, batch)
        grads = GradReduce.apply(grads, rules, mesh)
        both = comm.psum(torch.stack([nll, aux]), world, "tp")
        grads, gnorm = clip_by_global_norm(
            grads, hp.grad_clip,
            total=lambda sums: comm.psum((sums * counted).sum(), world,
                                         "grad"))
        lr = cosine_schedule(opt["step"], base_lr=hp.lr, warmup=hp.warmup,
                             total=hp.total_steps)
        params, opt = _sharded_adamw(params, grads, opt, lr, hp, extra,
                                     mesh)
        return params, opt, {"loss": both[0], "moe_aux": both[1] / n_devices,
                             "gnorm": gnorm, "lr": lr}

    step.layout = layout
    return step


def _sharded_adamw(params, grads, opt, lr, hp: TrainHParams, extra: dict,
                   mesh: Mesh):
    """AdamW on the rank's m/v blocks: a leaf whose m/v cut it further
    (``extra``: (dim, axis)) updates the slice of its parameter and
    gradient they cover, then gathers the parameter back over the axis
    (one gather an axis, metered ``param_gather``)."""
    def part(t, path):
        if extra[path] is None:
            return t
        dim, ax = extra[path]
        s = t.shape[dim] // mesh.size((ax,))
        return t.narrow(dim, mesh.coords[ax] * s, s)
    p_s = _map_paths(lambda path, t: part(t, path), params)
    g_s = _map_paths(lambda path, t: part(t, path), grads)
    new_p, opt = adamw_update(p_s, g_s, opt, lr=lr,
                              weight_decay=hp.weight_decay)
    got = dict(tree_paths(new_p))
    for ax in mesh.axis_names:
        paths = [p for p, c in extra.items() if c is not None and c[1] == ax]
        tiled = _tile([got[p] for p in paths], [extra[p][0] for p in paths],
                      mesh.group(ax))
        got.update(zip(paths, tiled))
    return _map_paths(lambda path, _: got[path], params), opt
