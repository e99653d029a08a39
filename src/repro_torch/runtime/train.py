"""The train step on one card: the PRISM forward over an explicit shard
axis, the full-vocabulary LM loss with the MoE load-balance term,
autograd, global-norm clipping, the cosine schedule and AdamW
(``repro.runtime.train``).

The reference runs its step under ``shard_map`` with FSDP parameter
gathers, vocab-parallel embedding and loss (``embed_vp``,
``vp_lm_loss``) and explicit gradient reductions (``GradReduce``).  On
one card the P sequence shards are an axis of the activations, (B·P,
n_loc, D) as on the serving path, and none of those collectives has a
counterpart: the parameters are whole, the loss is over the whole
vocabulary and autograd sums the shards' gradients.  A batch split over
a data axis needs more than one card and is refused (ROADMAP queue 1,
item 15).

The forward's context runs with ``backend="plain"``: the CUDA kernels
have no backward, and ``kernels.dispatch`` refuses a kernel call under
autograd.  Attention is the prefill kernel's plain version (the Eq.
13-15 softmax over the Eq. 17 mask, built from ``core.attention``) and
the means its plain version, both differentiated by autograd, as the
reference differentiates its jnp attention.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.protocol import PrismConfig
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.layers import norm
from ..models.transformer import check_decoder, check_supported, embed_inputs
from ..optim.adamw import (adamw_update, clip_by_global_norm,
                           cosine_schedule, tree_leaves, tree_unflatten)
from ..sharding.context import ShardedPrismContext
from .losses import chunked_lm_loss
from .serve import ServeHParams, sharded_layers


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
                    hp: TrainHParams = TrainHParams(), *, n_shards: int,
                    device="cuda", n_data: int = 1):
    """-> ``step(params, opt, batch) -> (params, opt, metrics)``: the loss
    over ``n_shards`` sequence shards, its gradients, clipping to
    ``hp.grad_clip``, the cosine learning rate at the optimizer's step,
    then AdamW.  ``metrics``: ``loss`` (the LM loss), ``moe_aux`` (the
    load-balance loss, the reference's mean over the routing groups),
    ``gnorm`` (before clipping) and ``lr``, 0-d tensors on ``device``.
    The reference also takes the parameters, for their shardings; one
    card needs none."""
    check_supported(cfg)
    check_decoder(cfg, "the train step")
    if n_data != 1:
        raise NotImplementedError(
            f"a batch split over a data axis of {n_data} needs more than "
            "one card (FSDP, gradient reductions): ROADMAP queue 1, item "
            "15")
    device = resolve_device(device)
    # a vlm's prefix rule is the model's (cfg.prefix_len), as on the
    # serving path
    ctx = ShardedPrismContext(prism, n_shards=n_shards, backend="plain")

    def step(params, opt, batch):
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

