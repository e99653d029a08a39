"""Transformer stack: ``init(cfg, generator, device)`` builds a parameter
dict, ``forward(cfg, params, tokens)`` runs it under a ``SeqContext``.

Parameters: {"layers": [per-layer dicts], "embed": {"table"},
"pos_embed": {"table"}, "final_norm": {...}} — the reference's stacked
``scan``/``tail`` layout unstacked into one dict per layer
(``convert.from_jax_numpy``).  Only the ``attn`` block kind with learned
positions and a tied head is ported.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .context import FullContext, SeqContext
from .layers import (AttnSpec, attn_init, attn_output, attn_project_kv,
                     attn_project_q, embed, embedding_init, mlp, mlp_init,
                     norm, norm_init)
from ..core.attention import prism_attention
from ..device import resolve_device


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not run yet."""
    bad = sorted(set(cfg.block_kinds) - {"attn"})
    if (bad or cfg.pos != "learned" or not cfg.tie_embeddings
            or cfg.parallel_block or cfg.embed_scale or cfg.logit_softcap
            or cfg.frontend or cfg.num_classes or cfg.prefix_len):
        raise NotImplementedError(
            f"{cfg.name}: only attention-only decoders with learned "
            f"positions and a tied head are ported (block kinds {bad})")


def attn_spec(cfg: ModelConfig, kind: str = "attn") -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, bias=cfg.attn_bias, rope_theta=None,
        qk_norm=cfg.qk_norm, logit_softcap=cfg.logit_softcap,
        window=None, causal=cfg.causal)


def block_init(cfg: ModelConfig, gen: torch.Generator, device):
    return {"ln1": norm_init(cfg.d_model, cfg.norm_kind, device),
            "attn": attn_init(gen, attn_spec(cfg), device),
            "ln2": norm_init(cfg.d_model, cfg.norm_kind, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            bias=cfg.attn_bias, device=device)}


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters with the reference's distributions (normal
    weights scaled by d_in^-0.5, unit norms, zero biases), drawn from
    ``generator`` and placed on ``device``: the card unless the caller
    asks for the CPU; raises without a card."""
    check_supported(cfg)
    device = resolve_device(device)
    return {
        "layers": [block_init(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": norm_init(cfg.d_model, cfg.norm_kind, device),
        "embed": embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                device),
        "pos_embed": embedding_init(generator, cfg.max_seq, cfg.d_model,
                                    device),
    }


def attn_sublayer(p, x, ctx: SeqContext, spec: AttnSpec, cfg: ModelConfig):
    """Attention through the SeqContext protocol: the receiving side norms
    the augmented matrix it attends over."""
    xq, akv = ctx.augment(x, spec)
    xq_n = norm(p["ln1"], xq, cfg.norm_kind)
    xh_n = norm(p["ln1"], akv.x_hat, cfg.norm_kind)
    q = attn_project_q(p["attn"], spec, xq_n)
    k, v = attn_project_kv(p["attn"], spec, xh_n)
    o = prism_attention(q, k, v, g=akv.g, mask=akv.mask,
                        block=cfg.attn_block)
    return ctx.finalize(attn_output(p["attn"], o))


def block_apply(cfg: ModelConfig, p, x, ctx: SeqContext):
    """One residual ``attn`` block."""
    x = x + attn_sublayer(p, x, ctx, attn_spec(cfg), cfg)
    return x + mlp(p["mlp"], norm(p["ln2"], x, cfg.norm_kind), cfg.mlp_kind)


def embed_inputs(cfg: ModelConfig, params, tokens, pos_start: int = 0):
    """tokens (B, N) -> x (B, N, D): token plus learned position
    embeddings."""
    x = embed(params["embed"], tokens)
    n = x.shape[1]
    return x + params["pos_embed"]["table"][pos_start:pos_start + n].to(
        x.dtype)


def forward(cfg: ModelConfig, params, tokens, *,
            ctx: SeqContext | None = None):
    """tokens (B, N) -> logits (B, N, V) through the tied head."""
    check_supported(cfg)
    ctx = ctx or FullContext(prefix_len=cfg.prefix_len)
    x = embed_inputs(cfg, params, tokens)
    for p in params["layers"]:
        x = block_apply(cfg, p, x, ctx)
    x = norm(params["final_norm"], x, cfg.norm_kind)
    return x @ params["embed"]["table"].T.to(x.dtype)
