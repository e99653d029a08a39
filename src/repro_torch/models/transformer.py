"""Transformer stack: ``init(cfg, generator, device)`` builds a parameter
dict, ``forward(cfg, params, tokens)`` runs it under a ``SeqContext``.

Parameters: {"layers": [per-layer dicts], "final_norm": {...}}, plus
"embed": {"table"} where the model has a vocabulary, "pos_embed":
{"table"} for learned positions, "lm_head": {"w"} for an untied head,
"head": {"w", "b"} for an encoder's classes and "frontend_proj": {"w"}
for a stub frontend — the reference's stacked ``scan``/``tail`` layout
unstacked into one dict per layer
(``convert.from_jax_numpy``).  The ``attn``, ``attn_local`` and ``moe``
block kinds are ported: GPT-2's pieces (learned positions, LayerNorm,
GELU, tied head), the Llama family's (RoPE, RMSNorm, SwiGLU, GQA, untied
head), Gemma's (sliding-window local layers beside global ones, a RoPE
theta for each kind, qk-norm, GeGLU, MQA, sqrt(d) input scaling),
Mixture-of-Experts blocks (``models/moe.py``: global attention, then
routed experts, with arctic's dense residual MLP where the model has
one) and Command-R's parallel block (attention and MLP both read the
one normed input: x + attn(ln1 x) + mlp(ln1 x), no ``ln2``;
``block_residual``, which every serving path calls).

A VLM (PaliGemma) takes tokens and a ``siglip_stub`` frontend's image
embeddings: the embeddings go through ``frontend_proj`` and overwrite
the first ``prefix_len`` token positions, which attend bidirectionally
(the prefix-LM rule of ``core.masks.visibility``).

Encoders (``num_classes``: BERT, ViT) attend without a causal mask and
return the class head's logits on the CLS row (global position 0); a
``patch_stub`` frontend (ViT) takes stub patch embeddings through
``frontend_proj`` in place of tokens, and such a model has no vocabulary.

Audio (MusicGen): an ``encodec_stub`` frontend's frame embeddings are the
whole prompt, through ``frontend_proj``, with parameter-free sinusoidal
positions (``sincos_embed``); the generated codes go through ``embed``.

Recurrent blocks (``models/ssm.py``): xLSTM's ``mlstm`` and ``slstm``
and Zamba2's ``mamba``, each {"ln", "cell"}, x + cell(norm(ln, x)), with
no feed-forward.  Zamba2's ``shared_attn`` layers hold no weights of
their own ({}): each is an attention + MLP block over the one shared
weight set ``params["shared"]`` ({ln1, attn, ln2, mlp}, built once), with
a cache of its own on the serving paths (``layer_blocks``).
"""
from __future__ import annotations

import math

import torch

from .config import ModelConfig
from .context import FullContext, SeqContext
from .layers import (MLP_KINDS, NORM_KINDS, AttnSpec, attn_init,
                     attn_output, attn_project_kv, attn_project_q, dense,
                     dense_init, embed, embedding_init, mlp, mlp_init, norm,
                     norm_init)
from .moe import moe_apply, moe_init
from .ssm import (mamba2_apply, mamba2_decode, mamba2_init, mlstm_apply,
                  mlstm_decode, mlstm_init, slstm_apply, slstm_decode,
                  slstm_init)
from ..core.attention import prism_attention
from ..device import resolve_device


RECURRENT_KINDS = ("mlstm", "slstm", "mamba")
BLOCK_KINDS = ("attn", "attn_local", "moe", "shared_attn") + RECURRENT_KINDS
FRONTENDS = (None, "patch_stub", "siglip_stub", "encodec_stub")
POSITIONS = ("learned", "rope", "sincos", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not run yet."""
    bad = sorted(set(cfg.block_kinds) - set(BLOCK_KINDS))
    if (bad or cfg.pos not in POSITIONS
            or cfg.norm_kind not in NORM_KINDS
            or cfg.mlp_kind not in MLP_KINDS
            or cfg.logit_softcap or cfg.frontend not in FRONTENDS
            or (cfg.prefix_len and cfg.arch_type != "vlm")
            or (cfg.parallel_block and not set(cfg.block_kinds)
                <= {"attn", "attn_local"})
            or not (cfg.vocab_size or cfg.num_classes)
            or ("mamba" in cfg.block_kinds and not cfg.ssm_state)
            or ("shared_attn" in cfg.block_kinds and not cfg.d_ff)
            or ("moe" in cfg.block_kinds
                and not (cfg.n_experts and cfg.top_k and cfg.expert_d_ff))):
        raise NotImplementedError(
            f"{cfg.name}: only decoders and classifying encoders of "
            f"{'/'.join(BLOCK_KINDS)} blocks (a parallel block of "
            f"attention kinds only) with {'/'.join(POSITIONS)} positions, "
            f"{'/'.join(NORM_KINDS)} and {'/'.join(MLP_KINDS)} are ported, "
            f"with no frontend, a patch, SigLIP or EnCodec stub, and an "
            f"image prefix on a vlm only (block kinds {bad}, pos {cfg.pos!r}, "
            f"norm {cfg.norm_kind!r}, mlp {cfg.mlp_kind!r}, softcap "
            f"{cfg.logit_softcap}, frontend {cfg.frontend!r}, prefix_len "
            f"{cfg.prefix_len}, arch_type {cfg.arch_type!r}, parallel_block "
            f"{cfg.parallel_block})")


#: the block kinds bf16 parameters serve (``check_dtype``)
BF16_KINDS = ("attn", "moe")
#: the parameter dtypes ``init`` and ``convert.from_jax_numpy`` make
DTYPES = (torch.float32, torch.bfloat16)


def params_dtype(params) -> torch.dtype:
    """The dtype of a parameter tree (``init``'s ``dtype``), from its
    final norm, which every model has; a rank's ``MeshParams`` by its
    local tree.  A tree of the reference's numpy arrays converts as f32
    (``convert.from_jax_numpy``'s default)."""
    scale = getattr(params, "params", params)["final_norm"]["scale"]
    return scale.dtype if isinstance(scale, torch.Tensor) else torch.float32


def check_dtype(cfg: ModelConfig, dtype: torch.dtype,
                refused: str | None = None) -> None:
    """Raise for parameters of ``dtype`` that a path does not take; each
    path checks once, where its parameters enter.  f32 runs everywhere,
    and so does float64 (the checks' float64 witnesses, through the plain
    versions).  bf16, the reference's ``init(dtype=jnp.bfloat16)``,
    serves decoders of ``attn`` and ``moe`` blocks with token prompts on
    one card: the forward, the static prefill and decode, ``score``, the
    engine and its chunked and packed ticks; each other use refuses by
    name: a path that takes no bf16 parameters names itself
    (``refused``), and Gemma 3's window ring, the recurrent kinds (the
    reference keeps their state in f32) and an image or frame prefix
    refuse everywhere."""
    if dtype in (torch.float32, torch.float64):
        return
    if dtype != torch.bfloat16:
        raise NotImplementedError(f"{cfg.name}: parameters in {dtype}; "
                                  f"the port takes {DTYPES}")
    if refused:
        raise NotImplementedError(
            f"{cfg.name}: bf16 parameters on {refused}: not ported; take "
            "f32 parameters")
    bad = sorted(set(cfg.block_kinds) - set(BF16_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: bf16 parameters over {bad} blocks: not ported "
            "(Gemma 3's window ring; the recurrent kinds, whose state the "
            f"reference keeps in f32); bf16 serves {list(BF16_KINDS)} "
            "blocks")
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: bf16 parameters with the {cfg.frontend} frontend "
            "(an image or frame prefix): not ported")


def is_encoder(cfg: ModelConfig) -> bool:
    """A classifying or bidirectional model: prefill only, no decode."""
    return bool(cfg.num_classes) or not cfg.causal


def check_decoder(cfg: ModelConfig, what: str) -> None:
    """Raise for an encoder on a path that decodes: it has no causal
    cache to extend and no vocabulary head (``runtime.serve.encode``
    serves it)."""
    if is_encoder(cfg):
        raise ValueError(
            f"{what} serves causal decoders only; arch {cfg.name!r} is an "
            f"encoder (causal={cfg.causal}, num_classes={cfg.num_classes}):"
            f" runtime.serve.encode classifies with it")


def attn_spec(cfg: ModelConfig, kind: str = "attn") -> AttnSpec:
    """The attention of a block of ``kind``: a local (sliding-window)
    layer takes the window and its own RoPE theta, a global one the
    other theta and no window."""
    local = kind == "attn_local"
    theta = None
    if cfg.pos == "rope":
        theta = cfg.rope_theta_local if local else cfg.rope_theta
    return AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, bias=cfg.attn_bias, rope_theta=theta,
        qk_norm=cfg.qk_norm, logit_softcap=cfg.logit_softcap,
        window=cfg.window if local else None, causal=cfg.causal)


def block_init(cfg: ModelConfig, kind: str, gen: torch.Generator, device,
               dtype=torch.float32):
    if kind == "mlstm":
        return {"ln": norm_init(cfg.d_model, cfg.norm_kind, device, dtype),
                "cell": mlstm_init(gen, cfg.d_model, cfg.n_ssm_heads,
                                   cfg.ssm_expand, device, dtype)}
    if kind == "slstm":
        return {"ln": norm_init(cfg.d_model, cfg.norm_kind, device, dtype),
                "cell": slstm_init(gen, cfg.d_model, cfg.n_ssm_heads,
                                   device, dtype)}
    if kind == "mamba":
        return {"ln": norm_init(cfg.d_model, cfg.norm_kind, device, dtype),
                "cell": mamba2_init(gen, cfg.d_model, cfg.n_ssm_heads,
                                    cfg.ssm_state, cfg.ssm_expand,
                                    cfg.ssm_conv, device, dtype)}
    if kind == "shared_attn":
        return {}              # the layer reads params["shared"]
    p = {"ln1": norm_init(cfg.d_model, cfg.norm_kind, device, dtype),
         "attn": attn_init(gen, attn_spec(cfg, kind), device, dtype)}
    if not cfg.parallel_block:          # a parallel block has one norm
        p["ln2"] = norm_init(cfg.d_model, cfg.norm_kind, device, dtype)
    if kind == "moe":
        p["moe"] = moe_init(gen, cfg.d_model, cfg.n_experts,
                            cfg.expert_d_ff, cfg.mlp_kind, device=device,
                            dense_d_ff=cfg.moe_dense_d_ff, dtype=dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            bias=cfg.attn_bias, device=device, dtype=dtype)
    return p


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
         dtype=torch.float32):
    """Random parameters with the reference's distributions (normal
    weights scaled by d_in^-0.5, unit norms, zero biases), drawn from
    ``generator`` in f32, then cast to ``dtype`` (the reference's
    ``init(cfg, key, dtype)``: a bf16 init is the f32 one rounded; Mamba2's
    ``a_log`` and ``dt_bias`` stay f32), and placed on ``device``: the card
    unless the caller asks for the CPU; raises without a card.  Any block
    kind takes either dtype; what bf16 parameters serve is
    ``check_dtype``'s."""
    check_supported(cfg)
    if dtype not in DTYPES:
        raise NotImplementedError(f"{cfg.name}: parameters in {dtype}; "
                                  f"the port takes {DTYPES}")
    device = resolve_device(device)
    kw = dict(device=device, dtype=dtype)
    params = {
        "layers": [block_init(cfg, kind, generator, **kw)
                   for kind in cfg.block_kinds],
        "final_norm": norm_init(cfg.d_model, cfg.norm_kind, **kw),
    }
    if "shared_attn" in cfg.block_kinds:
        # Zamba2's one attention + MLP block, read by every shared_attn
        # layer
        params["shared"] = block_init(cfg, "attn", generator, **kw)
    if cfg.vocab_size:
        params["embed"] = embedding_init(generator, cfg.vocab_size,
                                         cfg.d_model, **kw)
    if cfg.pos == "learned":
        params["pos_embed"] = embedding_init(generator, cfg.max_seq,
                                             cfg.d_model, **kw)
    if cfg.vocab_size and not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, **kw)
    if cfg.num_classes:
        params["head"] = dense_init(generator, cfg.d_model, cfg.num_classes,
                                    bias=True, **kw)
    if cfg.frontend:
        # the stub modality projector: a square linear from the
        # frontend's embedding space into the backbone
        params["frontend_proj"] = dense_init(generator, cfg.d_model,
                                             cfg.d_model, **kw)
    return params


def attn_sublayer(p, x, ctx: SeqContext, spec: AttnSpec, cfg: ModelConfig):
    """Attention through the SeqContext protocol: the receiving side norms
    the augmented matrix it attends over.  Returns (output, the normed
    query rows), the latter for a parallel block's MLP."""
    xq, akv = ctx.augment(x, spec)
    xq_n = norm(p["ln1"], xq, cfg.norm_kind)
    xh_n = norm(p["ln1"], akv.x_hat, cfg.norm_kind)
    q = attn_project_q(p["attn"], spec, xq_n, akv.row_pos)
    k, v = attn_project_kv(p["attn"], spec, xh_n, akv.col_pos)
    o = prism_attention(q, k, v, g=akv.g, mask=akv.mask,
                        block=cfg.attn_block)
    return ctx.finalize(attn_output(p["attn"], o)), ctx.finalize(xq_n)


def block_residual(cfg: ModelConfig, kind: str, p, x, o, xn,
                   ctx: SeqContext, routing=None, *, aux: bool = False):
    """The rest of a block once its attention sublayer gave ``o`` from
    the normed rows ``xn``, on every path (the forward, prefill, decode,
    a chunk call, a packed tick, a train step): sequential, x + o, then
    the feed-forward on norm(ln2, x + o): the MLP, or for a ``moe`` block
    the experts, routed in ``ctx``'s groups (``routing``: the checks'
    ``RoutingLog``); parallel (Command-R), x + (o + mlp(xn)), both
    branches off the one norm, as the reference sums them.  With ``aux``
    -> (x, the block's load-balance loss: the mean over the routing
    groups of their Switch losses, 0 for a block without experts)."""
    loss = None
    if cfg.parallel_block:
        x = x + (o + mlp(p["mlp"], xn, cfg.mlp_kind))
    else:
        x = x + o
        h = norm(p["ln2"], x, cfg.norm_kind)
        if kind == "moe":
            y, loss = moe_apply(p["moe"], h, cfg, ctx, routing=routing,
                                aux=aux)
            x = x + y
        else:
            x = x + mlp(p["mlp"], h, cfg.mlp_kind)
    if not aux:
        return x
    return x, (x.new_zeros((), dtype=torch.float32) if loss is None
               else loss.float().mean())


def block_apply(cfg: ModelConfig, kind: str, p, x, ctx: SeqContext,
                routing=None, chunk: int = 128, *, aux: bool = False):
    """One residual block; ``chunk`` is a recurrent block's; with ``aux``
    -> (x, its load-balance loss) (``block_residual``)."""
    if kind in RECURRENT_KINDS:
        x = recurrent_block(cfg, kind, p, x, ctx, chunk=chunk)
        return (x, x.new_zeros((), dtype=torch.float32)) if aux else x
    o, xn = attn_sublayer(p, x, ctx, attn_spec(cfg, kind), cfg)
    return block_residual(cfg, kind, p, x, o, xn, ctx, routing, aux=aux)


def recurrent_block(cfg: ModelConfig, kind: str, p, x, ctx: SeqContext, *,
                    chunk: int = 128, return_state: bool = False):
    """A residual ``mlstm``, ``slstm`` or ``mamba`` block, x + cell(norm(ln,
    x)) (the mLSTM's and Mamba2's recurrence chunked by ``chunk``); with
    ``return_state`` also the cell's decode cache after the sequence's
    last token: {"s"}, Mamba2's {"s", "tail"}, copies of their own (the
    decode steps update them in place)."""
    h = norm(p["ln"], x, cfg.norm_kind)
    heads = cfg.n_ssm_heads
    if kind == "mlstm":
        out = mlstm_apply(p["cell"], h, heads=heads, ctx=ctx, chunk=chunk,
                          return_state=return_state)
    elif kind == "mamba":
        out = mamba2_apply(p["cell"], h, heads=heads, d_state=cfg.ssm_state,
                           expand=cfg.ssm_expand, conv=cfg.ssm_conv, ctx=ctx,
                           chunk=chunk, return_state=return_state)
    else:
        out = slstm_apply(p["cell"], h, heads=heads, ctx=ctx,
                          return_state=return_state)
    if not return_state:
        return x + out
    y, state = out
    cache = state if kind == "mamba" else {"s": state}
    return x + y, {k: t.clone(memory_format=torch.contiguous_format)
                   for k, t in cache.items()}


def recurrent_decode(cfg: ModelConfig, kind: str, p, x, cache):
    """One token through a recurrent block: x (B, 1, D); ``cache``, the
    cell's cache leaves, is updated in place."""
    h = norm(p["ln"], x, cfg.norm_kind)
    if kind == "mamba":
        y, _ = mamba2_decode(p["cell"], h, cache, heads=cfg.n_ssm_heads,
                             d_state=cfg.ssm_state, expand=cfg.ssm_expand,
                             conv=cfg.ssm_conv)
    else:
        step = mlstm_decode if kind == "mlstm" else slstm_decode
        y, _ = step(p["cell"], h, cache["s"], heads=cfg.n_ssm_heads)
    return x + y


def layer_blocks(cfg: ModelConfig, params):
    """Each layer's (block kind, parameters) in depth order.  A
    ``shared_attn`` layer (Zamba2) is an ``attn`` block over the one
    shared weight set ``params["shared"]``: every path serves it as
    attention, with a cache of its own."""
    shared = params.get("shared")
    for kind, p in zip(cfg.block_kinds, params["layers"]):
        yield ("attn", shared) if kind == "shared_attn" else (kind, p)


def embed_scale(cfg: ModelConfig, x):
    """Gemma's sqrt(d_model) input scaling, in x's dtype; x as it is
    elsewhere."""
    if not cfg.embed_scale:
        return x
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def embed_inputs(cfg: ModelConfig, params, tokens=None, pos_start: int = 0,
                 *, embeds=None):
    """tokens (B, N) or stub-frontend embeds (B, N, D) -> x (B, N, D):
    token embeddings, or the embeds through ``frontend_proj`` where the
    model has a frontend (ViT's patches); scaled by sqrt(d_model) where
    the model says so, plus the learned position embeddings or the
    sinusoidal positions where the model has them (RoPE rotates q and k
    in the attention layers instead; xLSTM has none).  An audio model's
    frames (MusicGen's EnCodec stub) are its whole input.  A vlm takes
    both: the image embeds (B, prefix_len, D)
    through ``frontend_proj`` overwrite the first ``prefix_len`` token
    positions (tokens there are placeholders), and the scaling applies
    after, to the image rows too, as in the reference."""
    if (tokens is None and embeds is None) or (
            tokens is not None and embeds is not None
            and cfg.arch_type != "vlm"):
        raise ValueError("embed_inputs takes tokens or embeds, one of them "
                         "(both together are a vlm's input: its image "
                         "prefix)")
    if tokens is not None:
        x = embed(params["embed"], tokens)
        if embeds is not None:
            if (embeds.shape[1] != cfg.prefix_len
                    or tokens.shape[1] < cfg.prefix_len):
                raise ValueError(
                    f"{cfg.name}: image embeds of {embeds.shape[1]} rows "
                    f"for a prefix of {cfg.prefix_len} in a sequence of "
                    f"{tokens.shape[1]}")
            fe = dense(params["frontend_proj"], embeds).to(x.dtype)
            x = torch.cat([fe, x[:, cfg.prefix_len:]], dim=1)
    else:
        x = (dense(params["frontend_proj"], embeds) if cfg.frontend
             else embeds)
    x = embed_scale(cfg, x)
    n = x.shape[1]
    if cfg.pos == "learned":
        return x + params["pos_embed"]["table"][pos_start:pos_start + n].to(
            x.dtype)
    if cfg.pos == "sincos":
        return x + sincos_embed(n, cfg.d_model, pos_start, x.device).to(
            x.dtype)
    return x


def sincos(pos, d: int):
    """Parameter-free sinusoidal positions: pos (...) -> (..., d) f32,
    sin over the first half, cos over the second, frequencies
    10000^(-j / (d/2)) (MusicGen; the reference's ``sincos_embed``)."""
    half = d // 2
    freq = torch.exp(torch.tensor(-math.log(10000.0), dtype=torch.float32)
                     * torch.arange(half, dtype=torch.float32,
                                    device=pos.device) / half)
    ang = pos.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sincos_embed(n: int, d: int, start: int = 0, device=None):
    """The sinusoidal positions of positions start .. start + n - 1:
    (n, d) f32."""
    return sincos(torch.arange(n, device=device) + start, d)


def head(cfg: ModelConfig, params, x):
    """The LM head on the final-normed x (..., D) -> (..., V): tied to
    the embedding table, or its own dense ``lm_head``."""
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(x.dtype)
    return dense(params["lm_head"], x)


def classify(cfg: ModelConfig, params, cls):
    """An encoder's class head on the CLS rows cls (B, D), final norm
    first -> (B, num_classes)."""
    return dense(params["head"],
                 norm(params["final_norm"], cls, cfg.norm_kind))


def forward(cfg: ModelConfig, params, tokens=None, *, embeds=None,
            ctx: SeqContext | None = None, start: int = 0, routing=None,
            chunk: int = 128, aux: bool = False):
    """tokens (B, N), stub-frontend embeds (B, N, D) or a vlm's tokens
    with its image embeds (B, prefix_len, D) -> logits (B,
    N - start, V) of positions start.. (the head over the tail only: at a
    large vocabulary the whole (B, N, V) would dwarf the rest); for an
    encoder (``num_classes``) the class logits (B, num_classes) of the
    CLS row.  A ``moe`` block routes in ``ctx``'s groups (all B·N tokens
    as one by default); an ``mlstm`` or ``mamba`` block runs in chunks of
    ``chunk`` (N a multiple of it).  With ``aux`` -> (logits, the MoE
    load-balance loss summed over the blocks, f32; 0 without experts),
    the reference's ``aux["moe_aux"]``.  The logits are in the
    parameters' dtype, as the reference's."""
    check_supported(cfg)
    check_dtype(cfg, params_dtype(params))
    return forward_embedded(cfg, params,
                            embed_inputs(cfg, params, tokens, embeds=embeds),
                            ctx=ctx, start=start, routing=routing,
                            chunk=chunk, aux=aux)


def forward_embedded(cfg: ModelConfig, params, x, *,
                     ctx: SeqContext | None = None, start: int = 0,
                     routing=None, chunk: int = 128, aux: bool = False):
    """``forward`` from rows already embedded, x (B, N, D): the layers,
    the final norm and the head (MusicGen's reference over its frames
    and the codes fed after them)."""
    ctx = ctx or FullContext(prefix_len=cfg.prefix_len)
    total = x.new_zeros((), dtype=torch.float32)
    for kind, p in layer_blocks(cfg, params):
        out = block_apply(cfg, kind, p, x, ctx, routing, chunk, aux=aux)
        x, total = (out[0], total + out[1]) if aux else (out, total)
    if cfg.num_classes:
        logits = classify(cfg, params, x[:, 0])
    else:
        logits = head(cfg, params,
                      norm(params["final_norm"], x[:, start:],
                           cfg.norm_kind))
    return (logits, total) if aux else logits
