"""Neural layers as plain functions on tensors with parameter dicts.

Layouts follow the JAX reference so parameters convert by copying:
dense weights are ``(d_in, d_out)``, embeddings ``(vocab, d)``.  Every
``*_init`` takes the reference's ``dtype``: the weights are drawn in f32
and then cast, so a bf16 init is the f32 init rounded.  Only
what the ported models use is here: LayerNorm and RMSNorm, the tanh-GELU,
GeGLU and SwiGLU MLPs, rotary embeddings (split halves) and the attention
projections that apply them, with qk-norm where the model has it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.attention import at_least_f32


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, device,
            dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(device=device, dtype=dtype)


def dense_init(gen, d_in: int, d_out: int, *, device, bias: bool = False,
               scale: float | None = None, dtype=torch.float32):
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale, device, dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device, dtype=dtype)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(gen, vocab: int, d: int, device, dtype=torch.float32):
    return {"table": _normal(gen, (vocab, d), d ** -0.5, device, dtype)}


def embed(p, tokens):
    return p["table"][tokens]


NORM_KINDS = ("layernorm", "rmsnorm")


def norm_init(d: int, kind: str, device, dtype=torch.float32):
    if kind not in NORM_KINDS:
        raise NotImplementedError(f"norm kind {kind!r} is not ported yet")
    p = {"scale": torch.ones(d, device=device, dtype=dtype)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, device=device, dtype=dtype)
    return p


def norm(p, x, kind: str = "layernorm", eps: float = 1e-6):
    """LayerNorm or RMSNorm (no bias), computed in f32 (f64 for f64
    rows) with the reference's eps of 1e-6."""
    if kind not in NORM_KINDS:
        raise NotImplementedError(f"norm kind {kind!r} is not ported yet")
    xf = at_least_f32(x)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * p["scale"].to(xf.dtype)).to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(xf.dtype) + p["bias"].to(xf.dtype)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope(x, pos, *, theta: float = 10000.0):
    """Rotary position embedding over split halves, as the reference's.
    x (..., n, H, hd), pos (n,) or (..., n), int or float: a PRISM
    segment-mean column takes its segment's midpoint, which may be
    fractional.  The angle is computed in f32 (f64 for f64 rows)."""
    half = x.shape[-1] // 2
    dt = at_least_f32(x).dtype
    freq = theta ** (-torch.arange(half, dtype=dt, device=x.device) / half)
    angle = (pos.to(dt)[..., :, None] * freq)[..., :, None, :]
    cos, sin = torch.cos(angle), torch.sin(angle)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

MLP_KINDS = ("gelu", "geglu", "swiglu")


def mlp_init(gen, d: int, d_ff: int, kind: str, *, device,
             bias: bool = False, dtype=torch.float32):
    if kind not in MLP_KINDS:
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    kw = dict(bias=bias, device=device, dtype=dtype)
    p = {"up": dense_init(gen, d, d_ff, **kw),
         "down": dense_init(gen, d_ff, d, **kw)}
    if kind in ("geglu", "swiglu"):              # the gated kinds
        p["gate"] = dense_init(gen, d, d_ff, **kw)
    return p


def mlp(p, x, kind: str):
    if kind not in MLP_KINDS:
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    if kind == "swiglu":
        return dense(p["down"], F.silu(dense(p["gate"], x))
                     * dense(p["up"], x))
    # jax.nn.gelu's default is the tanh approximation
    if kind == "geglu":
        return dense(p["down"], F.gelu(dense(p["gate"], x),
                                       approximate="tanh")
                     * dense(p["up"], x))
    return dense(p["down"], F.gelu(dense(p["up"], x), approximate="tanh"))


# --------------------------------------------------------------------------
# attention projections
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    bias: bool = False
    rope_theta: float | None = 10000.0   # None => no rotary (learned/abs pos)
    qk_norm: bool = False
    logit_softcap: float | None = None
    window: int | None = None            # sliding-window layer (gemma3 local)
    causal: bool = True


def attn_init(gen, s: AttnSpec, device, dtype=torch.float32):
    hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    kw = dict(bias=s.bias, device=device, dtype=dtype)
    p = {
        "wq": dense_init(gen, s.d_model, hq, **kw),
        "wk": dense_init(gen, s.d_model, hkv, **kw),
        "wv": dense_init(gen, s.d_model, hkv, **kw),
        "wo": dense_init(gen, hq, s.d_model, **kw),
    }
    if s.qk_norm:                 # RMSNorm of each head's q and k
        p["qnorm"] = norm_init(s.head_dim, "rmsnorm", device, dtype)
        p["knorm"] = norm_init(s.head_dim, "rmsnorm", device, dtype)
    return p


def _rotate(s: AttnSpec, t, pos):
    """RoPE at ``pos`` when the spec has it.  Positions (P, n) given for
    a (B·P, n, ...) activation (the port's shard axis folded into the
    batch) are per shard: batch row b·P + p takes row p."""
    if s.rope_theta is None:
        return t
    if pos.dim() == 2 and pos.shape[0] != t.shape[0]:
        pos = pos.repeat(t.shape[0] // pos.shape[0], 1)
    return rope(t, pos, theta=s.rope_theta)


def attn_project_q(p, s: AttnSpec, x, row_pos):
    """x (B, n, D) -> q (B, n, Hq, hd), normed (qk-norm) and rotated to
    ``row_pos``."""
    b, n, _ = x.shape
    q = dense(p["wq"], x).reshape(b, n, s.n_heads, s.head_dim)
    if s.qk_norm:
        q = norm(p["qnorm"], q, "rmsnorm")
    return _rotate(s, q, row_pos)


def attn_project_kv(p, s: AttnSpec, x_hat, col_pos):
    """x_hat (B, m, D) -> k, v (B, m, Hkv, hd), k normed (qk-norm) and
    rotated to ``col_pos``."""
    b, m, _ = x_hat.shape
    k = dense(p["wk"], x_hat).reshape(b, m, s.n_kv_heads, s.head_dim)
    v = dense(p["wv"], x_hat).reshape(b, m, s.n_kv_heads, s.head_dim)
    if s.qk_norm:
        k = norm(p["knorm"], k, "rmsnorm")
    return _rotate(s, k, col_pos), v


def attn_output(p, o):
    b, n, h, hd = o.shape
    return dense(p["wo"], o.reshape(b, n, h * hd))
