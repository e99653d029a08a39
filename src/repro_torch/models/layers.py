"""Neural layers as plain functions on tensors with parameter dicts.

Layouts follow the JAX reference so parameters convert by copying:
dense weights are ``(d_in, d_out)``, embeddings ``(vocab, d)``.  Only
what the ported models use is here: LayerNorm, the tanh-GELU MLP, and
attention projections without rotary embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, device):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(device)


def dense_init(gen, d_in: int, d_out: int, *, device, bias: bool = False,
               scale: float | None = None):
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale, device)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(gen, vocab: int, d: int, device):
    return {"table": _normal(gen, (vocab, d), d ** -0.5, device)}


def embed(p, tokens):
    return p["table"][tokens]


def norm_init(d: int, kind: str, device):
    if kind != "layernorm":
        raise NotImplementedError(f"norm kind {kind!r} is not ported yet")
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def norm(p, x, kind: str = "layernorm", eps: float = 1e-6):
    """LayerNorm computed in f32 with the reference's eps of 1e-6."""
    if kind != "layernorm":
        raise NotImplementedError(f"norm kind {kind!r} is not ported yet")
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, kind: str, *, device,
             bias: bool = False):
    if kind != "gelu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    return {"up": dense_init(gen, d, d_ff, bias=bias, device=device),
            "down": dense_init(gen, d_ff, d, bias=bias, device=device)}


def mlp(p, x, kind: str):
    if kind != "gelu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    # jax.nn.gelu's default is the tanh approximation
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

    def __post_init__(self):
        if self.rope_theta is not None or self.qk_norm:
            raise NotImplementedError(
                "rotary embeddings and qk-norm are not ported yet")


def attn_init(gen, s: AttnSpec, device):
    hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    return {
        "wq": dense_init(gen, s.d_model, hq, bias=s.bias, device=device),
        "wk": dense_init(gen, s.d_model, hkv, bias=s.bias, device=device),
        "wv": dense_init(gen, s.d_model, hkv, bias=s.bias, device=device),
        "wo": dense_init(gen, hq, s.d_model, bias=s.bias, device=device),
    }


def attn_project_q(p, s: AttnSpec, x):
    b, n, _ = x.shape
    return dense(p["wq"], x).reshape(b, n, s.n_heads, s.head_dim)


def attn_project_kv(p, s: AttnSpec, x_hat):
    b, m, _ = x_hat.shape
    k = dense(p["wk"], x_hat).reshape(b, m, s.n_kv_heads, s.head_dim)
    v = dense(p["wv"], x_hat).reshape(b, m, s.n_kv_heads, s.head_dim)
    return k, v


def attn_output(p, o):
    b, n, h, hd = o.shape
    return dense(p["wo"], o.reshape(b, n, h * hd))
