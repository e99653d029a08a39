"""Recurrent sequence mixers: xLSTM's mLSTM and sLSTM [arXiv:2405.04517]
and Zamba2's Mamba2 / SSD block [arXiv:2411.15242].

The mLSTM's linear recurrence

    S_t = f_t · S_{t-1} + i_t · k_t v_tᵀ ,   y_t = q_t · S_t

runs chunkwise (``chunked_linear_attention``): inside a chunk as
decay-masked attention (q kᵀ ⊙ Γ) v, from chunk to chunk through a
(dk × dv) summary.  Over sequence shards the state entering a shard comes
from ``ctx.state_handoff``, an exclusive prefix of the shards' summaries:
the state is the summary, so no Segment Means are needed.

The sLSTM's recurrence passes through a nonlinearity and cannot be cut
into chunks: the sharded path gathers the whole sequence
(``ctx.gather_sequence``), scans it, and keeps the shard's own rows
(``ctx.take_local``).

Gates, as in the reference: sigmoid input and forget gates (log-sigmoid
decays), not xLSTM's exponential gating with its stabiliser; the chunked
math is the same, the gate range narrower.  The decode steps update the
state leaf in place.

Mamba2 is the same recurrence with keys B and queries C shared by every
head (``expand``, no copy), the input gate dt = softplus(dt_pre +
dt_bias) and the decay log f = -dt·exp(a_log), after a causal depthwise
convolution whose first rows need the previous shard's last ones
(``ctx.prev_tail``).  Its decode cache is the state and the conv's tail
of pre-convolution rows, {"s" (B, H, d_state, hd), "tail" (B, conv - 1,
d_in)}, both updated in place by a decode step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (_normal, at_least_f32, dense, dense_init, norm,
                     norm_init)


# --------------------------------------------------------------------------
# the chunkwise linear recurrence
# --------------------------------------------------------------------------

def chunked_linear_attention(q, k, v, log_f, gate_i, *, chunk: int, ctx,
                             normalize: bool = False,
                             return_state: bool = False):
    """q, k (B, N, H, dk), v (B, N, H, dv), log_f, gate_i (B, N, H) with
    log_f <= 0 -> y (B, N, H, dv).  ``normalize`` appends a ones column to
    v (the mLSTM normaliser n_t) and divides the output by max(|q·n|, 1).

    ``return_state``: also the state after the sequence's last token
    (B, H, dk, dv[+1]), the decode cache: each executor's end state, of
    which ``ctx.last_shard`` keeps the last shard's."""
    b, n, h, _ = q.shape
    if normalize:
        v = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)
    dv = v.shape[-1]
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"N={n} not divisible by chunk={chunk}")
    nc = n // chunk

    def r(x):
        return x.reshape(b, nc, chunk, *x.shape[2:])

    qc, kc, vc, lf, gi = r(q), r(k), r(v), r(log_f), r(gate_i)
    a = lf.cumsum(dim=2)                                 # (B, nc, c, H)
    # inside a chunk: w_{tτ} = exp(a_t - a_τ) · i_τ for τ <= t
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    diff = a[:, :, :, None, :] - a[:, :, None, :, :]     # (B, nc, c, c, H)
    w = diff.masked_fill(~tri[None, None, :, :, None], float("-inf")).exp()
    w = w * gi[:, :, None, :, :]
    scores = torch.einsum("bnthd,bnshd->bntsh", qc, kc)
    y = torch.einsum("bntsh,bnshv->bnthv", scores * w, vc)

    # chunk summaries: log A_j = a_end, U_j = Σ exp(a_end - a_τ) i_τ k_τ v_τᵀ
    a_end = a[:, :, -1]                                  # (B, nc, H)
    wu = (a_end[:, :, None] - a).exp() * gi              # (B, nc, c, H)
    u = torch.einsum("bnshd,bnshv->bnhdv", kc * wu[..., None], vc)

    # the state entering each chunk from the shard's start (exclusive)
    s = torch.zeros_like(u[:, 0])                        # (B, H, dk, dv)
    la = torch.zeros_like(a_end[:, 0])                   # (B, H)
    s_in, la_in = [], []
    for j in range(nc):
        s_in.append(s)
        la_in.append(la)
        s = a_end[:, j].exp()[..., None, None] * s + u[:, j]
        la = la + a_end[:, j]
    log_a_tot, u_tot = la, s

    # the state entering the shard, from the shards before it
    s0 = ctx.state_handoff(log_a_tot, u_tot)             # (B, H, dk, dv)
    s_glob = (torch.stack(la_in, dim=1).exp()[..., None, None] * s0[:, None]
              + torch.stack(s_in, dim=1))                # (B, nc, H, dk, dv)
    y = y + torch.einsum("bnthd,bnhdv->bnthv", qc * a.exp()[..., None],
                         s_glob)
    y = y.reshape(b, n, h, dv)
    if normalize:
        y, nrm = y[..., :-1], y[..., -1:]
        y = y / nrm.abs().clamp(min=1.0)
    if return_state:
        s_end = log_a_tot.exp()[..., None, None] * s0 + u_tot
        return y, ctx.last_shard(s_end)
    return y


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, d: int, heads: int, expand: int,
               device, dtype=torch.float32):
    d_in = d * expand
    kw = dict(device=device, dtype=dtype)
    return {
        "up": dense_init(gen, d, 2 * d_in, **kw),
        "wq": dense_init(gen, d_in, d_in, **kw),
        "wk": dense_init(gen, d_in, d_in, **kw),
        "wv": dense_init(gen, d_in, d_in, **kw),
        "gates": dense_init(gen, d_in, 2 * heads, bias=True, **kw),
        "hnorm": norm_init(d_in // heads, "rmsnorm", device, dtype),
        "down": dense_init(gen, d_in, d, **kw),
    }


def _mlstm_inputs(p, x, heads: int):
    """x (..., D) -> (q, k, v (..., H, hd), the input gate's and the
    forget gate's pre-activations (..., H) f32 (f64 in a float64
    forward), z (..., d_in))."""
    x_in, z = dense(p["up"], x).chunk(2, dim=-1)
    d_in = x_in.shape[-1]
    hd = d_in // heads

    def split_heads(t):
        return t.reshape(*t.shape[:-1], heads, hd)
    q = split_heads(dense(p["wq"], x_in)) * (hd ** -0.5)
    k = split_heads(dense(p["wk"], x_in))
    v = split_heads(dense(p["wv"], x_in))
    i_pre, f_pre = at_least_f32(dense(p["gates"], x_in)).chunk(2, dim=-1)
    return q, k, v, i_pre, f_pre, z


def mlstm_apply(p, x, *, heads: int, ctx, chunk: int = 128,
                return_state: bool = False):
    """x (B, N, D) -> y (B, N, D), and with ``return_state`` the state
    (B, H, hd, hd + 1) after the sequence's last token."""
    b, n, _ = x.shape
    q, k, v, i_pre, f_pre, z = _mlstm_inputs(p, x, heads)
    log_f = F.logsigmoid(f_pre + 1.0)        # forget bias: long memory
    gate_i = torch.sigmoid(i_pre)
    h = chunked_linear_attention(q, k, v, log_f, gate_i, chunk=chunk,
                                 ctx=ctx, normalize=True,
                                 return_state=return_state)
    if return_state:
        h, state = h
    h = norm(p["hnorm"], h, "rmsnorm")
    y = dense(p["down"], h.reshape(b, n, -1) * F.silu(z))
    return (y, state) if return_state else y


def mlstm_decode(p, x, state, *, heads: int):
    """One token: x (B, 1, D), state (B, H, hd, hd + 1) f32 -> (y (B, 1,
    D), state).  The state is updated in place: S = f·S + i·k [v, 1]ᵀ."""
    b = x.shape[0]
    q, k, v, i_pre, f_pre, z = _mlstm_inputs(p, x[:, 0], heads)
    hd = q.shape[-1]
    f = torch.sigmoid(f_pre + 1.0)                       # (B, H)
    i = torch.sigmoid(i_pre)
    v1 = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)
    s = state.view(b * heads, hd, hd + 1)
    state.mul_(f[..., None, None].to(state.dtype))
    s.baddbmm_((k * i[..., None]).reshape(b * heads, hd, 1).to(s.dtype),
               v1.reshape(b * heads, 1, hd + 1).to(s.dtype))
    y = torch.bmm(q.reshape(b * heads, 1, hd), s.to(q.dtype)).view(
        b, heads, hd + 1)
    y, nrm = y[..., :-1], y[..., -1:]
    y = y / nrm.abs().clamp(min=1.0)
    h = norm(p["hnorm"], y, "rmsnorm").reshape(b, -1) * F.silu(z)
    return dense(p["down"], h)[:, None], state


# --------------------------------------------------------------------------
# sLSTM: sequential
# --------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, d: int, heads: int, device,
               dtype=torch.float32):
    hd = d // heads
    return {
        "wx": dense_init(gen, d, 4 * d, bias=True, device=device,
                         dtype=dtype),
        # block-diagonal recurrent weights, one (hd, hd) block per gate
        # and head
        "r": _normal(gen, (4, heads, hd, hd), hd ** -0.5, device, dtype),
        "hnorm": norm_init(d, "rmsnorm", device, dtype),
        "down": dense_init(gen, d, d, device=device, dtype=dtype),
    }


def _slstm_step(r, carry, gates_t):
    """One step: carry (c, n, h) each (B, H, hd), gates_t (B, 4, H, hd)
    the input's pre-activations of z, i, f, o."""
    c, nrm, h = carry
    rec = torch.einsum("ghij,bhj->bghi", r, h)           # (B, 4, H, hd)
    zt, it, ft, ot = (gates_t[:, g] + rec[:, g] for g in range(4))
    zt = torch.tanh(zt)
    it = torch.sigmoid(it)
    ft = torch.sigmoid(ft + 1.0)
    ot = torch.sigmoid(ot)
    c = ft * c + it * zt
    nrm = ft * nrm + it
    h = ot * c / nrm.abs().clamp(min=1.0)
    return (c, nrm, h), h


def slstm_apply(p, x, *, heads: int, ctx, return_state: bool = False):
    """x (B', n, D) -> y (B', n, D), and with ``return_state`` the carry
    (B, 3, H, hd) f32 after the sequence's last token.  The scan runs over
    the whole gathered sequence (B, N, D)."""
    x_full = ctx.gather_sequence(x)
    b, nf, d = x_full.shape
    hd = d // heads
    pre = at_least_f32(dense(p["wx"], x_full).reshape(b, nf, 4, heads, hd))
    r = p["r"].to(pre.dtype)
    z0 = torch.zeros(b, heads, hd, dtype=pre.dtype, device=x.device)
    carry, hs = (z0, z0, z0), []
    for t in range(nf):
        carry, h = _slstm_step(r, carry, pre[:, t])
        hs.append(h)
    h_full = torch.stack(hs, dim=1).reshape(b, nf, d).to(x.dtype)
    h = norm(p["hnorm"], ctx.take_local(h_full), "rmsnorm")
    y = dense(p["down"], h)
    if return_state:
        return y, torch.stack(carry, dim=1)
    return y


def slstm_decode(p, x, state, *, heads: int):
    """One token: x (B, 1, D), state (B, 3, H, hd) f32 -> (y (B, 1, D),
    state), the state updated in place."""
    b, _, d = x.shape
    pre = dense(p["wx"], x[:, 0]).reshape(b, 4, heads, d // heads).float()
    carry, h = _slstm_step(p["r"].float(), state.unbind(dim=1), pre)
    state.copy_(torch.stack(carry, dim=1))
    h = norm(p["hnorm"], h.reshape(b, d).to(x.dtype), "rmsnorm")
    return dense(p["down"], h)[:, None], state


# --------------------------------------------------------------------------
# Mamba2 / SSD (zamba2)
# --------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, d: int, heads: int, d_state: int,
                expand: int, conv: int, device, dtype=torch.float32):
    """Mamba2's cell; ``a_log`` and ``dt_bias`` stay f32 whatever
    ``dtype``, as the reference's."""
    d_in = d * expand
    return {
        # fused in-proj: [z (d_in), x (d_in), B (d_state), C (d_state),
        # dt (H)]
        "in": dense_init(gen, d, 2 * d_in + 2 * d_state + heads,
                         device=device, dtype=dtype),
        "conv": _normal(gen, (conv, d_in), conv ** -0.5, device, dtype),
        "a_log": torch.zeros(heads, device=device),   # A = -exp(0) = -1
        "dt_bias": torch.zeros(heads, device=device),
        "d_skip": torch.ones(heads, device=device, dtype=dtype),
        "ynorm": norm_init(d_in, "rmsnorm", device, dtype),
        "out": dense_init(gen, d_in, d, device=device, dtype=dtype),
    }


def _mamba_proj_split(p, x, d_in: int, d_state: int):
    """x (..., D) -> z, xc (..., d_in), B, C (..., d_state), dt_pre
    (..., H): views of the fused in-projection."""
    proj = dense(p["in"], x)
    return proj.split([d_in, d_in, d_state, d_state,
                       proj.shape[-1] - 2 * d_in - 2 * d_state], dim=-1)


def _mamba_dt(p, dt_pre):
    """The input gate dt = softplus(dt_pre + dt_bias) and the decay
    log f = -dt·exp(a_log) <= 0, f32 (f64 in a float64 forward)."""
    dt_pre = at_least_f32(dt_pre)
    dt = F.softplus(dt_pre + p["dt_bias"].to(dt_pre.dtype))
    return dt, -dt * p["a_log"].to(dt.dtype).exp()


def _mamba_out(p, y, v, z):
    """The skip, the SiLU gate, the RMSNorm and the out-projection: y, v
    (..., H, hd), z (..., d_in) -> (..., D)."""
    y = y + v * p["d_skip"].to(v.dtype)[:, None]
    y = y.reshape(z.shape) * F.silu(z)
    return dense(p["out"], norm(p["ynorm"], y, "rmsnorm"))


def mamba2_apply(p, x, *, heads: int, d_state: int, expand: int,
                 conv: int, ctx, chunk: int = 128,
                 return_state: bool = False):
    """x (B, N, D) -> y (B, N, D), and with ``return_state`` the decode
    cache {"s": (B, H, d_state, hd) after the sequence's last token,
    "tail": its last conv - 1 pre-convolution rows (B, conv - 1, d_in)},
    both the last shard's (``ctx.last_shard``)."""
    b, n, d = x.shape
    d_in = d * expand
    z, xc, bmat, cmat, dt_pre = _mamba_proj_split(p, x, d_in, d_state)
    # causal depthwise conv; the halo comes from the previous shard
    xc_pad = torch.cat([ctx.prev_tail(xc, conv - 1), xc], dim=1)
    kern = p["conv"].to(xc.dtype)
    xc = F.silu(sum(xc_pad[:, i:i + n] * kern[i] for i in range(conv)))
    dt, log_f = _mamba_dt(p, dt_pre)                     # (B, N, H)
    v = xc.reshape(b, n, heads, d_in // heads)
    # B and C are shared by the heads: broadcast views, no copy
    k = bmat[:, :, None, :].expand(b, n, heads, d_state)
    q = cmat[:, :, None, :].expand(b, n, heads, d_state)
    y = chunked_linear_attention(q, k, v, log_f, dt, chunk=chunk, ctx=ctx,
                                 return_state=return_state)
    if return_state:
        y, state = y
    out = _mamba_out(p, y, v, z)
    if return_state:
        return out, {"s": state,
                     "tail": ctx.last_shard(xc_pad[:, n:])}
    return out


def mamba2_decode(p, x, cache, *, heads: int, d_state: int, expand: int,
                  conv: int):
    """One token: x (B, 1, D), cache {"s": (B, H, d_state, hd) f32,
    "tail": (B, conv - 1, d_in)} -> (y (B, 1, D), cache).  Both leaves
    are updated in place: the tail shifts by the new pre-convolution
    row, S = f·S + dt·B vᵀ."""
    b, _, d = x.shape
    d_in = d * expand
    hd = d_in // heads
    z, xc, bmat, cmat, dt_pre = _mamba_proj_split(p, x[:, 0], d_in,
                                                  d_state)
    tail, state = cache["tail"], cache["s"]
    window = torch.cat([tail, xc[:, None].to(tail.dtype)], dim=1)
    xc = F.silu(torch.einsum("bcd,cd->bd", window.to(xc.dtype),
                             p["conv"].to(xc.dtype)))
    tail.copy_(window[:, 1:])
    dt, log_f = _mamba_dt(p, dt_pre)                     # (B, H)
    v = xc.reshape(b, heads, hd)
    s = state.view(b * heads, d_state, hd)
    state.mul_(log_f.exp()[..., None, None].to(state.dtype))
    s.baddbmm_(bmat[:, None, :, None].expand(b, heads, d_state, 1)
               .reshape(b * heads, d_state, 1).to(s.dtype),
               (v * dt[..., None].to(v.dtype)).reshape(b * heads, 1, hd)
               .to(s.dtype))
    y = torch.bmm(cmat[:, None, None, :].expand(b, heads, 1, d_state)
                  .reshape(b * heads, 1, d_state), s.to(cmat.dtype))
    return _mamba_out(p, y.view(b, heads, hd), v, z)[:, None], cache
