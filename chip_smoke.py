#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one JSON line each:

1. env      the card (nvidia-smi name and power limit), torch and CUDA.
2. build    builds the three CUDA kernel libraries from ``src/repro_torch/
            kernels/csrc`` (one nvcc each, in parallel); seconds per
            library and the compiler's register / spill report.
3. kernel   each kernel against its plain PyTorch version on the card, at
            the main path's shapes and over an edge sweep (ragged M and
            Nq, GQA groups 1/3/12 and a folded 64, dead rows, g = 0
            columns, causal off, window, prefix; whole attention tiles
            invisible to a query tile, a window that drops early tiles,
            shuffled PRISM columns; decode columns off the 64-column
            pass, warps with no live column, groups of 40 and 128 heads;
            head dim 64, the only one the kernels are built for; segment
            means and the fused PRISM augment in f32 and bf16 over
            ragged segments, L = 1 and L = N, D = 33 and 5, P = 1/2/4
            and a misaligned base); the largest error beside the stated
            tolerance, and the times of kernel, plain version, library
            call and the bound (the attention kernel's operations at
            the 3xTF32 tensor-core rate, the others' at f32 FMA's).
            Times are event pairs (``ms``, over a floor of about 5 us,
            ``floor_ms``) and, for the kernels, the profiler's kernel
            durations (``device_ms``).
4. path     GPT-2 small at full width and depth, random weights from
            torch.Generator seed 0, B = 8, prompt 512, 64 generated
            tokens, P = 4 sequence shards, CR 4, through
            ``repro_torch.launch.serve`` in both pairings: voltage prefill
            + exact decode (checked against the plain full forward), PRISM
            prefill + prism decode (checked against the same run with
            backend='plain').  Launch counters are zeroed just before the
            run and read just after; every kernel must have launched as
            often as the path requires.
   trace    after each pairing, torch.profiler over one prefill and 8
            decode steps: device busy time, idle share and time by
            kernel class.
5. kernels  one line listing every kernel with its numbers: ``ms`` is
            the kernel's time and ``max_abs_err`` its largest error
            against the plain version over phase 3; the segment_means
            row adds its bf16 and fused-augment (``augment_*``) numbers.

Then the nvidia-smi line, and last the result line.  Any failed check
raises, and the script exits non-zero without printing a result; so it
does without a card, and outside the repository.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12                  # CUDA cores, f32 FMA
TF32_FLOP_PER_S = 495e12                # tensor cores, TF32
# f32-accurate products on the tensor cores take three TF32 products
# each (3xTF32), so the attention kernel's peak is a third of TF32's
F32_3XTF32_FLOP_PER_S = TF32_FLOP_PER_S / 3

# main path: GPT-2 small, B = 8, prompt 512, 64 generated, P = 4, CR 4
ARCH, BATCH, PROMPT, GEN, SHARDS, CR = "gpt2-small", 8, 512, 64, 4, 4.0

# kernel vs plain tolerances (|got - want| <= atol + rtol·|want|): both
# sides compute in f32 (the attention kernel's tensor-core products are
# 3xTF32, whose error stays at f32 FMA's level; single-pass TF32 would
# not fit); they differ only in summation order.  The reference's own
# kernel tests use the same.
TOL = {"prism_flash_attention": (2e-5, 2e-4),
       "segment_means": (1e-5, 1e-5),
       "flash_decode_stats": (1e-5, 1e-5)}
# bf16 segment means (both sides sum in f32 and round once to bf16): one
# bf16 rounding apart, 2^-7 of the value, beyond f32's sum-order error
TOL_BF16 = (1e-5, 2.0 ** -7)
# end-to-end: max |logits - reference| / max |reference| over every step
PATH_REL_TOL = 1e-4
# greedy tokens must agree where the reference's top-2 gap exceeds this
# share of its largest |logit|
TOKEN_GAP = 1e-3

SOURCES = {
    "prism_flash_attention": (
        "src/repro_torch/kernels/csrc/prism_attention.cu",
        "src/repro/kernels/prism_attention.py:88"),
    "segment_means": (
        "src/repro_torch/kernels/csrc/segment_means.cu",
        "src/repro/kernels/segment_means.py:33"),
    "flash_decode_stats": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:178"),
}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, with the 50 MB L2 flushed
    before each call (the main path finds its operands cold) and the
    card kept busy for about a millisecond after the flush, so that the
    host has enqueued the whole call before its start event is reached:
    the time is the card's, not the host's Python between launches."""

    AHEAD_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn, iters=25, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.AHEAD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def device(self, fn, iters=25, warmup=3):
        """Median device time of one call from torch.profiler's kernel
        records: the summed durations of the call's kernels, each call
        after the same L2 flush.  It holds none of the latency between
        an event and the kernel beside it, which puts a floor of about
        5 us under every event-pair time (``floor_ms``) and dominates a
        kernel of a few microseconds."""
        for _ in range(warmup):
            fn()
        flush = {name for name, _ in self._kernels(self.flush.zero_)}
        one = [name for name, _ in self._kernels(fn)]
        if not one or flush & set(one):
            raise RuntimeError(f"cannot tell the call's kernels {one} from "
                               f"the flush's {sorted(flush)}")

        def calls():
            for _ in range(iters):
                self.flush.zero_()
                fn()
        ms = [t for name, t in self._kernels(calls) if name not in flush]
        if len(ms) != iters * len(one):
            raise RuntimeError(f"{len(ms)} kernels in {iters} calls of "
                               f"{len(one)}")
        k = len(one)
        return statistics.median(sum(ms[i:i + k])
                                 for i in range(0, len(ms), k))

    def _kernels(self, fn):
        """(name, ms) of every device activity of ``fn``, in start order."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                for e in evs]

    def floor(self):
        """Event-pair time of a one-element add: the harness's floor."""
        tiny = self.torch.zeros(1, device="cuda")
        return self(lambda: tiny.add_(1))


def bound_ms(n_bytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


class Checker:
    """Collects the largest kernel-vs-plain error per kernel and raises on
    the first comparison outside the stated tolerance."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {name: 0.0 for name in TOL}
        self.cases = {name: 0 for name in TOL}

    def close(self, name, got, want, case, mask=None, tol=None, key=None):
        """``key`` (default ``name``) files the error apart, with its own
        ``tol``, e.g. a kernel's bf16 cases."""
        torch = self.torch
        atol, rtol = TOL[name] if tol is None else tol
        key = name if key is None else key
        got, want = got.double(), want.double()
        if mask is not None:
            got, want = got[mask], want[mask]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} [{case}]: non-finite output")
        diff = (got - want).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        bad = diff > atol + rtol * want.abs()
        if bad.any():
            raise AssertionError(f"{name} [{case}]: max |err| {err:.3e} "
                                 f"outside atol {atol} rtol {rtol}")
        self.max_err[key] = max(self.max_err.get(key, 0.0), err)

    def stats(self, got, want, case):
        """Decode stats: l and acc everywhere, m where the row is live."""
        m_g, l_g, a_g = got
        m_w, l_w, a_w = want
        self.close("flash_decode_stats", l_g, l_w, case + "/l")
        self.close("flash_decode_stats", a_g, a_w, case + "/acc")
        self.close("flash_decode_stats", m_g, m_w, case + "/m",
                   mask=l_w > 0)
        self.cases["flash_decode_stats"] += 1


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_inputs(torch, ctx_mode, seed=0):
    """The main path's prefill-attention inputs: q/k/v at GPT-2 small
    widths, metadata from the port's own sharded context."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models.transformer import attn_spec
    from repro_torch.sharding.context import ShardedPrismContext
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_loc, L = PROMPT // SHARDS, int(PROMPT // (CR * SHARDS))
    ctx = ShardedPrismContext(PrismConfig(P=SHARDS, L=L, mode=ctx_mode),
                              n_shards=SHARDS, backend="plain")
    x = torch.randn(BATCH * SHARDS, n_loc, cfg.d_model, device="cuda",
                    generator=gen)
    _, akv = ctx.augment(x, attn_spec(cfg))
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    m = akv.x_hat.shape[1]

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, device="cuda", generator=gen)
    q = rnd(BATCH * SHARDS, n_loc, hq, hd)
    k = rnd(akv.x_hat.shape[0], m, hkv, hd)
    v = rnd(akv.x_hat.shape[0], m, hkv, hd)
    g = akv.g if akv.g is not None else torch.ones(m, device="cuda")
    return q, k, v, g, akv.col_lo, akv.col_hi, akv.row_pos


def check_attention(torch, chk, timer):
    from repro_torch.core.attention import log_repeats
    from repro_torch.core.masks import visibility
    from repro_torch.kernels.ops import prism_attention_op
    from repro_torch.kernels.prism_attention import (
        prism_attention_reference, prism_flash_attention)
    name = "prism_flash_attention"

    def both(args, case, **kw):
        got = prism_attention_op(*args, backend="kernel", **kw)
        want = prism_attention_op(*args, backend="plain", **kw)
        chk.close(name, got, want, case)
        chk.cases[name] += 1

    # main-path shapes, both exchanges
    main = {}
    for mode in ("prism", "voltage"):
        args = attention_inputs(torch, mode)
        both(args, f"main/{mode}")
        q, k, v, g, lo, hi, row = args
        p = row.shape[0] if row.dim() == 2 else 1
        lg = log_repeats(g).reshape(-1, k.shape[1]).expand(p, -1)
        vis = visibility(row, lo.reshape(-1, k.shape[1]).expand(p, -1),
                         hi.reshape(-1, k.shape[1]).expand(p, -1),
                         causal=True) & (lg > -1e29)[:, None, :]
        pairs = int(vis.sum()) * (q.shape[0] // p) * q.shape[2]
        flops = 4 * q.shape[-1] * pairs          # QK^T and PV, 2 per FMA
        b_ms, b_by = bound_ms(nbytes(q, k, v, lg, lo, hi, row) +
                              nbytes(q), flops, F32_3XTF32_FLOP_PER_S)
        # the library yardstick: SDPA with log g and the mask folded into
        # a float mask (K/V expanded to the query batch for voltage)
        rep = q.shape[0] // k.shape[0]
        qs = q.transpose(1, 2).contiguous()
        ks = k.repeat_interleave(rep, 0).transpose(1, 2).contiguous()
        vs = v.repeat_interleave(rep, 0).transpose(1, 2).contiguous()
        bias = torch.where(vis, lg[:, None, :], torch.full_like(
            lg[:, None, :], -1e30))
        bias = bias.repeat(q.shape[0] // p, 1, 1)[:, None].contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the kernel and its plain version on the (P, M) / (P, Nq)
        # metadata the entry point hands them; the entry point's own
        # conversions (log g, int32, per-shard copies) are in op_ms
        i32 = torch.int32
        kargs = (q, k, v, lg.contiguous(),
                 lo.reshape(-1, k.shape[1]).expand(p, -1).to(i32).contiguous(),
                 hi.reshape(-1, k.shape[1]).expand(p, -1).to(i32).contiguous(),
                 row.reshape(p, -1).to(i32).contiguous())
        main[mode] = {
            "ms": timer(lambda: prism_flash_attention(*kargs, causal=True)),
            "device_ms": timer.device(lambda: prism_flash_attention(
                *kargs, causal=True)),
            "plain_ms": timer(lambda: prism_attention_reference(
                *kargs, causal=True), iters=10),
            "op_ms": timer(lambda: prism_attention_op(*args,
                                                      backend="kernel")),
            "library_ms": timer(lambda: sdpa(qs, ks, vs, attn_mask=bias)),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "shape": {"q": list(q.shape), "k": list(k.shape)}}

    # edge sweep: ragged Nq and M, GQA groups, dead rows,
    # g = 0 columns, causal off, window, prefix
    gen = torch.Generator(device="cuda").manual_seed(1)
    for hq, hkv, hd in ((12, 12, 64), (12, 4, 64), (12, 1, 64)):
        b, nq, m = 2, 100, 97
        q = 0.5 * torch.randn(b, nq, hq, hd, device="cuda", generator=gen)
        k = 0.5 * torch.randn(b, m, hkv, hd, device="cuda", generator=gen)
        v = 0.5 * torch.randn(b, m, hkv, hd, device="cuda", generator=gen)
        g = torch.randint(0, 5, (m,), device="cuda", generator=gen).float()
        lo = torch.randint(0, 120, (m,), device="cuda", generator=gen)
        hi = lo + torch.randint(0, 4, (m,), device="cuda", generator=gen)
        row = torch.arange(nq, device="cuda") + 20
        row[:7] = -1                              # rows that see nothing
        args = (q, k, v, g, lo, hi, row)
        for kw in (dict(causal=True), dict(causal=False),
                   dict(causal=True, window=16), dict(causal=True,
                                                      prefix_len=6),
                   dict(causal=False, window=24)):
            both(args, f"hq{hq}/hkv{hkv}/hd{hd}/{kw}", **kw)

    # tile skipping: sorted positions over Nq = 130 / M = 200 and
    # Nq = 200 / M = 400 (neither a tile multiple), two shards with their
    # own rows, so whole column tiles are invisible to a query tile
    # (causal), or drop out below the window; a prefix makes late tiles
    # visible again
    for (nq, m, r0, hq, hkv, kws) in (
            (130, 200, 40, 12, 12, (dict(causal=True),
                                    dict(causal=True, prefix_len=150))),
            (200, 400, 200, 12, 4, (dict(causal=True, window=50),
                                    dict(causal=True, window=150,
                                         prefix_len=20),
                                    dict(causal=False, window=70)))):
        p = 2
        q = 0.5 * torch.randn(2 * p, nq, hq, 64, device="cuda", generator=gen)
        k = 0.5 * torch.randn(2, m, hkv, 64, device="cuda", generator=gen)
        v = 0.5 * torch.randn(2, m, hkv, 64, device="cuda", generator=gen)
        g = torch.randint(0, 3, (p, m), device="cuda", generator=gen).float()
        lo = torch.arange(m, device="cuda").expand(p, m).contiguous()
        hi = lo + (torch.arange(m, device="cuda") % 2)
        row = (torch.arange(nq, device="cuda")[None] + r0
               + 60 * torch.arange(p, device="cuda")[:, None])
        for kw in kws:
            both((q, k, v, g, lo, hi, row), f"skip/nq{nq}/m{m}/{kw}", **kw)

    # the PRISM layout with its columns shuffled: a tile's positions are
    # neither sorted nor contiguous
    q, k, v, g, lo, hi, row = attention_inputs(torch, "prism", seed=4)
    perm = torch.randperm(k.shape[1], device="cuda", generator=gen)
    both((q[:8], k[:8, perm], v[:8, perm], g[..., perm], lo[..., perm],
          hi[..., perm], row), "prism/shuffled")
    return main


def check_segment_means(torch, chk, timer):
    """Both entries of csrc/segment_means.cu, f32 and bf16, against their
    plain versions: the means alone, and the fused PRISM augment.  Also
    a base 4 bytes off 16-byte alignment, which takes the kernel's scalar
    path at a D of whole vectors."""
    from repro_torch.kernels.segment_means import (prism_augment_op,
                                                   segment_means_op)
    name = "segment_means"
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dtype, misaligned=False):
        flat = torch.randn(math.prod(shape) + 1, device="cuda",
                           generator=gen).to(dtype)
        return (flat[1:] if misaligned else flat[:-1]).view(*shape)

    def both(op, x, case, **kw):
        tag = "" if x.dtype == torch.float32 else "/bf16"
        got = op(x, backend="kernel", **kw)
        want = op(x, backend="plain", **kw)
        if got.dtype != x.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} [{case}{tag}]: {got.dtype} "
                                 f"{tuple(got.shape)}, want {x.dtype} "
                                 f"{tuple(want.shape)}")
        chk.close(name, got, want, case + tag, key=name + tag,
                  tol=None if not tag else TOL_BF16)
        chk.cases[name] += 1
        return got

    n_loc, L0 = PROMPT // SHARDS, int(PROMPT // (CR * SHARDS))
    main = (BATCH * SHARDS, n_loc, 768, L0)
    means_cases = [main, (32, 100, 768, 16), (3, 17, 33, 4), (2, 9, 64, 1),
                   (1, 130, 5, 130), (4, 128, 768, 7), (2, 130, 768, 1)]
    # (B·P, n_loc, D, L, P): the main shape, ragged n_loc, L = 1,
    # L = n_loc, D = 33 and 5, P = 1, 2 and 4
    augment_cases = [main + (SHARDS,), (8, 100, 768, 16, 4),
                     (6, 130, 768, 1, 2), (4, 12, 768, 12, 4),
                     (6, 17, 33, 4, 2), (4, 9, 5, 3, 4), (3, 64, 768, 8, 1),
                     (2, 7, 5, 7, 1), (8, 128, 64, 32, 2)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d, L in means_cases:
            both(segment_means_op, rand((b, n, d), dtype),
                 f"means/b{b}/n{n}/d{d}/L{L}", L=L)
        for bp, n, d, L, p in augment_cases:
            x = rand((bp, n, d), dtype)
            got = both(prism_augment_op, x,
                       f"augment/bp{bp}/n{n}/d{d}/L{L}/P{p}", L=L,
                       n_shards=p)
            if not torch.equal(got[:, :n], x):
                raise AssertionError(f"{name} [augment/bp{bp}/n{n}]: the "
                                     "local rows are not copied exactly")
        b, n, d, L = main
        both(segment_means_op, rand((b, n, d), dtype, misaligned=True),
             "means/misaligned", L=L)
        both(prism_augment_op, rand((b, n, d), dtype, misaligned=True),
             "augment/misaligned", L=L, n_shards=SHARDS)

    # times at the main path's shape: the means alone (f32 and bf16),
    # then the fused augment against the chain it replaced; each as an
    # event pair (``*ms``) and from the profiler's kernel records
    # (``*device_ms``)
    b, n, d, L = main
    s = n // L
    x = rand((b, n, d), torch.float32)
    xb = x.to(torch.bfloat16)
    out = torch.empty(b, L, d, device="cuda")
    b_ms, b_by = bound_ms(nbytes(x, out), x.numel())
    bf_ms, _ = bound_ms(nbytes(xb, out.to(torch.bfloat16)), x.numel())
    x_hat = torch.empty(b, n + SHARDS * L, d, device="cuda")
    a_ms, a_by = bound_ms(nbytes(x, x_hat), x.numel())
    m = SHARDS * L

    def chain(z):          # the unfused augment after the means
        z_rep = z.reshape(b // SHARDS, m, d)[:, None].expand(
            -1, SHARDS, m, d).reshape(b, m, d)
        return torch.cat([x, z_rep], dim=1)
    calls = {
        "": lambda: segment_means_op(x, L=L, backend="kernel"),
        "plain_": lambda: segment_means_op(x, L=L, backend="plain"),
        "library_": lambda: x.view(b, L, s, d).mean(2),
        "bf16_": lambda: segment_means_op(xb, L=L, backend="kernel"),
        "augment_": lambda: prism_augment_op(x, L=L, n_shards=SHARDS,
                                             backend="kernel"),
        "augment_plain_": lambda: prism_augment_op(
            x, L=L, n_shards=SHARDS, backend="plain"),
        "augment_library_": lambda: chain(x.view(b, L, s, d).mean(2)),
        # the parent's route: the means kernel, then expand and cat
        "augment_unfused_": lambda: chain(
            segment_means_op(x, L=L, backend="kernel")),
    }
    times = {}
    for tag, fn in calls.items():
        times[tag + "ms"] = timer(fn)
        times[tag + "device_ms"] = timer.device(fn)
    return {**times, "bound_ms": b_ms, "bound_by": b_by,
            "bf16_bound_ms": bf_ms, "augment_bound_ms": a_ms,
            "augment_bound_by": a_by,
            "shape": {"x": [b, n, d], "L": L, "P": SHARDS}}


def decode_inputs(torch, mode, gen):
    """The main path's decode-kernel inputs at the last decode step
    (position prompt + gen - 2), with the layout's own valid mask and
    means bias."""
    from repro_torch.configs import get_config
    from repro_torch.core.attention import log_repeats
    from repro_torch.runtime import serve as S
    from repro_torch.sharding.context import means_columns
    cfg = get_config(ARCH)
    hp = S.ServeHParams(decode_mode=mode, means_cr=CR)
    cap = PROMPT + GEN + (-(PROMPT + GEN)) % SHARDS
    lay = S.make_layout(SHARDS, cap, hp, prefill_len=PROMPT)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = torch.full((BATCH,), PROMPT + GEN - 2, device="cuda")
    _, _, col_pos = S._decode_cols(lay, pos)
    valid = (col_pos[None] <= pos[:, None, None]).reshape(BATCH * SHARDS, -1)

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, device="cuda", generator=gen)
    args = [rnd(BATCH, 1, hq, hd), rnd(BATCH * SHARDS, lay.cap_l, hkv, hd),
            rnd(BATCH * SHARDS, lay.cap_l, hkv, hd), valid.contiguous()]
    if mode == "prism":
        m = SHARDS * lay.L
        cols = means_columns(SHARDS, lay.n_loc0, lay.L, pos.device)
        cnt = cols.sizes
        live = (cols.g > 0) & (cols.lo + cnt <= pos[:, None, None] + 1)
        gz = torch.where(live, cnt, torch.zeros_like(cnt))
        args += [log_repeats(gz).reshape(BATCH * SHARDS, m).contiguous(),
                 rnd(BATCH, m, hkv, hd), rnd(BATCH, m, hkv, hd)]
    return args, hd ** -0.5


def check_decode(torch, chk, timer):
    from repro_torch.kernels.decode_attention import decode_stats
    gen = torch.Generator(device="cuda").manual_seed(3)

    def both(args, scale, case):
        got = decode_stats(*args, scale=scale, backend="kernel")
        want = decode_stats(*args, scale=scale, backend="plain")
        chk.stats(got, want, case)

    main = {}
    for mode in ("exact", "prism"):
        args, scale = decode_inputs(torch, mode, gen)
        both(args, scale, f"main/{mode}")
        q, k, v, valid = args[:4]
        live_cols = int(valid.sum())
        n_bytes = nbytes(q, valid) + 2 * live_cols * k.shape[2] * k.shape[3] * 4
        cols_per_row = live_cols
        if mode == "prism":
            log_gz, kz, vz = args[4:]
            live_z = log_gz > -1e29                    # (B·P, m)
            cols_per_row += int(live_z.sum())
            z_any = live_z.reshape(BATCH, SHARDS, -1).any(1)
            n_bytes += (nbytes(log_gz)
                        + 2 * int(z_any.sum()) * kz.shape[2] * kz.shape[3] * 4)
        hq, hd = q.shape[2], q.shape[3]
        flops = 4 * hd * cols_per_row * hq
        n_bytes += 4 * (2 * k.shape[0] * hq + k.shape[0] * hq * hd)  # outputs
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib_ms, lib_err = decode_library(torch, timer, args, scale)
        main[mode] = {
            "ms": timer(lambda: decode_stats(*args, scale=scale,
                                             backend="kernel")),
            "device_ms": timer.device(lambda: decode_stats(
                *args, scale=scale, backend="kernel")),
            "plain_ms": timer(lambda: decode_stats(*args, scale=scale,
                                                   backend="plain")),
            "library_ms": lib_ms, "library_check": lib_err,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "shape": {"q": list(q.shape), "k": list(k.shape)}}

    # edge sweep: GQA groups 1/3/12 and a folded 64, ragged M, all-dead
    # rows, g = 0 means columns, shards folded into the batch (rep > 1);
    # then M and the means count off the 64-column pass, rows whose
    # later passes and warps hold no live column, rows of many passes,
    # and groups of 40 and 128 heads (more than one block of 32 heads)
    for hq, hkv, m_loc, rep, mz, max_pos in (
            (12, 12, 100, 1, 37, None), (12, 4, 33, 4, 37, None),
            (12, 1, 130, 2, 37, None), (64, 1, 70, 4, 37, None),
            (6, 3, 7, 1, 37, None), (8, 2, 65, 2, 37, None),
            (4, 4, 200, 3, 37, None),
            (12, 12, 300, 4, 100, None), (12, 4, 300, 2, 100, 20),
            (64, 1, 190, 2, 70, 60), (12, 1, 700, 2, 37, None),
            (24, 8, 450, 3, 129, 130), (40, 1, 90, 2, 37, 50),
            (128, 1, 70, 2, 37, None)):
        sweep_decode_case(torch, both, gen, hq, hkv, m_loc, rep, mz, max_pos)
    return main


def sweep_decode_case(torch, both, gen, hq, hkv, m_loc, rep, mz, max_pos,
                      hd=64):
    """One decode sweep case, without and with means columns: 3 query
    rows, each folded over ``rep`` shards; cache positions up to
    ``max_pos`` (default: the whole shard) with row 0 all dead."""
    bq = 3
    b = bq * rep
    top = m_loc if max_pos is None else max_pos
    q = 0.5 * torch.randn(bq, 1, hq, hd, device="cuda", generator=gen)
    k = 0.5 * torch.randn(b, m_loc, hkv, hd, device="cuda", generator=gen)
    v = 0.5 * torch.randn(b, m_loc, hkv, hd, device="cuda", generator=gen)
    pos = torch.randint(-1, top, (b,), device="cuda", generator=gen)
    pos[0] = -1                                  # an all-dead row
    valid = torch.arange(m_loc, device="cuda")[None] <= pos[:, None]
    case = f"hq{hq}/hkv{hkv}/M{m_loc}/rep{rep}/top{top}"
    both([q, k, v, valid], hd ** -0.5, case)
    gz = torch.randint(0, 5, (b, mz), device="cuda", generator=gen)
    gz[0] = 0                                    # dead means too
    if max_pos is not None:
        gz[:, max_pos:] = 0                      # late means not visible
    log_gz = torch.where(gz > 0, gz.float().log(),
                         torch.full_like(gz, -1e30, dtype=torch.float))
    kz = 0.5 * torch.randn(bq, mz, hkv, hd, device="cuda", generator=gen)
    vz = 0.5 * torch.randn(bq, mz, hkv, hd, device="cuda", generator=gen)
    both([q, k, v, valid, log_gz, kz, vz], hd ** -0.5, f"{case}/mz{mz}")


def decode_library(torch, timer, args, scale):
    """The decode yardstick: one call of PyTorch's memory-efficient
    attention over the same columns (local K/V and the means
    concatenated, a float bias from ``valid`` / ``log_gz``), with its
    log-sum-exp, which determine (m, l, acc).  Inputs are laid out
    outside the timed call; the port never calls it.  Returns (ms, the
    largest |out - acc / l| over live rows) or (None, the op's error)."""
    from repro_torch.kernels.decode_attention import decode_stats
    q, k, v, valid = args[:4]
    b, bq = k.shape[0], q.shape[0]
    rep, hq, hkv = b // bq, q.shape[2], k.shape[2]
    bias = torch.where(valid, 0.0, -1e30)
    if len(args) > 4:
        log_gz, kz, vz = args[4:]
        k = torch.cat([k, kz.repeat_interleave(rep, 0)], dim=1)
        v = torch.cat([v, vz.repeat_interleave(rep, 0)], dim=1)
        bias = torch.cat([bias, log_gz], dim=1)

    def heads(t):                                # (B, N, Hkv, hd) -> BHNd
        return t.repeat_interleave(hq // hkv, 2).transpose(1, 2).contiguous()
    qs = q.repeat_interleave(rep, 0).transpose(1, 2).contiguous()
    ks, vs = heads(k), heads(v)
    bias = bias[:, None, None, :].expand(b, hq, 1, -1).contiguous()
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    try:
        out = op(qs, ks, vs, bias, True, 0.0, False, scale=scale)[0]
        ms = timer(lambda: op(qs, ks, vs, bias, True, 0.0, False,
                              scale=scale))
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0][:200]}"
    _, l, acc = decode_stats(*args, scale=scale, backend="plain")
    live = (l[:, :, 0, 0] > 0)                              # (B, Hq)
    want = (acc[:, 0] / l[:, :, 0].clamp(min=1e-30))[live]
    return ms, float((out[:, :, 0][live] - want).abs().max())


# ---------------------------------------------------------------------------
# trace: where the device time goes
# ---------------------------------------------------------------------------

TRACED_STEPS = 8


def kernel_kind(name: str) -> str:
    """Coarse class of a device kernel, by its name."""
    for kind, keys in (("prism_flash_attention", ("prism_attention",)),
                       ("flash_decode_stats", ("decode_stats",)),
                       ("segment_means", ("segment_means",)),
                       ("matmul", ("gemm", "gemv", "cutlass", "cublas")),
                       ("reduce", ("reduce",)),
                       ("index", ("index", "scatter", "gather")),
                       ("copy", ("copy", "cat")),
                       ("elementwise", ("elementwise",))):
        if any(k in name.lower() for k in keys):
            return kind
    return "other"


def device_breakdown(prof, n_steps: int) -> dict:
    """Device time of a profiled window: kernels' summed and merged
    (busy) time, the idle share of the span from the first kernel's
    start to the last one's end, and time by kernel class; all per
    step."""
    from torch.autograd import DeviceType
    spans, by_kind = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (t1 - t0)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy, (cur0, cur1) = 0.0, spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy, cur0 = busy + cur1 - cur0, t0
        cur1 = max(cur1, t1)
    busy += cur1 - cur0
    span = spans[-1][1] - spans[0][0]
    ms = 1e-3 / n_steps                          # profiler times are in us
    return {"span_ms": span * ms, "busy_ms": busy * ms,
            "idle_share": 1.0 - busy / span, "kernels": len(spans) / n_steps,
            "by_kind_ms": {k: v * ms for k, v in sorted(
                by_kind.items(), key=lambda kv: -kv[1])}}


def profile(torch, run) -> dict:
    """Trace one prefill and ``TRACED_STEPS`` greedy decode steps of an
    already warmed-up static-batch ``run`` with ``torch.profiler``;
    returns the device breakdown of each window (per step for decode).
    The profiler's own overhead stretches the spans; the kernel times are
    the card's."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    from repro_torch.runtime.serve import prefill, serve_step
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    b, n = run.prompts.shape
    torch.cuda.synchronize()
    with trace(activities=acts) as prof_pre:
        logits, cache = prefill(run.cfg, run.params, run.prompts, run.prism,
                                run.lay, run.hp)
        torch.cuda.synchronize()
    with trace(activities=acts) as prof_dec:
        for i in range(TRACED_STEPS):
            pos = torch.full((b,), n + i, dtype=torch.long,
                             device=run.prompts.device)
            logits, cache = serve_step(run.cfg, run.params, cache,
                                       logits.argmax(dim=-1), pos, run.lay,
                                       run.hp)
        torch.cuda.synchronize()
    return {"prefill": device_breakdown(prof_pre, 1),
            "decode_per_token": device_breakdown(prof_dec, TRACED_STEPS)}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp(min=1e-6))


def tokens_agree(torch, tokens, ref_logits):
    """tokens (B, gen) vs the argmax of ref_logits (gen, B, V) wherever
    the reference's top-2 gap is clear; returns (checked, total)."""
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > TOKEN_GAP * float(
        ref_logits.abs().max())
    want = ref_logits.argmax(-1)
    got = tokens.T
    if (got[clear] != want[clear]).any():
        raise AssertionError("greedy tokens differ where the reference's "
                             "top-2 gap is clear")
    return int(clear.sum()), clear.numel()


def drive_path(torch, params):
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup
    from repro_torch.models import transformer as T
    n_layers = 12
    launches = {name: 0 for name in TOL}
    results = {}
    for mode in ("exact", "prism"):
        run = setup(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                    seq_shards=SHARDS, decode_mode=mode, cr=CR,
                    device="cuda", params=params)
        assert run.cfg.n_layers == n_layers and run.cfg.d_model == 768
        run.run()                                    # warm-up
        torch.cuda.synchronize()
        LAUNCHES.clear()
        tokens, logits, times = run.run()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        want = {"prism_flash_attention": n_layers,
                "segment_means": n_layers if mode == "prism" else 0,
                "flash_decode_stats": n_layers * (GEN - 1)}
        for name, n in want.items():
            got = counts.get(name, 0)
            if got != n:
                raise AssertionError(f"{mode}: {name} launched {got} "
                                     f"times, the path needs {n}")
            launches[name] += got
        vocab = run.cfg.vocab_size
        if tuple(logits.shape) != (GEN, BATCH, vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{mode}: logits {tuple(logits.shape)} "
                                 "not finite or of the wrong shape")
        if mode == "exact":
            # teacher-forced: one causal forward over prompt + generated
            # tokens covers every step
            seq = torch.cat([run.prompts, tokens[:, :-1]], dim=1)
            with torch.no_grad():
                full = T.forward(run.cfg, params, seq)
            ref = full[:, PROMPT - 1:].transpose(0, 1)        # (gen, B, V)
            ref_name = "plain full forward"
        else:
            plain = setup(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                          seq_shards=SHARDS, decode_mode=mode, cr=CR,
                          device="cuda", params=params, backend="plain")
            _, ref, _ = plain.run(forced=tokens[:, :-1])
            ref_name = "backend='plain' run"
        err = rel_err(logits, ref)
        if err > PATH_REL_TOL:
            raise AssertionError(f"{mode}: logits rel err {err:.3e} vs the "
                                 f"{ref_name} > {PATH_REL_TOL}")
        checked, total = tokens_agree(torch, tokens, ref)
        decode_s = times["decode_ms_per_token"] / 1e3
        results[mode] = {
            "prefill_ms": times["prefill_ms"],
            "decode_ms_per_token": times["decode_ms_per_token"],
            "decode_tokens_per_s": BATCH / decode_s,
            "e2e_tokens_per_s": BATCH * GEN / (
                (times["prefill_ms"] + times["decode_ms_per_token"]
                 * (GEN - 1)) / 1e3),
            "clock": times["clock"], "launches": counts,
            "logits_rel_err": err, "reference": ref_name,
            "tol": PATH_REL_TOL, "tokens_checked": checked,
            "tokens_total": total}
        emit("path", mode=mode, prefill="voltage" if mode == "exact"
             else "prism", batch=BATCH, prompt=PROMPT, gen=GEN,
             shards=SHARDS, cr=CR, **results[mode])
        # where the time goes: a torch.profiler trace of one prefill and
        # a few decode steps, after the counted run
        emit("trace", mode=mode, **profile(torch, run))
        del logits, ref
    return launches, results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.configs import get_config

    smi = nvidia_smi()
    dev = resolve_device("cuda")                # full-f32 matmuls, no TF32
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    secs = build.build()
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in build.LIBS}
    emit("build", seconds=secs, ptxas=ptxas)

    timer = Timer(torch)
    chk = Checker(torch)
    t_attn = check_attention(torch, chk, timer)
    t_means = check_segment_means(torch, chk, timer)
    t_dec = check_decode(torch, chk, timer)
    emit("kernel", max_abs_err=chk.max_err, tol=TOL, cases=chk.cases,
         floor_ms=timer.floor(), attention=t_attn, segment_means=t_means,
         decode=t_dec)

    params = T.init(get_config(ARCH),
                    torch.Generator(device=dev).manual_seed(0), dev)
    launches, _ = drive_path(torch, params)

    main_t = {"prism_flash_attention": t_attn["prism"],
              "segment_means": t_means,
              "flash_decode_stats": t_dec["prism"]}
    extra = {"prism_flash_attention": ("voltage", t_attn["voltage"]),
             "flash_decode_stats": ("exact", t_dec["exact"])}
    rows = []
    for name in TOL:
        src, rep = SOURCES[name]
        t = main_t[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[name],
               "max_abs_err": chk.max_err[name], "tol": list(TOL[name]),
               "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in extra:
            tag, te = extra[name]
            row.update({f"{tag}_ms": te["ms"],
                        f"{tag}_plain_ms": te["plain_ms"],
                        f"{tag}_bound_ms": te["bound_ms"],
                        f"{tag}_library_ms": te["library_ms"]})
        if name == "segment_means":        # bf16 and the fused augment
            row.update({k: v for k, v in t.items() if k != "shape"})
            row.update({"bf16_max_abs_err": chk.max_err[name + "/bf16"],
                        "bf16_tol": list(TOL_BF16)})
        else:
            row["device_ms"] = t["device_ms"]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
