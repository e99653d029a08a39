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
            the decode kernel's two tick layouts at full width: a chunk's
            64·12 queries folded into the head axis over the whole cache
            rows at offsets 0, 64, 448 and staggered, and a packed tick
            of T = 72 (decode and prompt tokens, several per slot, dead
            entries) through the row map, exact and prism passes; the
            row map with repeats, every entry equal, entries out of
            range (clamped), T = 1, 7, 9, 13, 30, rep 1, 2 and 4; the
            decode kernel's tile route (a group of at least 4 query
            heads a KV head and no row map: the chunk layouts and the
            sweep's groups of 4 to 128 take it, each call checked to
            take the route the wrapper's rule names; every case
            without a row map also runs the other route) and its own
            cases: means with g = 0 in whole tiles at a group of 64, a
            row whose only live column ends a ragged local or means
            tile, groups of 4 (the threshold) and 3, 16 alone and over
            12 KV heads, rep 1 and 4;
            head dim 64, the only one the kernels are built for; segment
            means and the fused PRISM augment in f32 and bf16 over
            ragged segments, L = 1 and L = N, D = 33 and 5, P = 1/2/4
            and a misaligned base); the largest error beside the stated
            tolerance and the largest share of it a kernel used
            (``tol_share``), and the times of kernel, plain version,
            library call and the bound (the attention and decode
            kernels' operations at the 3xTF32 tensor-core rate, segment
            means' at f32 FMA's); the chunk layout's library call both at its
            natural (B·P, Hq, C) shape and folded as the kernel sees it;
            both decode routes at the chunk layout and, for the
            crossover, at its cache rows with folded groups of 1, 2, 4,
            8, 16, 32, 40, 64 and 128 query heads a KV head.
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
            often as the path requires (the decode kernel's tile route,
            counted apart as ``flash_decode_stats.mq``, 0 times).
   trace    after each pairing, torch.profiler over one prefill and 8
            decode steps: device busy time, idle share and time by
            kernel class.
5. path     the engine's tick programs at the same shape, each decode
            mode, the launch counters zeroed before each run:
            ``chunked``: chunked prefill of 64 tokens a call, row i
            admitted at call i // 2, the rewind, 63 greedy decode
            steps; its cache after the last chunk and its logits held
            to the monolithic Voltage prefill (exact: ``generate``;
            prism: the same rewind and prism decode steps); each chunk
            call's decode-kernel launches take the tile route (12 a
            call, 132 a run, ``flash_decode_stats.mq``), the decode
            steps the row route.
            ``packed``: every slot admitted at once, ticks of 72 tokens
            planned as ``FifoScheduler.plan_tick`` plans them, greedy
            through ``pack`` / ``merge`` (timed, launches counted; no
            tile route: a row map takes the row route); its logits held
            to the chunked path's at every step by a run teacher-forced
            on the chunked path's tokens.
   trace    per mode, torch.profiler over one chunk call and one packed
            tick with decode and prompt tokens.
6. kernels  one line listing every kernel with its numbers: ``ms`` is
            the kernel's time and ``max_abs_err`` its largest error
            against the plain version over phase 3, ``launches`` its
            launches over every path (``launches_by_path``); the
            flash_decode_stats row adds its chunk and packed layouts
            (``chunk_*``, ``packed_*``, ``packed_prism_*``), the chunk
            layout per route (``chunk_tile_*``, ``chunk_row_*``; the
            path's call, ``chunk_ms``, takes the tile route), the
            ``crossover`` table, the cases checked per route and the tile
            route's launches (``launches_mq``, ``launches_mq_by_path``);
            the segment_means row its bf16 and fused-augment
            (``augment_*``) numbers.

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
# each (3xTF32), so the card's peak for them is a third of TF32's
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
        self.flush_kernels = None           # names of the flush's kernels

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
        if self.flush_kernels is None:
            self.flush_kernels = {e.name for e in device_events(
                trace_device(self.torch, self.flush.zero_))}

        def calls():
            for _ in range(iters):
                self.flush.zero_()
                fn()

        def per_call(prof):
            """Kernel times of each call: those between two flushes."""
            runs, cur = [], None
            for e in device_events(prof):
                if e.name in self.flush_kernels:
                    cur = None
                    continue
                if cur is None:
                    cur = []
                    runs.append(cur)
                cur.append((e.time_range.end - e.time_range.start) / 1e3)
            return runs

        def complete(prof):
            runs = per_call(prof)
            return len(runs) == iters and len({len(r) for r in runs}) == 1
        runs = per_call(trace_device(self.torch, calls, complete))
        return statistics.median(sum(r) for r in runs)

    def floor(self):
        """Event-pair time of a one-element add: the harness's floor."""
        tiny = self.torch.zeros(1, device="cuda")
        return self(lambda: tiny.add_(1))


def device_events(prof):
    """The device activities of a profile, in start order."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def trace_device(torch, fn, complete=None, tries=6):
    """torch.profiler over ``fn()`` on the CPU and the card.  A trace that
    recorded no device activity, or that ``complete(prof)`` finds short
    of what ``fn`` launched, is taken again, up to ``tries`` times, after
    a pause that grows each time: the profiler's device tracing on the
    card now and then comes back empty or holding only part of a call,
    up to three traces in a row."""
    import time
    from torch.profiler import ProfilerActivity, profile
    for i in range(tries):
        time.sleep(0.25 * i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if device_events(prof) and (complete is None or complete(prof)):
            return prof
    raise RuntimeError(f"the profiler recorded no or an incomplete device "
                       f"trace in {tries} tries")


def trace_window(torch, fn):
    """``trace_device`` over a window of the serving path, complete when
    it holds a device record of every launch of the port's kernels that
    the window counted (``LAUNCHES``)."""
    from repro_torch.kernels.dispatch import LAUNCHES
    counted = {}

    def run():
        n0 = sum(LAUNCHES[name] for name in TOL)
        fn()
        counted["n"] = sum(LAUNCHES[name] for name in TOL) - n0

    def complete(prof):
        return counted["n"] == sum(1 for e in device_events(prof)
                                   if kernel_kind(e.name) in TOL)
    return trace_device(torch, run, complete)


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
        # the largest |err| / (atol + rtol·|want|): how much of its
        # tolerance a kernel uses (1 fails)
        self.tol_share = {name: 0.0 for name in TOL}
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
        share = diff / (atol + rtol * want.abs())
        if (share > 1).any():
            raise AssertionError(f"{name} [{case}]: max |err| {err:.3e} "
                                 f"outside atol {atol} rtol {rtol}")
        self.max_err[key] = max(self.max_err.get(key, 0.0), err)
        if share.numel():
            self.tol_share[key] = max(self.tol_share.get(key, 0.0),
                                      float(share.max()))

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
        gz = S.prism_gz(cols, cols.sizes, pos)
        args += [log_repeats(gz).reshape(BATCH * SHARDS, m).contiguous(),
                 rnd(BATCH, m, hkv, hd), rnd(BATCH, m, hkv, hd)]
    return args, hd ** -0.5


def decode_bound(torch, q, k, valid, log_gz=None, kz=None, rows=None):
    """(bound ms, what bounds it, bytes) of one decode-stats call: each
    live cache column read once, however many query rows read it (the
    packed layout's tokens of one slot share their row), each live means
    column once per means row, q / valid / log g / the row map once, the
    stats written once; operations 4·hd per live (query head, column)
    pair, at the rate the card computes f32-accurate products on its
    tensor cores (3xTF32), as the attention kernel's bound counts them:
    the least time the card could take, whatever this kernel's route."""
    b, bq = valid.shape[0], q.shape[0]
    rep, (hq, hd), hkv = b // bq, q.shape[2:], k.shape[2]
    sel = (torch.arange(bq, device=q.device) if rows is None
           else rows.long().clamp(0, k.shape[0] // rep - 1))
    shard_row = (sel[:, None] * rep + torch.arange(rep, device=q.device)
                 ).reshape(-1)
    kv_live = torch.zeros(k.shape[:2], device=q.device).index_add_(
        0, shard_row, valid.float()) > 0
    n_bytes = (nbytes(q, valid) + 2 * int(kv_live.sum()) * hkv * hd * 4
               + 4 * (2 * b * hq + b * hq * hd))
    pairs = int(valid.sum())
    if kz is not None:
        live_z = log_gz > -1e29                                  # (B, m)
        pairs += int(live_z.sum())
        z_live = torch.zeros(kz.shape[:2], device=q.device).index_add_(
            0, sel.repeat_interleave(rep), live_z.float()) > 0
        n_bytes += nbytes(log_gz) + 2 * int(z_live.sum()) * hkv * hd * 4
    if rows is not None:
        n_bytes += nbytes(rows)
    b_ms, b_by = bound_ms(n_bytes, 4 * hd * hq * pairs,
                          F32_3XTF32_FLOP_PER_S)
    return b_ms, b_by, n_bytes


def time_decode(torch, timer, args, scale, rows=None):
    """Kernel, plain version, library call and bound of one decode-stats
    call.  The library call reads the rows the row map selects, gathered
    outside the timed call."""
    from repro_torch.kernels.decode_attention import (decode_stats,
                                                      gather_rows)
    q, k, v, valid = args[:4]
    lib_args = list(args)
    if rows is not None:
        k_g, v_g, kz_g, vz_g = gather_rows(rows, valid.shape[0] // q.shape[0],
                                           k, v, *args[5:7])
        lib_args[1:3] = [k_g, v_g]
        if kz_g is not None:
            lib_args[5:7] = [kz_g, vz_g]
    lib_ms, lib_err = decode_library(torch, timer, lib_args, scale)
    b_ms, b_by, n_bytes = decode_bound(torch, q, k, valid, *args[4:6],
                                       rows=rows)

    def call(backend):
        return lambda: decode_stats(*args, scale=scale, rows=rows,
                                    backend=backend)
    return {"ms": timer(call("kernel")),
            "device_ms": timer.device(call("kernel")),
            "plain_ms": timer(call("plain")),
            "library_ms": lib_ms, "library_check": lib_err,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "shape": {"q": list(q.shape), "k": list(k.shape),
                      "rows": None if rows is None else list(rows.shape)}}


def tick_layout_inputs(torch, gen):
    """The decode kernel's inputs on the two tick paths at full width.

    chunk: the C = 64 chunk's queries folded into the head axis, q (B, 1,
    64·12, 64), the whole cache rows (B·P, cap_l, 12, 64), valid =
    col_pos < off, at the offsets of every row the same (0, 64, 448) and
    staggered as in the chunked path's 8th call.

    packed: a T = 72 tick of the main layout: 6 decode tokens (slots
    0-5), 40 prompt tokens of slot 6 from offset 448 and 20 of slot 7
    from offset 64 (several tokens per cache row), 6 dead entries; the
    exact pass (valid = col_pos < off) and the prism pass (valid =
    col_pos <= pos, the means columns of each token's slot)."""
    from repro_torch.configs import get_config
    from repro_torch.core.attention import log_repeats
    from repro_torch.runtime import serve as S
    from repro_torch.sharding.context import means_columns
    cfg = get_config(ARCH)
    hp = S.ServeHParams(decode_mode="prism", means_cr=CR)
    cap = PROMPT + GEN + (-(PROMPT + GEN)) % SHARDS
    lay = S.make_layout(SHARDS, cap, hp, prefill_len=PROMPT)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = "cuda"

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, device=dev, generator=gen)
    k = rnd(BATCH * SHARDS, lay.cap_l, hkv, hd)
    v = rnd(BATCH * SHARDS, lay.cap_l, hkv, hd)
    _, _, col_pos = S._decode_cols(lay, torch.zeros(1, dtype=torch.long,
                                                    device=dev))
    chunk = {}
    q = rnd(BATCH, 1, CHUNK_LEN * hq, hd)
    for name, off in (("off0", [0] * BATCH), ("off64", [64] * BATCH),
                      ("off448", [448] * BATCH),
                      ("staggered", [448, 448, 384, 384, 320, 320, 256,
                                     256])):
        off = torch.as_tensor(off, device=dev)
        valid = (col_pos[None] < off[:, None, None]).reshape(
            BATCH * SHARDS, -1)
        chunk[name] = [q, k, v, valid.contiguous()]

    slot = [*range(6), *[6] * 40, *[7] * 20, *[-1] * 6]
    pos = [PROMPT + 20 + s for s in range(6)] + list(range(448, 488)) + \
        list(range(64, 84)) + [-1] * 6
    off = [PROMPT + 20 + s for s in range(6)] + [448] * 40 + [64] * 20 + \
        [-1] * 6
    slot, pos, off = (torch.as_tensor(a, device=dev)
                      for a in (slot, pos, off))
    alive = slot >= 0
    rows = slot.clamp(min=0).to(torch.int32)
    t = slot.shape[0]
    q = rnd(t, 1, hq, hd)
    valid = alive[:, None, None] & (col_pos[None] < off[:, None, None])
    valid_le = alive[:, None, None] & (col_pos[None] <= pos[:, None, None])
    cols = means_columns(SHARDS, lay.n_loc0, lay.L, dev)
    gz = S.prism_gz(cols, cols.sizes, torch.where(alive, pos, -1))
    m = SHARDS * lay.L
    packed = [q, k, v, valid.reshape(t * SHARDS, -1).contiguous()]
    packed_prism = [q, k, v, valid_le.reshape(t * SHARDS, -1).contiguous(),
                    log_repeats(gz).reshape(t * SHARDS, m).contiguous(),
                    rnd(BATCH, m, hkv, hd), rnd(BATCH, m, hkv, hd)]
    return chunk, packed, packed_prism, rows, hd ** -0.5


def check_decode(torch, chk, timer):
    from repro_torch.kernels.decode_attention import (decode_route,
                                                      decode_stats,
                                                      launch_route)
    from repro_torch.kernels.dispatch import LAUNCHES
    gen = torch.Generator(device="cuda").manual_seed(3)
    by_route = {"row": 0, "tile": 0}

    def both(args, scale, case, rows=None):
        """The routed kernel against the plain version (the call must
        take the route the wrapper's rule names) and, without a row map,
        the other route on the same inputs."""
        n_mq = LAUNCHES["flash_decode_stats.mq"]
        got = decode_stats(*args, scale=scale, rows=rows, backend="kernel")
        route = "tile" if LAUNCHES["flash_decode_stats.mq"] > n_mq else "row"
        want_route = decode_route(args[0].shape[2], args[1].shape[2],
                                  rows is None)
        if route != want_route:
            raise AssertionError(f"flash_decode_stats [{case}]: took the "
                                 f"{route} route, the rule says "
                                 f"{want_route}")
        want = decode_stats(*args, scale=scale, rows=rows, backend="plain")
        chk.stats(got, want, f"{case}/{route}")
        by_route[route] += 1
        if rows is None:
            other = "row" if route == "tile" else "tile"
            chk.stats(launch_route(other, *args, scale=scale), want,
                      f"{case}/{other}")
            by_route[other] += 1

    times = {}
    for mode in ("exact", "prism"):
        args, scale = decode_inputs(torch, mode, gen)
        both(args, scale, f"main/{mode}")
        times[mode] = time_decode(torch, timer, args, scale)

    # the tick paths' layouts: the chunk's folded queries over the whole
    # cache rows, the packed tokens through the row map
    chunk, packed, packed_prism, rows, scale = tick_layout_inputs(torch, gen)
    for name, args in chunk.items():
        both(args, scale, f"chunk/{name}")
    both(packed, scale, "packed/exact", rows=rows)
    both(packed_prism, scale, "packed/prism", rows=rows)
    times["chunk"] = time_decode(torch, timer, chunk["off448"], scale)
    t = times["chunk"]
    t["library_folded_ms"], t["library_folded_check"] = (
        t["library_ms"], t["library_check"])
    t["library_ms"], t["library_check"], t["library_bias"] = chunk_library(
        torch, timer, chunk["off448"], scale, CHUNK_LEN)
    t.update(time_routes(torch, timer, chunk["off448"], scale))
    times["crossover"] = crossover(torch, timer, chunk["off448"], scale, gen)
    times["packed"] = time_decode(torch, timer, packed, scale, rows=rows)
    times["packed_prism"] = time_decode(torch, timer, packed_prism, scale,
                                        rows=rows)

    # edge sweep: GQA groups 1/3/12 and a folded 64, ragged M, all-dead
    # rows, g = 0 means columns, shards folded into the batch (rep > 1);
    # then M and the means count off the 64-column pass, rows whose
    # later passes and warps hold no live column, rows of many passes,
    # and groups of 40 and 128 heads (more than one block of 32 heads of
    # the row route); each case on both routes
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
    # the row map: repeats and out-of-range entries (clamped), every entry
    # equal, T = 1, T not a multiple of 4, rep 1 and 4
    for t, n_rows, rep, hq, hkv, kind in (
            (72, 8, 4, 12, 12, "repeats"), (7, 3, 1, 12, 12, "equal"),
            (1, 8, 4, 12, 12, "repeats"), (13, 5, 4, 12, 4, "clamped"),
            (30, 2, 2, 64, 1, "repeats"), (9, 4, 1, 12, 3, "equal")):
        sweep_rows_case(torch, both, gen, t, n_rows, rep, hq, hkv, kind)
    # the tile route's edges, on both routes: a group of 64 with means
    # whose g is 0 in whole tiles and scattered columns; a row whose only
    # live column is the last of a ragged local tile (M = 144, 4.5 tiles)
    # or of a ragged means tile (37 columns); groups of 4 (the rule's
    # threshold) and 3 (the row route's by the rule) over 12 KV heads, of
    # 16 alone and over 12 KV heads; rep 1 and 4
    for hq, hkv, m_loc, rep, mz, kind in (
            (64, 1, 144, 4, 128, "dead_means"), (128, 2, 144, 1, 64,
                                                 "dead_means"),
            (64, 1, 144, 4, 37, "last_local"), (64, 2, 144, 1, 37,
                                                "last_means"),
            (4 * 12, 12, 144, 4, 128, "random"), (3 * 12, 12, 144, 4, 37,
                                                  "random"),
            (16, 1, 144, 4, 37, "random"), (16 * 12, 12, 144, 4, 128,
                                            "random"),
            (40, 1, 100, 1, 37, "random"), (128, 1, 70, 4, 37, "random")):
        sweep_tile_case(torch, both, gen, hq, hkv, m_loc, rep, mz, kind)
    times["cases_by_route"] = by_route
    return times


def sweep_tile_case(torch, both, gen, hq, hkv, m_loc, rep, mz, kind,
                    hd=64):
    """One tile-route case over 3 query rows folded over ``rep`` shards,
    without and with means columns: ``dead_means`` (local columns to a
    random position, means g = 0 in the second 32-column tile and every
    third column, and in every means column of one row), ``last_local``
    / ``last_means`` (every row's only live column is the last local /
    means column, the end of a ragged tile), ``random`` (random
    positions and g, row 0 all dead)."""
    dev = "cuda"
    bq = 3
    b = bq * rep
    q = 0.5 * torch.randn(bq, 1, hq, hd, device=dev, generator=gen)
    k = 0.5 * torch.randn(b, m_loc, hkv, hd, device=dev, generator=gen)
    v = 0.5 * torch.randn(b, m_loc, hkv, hd, device=dev, generator=gen)
    cols = torch.arange(m_loc, device=dev)
    gz = torch.randint(1, 5, (b, mz), device=dev, generator=gen)
    if kind == "last_local":
        valid = (cols == m_loc - 1).expand(b, m_loc).contiguous()
        gz[:] = 0
    elif kind == "last_means":
        valid = torch.zeros(b, m_loc, dtype=torch.bool, device=dev)
        gz[:] = 0
        gz[:, -1] = 3
    else:
        pos = torch.randint(-1, m_loc, (b,), device=dev, generator=gen)
        pos[0] = -1                              # an all-dead row
        valid = cols[None] <= pos[:, None]
        gz[0] = 0
        if kind == "dead_means":
            gz[:, 32:64] = 0
            gz[:, ::3] = 0
            gz[1] = 0
    case = f"tile/{kind}/hq{hq}/hkv{hkv}/M{m_loc}/rep{rep}"
    args = [q, k, v, valid]
    both(args, hd ** -0.5, case)                 # last_means: all dead
    log_gz = torch.where(gz > 0, gz.float().log(),
                         torch.full_like(gz, -1e30, dtype=torch.float))
    kz = 0.5 * torch.randn(bq, mz, hkv, hd, device=dev, generator=gen)
    vz = 0.5 * torch.randn(bq, mz, hkv, hd, device=dev, generator=gen)
    args += [log_gz, kz, vz]
    both(args, hd ** -0.5, f"{case}/mz{mz}")


def time_routes(torch, timer, args, scale):
    """Event and profiler times of each route of the decode kernel on
    the same inputs (no row map)."""
    from repro_torch.kernels.decode_attention import launch_route
    out = {}
    for route in ("tile", "row"):
        def call():
            return launch_route(route, *args, scale=scale)
        out[f"{route}_ms"] = timer(call)
        out[f"{route}_device_ms"] = timer.device(call)
    return out


CROSSOVER_GROUPS = (1, 2, 4, 8, 16, 32, 40, 64, 128)


def crossover(torch, timer, chunk_args, scale, gen):
    """Both routes at the chunk layout's cache rows (offset 448) with a
    folded group of each of ``CROSSOVER_GROUPS`` query heads a KV head
    (a chunk of that many tokens): where the tile route starts to win,
    against the rule's threshold."""
    from repro_torch.kernels.decode_attention import (TILE_MIN_GROUP,
                                                      decode_route)
    _, k, v, valid = chunk_args
    bq, hkv, hd = chunk_args[0].shape[0], k.shape[2], k.shape[3]
    rows = []
    for grp in CROSSOVER_GROUPS:
        q = 0.5 * torch.randn(bq, 1, grp * hkv, hd, device="cuda",
                              generator=gen)
        args = [q, k, v, valid]
        b_ms, b_by, _ = decode_bound(torch, q, k, valid)
        rows.append({"group": grp, "rule": decode_route(grp * hkv, hkv,
                                                        True),
                     **time_routes(torch, timer, args, scale),
                     "bound_ms": b_ms, "bound_by": b_by})
    return {"threshold": TILE_MIN_GROUP, "offset": 448, "by_group": rows}


def sweep_rows_case(torch, both, gen, t, n_rows, rep, hq, hkv, kind,
                    m_loc=150, mz=40, hd=64):
    """One row-map case, without and with means columns: ``t`` query rows
    over ``n_rows`` cache rows of ``rep`` shards, per-output-row valid
    columns (some rows all dead), rows drawn with repeats, all equal, or
    with entries below and above the range (the kernel reads them
    clamped)."""
    dev = "cuda"
    q = 0.5 * torch.randn(t, 1, hq, hd, device=dev, generator=gen)
    k = 0.5 * torch.randn(n_rows * rep, m_loc, hkv, hd, device=dev,
                          generator=gen)
    v = 0.5 * torch.randn(n_rows * rep, m_loc, hkv, hd, device=dev,
                          generator=gen)
    rows = torch.randint(0, n_rows, (t,), device=dev, generator=gen)
    if kind == "equal":
        rows[:] = rows[0]
    elif kind == "clamped":
        rows[::3], rows[1::3] = -1, n_rows + 2
    rows = rows.to(torch.int32)
    pos = torch.randint(-1, m_loc, (t * rep,), device=dev, generator=gen)
    pos[0] = -1                                  # an all-dead row
    valid = torch.arange(m_loc, device=dev)[None] <= pos[:, None]
    case = f"rows/{kind}/T{t}/R{n_rows}/rep{rep}/hq{hq}/hkv{hkv}"
    both([q, k, v, valid], hd ** -0.5, case, rows=rows)
    gz = torch.randint(0, 5, (t * rep, mz), device=dev, generator=gen)
    log_gz = torch.where(gz > 0, gz.float().log(),
                         torch.full_like(gz, -1e30, dtype=torch.float))
    kz = 0.5 * torch.randn(n_rows, mz, hkv, hd, device=dev, generator=gen)
    vz = 0.5 * torch.randn(n_rows, mz, hkv, hd, device=dev, generator=gen)
    both([q, k, v, valid, log_gz, kz, vz], hd ** -0.5, f"{case}/mz{mz}",
         rows=rows)


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


def chunk_library(torch, timer, args, scale, c):
    """The chunk layout's yardstick at its natural shape: one call of
    PyTorch's memory-efficient attention with each (row, shard)'s C
    queries as its query axis, q (B·P, Hq, C, hd) over K/V (B·P, Hq,
    cap_l, hd), under a bias (B·P, 1, 1, cap_l) from ``valid`` broadcast
    over heads and queries (every query of a chunk sees the same prior
    columns), or materialised if the op refuses the broadcast.  The
    folded call (``decode_library``) reads K/V once per folded head.
    Returns (ms, the largest |out - acc / l| over live rows, the bias's
    form) or (None, the op's error, None)."""
    from repro_torch.kernels.decode_attention import decode_stats
    q, k, v, valid = args
    b, bq, hqc, hd = k.shape[0], q.shape[0], q.shape[2], q.shape[3]
    rep, hkv = b // bq, k.shape[2]
    grp = hqc // (c * hkv)
    hq = hkv * grp
    qs = (q.reshape(bq, hkv, c, grp, hd).transpose(2, 3)
          .reshape(bq, hq, c, hd).repeat_interleave(rep, 0).contiguous())
    ks, vs = (t.repeat_interleave(grp, 2).transpose(1, 2).contiguous()
              for t in (k, v))
    bias = torch.where(valid, 0.0, -1e30)[:, None, None, :].expand(
        b, hq, c, -1)
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    refused = []
    for form, bb in (("broadcast", bias), ("materialised", bias.contiguous())):
        try:
            out = op(qs, ks, vs, bb, True, 0.0, False, scale=scale)[0]
        except RuntimeError as e:
            refused.append(f"{form}: {str(e).splitlines()[0][:200]}")
            continue
        ms = timer(lambda: op(qs, ks, vs, bb, True, 0.0, False, scale=scale))
        break
    else:
        return None, "refused: " + "; ".join(refused), None
    _, l, acc = decode_stats(*args, scale=scale, backend="plain")
    live = l[:, :, 0, 0] > 0                               # (B·P, C·Hq)
    want = acc[:, 0] / l[:, :, 0].clamp(min=1e-30)
    got = (out.reshape(b, hkv, grp, c, hd).transpose(2, 3)
           .reshape(b, hqc, hd))
    return ms, float((got[live] - want[live]).abs().max()), form


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
    spans, by_kind = [], {}
    for e in device_events(prof):
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
    from repro_torch.runtime.serve import prefill, serve_step
    b, n = run.prompts.shape
    state = {}

    def pre():
        state["out"] = prefill(run.cfg, run.params, run.prompts, run.prism,
                               run.lay, run.hp)

    def dec():
        logits, cache = state["out"]
        for i in range(TRACED_STEPS):
            pos = torch.full((b,), n + i, dtype=torch.long,
                             device=run.prompts.device)
            logits, cache = serve_step(run.cfg, run.params, cache,
                                       logits.argmax(dim=-1), pos, run.lay,
                                       run.hp)
    prof_pre = trace_window(torch, pre)
    prof_dec = trace_window(torch, dec)
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


def check_launches(path, counts, need):
    for name, n in need.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"{path}: {name} launched "
                                 f"{counts.get(name, 0)} times, the path "
                                 f"needs {n}")


def drive_path(torch, params):
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup
    from repro_torch.models import transformer as T
    n_layers = 12
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
        check_launches(f"static/{mode}", counts, {
            "prism_flash_attention": n_layers,
            "segment_means": n_layers if mode == "prism" else 0,
            "flash_decode_stats": n_layers * (GEN - 1),
            "flash_decode_stats.mq": 0})
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
    return results


# ---------------------------------------------------------------------------
# phase 5: the engine's tick programs, chunked prefill and packed ticks
# ---------------------------------------------------------------------------

CHUNK_LEN = 64                       # the engine's default chunk_len
TOKEN_BUDGET = BATCH + CHUNK_LEN     # its default token budget: 72
TICK_KEYS = ("tok", "src", "slot", "pos", "off", "pre")


def plan_chunks(prompts, chunk_len, join):
    """The chunked-prefill calls an engine makes for ``prompts`` (lists of
    token ids), row i admitted at call ``join[i]``: every admitted row
    with prompt left advances by up to ``chunk_len`` tokens at its own
    offset.  Returns one (tokens (B, C), off (B,), nreal (B,)) of numpy
    arrays per call; a row not prefilling has off = -1."""
    import numpy as np
    b = len(prompts)
    done = [0] * b
    calls = []
    while any(done[i] < len(p) for i, p in enumerate(prompts)):
        tokens = np.zeros((b, chunk_len), np.int64)
        off = np.full(b, -1, np.int64)
        nreal = np.zeros(b, np.int64)
        for i, p in enumerate(prompts):
            take = min(chunk_len, len(p) - done[i])
            if join[i] <= len(calls) and take > 0:
                tokens[i, :take] = p[done[i]:done[i] + take]
                off[i], nreal[i] = done[i], take
                done[i] += take
        calls.append((tokens, off, nreal))
    return calls


def plan_packed(prompts, gen, budget, forced=None):
    """The packed ticks ``FifoScheduler.plan_tick`` plans for ``prompts``,
    all admitted at the first tick, each generating ``gen`` tokens: every
    decoding slot's token first, then prompt tokens in slot order up to
    ``budget``, the dead tail padded (slot = -1).  A slot's first decode
    token re-feeds its last prompt token at ``off = pos = n - 1``; a later
    one is ``forced[slot][k - 1]`` if given, else the slot's sample of
    the tick before (``src`` = the slot, for ``merge``).  Returns one dict
    per tick: numpy arrays ``TICK_KEYS`` (budget,); ``n_dec``, its decode
    rows, which come first; ``lengths`` (B,), each slot's cached tokens
    after the tick; ``dslot`` and ``flat`` (B,), zero-padded: the slot
    and the (step·B + slot) of each decode row."""
    import numpy as np
    b = len(prompts)
    if budget < b:
        raise ValueError(f"token budget {budget} < {b} slots")
    done, n_dec = [0] * b, [0] * b
    ticks = []
    while any(n < gen for n in n_dec):
        t = {k: np.full(budget, -1, np.int64) for k in TICK_KEYS}
        t["tok"][:], t["pre"][:] = 0, 0
        t["dslot"], t["flat"] = np.zeros(b, np.int64), np.zeros(b, np.int64)
        i = 0
        for s, p in enumerate(prompts):
            if done[s] < len(p) or n_dec[s] >= gen:
                continue
            k = n_dec[s]
            t["slot"][i] = s
            t["pos"][i] = t["off"][i] = len(p) - 1 + k
            if k == 0:
                t["tok"][i] = p[-1]
            elif forced is not None:
                t["tok"][i] = forced[s][k - 1]
            else:
                t["src"][i] = s
            t["dslot"][i], t["flat"][i] = s, k * b + s
            n_dec[s] += 1
            i += 1
        t["n_dec"] = i
        for s, p in enumerate(prompts):
            take = min(budget - i, len(p) - done[s])
            if take <= 0:
                continue
            t["tok"][i:i + take] = p[done[s]:done[s] + take]
            t["slot"][i:i + take] = s
            t["pos"][i:i + take] = np.arange(done[s], done[s] + take)
            t["off"][i:i + take] = done[s]
            t["pre"][i:i + take] = 1
            done[s] += take
            i += take
        t["lengths"] = np.array([d + max(0, n - 1)
                                 for d, n in zip(done, n_dec)], np.int64)
        ticks.append(t)
    return ticks


class Clock:
    """Time marks on the card's stream (CUDA events) or, on the CPU, the
    host clock."""

    def __init__(self, torch, device):
        self.torch = torch
        self.on_card = torch.device(device).type == "cuda"
        self.kind = "cuda_events" if self.on_card else "host"
        self.marks = []

    def mark(self):
        if self.on_card:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            import time
            self.marks.append(time.perf_counter())

    def ms(self, i, j):
        """Milliseconds from mark i to mark j (synchronises the card)."""
        if self.on_card:
            self.torch.cuda.synchronize()
            return self.marks[i].elapsed_time(self.marks[j])
        return 1e3 * (self.marks[j] - self.marks[i])


def rewind_decode(cfg, params, cache, prompts, *, gen, lay, hp, device,
                  forced=None):
    """The rewind step (each row's last prompt token re-fed at
    ``pos = n - 1``), then ``gen - 1`` greedy (or ``forced`` (B, gen-1))
    ``serve_step``s on ``cache``.  Returns the logits (gen, B, V)."""
    import torch
    from repro_torch.runtime.serve import serve_step
    tok = torch.as_tensor([p[-1] for p in prompts], device=device)
    pos = torch.as_tensor([len(p) - 1 for p in prompts], device=device)
    out = []
    for k in range(gen):
        logits, cache = serve_step(cfg, params, cache, tok, pos + k, lay, hp)
        out.append(logits)
        if k + 1 < gen:
            tok = logits.argmax(dim=-1) if forced is None else forced[:, k]
    return torch.stack(out)


def run_chunked(cfg, params, prompts, *, gen, lay, hp, chunk_len, join,
                device, forced=None):
    """Chunked prefill of ``prompts`` (lists of token ids) into an empty
    cache, row i admitted at call ``join[i]``, then ``rewind_decode``.
    Returns (tokens (B, gen), logits (gen, B, V), a copy of the cache
    after the last chunk, info: prefill_ms (the first chunk call to the
    end of the last), decode_ms_per_token, the number of chunk calls)."""
    import numpy as np
    import torch
    from repro_torch.runtime.serve import init_cache
    from repro_torch.runtime.ticks import chunk_prefill_step
    calls = plan_chunks(prompts, chunk_len, join)
    toks, offs, nreals = (torch.as_tensor(np.stack(a), device=device)
                          for a in zip(*calls))
    cache = init_cache(cfg, lay, len(prompts), hp, device)
    clock = Clock(torch, device)
    clock.mark()
    for i in range(len(calls)):
        chunk_prefill_step(cfg, params, cache, toks[i], offs[i], nreals[i],
                           lay, hp)
    clock.mark()
    snap = [{k: t.clone() for k, t in c.items()} for c in cache]
    clock.mark()
    logits = rewind_decode(cfg, params, cache, prompts, gen=gen, lay=lay,
                           hp=hp, device=device, forced=forced)
    clock.mark()
    info = {"prefill_ms": clock.ms(0, 1),
            "decode_ms_per_token": clock.ms(2, 3) / gen,
            "calls": len(calls), "clock": clock.kind}
    return logits.argmax(dim=-1).T, logits, snap, info


def run_packed(cfg, params, prompts, *, gen, lay, hp, budget, device,
               forced=None):
    """Every prompt admitted at once and served by packed ticks
    (``plan_packed``) until each has ``gen`` tokens, sampled on the card
    by ``pack`` and fed back by ``merge``.  Returns (tokens (B, gen),
    logits (gen, B, V), the cache, info: prefill_ms (the first tick to the
    end of the last with a prompt token), decode_ms_per_tick over the
    ticks after it, the tick count, a mixed tick's index)."""
    import numpy as np
    import torch
    from repro_torch.runtime.serve import init_cache
    from repro_torch.runtime.ticks import merge, pack, packed_step
    ticks = plan_packed(prompts, gen, budget, forced)
    b, v_size = len(prompts), cfg.vocab_size
    head = min(b, budget)

    def stack(key):
        return torch.as_tensor(np.stack([t[key] for t in ticks]),
                               device=device)
    tok, src, slot, pos, off, pre = (stack(k) for k in TICK_KEYS)
    lengths, dslot, flat = stack("lengths"), stack("dslot"), stack("flat")
    is_dec = (pre[:, :head] == 0) & (slot[:, :head] >= 0)
    logits_out = torch.zeros(gen * b, v_size, device=device)
    tok_out = torch.zeros(gen * b, dtype=torch.long, device=device)
    fin_out = torch.zeros(gen * b, dtype=torch.int32, device=device)
    prev = torch.zeros(b, 4, dtype=torch.int32, device=device)
    cache = init_cache(cfg, lay, b, hp, device)
    clock = Clock(torch, device)
    clock.mark()
    for i, t in enumerate(ticks):
        tokens = merge(tok[i], src[i], prev)
        logits, cache = packed_step(cfg, params, cache, tokens, slot[i],
                                    pos[i], off[i], pre[i], lay, hp)
        prev = pack(logits, slot[i, :head], is_dec[i], lengths[i])
        n = t["n_dec"]
        if n:
            rows = flat[i, :n]
            logits_out.index_copy_(0, rows, logits[:n])
            tok_out.index_copy_(0, rows, prev[dslot[i, :n], 0].long())
            fin_out.index_copy_(0, rows, prev[dslot[i, :n], 3])
        clock.mark()
    if not bool((fin_out == 1).all()):
        raise AssertionError("pack flagged a row with a non-finite logit")
    last_pre = max(i for i, t in enumerate(ticks) if t["pre"].any())
    n_after = len(ticks) - 1 - last_pre
    mixed = [i for i, t in enumerate(ticks)
             if t["pre"].any() and t["n_dec"] > 0]
    info = {"prefill_ms": clock.ms(0, last_pre + 1),
            "decode_ms_per_tick": (clock.ms(last_pre + 1, len(ticks))
                                   / max(1, n_after)),
            "total_ms": clock.ms(0, len(ticks)), "ticks": len(ticks),
            "decode_only_ticks": n_after, "clock": clock.kind,
            "mixed_tick": mixed[0] if mixed else None}
    return (tok_out.view(gen, b).T, logits_out.view(gen, b, v_size), cache,
            info)


def profile_ticks(torch, cfg, params, prompts, lay, hp, join):
    """torch.profiler over one chunk call (every row admitted, at its own
    offset) and one mixed packed tick (decode and prompt tokens), each
    on a fresh cache after one untraced call."""
    import numpy as np
    from repro_torch.runtime.serve import init_cache
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    calls = plan_chunks(prompts, CHUNK_LEN, join)
    i = max(join)                               # the first with every row
    args = [torch.as_tensor(a, device="cuda") for a in calls[i]]
    ticks = plan_packed(prompts, GEN, TOKEN_BUDGET)
    t = ticks[[j for j, t in enumerate(ticks)
               if t["pre"].any() and t["n_dec"] > 0][0]]
    targs = [torch.as_tensor(t[k], device="cuda") for k in TICK_KEYS]
    tok, _, slot, pos, off, pre = targs
    out = {}
    for name, fn in (
            ("chunk_call", lambda c: chunk_prefill_step(
                cfg, params, c, *args, lay, hp)),
            ("packed_tick", lambda c: packed_step(
                cfg, params, c, tok, slot, pos, off, pre, lay, hp))):
        cache = init_cache(cfg, lay, len(prompts), hp, "cuda")
        fn(cache)
        out[name] = device_breakdown(trace_window(torch, lambda: fn(cache)),
                                     1)
    out["chunk_call"]["offsets"] = calls[i][1].tolist()
    out["packed_tick"]["tokens"] = {"decode": int(t["n_dec"]),
                                    "prompt": int(np.sum(t["pre"]))}
    return out


def drive_ticks(torch, params):
    """Phase 5: the chunked and packed paths in both decode modes, at the
    main path's shape; returns the launches of each path."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup
    from repro_torch.runtime.serve import (ServeHParams, generate,
                                           make_layout, prefill)
    run = setup(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                seq_shards=SHARDS, cr=CR, device="cuda", params=params)
    cfg, prompts_t = run.cfg, run.prompts
    prompts = prompts_t.tolist()
    n_layers = cfg.n_layers
    join = [i // 2 for i in range(BATCH)]       # staggered admission
    voltage = PrismConfig(P=SHARDS, cr=CR, mode="voltage")
    launches = {}
    for mode in ("exact", "prism"):
        hp = ServeHParams(decode_mode=mode, means_cr=CR)
        lay = make_layout(SHARDS, run.lay.cap, hp, prefill_len=PROMPT)
        kw = dict(gen=GEN, lay=lay, hp=hp, device="cuda")

        # chunked prefill, the rewind, greedy decode
        run_chunked(cfg, params, prompts, chunk_len=CHUNK_LEN, join=join,
                    **kw)                                        # warm-up
        torch.cuda.synchronize()
        LAUNCHES.clear()
        tokens, logits, snap, info = run_chunked(
            cfg, params, prompts, chunk_len=CHUNK_LEN, join=join, **kw)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        check_launches(f"chunked/{mode}", counts, {
            "flash_decode_stats": n_layers * (info["calls"] + GEN),
            "flash_decode_stats.mq": n_layers * info["calls"],
            "prism_flash_attention": 0, "segment_means": 0})
        launches[f"chunked/{mode}"] = counts
        _, ref_cache = prefill(cfg, params, prompts_t, voltage, lay, hp)
        leaf_err = {k: max(rel_err(a[k], b[k])
                           for a, b in zip(snap, ref_cache))
                    for k in ref_cache[0]}
        if max(leaf_err.values()) > PATH_REL_TOL or set(snap[0]) != set(
                ref_cache[0]):
            raise AssertionError(f"chunked/{mode}: cache leaves {leaf_err} "
                                 f"vs the monolithic prefill > "
                                 f"{PATH_REL_TOL}")
        if mode == "exact":
            _, ref, _ = generate(cfg, params, prompts_t, gen=GEN,
                                 prism=voltage, lay=lay, hp=hp,
                                 forced=tokens[:, :-1])
            ref_name = "monolithic Voltage prefill, exact decode"
        else:
            ref = rewind_decode(cfg, params, ref_cache, prompts,
                                forced=tokens[:, :-1], **kw)
            ref_name = "monolithic Voltage prefill, rewind, prism decode"
        del snap, ref_cache
        err = rel_err(logits, ref)
        if tuple(logits.shape) != (GEN, BATCH, cfg.vocab_size) or not (
                err <= PATH_REL_TOL):
            raise AssertionError(f"chunked/{mode}: logits rel err {err:.3e} "
                                 f"vs the {ref_name} > {PATH_REL_TOL}")
        checked, total = tokens_agree(torch, tokens, ref)
        del ref
        emit("path", path="chunked", mode=mode, batch=BATCH, prompt=PROMPT,
             gen=GEN, shards=SHARDS, cr=CR, chunk_len=CHUNK_LEN, join=join,
             **info, launches=counts, leaf_rel_err=leaf_err,
             logits_rel_err=err, reference=ref_name, tol=PATH_REL_TOL,
             tokens_checked=checked, tokens_total=total)

        # packed ticks, teacher-forced on the chunked path's tokens, so
        # every step's logits compare (and the timed run's warm-up)
        f_tokens, f_logits, _, _ = run_packed(
            cfg, params, prompts, budget=TOKEN_BUDGET,
            forced=tokens[:, :-1].tolist(), **kw)
        err = rel_err(f_logits, logits)
        if tuple(f_logits.shape) != tuple(logits.shape) or not bool(
                torch.isfinite(f_logits).all()) or not err <= PATH_REL_TOL:
            raise AssertionError(f"packed/{mode}: logits rel err {err:.3e} "
                                 f"vs the chunked path > {PATH_REL_TOL}")
        checked, total = tokens_agree(torch, f_tokens, logits)
        del f_logits
        # then greedy through pack / merge, timed and counted
        torch.cuda.synchronize()
        LAUNCHES.clear()
        p_tokens, _, _, p_info = run_packed(
            cfg, params, prompts, budget=TOKEN_BUDGET, **kw)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        per_tick = n_layers * (2 if mode == "prism" else 1)
        check_launches(f"packed/{mode}", counts, {
            "flash_decode_stats": per_tick * p_info["ticks"],
            "flash_decode_stats.mq": 0,
            "prism_flash_attention": 0, "segment_means": 0})
        launches[f"packed/{mode}"] = counts
        emit("path", path="packed", mode=mode, batch=BATCH, prompt=PROMPT,
             gen=GEN, shards=SHARDS, cr=CR, token_budget=TOKEN_BUDGET,
             **p_info, launches=counts, logits_rel_err=err,
             reference=f"the chunked path ({mode}), teacher-forced",
             tol=PATH_REL_TOL, tokens_checked=checked, tokens_total=total,
             greedy_tokens_equal=bool((p_tokens == tokens).all()))
        del logits
        tr = profile_ticks(torch, cfg, params, prompts, lay, hp, join)
        emit("trace", path="chunked", mode=mode, chunk_call=tr["chunk_call"])
        emit("trace", path="packed", mode=mode, packed_tick=tr["packed_tick"])
    return launches


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
    emit("kernel", max_abs_err=chk.max_err, tol_share=chk.tol_share,
         tol=TOL, cases=chk.cases,
         floor_ms=timer.floor(), attention=t_attn, segment_means=t_means,
         decode=t_dec)

    params = T.init(get_config(ARCH),
                    torch.Generator(device=dev).manual_seed(0), dev)
    by_path = {f"static/{mode}": r["launches"]
               for mode, r in drive_path(torch, params).items()}
    by_path.update(drive_ticks(torch, params))

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
               "replaces": rep,
               "launches": sum(c.get(name, 0) for c in by_path.values()),
               "launches_by_path": {path: c.get(name, 0)
                                    for path, c in by_path.items()},
               "max_abs_err": chk.max_err[name], "tol": list(TOL[name]),
               "tol_share": chk.tol_share[name],
               "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in extra:
            tag, te = extra[name]
            row.update({f"{tag}_ms": te["ms"],
                        f"{tag}_plain_ms": te["plain_ms"],
                        f"{tag}_bound_ms": te["bound_ms"],
                        f"{tag}_library_ms": te["library_ms"]})
        if name == "flash_decode_stats":   # the tick paths' layouts
            for tag in ("chunk", "packed", "packed_prism"):
                row.update({f"{tag}_{k}": t_dec[tag][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})
            # the chunk layout per route (the path's call takes the tile
            # route), and both routes over the folded group sizes
            row.update({f"chunk_{k}": t_dec["chunk"][k] for k in (
                "tile_ms", "tile_device_ms", "row_ms", "row_device_ms",
                "library_folded_ms")})
            row["crossover"] = t_dec["crossover"]
            row["cases_by_route"] = t_dec["cases_by_route"]
            mq = name + ".mq"
            row["launches_mq"] = sum(c.get(mq, 0) for c in by_path.values())
            row["launches_mq_by_path"] = {path: c.get(mq, 0)
                                          for path, c in by_path.items()}
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
