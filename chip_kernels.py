#!/usr/bin/env python3
"""Phase 3 of a checkout's ``chip_smoke.py`` on one NVIDIA card: GPT-2
small's three kernels (head dim 64) and, where the checkout has them,
Yi-6B's (head dim 128, ``check_head_dim_128``), built from that
checkout's sources, checked against their plain versions and timed with
its own functions; one JSON line with the main-shape times.

    python3 chip_kernels.py [CHECKOUT] [TAG]
    python3 chip_kernels.py --bf16 [CHECKOUT] [TAG]

CHECKOUT (default: the directory of this file) is the root of a checkout
of this repository, for example an older commit unpacked with ``git
archive``.  To compare two checkouts' kernels, run them in turns in one
call on one card (a, b, b, a): machines and power limits differ between
calls.

``--bf16`` runs the checkout's ``check_bf16_kernels`` alone (the bf16,
mixed-dtype and head-dim 16 / 32 cases) and prints whether it passed,
the first case outside its tolerance and the share of each tolerance
used; it exits 1 if a case failed.  Run on a copy of a checkout with a
fault planted in a kernel source, it shows whether the checks see it.
"""
from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--bf16"]
    bf16 = len(args) < len(sys.argv) - 1
    tree = os.path.abspath(args[0] if args
                           else os.path.dirname(os.path.abspath(__file__)))
    tag = args[1] if len(args) > 1 else os.path.basename(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"imported {cs.__file__}, not {tree}'s")
    resolve_device("cuda")
    build.build()
    timer, chk = cs.Timer(torch), cs.Checker(torch)
    t0 = time.perf_counter()
    if bf16:
        try:
            cs.check_bf16_kernels(torch, chk, timer)
            failed = None
        except AssertionError as e:
            failed = str(e)
        print(json.dumps({
            "tag": tag, "nvidia_smi": cs.nvidia_smi(), "failed": failed,
            "tol_share": {k: v for k, v in chk.tol_share.items() if v},
            "worst": chk.worst, "seconds": time.perf_counter() - t0}),
            flush=True)
        return 1 if failed else 0
    att = cs.check_attention(torch, chk, timer)
    means = cs.check_segment_means(torch, chk, timer)
    dec = cs.check_decode(torch, chk, timer)
    keys = ("ms", "device_ms")
    yi = {}
    if hasattr(cs, "check_head_dim_128"):
        t = cs.check_head_dim_128(torch, chk, timer)
        yi = {"attention": {m: {k: a[k] for k in keys}
                            for m, a in t["attention"].items()},
              "segment_means": {k: t["segment_means"][k] for k in (
                  "ms", "device_ms", "augment_ms", "augment_device_ms")},
              "decode": {m: {k: t["decode"][m][k] for k in keys}
                         for m in ("exact", "prism", "chunk", "packed",
                                   "packed_prism")}}
    print(json.dumps({
        "tag": tag, "nvidia_smi": cs.nvidia_smi(),
        "attention": {m: {k: t[k] for k in keys} for m, t in att.items()},
        "segment_means": {k: means[k] for k in (
            "ms", "device_ms", "augment_ms", "augment_device_ms")},
        "decode": {m: {k: dec[m][k] for k in keys} for m in (
            "exact", "prism", "chunk", "packed", "packed_prism")},
        "decode_paged": {m: {k: t[k] for k in keys}
                         for m, t in dec["paged"].items()},
        "hd128": yi, "max_abs_err": chk.max_err,
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
