"""Continuous-batching engine demo, the PyTorch port: six requests with
staggered arrivals share four decode slots over a (2 data x 4 model) mesh
of processes.  Late arrivals are prefilled into slots freed by earlier
evictions while the surviving streams keep decoding; with the default
token-packed mode, each engine tick with any prefill work runs one call
over a flat mixed batch of decode and prompt tokens (watch the 'packed'
step kinds below).

    PYTHONPATH=src python examples/serve_engine_torch.py        # the card
    PYTHONPATH=src python examples/serve_engine_torch.py --device cpu
    # the degraded mesh: sequence shard 1's K/V lost at the 6th tick
    PYTHONPATH=src python examples/serve_engine_torch.py --device cpu \
        --shard-loss 1

Every mesh position is one process (``launch/mesh.py::spawn``) over the
``gloo`` backend, which runs any number of ranks on one card or on the
CPU.  Each rank runs the same engine (the same scheduler, page table and
sampling; the clock is rank 0's): the four slots split over ``data``
where the cache is dense, the paged pool is replicated over it, and each
request's sequence is cut over ``model`` (P = 4).  Every rank gives the
same tokens.  Without a card ``--device cuda`` (the default) raises.

``--shard-loss S`` loses the K/V of sequence shard S (the rank at
``model`` index S) mid-run: for two ticks the decoding requests go on
through the Segment-Means standby of shard S, which its ring neighbour
(S + 1) mod 4 hosts and sends back, then every active request is
prefilled again, so the final tokens are the uninterrupted ones.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def rank(mesh, shard_loss=None):
    """One rank: the demo's engine run -> its step kinds, tokens and
    stats."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import ServeHParams, mesh_params
    from repro_torch.serving import (EngineConfig, FaultPlan, FaultSpec,
                                     SamplingParams, ServingEngine)
    torch.set_num_threads(1)
    cfg = get_config("gpt2-small").reduced()
    params = T.init(cfg, torch.Generator(device=mesh.device).manual_seed(0),
                    mesh.device)
    # EngineConfig is the one construction path: the paged page-table cache
    # and (in exact mode) shared-prefix reuse are on by default
    faults = (None if shard_loss is None else FaultPlan(
        shard_loss=FaultSpec(at=(6,), shard=shard_loss)))
    eng = ServingEngine(cfg, mesh_params(cfg, params, mesh), EngineConfig(
        n_slots=4, prefill_len=32, max_cache=48,
        hp=ServeHParams(decode_mode="exact"), faults=faults))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(8, 33))).tolist()
               for _ in range(6)]
    # the first four arrive at once and fill the pool ...
    for p in prompts[:4]:
        eng.submit(p, max_new_tokens=10, sampling=SamplingParams())  # greedy
    kinds = [eng.step() for _ in range(5 if shard_loss is None else 12)]
    # ... two more arrive mid-flight; they wait for evictions
    for p in prompts[4:]:
        eng.submit(p, max_new_tokens=10)
    out = eng.run()
    return {"kinds": kinds, "out": out, "prompts": prompts,
            "stats": eng.stats.summary(), "kv": eng.kv_cache.stats(),
            "coords": mesh.coords, "meter": mesh.meter.snapshot()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="2x4", metavar="DxM")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shard-loss", type=int, default=None, metavar="S",
                    help="lose sequence shard S's K/V at the 6th tick")
    args = ap.parse_args()
    from repro_torch.launch.mesh import MESH_TIMEOUT, spawn
    data, model = (int(v) for v in args.mesh.split("x"))
    ranks = spawn(rank, data, model, backend="gloo", device=args.device,
                  timeout=MESH_TIMEOUT, args=(args.shard_loss,))
    first = ranks[0]
    if any(r["out"] != first["out"] for r in ranks[1:]):
        raise SystemExit("the ranks' tokens differ")
    for kind in first["kinds"]:
        print(f"[demo] step -> {kind}")
    for rid, toks in first["out"].items():
        print(f"[demo] request {rid} ({len(first['prompts'][rid])} prompt "
              f"tokens) -> {toks}")
    for k, v in first["stats"].items():
        print(f"[demo] {k:22s} {v:.4f}" if isinstance(v, float)
              else f"[demo] {k:22s} {v}")
    for k, v in first["kv"].items():
        print(f"[demo] kv/{k:19s} {v}")
    for r, res in enumerate(ranks):
        print(f"[meter] rank {r} {res['coords']}: bytes sent "
              f"{res['meter']['sent']}")
    print(f"[demo] every one of the {len(ranks)} ranks gave the same tokens")


if __name__ == "__main__":
    main()
