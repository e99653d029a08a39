"""Batched serving over a mesh of ranks, the PyTorch port: prefill a
batch of prompts through the sequence-sharded runtime on a (data, model)
mesh of processes, then decode tokens in the exact (flash-decoding) and
prism (Segment-Means cache) modes and compare.

    PYTHONPATH=src python examples/serve_batched_torch.py        # the card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

Every mesh position is one process (``launch/mesh.py::spawn``) over the
``gloo`` backend, which runs any number of ranks on one card or on the
CPU.  On a 2x4 mesh the batch of 8 splits over ``data`` and each
prompt's 64 tokens over ``model`` (P = 4); each layer's weights are
gathered as it is reached, and each rank reports the bytes it sent.
Gemma 3 1B at its reduced size, as the JAX example serves it: a
sliding-window layer's halo comes from the previous rank and its ring is
decoded alike on every rank; ``--arch`` takes any decoder of the
registry.  Without a card ``--device cuda`` (the default) raises.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

B, N, GEN, CR = 8, 64, 12, 4.0


def rank(mesh, arch):
    """One rank: both decode modes on its rows; its tokens and meter."""
    import torch
    from repro_torch.launch.serve import mesh_rank
    torch.set_num_threads(1)
    out = {"coords": mesh.coords}
    for mode in ("exact", "prism"):
        r = mesh_rank(mesh, arch, batch=B, prompt_len=N, gen=GEN,
                      decode_mode=mode, cr=CR, reduced=True)
        out[mode] = r["tokens"].cpu().numpy()
        out[f"{mode}_meter"] = r["meter"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="2x4", metavar="DxM")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="gemma3-1b")
    args = ap.parse_args()
    from repro_torch.launch.mesh import MESH_TIMEOUT, spawn
    data, model = (int(v) for v in args.mesh.split("x"))
    ranks = spawn(rank, data, model, backend="gloo", device=args.device,
                  timeout=MESH_TIMEOUT, args=(args.arch,))
    # each data row of the mesh holds B / data sequences; model ranks agree
    outs = {mode: np.concatenate([r[mode] for r in ranks[::model]])
            for mode in ("exact", "prism")}
    for mode, toks in outs.items():
        print(f"[{mode:5s}] generated:\n{toks[:3]}")
    for r, res in enumerate(ranks):
        for mode in ("exact", "prism"):
            print(f"[meter] rank {r} {res['coords']} {mode:5s}: bytes sent "
                  f"{res[f'{mode}_meter']['sent']}")
    agree = (outs["exact"] == outs["prism"]).mean()
    print(f"\nexact-vs-prism greedy token agreement: {agree:.1%} "
          "(prism approximates remote context by Segment Means; "
          "agreement rises with lower CR)")


if __name__ == "__main__":
    main()
