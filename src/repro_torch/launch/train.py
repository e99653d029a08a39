"""Training launcher: the PRISM train step on the reference's synthetic
character corpus, on one card over P sequence shards, or over a (data,
model) mesh of ranks.

    # GPT-2 small at full width on the card, P 4, CR 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
        --steps 30 --batch 8 --seq 512 --seq-shards 4 --mode prism --cr 4

    # any decoder family at its smoke-test size, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
        --reduced --device cpu --seq-shards 4 --steps 20 --batch 4 \
        --seq 64

    # over a (data, model) mesh of ranks, one process each (the
    # reference's --mesh DxM): FSDP over data and model, the batch over
    # data, the sequence over model; gloo runs any number of ranks on one
    # card or on the CPU, nccl one rank a card
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
        --reduced --device cpu --mesh 2x2 --backend gloo --steps 20 \
        --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
        --mesh 1x4 --backend gloo --steps 10 --batch 8 --seq 512

Weights are random, drawn from ``torch.Generator`` seeded with
``--seed``; the corpus is ``synthetic_text(500_000, seed=1)`` through
``CharTokenizer``, batches ``lm_batches(..., seed=0)`` (the reference
launcher's).  The learning rate warms up over a tenth of the steps and
follows the cosine to the last.  ``--seq-shards`` is the reference's
``model`` mesh axis folded into one process; ``--mesh`` runs both axes
as ranks (every rank draws the same weights and batches and keeps its
block).  ``--checkpoint`` saves the whole final parameters in the
reference's layout (over a mesh gathered, and written by rank 0).
Runs on CUDA unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, replace

import torch

from ..checkpoint.io import save_checkpoint
from ..configs import get_config
from ..convert import to_jax_numpy
from ..core.protocol import PrismConfig
from ..data.pipeline import CharTokenizer, lm_batches, synthetic_text
from ..device import resolve_device
from ..launch.mesh import Mesh, spawn
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim.adamw import adamw_init, tree_leaves
from ..runtime.train import (TrainHParams, gather_train_state,
                             make_train_step, shard_train_state)

#: seconds every rank of a ``--mesh`` run must end within
TRAIN_TIMEOUT = 3600.0


@dataclass
class TrainRun:
    """Everything a run of the launcher needs."""
    cfg: ModelConfig
    params: dict
    opt: dict
    step: object                     # make_train_step's step
    prism: PrismConfig
    hp: TrainHParams
    mesh: Mesh | None = None        # over a mesh: params and opt local


def setup(arch: str = "gpt2-small", *, reduced: bool = False,
          seq_shards: int = 4, mode: str = "prism", cr: float = 4.0,
          lr: float = 3e-4, steps: int = 100, device="cuda", seed: int = 0,
          params: dict | None = None, mesh: Mesh | None = None,
          n_layers: int | None = None) -> TrainRun:
    """The config, seeded parameters (or ``params``: the tests bring the
    reference's), AdamW's state and the train step, with the reference
    launcher's hyper-parameters.  ``mesh``: this rank's ``Mesh``; the run
    keeps the rank's blocks of the parameters and state, on its device,
    over sequence shards of the mesh's ``model`` size.  ``n_layers``
    keeps the first layers only."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers,
                      blocks=cfg.block_kinds[:n_layers])
    if params is None:
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    if mesh is not None:
        seq_shards = mesh.size(("model",))
    prism = PrismConfig(P=seq_shards, cr=cr, mode=mode)
    hp = TrainHParams(lr=lr, total_steps=steps, warmup=max(1, steps // 10))
    if mesh is None:
        step = make_train_step(cfg, prism, hp, n_shards=seq_shards,
                               device=dev)
        return TrainRun(cfg, params, adamw_init(params), step, prism, hp)
    step = make_train_step(cfg, prism, hp, mesh=mesh, params=params)
    local, opt = shard_train_state(step.layout, params)
    return TrainRun(cfg, local, opt, step, prism, hp, mesh)


def save(run: TrainRun, dirpath: str, step: int) -> str | None:
    """The whole parameters saved in the reference's layout, so that
    either package restores them; over a mesh every rank gathers them
    (every rank calls it) and rank 0 writes.  -> the file written, None
    on the other ranks."""
    if run.mesh is None:
        return save_checkpoint(dirpath, step, to_jax_numpy(run.cfg,
                                                           run.params))
    whole = gather_train_state(run.step.layout, run.params)
    if run.mesh.rank != 0:
        return None
    return save_checkpoint(dirpath, step, to_jax_numpy(run.cfg, whole))


def corpus_batches(batch: int, seq: int):
    """The reference launcher's batches: (inputs, labels) int32 numpy."""
    tok = CharTokenizer()
    corpus = tok.encode(synthetic_text(500_000, seed=1))
    return lm_batches(corpus, batch=batch, seq=seq, seed=0)


def train(run: TrainRun, batches, steps: int, *, log_every: int = 10,
          log=print) -> list[dict]:
    """``steps`` steps from ``batches``; ``run.params`` and ``run.opt``
    advance.  Logs the reference's ``step`` lines; returns each step's
    metrics as floats."""
    history = []
    t0 = time.time()
    for i in range(steps):
        x, y = next(batches)
        run.params, run.opt, m = run.step(run.params, run.opt,
                                          {"tokens": x, "labels": y})
        history.append({k: float(v) for k, v in m.items()})
        if i % log_every == 0 or i == steps - 1:
            h = history[-1]
            log(f"step {i:5d}  loss {h['loss']:.4f}  gnorm {h['gnorm']:.3f}"
                f"  lr {h['lr']:.2e}  {(time.time() - t0):.1f}s")
    return history


def _mesh_main(mesh: Mesh, args: dict) -> list[dict]:
    """One rank of ``--mesh``: the seeded run on its block, rank 0
    logging; the checkpoint gathered and written by rank 0.  -> the
    metrics of each step."""
    run = setup(args["arch"], reduced=args["reduced"], mode=args["mode"],
                cr=args["cr"], lr=args["lr"], steps=args["steps"],
                seed=args["seed"], mesh=mesh)
    log = print if mesh.rank == 0 else (lambda line: None)
    log(f"[train] {run.cfg.name}: {run.cfg.n_layers}L d={run.cfg.d_model} "
        f"mesh={mesh.shape[0]}x{mesh.shape[1]} mode={args['mode']} "
        f"cr={args['cr']}")
    history = train(run, corpus_batches(args["batch"], args["seq"]),
                    args["steps"], log_every=args["log_every"], log=log)
    if args["checkpoint"]:
        path = save(run, args["checkpoint"], args["steps"])
        log(f"[train] saved {path}")
    log(f"[meter] rank 0 {mesh.coords}: bytes sent in all "
        f"{mesh.meter.snapshot()['sent']}")
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seq-shards", type=int, default=4,
                    help="P, the sequence shards (the reference's model "
                         "axis) folded into one process")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh of ranks, one process "
                         "each, in place of --seq-shards")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="[mesh] torch.distributed backend: gloo (any "
                         "number of ranks a card, or the CPU) or nccl "
                         "(one rank a card)")
    ap.add_argument("--mode", default="prism",
                    choices=("prism", "voltage", "single"))
    ap.add_argument("--cr", type=float, default=4.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None,
                    help="directory to save the final parameters in, in "
                         "the reference's layout")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.mesh is not None:
        if args.backend is None:
            ap.error("--mesh needs --backend gloo or nccl")
        data, model = (int(v) for v in args.mesh.split("x"))
        spawn(_mesh_main, data, model, backend=args.backend,
              device=args.device, timeout=TRAIN_TIMEOUT, args=(vars(args),))
        return
    run = setup(args.arch, reduced=args.reduced, seq_shards=args.seq_shards,
                mode=args.mode, cr=args.cr, lr=args.lr, steps=args.steps,
                device=args.device, seed=args.seed)
    cfg = run.cfg
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"seq_shards={args.seq_shards} mode={args.mode} cr={args.cr}")
    n_params = sum(t.numel() for t in tree_leaves(run.params))
    print(f"[train] {n_params / 1e6:.1f}M params")
    train(run, corpus_batches(args.batch, args.seq), args.steps,
          log_every=args.log_every)
    if args.checkpoint:
        # the reference's layout, so that either package restores it
        print(f"[train] saved {save(run, args.checkpoint, args.steps)}")


if __name__ == "__main__":
    main()
