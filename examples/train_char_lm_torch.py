"""End-to-end example, the PyTorch port: train a char-LM with the
PRISM-sharded train step over a (data, model) mesh of ranks (sequence
parallelism over ``model``, FSDP over ``data`` and ``model``, the
Segment-Means exchange a block), then evaluate the held-out bpc.

    PYTHONPATH=src python examples/train_char_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_char_lm_torch.py --device cpu \
        --steps 20 --layers 2 --d-model 64 --seq 64 --batch 4

Every mesh position is one process (``launch/mesh.py::spawn``) over the
``gloo`` backend, which runs any number of ranks on one card or on the
CPU; every rank draws the same seeded weights and batches and keeps its
block.  The default model (6 layers, d 384, about 11M parameters) is the
JAX example's; ``--d-model`` and ``--layers`` scale it.  Without a card
``--device cuda`` (the default) raises.
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def char_lm_config(layers: int, d_model: int, vocab: int):
    """The JAX example's char-LM: SwiGLU, RMSNorm, RoPE, tied embeddings,
    8 heads over 4 KV heads."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name="char-lm", arch_type="dense", n_layers=layers,
        d_model=d_model, n_heads=8, n_kv_heads=4, head_dim=d_model // 8,
        d_ff=4 * d_model, vocab_size=vocab, mlp_kind="swiglu",
        norm_kind="rmsnorm", pos="rope", tie_embeddings=True)


def rank(mesh, args: dict) -> list:
    """One rank: the steps, then the held-out loss through the step (the
    loss is computed before the update, so it is a clean evaluation);
    rank 0 logs.  -> the held-out losses."""
    import torch
    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.convert import to_jax_numpy
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.data.pipeline import (CharTokenizer, lm_batches,
                                           synthetic_text)
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train import (TrainHParams, gather_train_state,
                                           make_train_step, shard_train_state)
    torch.set_num_threads(1)
    log = print if mesh.rank == 0 else (lambda *a: None)
    tok = CharTokenizer()
    corpus = tok.encode(synthetic_text(1_000_000, seed=1))
    held = tok.encode(synthetic_text(50_000, seed=2))
    cfg = char_lm_config(args["layers"], args["d_model"], tok.vocab)
    params = T.init(cfg, torch.Generator(device=mesh.device).manual_seed(0),
                    mesh.device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"model: {n_params / 1e6:.1f}M params, mesh {args['mesh']}, "
        f"mode={args['mode']} CR={args['cr']}")
    prism = PrismConfig(P=mesh.size(("model",)), cr=args["cr"],
                        mode=args["mode"])
    hp = TrainHParams(lr=1e-3, warmup=20, total_steps=args["steps"],
                      loss_chunks=8)
    step = make_train_step(cfg, prism, hp, mesh=mesh, params=params)
    p, opt = shard_train_state(step.layout, params)
    del params
    it = lm_batches(corpus, batch=args["batch"], seq=args["seq"], seed=0)
    t0 = time.time()
    for i in range(args["steps"]):
        x, y = next(it)
        p, opt, m = step(p, opt, {"tokens": x, "labels": y})
        if i % 25 == 0 or i == args["steps"] - 1:
            loss = float(m["loss"])
            log(f"step {i:4d}  loss {loss:.4f}  bpc {loss / math.log(2):.3f}"
                f"  gnorm {float(m['gnorm']):.2f}  {time.time() - t0:.0f}s")
    ev = lm_batches(held, batch=args["batch"], seq=args["seq"], seed=9)
    losses = []
    for _ in range(args["eval_batches"]):
        x, y = next(ev)
        p, opt, m = step(p, opt, {"tokens": x, "labels": y})
        losses.append(float(m["loss"]))
    log(f"held-out bpc ≈ {sum(losses) / len(losses) / math.log(2):.3f} "
        f"({args['mode']}, CR={args['cr']})")
    if args["ckpt_dir"]:
        # the whole parameters, gathered, in the reference's layout
        whole = gather_train_state(step.layout, p)
        if mesh.rank == 0:
            log("saved:", save_checkpoint(args["ckpt_dir"], args["steps"],
                                          to_jax_numpy(cfg, whole)))
    return losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--cr", type=float, default=4.0)
    ap.add_argument("--mode", default="prism", choices=("prism", "voltage"))
    ap.add_argument("--mesh", default="2x4", metavar="DxM")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--eval-batches", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import TRAIN_TIMEOUT
    data, model = (int(v) for v in args.mesh.split("x"))
    losses = spawn(rank, data, model, backend="gloo", device=args.device,
                   timeout=TRAIN_TIMEOUT, args=(vars(args),))
    # every rank reports the same metrics
    assert all(r == losses[0] for r in losses)


if __name__ == "__main__":
    main()
