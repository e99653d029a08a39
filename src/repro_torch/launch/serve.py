"""Static-batch serving launcher: prefill + greedy decode on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --batch 8 --prompt-len 512 --gen 64 --seq-shards 4 \
        --decode-mode exact

``--decode-mode exact`` pairs the voltage prefill (full exchange) with
exact split-K flash-decode; ``--decode-mode prism`` pairs the PRISM
prefill (Segment-Means exchange) with prism decode.  Weights are random,
drawn from ``torch.Generator`` seeded with ``--seed``.  Runs on CUDA
unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..configs import get_config
from ..core.protocol import PrismConfig
from ..device import resolve_device
from ..models import transformer as T
from ..models.config import ModelConfig
from ..runtime.serve import (ServeHParams, ServeLayout, generate,
                             make_layout)


@dataclass
class StaticServe:
    """Everything one static-batch run needs."""
    cfg: ModelConfig
    params: dict
    prompts: torch.Tensor            # (B, n) int64
    prism: PrismConfig
    lay: ServeLayout
    hp: ServeHParams
    gen: int

    def run(self, forced: torch.Tensor | None = None):
        """-> (tokens (B, gen), logits (gen, B, V), times)."""
        return generate(self.cfg, self.params, self.prompts, gen=self.gen,
                        prism=self.prism, lay=self.lay, hp=self.hp,
                        forced=forced)


def setup(arch: str = "gpt2-small", *, batch: int = 8, prompt_len: int = 64,
          gen: int = 16, seq_shards: int = 4, decode_mode: str = "exact",
          cr: float = 4.0, device: str = "cuda", seed: int = 0,
          backend: str = "auto", params: dict | None = None) -> StaticServe:
    """Build a static-batch run: the prompt length is rounded down and
    the cache capacity up to multiples of the shard count, as the
    reference launcher does.  ``params`` reuses weights already built."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    n = prompt_len - prompt_len % seq_shards
    cap = n + gen + (-(n + gen)) % seq_shards
    hp = ServeHParams(decode_mode=decode_mode, means_cr=cr, backend=backend)
    prism = PrismConfig(P=seq_shards, cr=cr,
                        mode="prism" if decode_mode == "prism"
                        else "voltage")
    lay = make_layout(seq_shards, cap, hp, prefill_len=n)
    if params is None:
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(batch, n)), device=dev)
    return StaticServe(cfg, params, prompts, prism, lay, hp, gen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seq-shards", type=int, default=4)
    ap.add_argument("--decode-mode", default="exact",
                    choices=("exact", "prism"))
    ap.add_argument("--cr", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run = setup(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seq_shards=args.seq_shards,
                decode_mode=args.decode_mode, cr=args.cr,
                device=args.device, seed=args.seed)
    tokens, _, times = run.run()
    b, n = run.prompts.shape
    print(f"[serve] {run.cfg.name} {args.decode_mode}: prefill {b}x{n} "
          f"{times['prefill_ms']:.2f} ms, decode "
          f"{times['decode_ms_per_token']:.3f} ms/token over "
          f"{args.gen - 1} steps ({times['clock']})")
    print("[serve] generated token ids (first 2 rows):")
    print(tokens[:2].cpu().numpy())


if __name__ == "__main__":
    main()
