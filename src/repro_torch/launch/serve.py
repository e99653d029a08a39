"""Serving launcher on one card: a static batch (prefill + greedy
decode) or the continuous-batching engine on a seeded Poisson trace.

    # static batch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --batch 8 --prompt-len 512 --gen 64 --seq-shards 4 \
        --decode-mode exact

    # request-level engine (paged cache, packed ticks), Poisson arrivals
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --engine --requests 16 --rate 4 --batch 8 --prompt-len 512 \
        --gen 64

    # two priority classes over a short pool with the host offload tier,
    # under the seeded chaos plan (store losses, page poison, stalls,
    # tick delays, a shard loss)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --engine --requests 16 --rate 4 --batch 8 --prompt-len 512 \
        --gen 64 --offload --priority 2 --n-pages 144 --chaos 0

    # the streaming loop (tick N+1 dispatched before tick N's tokens are
    # home; --no-overlap for synchronous ticks, still streamed)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --engine --requests 16 --rate 4 --batch 8 --prompt-len 512 \
        --gen 64 --stream

    # the degraded-mesh drill: sequence shard 1 lost at the 6th tick
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --engine --requests 16 --rate 4 --batch 8 --prompt-len 512 \
        --gen 64 --shard-loss 1 --shard-loss-at 6

    # static-batching admission (the gang baseline); the padded flush
    ... --engine --gang
    ... --engine --prefill-mode padded

``--decode-mode exact`` pairs the voltage prefill (full exchange) with
exact split-K flash-decode; ``--decode-mode prism`` pairs the PRISM
prefill (Segment-Means exchange) with prism decode (the engine prefills
exactly in both modes and captures the means over real tokens);
``--prefill voltage --decode-mode prism`` is the third static pairing.

    # Gemma 3 1B (sliding-window local layers, 5:1 local:global): the
    # static path only (the engine refuses its ring caches); each of the
    # P shards must hold a window, so the prompt is at least P x 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 8 --prompt-len 2048 --gen 64 --seq-shards 4 \
        --decode-mode prism
    # Mixture-of-Experts (OLMoE-1B-7B: 64 experts top-8, 27.7 GB of f32
    # weights) and Gemma 7B (MHA at head dim 256, 34.2 GB): every path
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --batch 8 --prompt-len 512 --gen 64 --seq-shards 4 \
        --decode-mode prism
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        --engine --requests 16 --rate 4 --batch 8 --prompt-len 512 \
        --gen 64

    # PaliGemma 3B (a stub SigLIP image prefix of 256 embeddings over the
    # first prompt positions, attended bidirectionally): the static path
    # only (the engine and the tick programs take token prompts only);
    # Command-R 35B (the parallel attention + MLP block): every path, at
    # a depth the card holds (40 layers of f32 are 121 GB)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --batch 8 --prompt-len 512 --gen 64 --seq-shards 4 \
        --decode-mode prism
    PYTHONPATH=src python -m repro_torch.launch.serve --arch command-r-35b \
        --reduced --engine --device cpu --requests 6 --rate 50 --batch 4 \
        --prompt-len 32 --gen 6

    # MusicGen-medium (a stub EnCodec prompt: 512 seeded frame embeddings
    # through ``frontend_proj``, sinusoidal positions; 64 codes of 2048
    # generated) and xLSTM 1.3B (42 mLSTM and 6 sLSTM blocks, the state
    # handed across the shards): the static path only (the tick programs
    # and the engine refuse both)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch musicgen-medium --batch 8 --prompt-len 512 --gen 64 \
        --seq-shards 4 --decode-mode prism
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --batch 8 --prompt-len 512 --gen 64 --seq-shards 4

    # Zamba2 2.7B (45 Mamba2 blocks, the conv halo and the state handed
    # across the shards, and one shared attention + MLP block over 9
    # layers, 32 heads of 80): the static path only (the tick programs,
    # the paged cache and the engine refuse the Mamba2 state)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --batch 8 --prompt-len 512 --gen 64 --seq-shards 4 \
        --decode-mode prism

    # the paper's encoders classify a seeded batch over P sequence shards
    # (no decode, no engine): BERT-base on 512 token ids, ViT-B/16 on 197
    # stub patch embeddings, split 49/49/49/50 by Alg. 1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch bert-base \
        --batch 32 --seq-shards 4 --prefill prism --cr 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vit-b16 \
        --batch 64 --seq-shards 4 --prefill voltage

    # over a (data, model) mesh of ranks, one process each (the
    # reference's --mesh DxM): the batch over data where it divides, the
    # sequence over model (else over every axis), FSDP weights gathered
    # a layer at a time, a MoE layer's experts over model (all_to_all);
    # --decode-tp keeps the decode tensor-parallel (expert-TP over data
    # for experts).  Every decoder family serves: window layers, recurrent
    # blocks, an image prefix or frames.  gloo runs any number of ranks
    # on one card or on the CPU, nccl one rank a card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --reduced --batch 8 --prompt-len 64 --gen 6 --mesh 1x4 \
        --backend gloo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --reduced --batch 8 --prompt-len 64 --gen 6 --mesh 2x2 \
        --backend gloo --device cpu --decode-mode exact --prefill prism \
        --decode-tp
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --batch 8 --prompt-len 64 --gen 6 --mesh 1x4 \
        --backend gloo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 8 --prompt-len 2048 --gen 8 --mesh 1x4 --backend gloo \
        --decode-mode prism
    # the engine over the mesh: every rank runs the same scheduler on the
    # same logits, rank 0's clock; packed, chunked or padded, the paged
    # or dense cache, and every robustness layer: --stream, --offload,
    # --chaos, --shard-loss (a 'model' index), --gang
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --reduced --engine --requests 6 --rate 50 --batch 4 \
        --prompt-len 32 --gen 6 --mesh 2x2 --backend gloo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --reduced --engine --requests 6 --rate 50 --batch 4 \
        --prompt-len 32 --gen 6 --mesh 1x4 --backend gloo --device cpu \
        --shard-loss 1 --shard-loss-at 6

    # serve what a training run saved (the latest step of a checkpoint
    # directory in the reference's layout, as ``launch/train.py
    # --checkpoint`` writes it, alone or over a mesh)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --reduced --batch 2 --prompt-len 32 --gen 8 --device cpu \
        --checkpoint CKPT_DIR

Weights are random, drawn from ``torch.Generator`` seeded with
``--seed``, unless ``--checkpoint`` restores them; ``--reduced`` takes
the architecture's smoke-test size.  Runs on CUDA unless ``--device
cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..checkpoint.io import latest_step, restore_checkpoint
from ..configs import get_config
from ..convert import from_jax_numpy, to_jax_numpy
from ..core.protocol import PrismConfig, partition_bounds
from ..device import resolve_device
from ..models import transformer as T
from ..models.config import ModelConfig
from ..models.moe import RoutingLog
from ..models.transformer import is_encoder
from ..launch.mesh import MESH_TIMEOUT, spawn
from ..runtime.serve import (MeshParams, ServeHParams, ServeLayout, encode,
                             generate, make_layout, mesh_params, seq_shards)

# ViT-B/16's tokens: 14 x 14 patches of a 224-pixel image, plus CLS
VIT_TOKENS = 197


@dataclass
class StaticServe:
    """Everything one static-batch run needs."""
    cfg: ModelConfig
    params: dict
    prompts: torch.Tensor | None     # (B, n) int64; None: audio frames
    prism: PrismConfig
    lay: ServeLayout
    hp: ServeHParams
    gen: int
    # a vlm's image (B, prefix, D), an audio model's frames (B, n, D)
    embeds: torch.Tensor | None = None
    # a mesh rank's decode-TP cut of the weights (``mesh_rank``)
    decode_params: MeshParams | None = None

    def run(self, forced: torch.Tensor | None = None):
        """-> (tokens (B, gen), logits (gen, B, V), times)."""
        return generate(self.cfg, self.params, self.prompts, gen=self.gen,
                        prism=self.prism, lay=self.lay, hp=self.hp,
                        forced=forced, embeds=self.embeds,
                        decode_params=self.decode_params)


def restore_params(cfg: ModelConfig, params: dict, checkpoint: str) -> dict:
    """The latest step saved in ``checkpoint`` (the reference's layout,
    ``checkpoint.io``), in place of ``params``, on their device: the
    reference launcher's restore."""
    step = latest_step(checkpoint)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {checkpoint!r}")
    dev = next(iter(params["final_norm"].values())).device
    return from_jax_numpy(cfg, restore_checkpoint(
        checkpoint, step, to_jax_numpy(cfg, params)), device=dev)


def setup(arch: str = "gpt2-small", *, batch: int = 8, prompt_len: int = 64,
          gen: int = 16, seq_shards: int = 4, decode_mode: str = "exact",
          cr: float = 4.0, device: str = "cuda", seed: int = 0,
          backend: str = "auto", params: dict | None = None,
          reduced: bool = False, prefill: str | None = None,
          cap: int | None = None, n_layers: int | None = None,
          checkpoint: str | None = None) -> StaticServe:
    """Build a static-batch run: the prompt length is rounded down and
    the cache capacity (by default prompt + gen) up to multiples of the
    shard count, as the reference launcher does.  ``params`` reuses
    weights already built; ``n_layers`` keeps the first layers only;
    ``checkpoint`` restores the latest step saved in that directory
    (``restore_params``).
    ``prefill`` ('voltage' | 'prism') picks the prefill exchange; by
    default the decode mode's pairing (exact: voltage, prism: PRISM).  A
    vlm (PaliGemma) also gets stub image embeddings (B, prefix_len, D),
    a seeded ``torch.Generator`` normal, over its first prompt
    positions; an audio model (MusicGen) a prompt of stub frame
    embeddings (B, n, D) drawn the same way, and no token ids."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers,
                      blocks=cfg.block_kinds[:n_layers])
    n = prompt_len - prompt_len % seq_shards
    cap = n + gen if cap is None else cap
    cap += -cap % seq_shards
    hp = ServeHParams(decode_mode=decode_mode, means_cr=cr, backend=backend)
    if prefill is None:
        prefill = "prism" if decode_mode == "prism" else "voltage"
    prism = PrismConfig(P=seq_shards, cr=cr, mode=prefill)
    lay = make_layout(seq_shards, cap, hp, prefill_len=n)
    if params is None:
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    if checkpoint is not None:
        params = restore_params(cfg, params, checkpoint)
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(batch, n)), device=dev)
    embeds = None
    if cfg.arch_type == "audio":
        prompts = None
        embeds = torch.randn(batch, n, cfg.d_model, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(seed))
    elif cfg.arch_type == "vlm":
        if n < cfg.prefix_len:
            raise ValueError(f"{arch}: a prompt of {n} tokens cannot hold "
                             f"the image prefix of {cfg.prefix_len}")
        embeds = torch.randn(batch, cfg.prefix_len, cfg.d_model, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(seed))
    return StaticServe(cfg, params, prompts, prism, lay, hp, gen, embeds)


def mesh_rank(mesh, arch: str, *, batch: int, decode_tp: bool = False,
              forced: torch.Tensor | None = None,
              routing: RoutingLog | None = None, **opts) -> dict:
    """One rank of a static-batch run over ``mesh`` (``spawn``'s ``fn``):
    ``setup``'s run (``opts`` are its arguments) at the mesh's sequence
    shards on the rank's device, laid out over the mesh, its whole
    weights cut to the rank's shards (``mesh_params``; the decode-TP cut
    too with ``decode_tp``), then ``generate``.  ``forced`` (B, gen - 1)
    teacher-forces the decoded tokens; ``routing`` (checks only) records
    or replays a MoE model's routing.  -> the rank's tokens (B_loc, gen)
    and logits (gen, B_loc, V) on its device, its times, its meter, its
    coordinates and the layout."""
    run = setup(arch, batch=batch, seq_shards=seq_shards(mesh, batch),
                device=mesh.device, **opts)
    hp = replace(run.hp, decode_tp=decode_tp, routing=routing)
    lay = make_layout(mesh, run.lay.cap, hp,
                      prefill_len=run.lay.prefill_len, batch=batch)
    mp = mesh_params(run.cfg, run.params, mesh)
    dp = (mesh_params(run.cfg, run.params, mesh, decode_tp=True)
          if decode_tp else None)
    run = replace(run, params=mp, lay=lay, hp=hp, decode_params=dp)
    mesh.meter.reset()
    tokens, logits, times = run.run(forced)
    return {"tokens": tokens, "logits": logits, "times": times,
            "meter": mesh.meter.snapshot(), "coords": mesh.coords,
            "lay": lay, "mp": mp, "dp": dp}


def _mesh_rank_report(mesh, args: dict) -> dict:
    """``mesh_rank`` for the launcher: what the parent prints, on the
    host."""
    out = mesh_rank(mesh, **args)
    return {"tokens": out["tokens"].cpu(), "times": out["times"],
            "meter": out["meter"], "coords": out["coords"],
            "lay": out["lay"]}


def run_mesh(args) -> None:
    """``--mesh DxM``: one rank a mesh position (``launch/mesh.py::
    spawn``); rank 0's tokens and times printed, and every rank's
    meter."""
    data, model = (int(v) for v in args.mesh.split("x"))
    opts = dict(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, decode_mode=args.decode_mode,
                prefill=args.prefill, cr=args.cr, seed=args.seed,
                reduced=args.reduced, decode_tp=args.decode_tp,
                checkpoint=args.checkpoint)
    ranks = spawn(_mesh_rank_report, data, model, backend=args.backend,
                  device=args.device, timeout=MESH_TIMEOUT, args=(opts,))
    first = ranks[0]
    lay, times = first["lay"], first["times"]
    print(f"[serve] {args.arch} on a {data}x{model} mesh of {args.backend} "
          f"ranks ({args.device}): batch over {lay.ba or 'none'}, sequence "
          f"over {lay.seq_axes} (P={lay.n_seq}); rank 0: prefill "
          f"{times['prefill_ms']:.2f} ms, decode "
          f"{times['decode_ms_per_token']:.3f} ms/token ({times['clock']})")
    print("[serve] rank 0's generated token ids (first 2 rows):")
    print(first["tokens"][:2].numpy())
    for r, res in enumerate(ranks):
        print(f"[meter] rank {r} {res['coords']}: bytes sent "
              f"{res['meter']['sent']}")


@dataclass
class EncodeRun:
    """Everything one encoder classification run needs: token ids, or a
    stub frontend's embeddings."""
    cfg: ModelConfig
    params: dict
    tokens: torch.Tensor | None      # (B, N) int64
    embeds: torch.Tensor | None      # (B, N, D) f32
    prism: PrismConfig
    n_shards: int
    hp: ServeHParams

    def run(self):
        """-> (classes (B,), logits (B, num_classes) f32, times):
        ``times['encode_ms']`` from CUDA events on a card, from the host
        clock on the CPU (``times['clock']``)."""
        x = self.tokens if self.tokens is not None else self.embeds
        if x.is_cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            t0 = time.perf_counter()
        logits = encode(self.cfg, self.params, self.tokens,
                        embeds=self.embeds, prism=self.prism,
                        n_shards=self.n_shards, hp=self.hp)
        if x.is_cuda:
            ev[1].record()
            torch.cuda.synchronize(x.device)
            ms, clock = ev[0].elapsed_time(ev[1]), "cuda_events"
        else:
            ms, clock = 1e3 * (time.perf_counter() - t0), "host"
        return logits.argmax(dim=-1), logits, {"encode_ms": ms,
                                               "clock": clock}


def default_len(cfg: ModelConfig) -> int:
    """An encoder's sequence length: ViT's 197 tokens for a patch
    frontend, else its position table's (BERT's 512)."""
    return VIT_TOKENS if cfg.frontend else cfg.max_seq


def setup_encoder(arch: str, *, batch: int = 8, n: int | None = None,
                  seq_shards: int = 4, prefill: str = "voltage",
                  cr: float = 4.0, device: str = "cuda", seed: int = 0,
                  backend: str = "auto", params: dict | None = None,
                  reduced: bool = False) -> EncodeRun:
    """Build an encoder run on a seeded batch of ``n`` tokens (default
    ``default_len`` of the full config): token ids from
    ``np.random.default_rng(seed)``, or for a frontend model embeddings
    from a seeded ``torch.Generator`` normal.  ``n`` need not be a
    multiple of ``seq_shards`` (Alg. 1's uneven split).  ``params``
    reuses weights already built."""
    dev = resolve_device(device)
    full = get_config(arch)
    cfg = full.reduced() if reduced else full
    n = default_len(full) if n is None else n
    if params is None:
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    tokens = embeds = None
    if cfg.frontend:
        embeds = torch.randn(batch, n, cfg.d_model, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(seed))
    else:
        tokens = torch.as_tensor(np.random.default_rng(seed).integers(
            1, cfg.vocab_size, size=(batch, n)), device=dev)
    return EncodeRun(cfg, params, tokens, embeds,
                     PrismConfig(P=seq_shards, cr=cr, mode=prefill),
                     seq_shards, ServeHParams(backend=backend))


def run_encoder(args) -> None:
    """An encoder (``--arch bert-base|vit-b16``): one classification of
    a seeded batch; prints the classes and the time."""
    run = setup_encoder(args.arch, batch=args.batch, n=args.prompt_len,
                        seq_shards=args.seq_shards,
                        prefill=args.prefill or "voltage", cr=args.cr,
                        device=args.device, seed=args.seed,
                        reduced=args.reduced)
    classes, logits, times = run.run()
    x = run.tokens if run.tokens is not None else run.embeds
    b, n = x.shape[:2]
    split = "/".join(str(size)
                     for _, size in partition_bounds(n, run.n_shards))
    what = ("L " + str(run.prism.landmarks(n)) if run.prism.mode == "prism"
            else "full exchange")
    print(f"[encode] {run.cfg.name} {run.prism.mode} ({what}): {b}x{n} "
          f"over shards of {split} tokens, {times['encode_ms']:.2f} ms "
          f"({times['clock']})")
    print(f"[encode] classes of {run.cfg.num_classes} (first 16 rows): "
          f"{classes[:16].cpu().tolist()}")


def poisson_trace(n_requests: int, rate: float, prefill_len: int,
                  vocab: int, seed: int = 0, classes: int = 1):
    """A seeded Poisson trace: (arrival s, prompt, priority) per request,
    prompt lengths drawn from [prefill_len // 2, prefill_len] and
    priorities from [0, classes), as the reference's launcher draws
    them."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    trace = []
    for i in range(n_requests):
        plen = int(rng.integers(max(1, prefill_len // 2), prefill_len + 1))
        prompt = rng.integers(1, vocab, size=plen).tolist()
        trace.append((float(arrivals[i]), prompt,
                      int(rng.integers(0, max(1, classes)))))
    return trace


def fault_plan(chaos, shard_loss, shard_loss_at):
    """The launcher's fault plan: ``FaultPlan.chaos(chaos)`` (every kind),
    with ``shard_loss`` pinned to shard ``shard_loss`` at its
    ``shard_loss_at``-th opportunity when that is given; None without
    either."""
    from ..serving import FaultPlan, FaultSpec
    if shard_loss is None:
        return FaultPlan.chaos(chaos) if chaos is not None else None
    spec = FaultSpec(at=(shard_loss_at,), shard=shard_loss)
    return (FaultPlan(shard_loss=spec) if chaos is None
            else FaultPlan.chaos(chaos, shard_loss=spec))


def engine_setup(args, device, p: int):
    """The run of ``--engine`` over ``p`` sequence shards on ``device``:
    (config, seeded weights, engine config, the seeded Poisson trace's
    requests as ``submit``'s keywords)."""
    from ..serving import EngineConfig, SamplingParams
    faults = fault_plan(args.chaos, args.shard_loss, args.shard_loss_at)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    n = args.prompt_len - args.prompt_len % p
    cap = n + args.gen                 # as the reference launcher does
    cap += -cap % p
    hp = ServeHParams(decode_mode=args.decode_mode, means_cr=args.cr)
    params = T.init(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    if args.checkpoint is not None:
        params = restore_params(cfg, params, args.checkpoint)
    ecfg = EngineConfig(
        n_slots=args.batch, prefill_len=n, max_cache=cap, hp=hp,
        gang=args.gang, chunk_len=args.chunk_len,
        prefill_mode=args.prefill_mode,
        token_budget=args.token_budget, paged=not args.no_paged,
        page_tokens=args.page_tokens, n_pages=args.n_pages,
        prefix_cache=False if args.no_prefix_cache else None,
        offload=args.offload, faults=faults,
        max_restarts=8 if faults is not None else 3)
    reqs = [dict(prompt=prompt, max_new_tokens=args.gen, arrival=t,
                 priority=prio,
                 sampling=SamplingParams(temperature=args.temperature,
                                         top_k=args.top_k, seed=i))
            for i, (t, prompt, prio) in enumerate(poisson_trace(
                args.requests, args.rate, n, cfg.vocab_size, args.seed,
                args.priority))]
    return cfg, params, ecfg, reqs


def _engine_line(args, cfg, eng, dev, extras="") -> str:
    cache = "paged" if eng.kv_cache.paged else "dense"
    admission = "gang (static)" if args.gang else "continuous"
    return (f"[engine] {cfg.name} {args.decode_mode}, {args.requests} "
            f"requests, Poisson rate {args.rate}/s, {args.batch} slots, "
            f"{admission} admission, {args.prefill_mode} prefill, {cache} "
            f"cache{extras}, on {dev}")


def _print_stats(stats: dict) -> None:
    for k, v in stats.items():
        print(f"[engine] {k:22s} {v:.3f}" if isinstance(v, float)
              else f"[engine] {k:22s} {v}")


def _engine_extras(args) -> str:
    extras = (f", {args.priority} priority classes"
              if args.priority > 1 else "")
    extras += ", host offload" if args.offload else ""
    extras += f", chaos seed {args.chaos}" if args.chaos is not None else ""
    extras += (f", shard {args.shard_loss} lost at tick "
               f"{args.shard_loss_at}" if args.shard_loss is not None
               else "")
    extras += (", streaming" + (" (overlap off)" if args.no_overlap
                                else " (overlap)") if args.stream else "")
    return extras


def serve_trace(eng, args, reqs) -> list:
    """The trace through ``eng``: the streaming loop's asyncio front-end
    under ``--stream`` (the lines it prints returned), else ``run``."""
    from ..serving import StreamingEngine, serve_stream
    if not args.stream:
        for kw in reqs:
            eng.submit(**kw)
        eng.run()
        return []
    import asyncio
    seng = StreamingEngine(eng, overlap=not args.no_overlap)
    got = asyncio.run(serve_stream(seng, reqs))
    fins = {}
    for g in got.values():
        fins[g["finished"]] = fins.get(g["finished"], 0) + 1
    lines = [f"[stream] {len(got)} streams closed: "
             + ", ".join(f"{k}={v}" for k, v in sorted(fins.items()))]
    itl = [dt for ds in seng.itl_samples().values() for dt in ds]
    if itl:
        lines.append(f"[stream] itl_p50_s {float(np.percentile(itl, 50)):.4f}"
                     f"  itl_p99_s {float(np.percentile(itl, 99)):.4f}")
    return lines


def audit_engine(eng, args) -> list:
    """Under a fault plan: every request finished or failed, the refcounts
    hold, no slot holds pages, the store is empty, every slot is free
    (raises otherwise); the lines to print."""
    if eng.config.faults is None:
        return []
    inj = eng._injector.stats()
    done, failed = len(eng.results()), eng.failed()
    lines = [f"[chaos] injected {inj['injected']} over {inj['ops']} "
             "opportunities",
             f"[chaos] completed {done}/{args.requests}, failed "
             f"{len(failed)} {sorted(failed.values())}"]
    assert done + len(failed) == args.requests, (done, failed)
    kv = eng.kv_cache
    kv.check()
    assert not kv.slot_pages and not kv.slot_state
    if eng.kv_store is not None:
        assert len(eng.kv_store) == 0, eng.kv_store.stats()
    assert sorted(eng._sched.free_slots) == list(range(args.batch))
    lines.append("[chaos] zero-leak audits OK")
    if args.shard_loss is not None:
        s = eng.stats
        rep = eng._replica.stats() if eng._replica is not None else {}
        lines.append(f"[degraded] shard_lost {s.shard_lost} degraded_ticks "
                     f"{s.degraded_ticks} restarts {s.restarts} "
                     f"replica_captures {rep.get('captures', 0)}")
        assert s.shard_lost >= 1, "shard_loss never fired"
    return lines


def run_engine(args) -> None:
    """``--engine``: the continuous-batching engine over a Poisson trace;
    prints the engine's stats summary and, under ``--chaos`` or
    ``--shard-loss``, checks that every request finished or failed and
    that nothing leaked."""
    from ..serving import ServingEngine
    dev = resolve_device(args.device)
    cfg, params, ecfg, reqs = engine_setup(args, dev, args.seq_shards)
    eng = ServingEngine(cfg, params, ecfg, n_seq=args.seq_shards)
    print(_engine_line(args, cfg, eng, dev, _engine_extras(args)))
    for line in serve_trace(eng, args, reqs):
        print(line)
    _print_stats({**eng.stats.summary(), **eng.kv_cache.stats()})
    for line in audit_engine(eng, args):
        print(line)


#: the robustness counters ``--engine --mesh`` prints of rank 0
ROBUST_STATS = ("preemptions", "restore_hits", "faults_injected",
                "shard_lost", "degraded_ticks")


def _mesh_engine_rank(mesh, args) -> dict:
    """One rank of ``--engine --mesh``: ``engine_setup``'s run on the
    rank's device, its weights cut to the rank's shards, the trace
    through the SPMD engine (the streaming loop under ``--stream``),
    audited under a fault plan -> its tokens by request, stats, the
    engine's digest of its host decisions, meter, coordinates and the
    lines to print, on the host."""
    from ..serving import ServingEngine
    cfg, params, ecfg, reqs = engine_setup(args, mesh.device,
                                           seq_shards(mesh, args.batch))
    eng = ServingEngine(cfg, mesh_params(cfg, params, mesh), ecfg)
    del params
    mesh.meter.reset()
    lines = serve_trace(eng, args, reqs)
    lines += audit_engine(eng, args)
    return {"results": eng.results(), "meter": mesh.meter.snapshot(),
            "stats": {**eng.stats.summary(), **eng.kv_cache.stats()},
            "trail": eng.trail, "coords": mesh.coords, "lay": eng.layout,
            "lines": lines, "line": _engine_line(args, cfg, eng, mesh.device,
                                                 _engine_extras(args))}


def run_mesh_engine(args) -> None:
    """``--engine --mesh DxM``: the engine on every rank of the mesh; the
    ranks' host decisions (``ServingEngine.trail``), then their tokens,
    must be equal; rank 0's stats and robustness counters printed, and
    every rank's meter."""
    data, model = (int(v) for v in args.mesh.split("x"))
    ranks = spawn(_mesh_engine_rank, data, model, backend=args.backend,
                  device=args.device, timeout=MESH_TIMEOUT, args=(args,))
    first = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        if res["trail"] != first["trail"]:
            raise RuntimeError(f"rank {r}'s host decisions differ from rank "
                               "0's")
        if res["results"] != first["results"]:
            raise RuntimeError(f"rank {r}'s tokens differ from rank 0's")
    lay = first["lay"]
    print(f"{first['line']}, over a {data}x{model} mesh of {args.backend} "
          f"ranks: batch over {lay.ba or 'none'}, sequence over "
          f"{lay.seq_axes} (P={lay.n_seq}); every rank's tokens equal")
    for line in first["lines"]:
        print(line)
    _print_stats(first["stats"])
    print("[robust] rank 0: " + ", ".join(
        f"{k} {first['stats'][k]}" for k in ROBUST_STATS))
    for r, res in enumerate(ranks):
        print(f"[meter] rank {r} {res['coords']}: bytes sent "
              f"{res['meter']['sent']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's smoke-test size")
    ap.add_argument("--batch", type=int, default=8,
                    help="static batch size / engine slot count")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="static prompt length / engine prefill length "
                         "(default 64); an encoder's tokens (default: "
                         "BERT 512, ViT 197)")
    ap.add_argument("--gen", type=int, default=None,
                    help="tokens generated per sequence / request "
                         "(default 16; an encoder generates none)")
    ap.add_argument("--seq-shards", type=int, default=4,
                    help="sequence shards folded into one process")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="[static, engine] a (data, model) mesh of ranks, "
                         "one process each, in place of --seq-shards")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="[mesh] torch.distributed backend: gloo (any "
                         "number of ranks a card, or the CPU) or nccl "
                         "(one rank a card)")
    ap.add_argument("--decode-tp", action="store_true",
                    help="[mesh] tensor-parallel decode over the model "
                         "axis, expert-TP over data (exact decode)")
    ap.add_argument("--decode-mode", default="exact",
                    choices=("exact", "prism"))
    ap.add_argument("--prefill", default=None,
                    choices=("voltage", "prism"),
                    help="[static, encoder] the prefill exchange "
                         "(default: voltage for exact decode and for an "
                         "encoder, prism for prism decode)")
    ap.add_argument("--cr", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="[decoders] serve the latest step saved in DIR "
                         "(the reference's layout) in place of the seeded "
                         "weights")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine over a Poisson trace")
    ap.add_argument("--requests", type=int, default=32,
                    help="[engine] number of requests in the trace")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="[engine] Poisson arrival rate, requests/s")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--gang", action="store_true",
                    help="[engine] static-batching admission (the "
                         "baseline): a full gang into an empty pool")
    ap.add_argument("--prefill-mode", default="packed",
                    choices=("packed", "chunked", "padded"),
                    help="[engine] token-packed ticks (default), chunked "
                         "prefill, or the padded admission flush (dense "
                         "cache)")
    ap.add_argument("--chunk-len", type=int, default=64,
                    help="[engine] prefill chunk size (clamped to the "
                         "prefill length)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="[engine, packed] tokens per packed tick "
                         "(default: slots + chunk-len)")
    ap.add_argument("--no-paged", action="store_true",
                    help="[engine] dense slot-row cache instead of the "
                         "paged pool")
    ap.add_argument("--page-tokens", type=int, default=None,
                    help="[engine, paged] page size in token positions "
                         "(default: derived, about 16)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="[engine, paged] pool pages (default: memory "
                         "parity with the dense rows)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="[engine, paged] no shared-prefix reuse (on by "
                         "default in exact decode mode)")
    ap.add_argument("--offload", action="store_true",
                    help="[engine, paged] host KV offload tier: blocked "
                         "higher-priority requests preempt lower-priority "
                         "work (spilled to host memory, restored on "
                         "resume)")
    ap.add_argument("--priority", type=int, default=1, metavar="CLASSES",
                    help="[engine] priority classes in the trace: each "
                         "request draws one from [0, CLASSES) (higher = "
                         "more urgent; 1 = plain FIFO)")
    ap.add_argument("--stream", action="store_true",
                    help="[engine] the streaming front-end: tokens stream "
                         "per request while the double-buffered loop "
                         "overlaps host and device work")
    ap.add_argument("--no-overlap", action="store_true",
                    help="[engine, stream] synchronous ticks, tokens still "
                         "streamed: the baseline of the overlap")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="[engine] seeded fault injection: the trace under "
                         "FaultPlan.chaos(SEED) (store put and get loss, "
                         "page poison, admission stalls, tick delays, "
                         "shard loss), then zero-leak audits")
    ap.add_argument("--shard-loss", type=int, default=None,
                    metavar="SHARD",
                    help="[engine] the degraded-mesh drill: sequence shard "
                         "SHARD's K/V lost mid-trace (a scheduled "
                         "shard_loss fault); decoding requests go on "
                         "through the Segment-Means standby replicas, then "
                         "are prefilled again; audited as --chaos is")
    ap.add_argument("--shard-loss-at", type=int, default=6, metavar="N",
                    help="[engine] shard_loss fires at the Nth "
                         "opportunity (an engine tick with work; default "
                         "6)")
    args = ap.parse_args(argv)
    if is_encoder(get_config(args.arch)):
        if args.engine or args.gen is not None or args.checkpoint:
            ap.error(f"{args.arch} is an encoder: it classifies, with no "
                     "--engine, no --gen and no --checkpoint")
        run_encoder(args)
        return
    args.prompt_len = 64 if args.prompt_len is None else args.prompt_len
    args.gen = 16 if args.gen is None else args.gen
    if args.mesh is not None:
        if args.backend is None:
            ap.error("--mesh needs --backend gloo or nccl")
        if not args.engine:
            run_mesh(args)
            return
        run_mesh_engine(args)
        return
    if args.decode_tp:
        ap.error("--decode-tp takes a --mesh")
    if args.engine:
        run_engine(args)
        return
    run = setup(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seq_shards=args.seq_shards,
                decode_mode=args.decode_mode, cr=args.cr,
                device=args.device, seed=args.seed, reduced=args.reduced,
                prefill=args.prefill, checkpoint=args.checkpoint)
    tokens, _, times = run.run()
    b, n = tokens.shape[0], run.lay.prefill_len
    image = ("" if run.embeds is None
             else f" (frames {run.embeds.shape[1]})" if run.prompts is None
             else f" (image prefix {run.embeds.shape[1]})")
    print(f"[serve] {run.cfg.name} {run.prism.mode}+{args.decode_mode}: "
          f"prefill {b}x{n}{image} "
          f"{times['prefill_ms']:.2f} ms, decode "
          f"{times['decode_ms_per_token']:.3f} ms/token over "
          f"{args.gen - 1} steps ({times['clock']})")
    print("[serve] generated token ids (first 2 rows):")
    print(tokens[:2].cpu().numpy())


if __name__ == "__main__":
    main()
