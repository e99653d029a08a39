"""Architecture registry: ``get_config("<arch-id>")`` for the
architectures the port runs so far."""
from __future__ import annotations

import importlib

# arch-id -> module name
_REGISTRY = {
    "gpt2-small": "gpt2_small",
    "yi-6b": "yi_6b",
    "gemma3-1b": "gemma3_1b",
    "gemma-7b": "gemma_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    # a stub SigLIP image prefix, attended bidirectionally
    "paligemma-3b": "paligemma_3b",
    # the parallel attention + MLP block
    "command-r-35b": "command_r_35b",
    # a stub EnCodec frame prompt, sinusoidal positions
    "musicgen-medium": "musicgen_medium",
    # mLSTM and sLSTM blocks (7:1), the state handed across shards
    "xlstm-1.3b": "xlstm_1_3b",
    # Mamba2 blocks (the conv halo and the state handed across shards)
    # and one shared attention + MLP block over every 6th layer
    "zamba2-2.7b": "zamba2_2_7b",
    # 480 B parameters fit on no card: served at its reduced size only
    "arctic-480b": "arctic_480b",
    # the paper's encoders: classification over sequence shards, no decode
    "bert-base": "bert_base",
    "vit-b16": "vit_b16",
}


def get_config(arch: str):
    if arch not in _REGISTRY:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet; "
            f"ported: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG
