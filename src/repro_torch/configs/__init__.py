"""Architecture registry: ``get_config("<arch-id>")`` for the
architectures the port runs so far."""
from __future__ import annotations

import importlib

# arch-id -> module name
_REGISTRY = {
    "gpt2-small": "gpt2_small",
}


def get_config(arch: str):
    if arch not in _REGISTRY:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet; "
            f"ported: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG
