"""Kernel-backend dispatch: one rule for every kernel call site.

Each hot op has two implementations, a hand-written CUDA kernel and a
plain PyTorch version.  Which one runs follows from the tensor and the
caller's ``backend``:

    backend = "auto"    -> the kernel for a CUDA tensor, the plain version
                           for a CPU tensor
    backend = "kernel"  -> the kernel; raises for a CPU tensor
    backend = "plain"   -> the plain version, always (tests and the
                           reference run of chip_smoke.py)

There is deliberately no environment override: nothing on the main
path can reach the plain version on a card except by passing
``backend="plain"``.

The kernels have no backward: a kernel's output has no ``grad_fn``.  So
a call that would go to a kernel while autograd records (grad mode on
and some input requiring grad) raises instead of silently cutting the
gradient; a training forward passes ``backend="plain"``.  Nothing falls
through to the plain version.

``LAUNCHES`` counts kernel launches by kernel name.  ``launch`` adds
one right after a kernel launched, and nowhere else, so a run can show
that the main path went through every kernel.  Every wrapper launches
through ``launch``, which makes the tensors' device the current one
around the call: the C entry points launch on the current device.
"""
from __future__ import annotations

import collections

import torch

from . import build

BACKENDS = ("auto", "kernel", "plain")

#: kernel name -> launches since the last reset
LAUNCHES: collections.Counter = collections.Counter()


def use_kernel(backend: str, t: torch.Tensor, *inputs) -> bool:
    """Whether the call on tensor ``t`` (and its other tensor ``inputs``)
    goes to the CUDA kernel; raises where a kernel would run under
    autograd."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "plain":
        return False
    if backend == "kernel" and not t.is_cuda:
        raise RuntimeError(
            f"backend='kernel' needs a CUDA tensor, got one on {t.device}")
    if t.is_cuda and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in (t, *inputs)):
        raise RuntimeError(
            "a CUDA kernel was called on tensors that require grad with "
            "grad mode on: the kernels have no backward, so the gradient "
            "through this call would be lost; pass backend='plain' for a "
            "forward that is differentiated")
    return t.is_cuda


def check_tensor(t: torch.Tensor, name: str, *,
                 dtype: torch.dtype | tuple[torch.dtype, ...], ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous tensor of
    ``dtype`` (or one of a tuple of dtypes) and rank ``ndim`` on the CUDA
    ``device``."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        want = " or ".join(str(d) for d in dtypes)
        raise TypeError(f"{name}: kernel takes {want}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes a CUDA tensor, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got one on {t.device}")


def raise_on_error(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch")


def launch(name: str, lib: str, entry: str, argtypes: list,
           device: torch.device, *args, counts: tuple = ()) -> None:
    """Call the C entry point ``entry`` of library ``lib`` with ``args``
    and the current stream of ``device``, with ``device`` made the
    current device for the call; raise if it returned an error, then
    count one launch under ``name`` and each of ``counts``."""
    fn = build.function(lib, entry, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
    for key in counts:
        LAUNCHES[key] += 1
