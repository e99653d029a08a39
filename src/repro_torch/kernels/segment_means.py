"""Segment Means reduction (paper Alg. 2): the CUDA kernel
(``csrc/segment_means.cu``) and its plain PyTorch version.

``segment_means_op`` routes a CUDA tensor to the kernel and a CPU tensor
to the plain version (``kernels.dispatch``).  The Eq. 8 ragged tail
(N_p % L != 0: L-1 even segments plus an oversized last one) is handled
inside the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import LAUNCHES, check_tensor, raise_on_error, use_kernel
from ..core.segment_means import segment_means as segment_means_plain

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def segment_means_cuda(x: torch.Tensor, L: int) -> torch.Tensor:
    """x (B, N_p, D) f32 on a card -> (B, L, D) f32 segment means."""
    check_tensor(x, "x", dtype=torch.float32, ndim=3, device=x.device)
    b, n, d = x.shape
    if not 1 <= L <= n:
        raise ValueError(f"need 1 <= L <= N_p, got L={L}, N_p={n}")
    out = torch.empty((b, L, d), dtype=torch.float32, device=x.device)
    fn = build.function("segment_means", "segment_means_f32", _ARGTYPES)
    rc = fn(x.data_ptr(), out.data_ptr(), b, n, L, d,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(rc, "segment_means")
    LAUNCHES["segment_means"] += 1
    return out


def segment_means_op(x: torch.Tensor, *, L: int,
                     backend: str = "auto") -> torch.Tensor:
    """x (B, N_p, D) -> (B, L, D) segment means, any 1 <= L <= N_p."""
    if use_kernel(backend, x):
        return segment_means_cuda(x, L)
    return segment_means_plain(x, L)
