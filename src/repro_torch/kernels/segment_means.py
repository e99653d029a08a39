"""Segment Means reduction (paper Alg. 2) and the PRISM augment built on
it: the CUDA kernel (``csrc/segment_means.cu``) and its plain PyTorch
versions.

``segment_means_op`` (B, N_p, D) -> (B, L, D) and ``prism_augment_op``
(B·P, n_loc, D) -> (B·P, n_loc + P·L, D) route a CUDA tensor to the
kernel and a CPU tensor to the plain version (``kernels.dispatch``).
Both take f32 and bf16, sum in f32 and return x's dtype.  The Eq. 8
ragged tail (N_p % L != 0: L-1 even segments plus an oversized last one)
is handled inside the kernel, and so is Alg. 1's uneven split in the
augment (every shard but the last holds ``n_real`` real rows, padded to
the last one's).  A launch of either entry counts as ``segment_means``
in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from .dispatch import check_tensor, launch, use_kernel
from ..core.segment_means import segment_means as segment_means_plain

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT = ctypes.c_int
_PTR = ctypes.c_void_p
_MEANS_ARGS = [_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR]
_AUGMENT_ARGS = [_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR]


def _check(x: torch.Tensor, L: int) -> tuple[int, int, int]:
    check_tensor(x, "x", dtype=tuple(DTYPES), ndim=3, device=x.device)
    b, n, d = x.shape
    if not 1 <= L <= n:
        raise ValueError(f"need 1 <= L <= N_p, got L={L}, N_p={n}")
    return b, n, d


def _launch(entry: str, argtypes: list, x: torch.Tensor, *args) -> None:
    launch("segment_means", "segment_means", entry, argtypes, x.device,
           *args)


def segment_means_cuda(x: torch.Tensor, L: int) -> torch.Tensor:
    """x (B, N_p, D) f32 or bf16 on a card -> (B, L, D) segment means in
    x's dtype."""
    b, n, d = _check(x, L)
    out = torch.empty((b, L, d), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch(f"segment_means_{DTYPES[x.dtype]}", _MEANS_ARGS, x,
                x.data_ptr(), out.data_ptr(), b, n, L, d)
    return out


def segment_means_op(x: torch.Tensor, *, L: int,
                     backend: str = "auto") -> torch.Tensor:
    """x (B, N_p, D) -> (B, L, D) segment means, any 1 <= L <= N_p."""
    if use_kernel(backend, x):
        return segment_means_cuda(x, L)
    return segment_means_plain(x, L)


def _check_split(x: torch.Tensor, L: int, n_shards: int,
                 n_real: int | None) -> int:
    """The real rows of every shard but the last (``n_real``, by default
    all of them); raises on a split the augment does not take."""
    bp, n, _ = x.shape
    n_real = n if n_real is None else n_real
    if n_shards < 1 or bp % n_shards:
        raise ValueError(f"{n_shards} shards do not divide the batch {bp}")
    if not 1 <= L <= n_real <= n:
        raise ValueError(f"need 1 <= L <= n_real <= N_p, got L={L}, "
                         f"n_real={n_real}, N_p={n}")
    return n_real


def prism_augment_plain(x: torch.Tensor, L: int, n_shards: int,
                        n_real: int | None = None) -> torch.Tensor:
    """Plain version of the PRISM augment: every shard's segment means
    over its real rows, gathered shard-major and repeated for each shard
    of the sequence, after the shard's own rows."""
    bp, n, d = x.shape
    n_real = _check_split(x, L, n_shards, n_real)
    m = n_shards * L
    xs = x.view(bp // n_shards, n_shards, n, d)
    z = torch.cat([segment_means_plain(xs[:, :-1, :n_real], L),
                   segment_means_plain(xs[:, -1:], L)], dim=1)
    z_rep = z.reshape(-1, 1, m, d).expand(-1, n_shards, m, d).reshape(
        bp, m, d)
    return torch.cat([x, z_rep], dim=1)


def prism_augment_cuda(x: torch.Tensor, L: int, n_shards: int,
                       n_real: int | None = None) -> torch.Tensor:
    """x (B·P, n_loc, D) f32 or bf16 on a card -> x_hat (B·P, n_loc + P·L,
    D) in one launch: each block copies its segment's rows and writes
    their mean into all P rows of its sequence."""
    bp, n, d = _check(x, L)
    n_real = _check_split(x, L, n_shards, n_real)
    out = torch.empty((bp, n + n_shards * L, d), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        _launch(f"prism_augment_{DTYPES[x.dtype]}", _AUGMENT_ARGS, x,
                x.data_ptr(), out.data_ptr(), bp, n, L, d, n_shards, n_real)
    return out


def prism_augment_op(x: torch.Tensor, *, L: int, n_shards: int,
                     n_real: int | None = None,
                     backend: str = "auto") -> torch.Tensor:
    """x (B·P, n_loc, D), row b·P + p holding shard p of sequence b ->
    x_hat (B·P, n_loc + P·L, D): the shard's own rows, then the L segment
    means of every shard of its sequence, shard-major.  Under Alg. 1's
    uneven split every shard but the last holds ``n_real`` real rows
    (then pad rows up to n_loc) and its means are over those alone."""
    if use_kernel(backend, x):
        return prism_augment_cuda(x, L, n_shards, n_real)
    return prism_augment_plain(x, L, n_shards, n_real)
