"""PyTorch + CUDA port of the PRISM serving system.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``core``, ``models``, ``configs``, ``kernels``,
``sharding``, ``runtime``, ``launch``) so each module's counterpart is
easy to find.  It imports neither ``jax`` nor anything of ``repro``.

Every Pallas TPU kernel of the reference is a hand-written CUDA kernel
for Hopper (``kernels/csrc``) with a plain PyTorch version beside it;
``kernels.dispatch`` picks the kernel for CUDA tensors and the plain
version for CPU tensors.
"""
