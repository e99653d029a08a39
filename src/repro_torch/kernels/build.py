"""Build and load the CUDA kernels: ``nvcc`` compiles each source under
``csrc/`` into a shared library with a plain C interface, loaded with
``ctypes``.  That builds in seconds; a PyTorch C++ extension that
includes the torch headers takes minutes.

Builds happen at first use, one ``nvcc`` per source, started together,
into ``_build/`` beside this file (listed in ``.gitignore``).  A library
is named by a hash of its source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBS = ("prism_attention", "decode_attention", "segment_means")

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """Where library ``name`` is built: named by a hash of its source,
    every shared header under ``csrc/`` (a source may include any of
    them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``, or '' if it was built earlier."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=LIBS) -> dict[str, float]:
    """Compile the named libraries that are not built yet, one ``nvcc``
    each, all started together.  Returns the seconds from the start until
    each library was done (0.0 for one already built).  Raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), tmp, log)
    secs = {name: 0.0 for name in names}
    failed = []
    while jobs:
        for name, (proc, tmp, log) in list(jobs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del jobs[name]
            log.close()
            secs[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(f"nvcc failed for {name}.cu (exit {rc}):\n"
                              + build_log(name))
            else:
                os.replace(tmp, library_path(name))
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def function(lib: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of library ``lib``, built and loaded on
    first use, with its argument types declared (pointers and the stream
    as ``c_void_p``) and a ``cudaError_t`` (int) result."""
    key = (lib, fn)
    f = _functions.get(key)
    if f is None:
        handle = _loaded.get(lib)
        if handle is None:
            build([lib])
            handle = _loaded[lib] = ctypes.CDLL(str(library_path(lib)))
        f = getattr(handle, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _functions[key] = f
    return f
