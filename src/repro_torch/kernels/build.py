"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout. The library's
file name carries a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded. ``build_all`` starts one
``nvcc`` per missing library, all together, and waits for them; each
build's log (with ptxas's registers and spills a kernel) is kept beside
its library as ``<library>.log``.

Nothing here runs at import time: the CPU tests import every module of
the port, and a machine without ``nvcc`` never reaches this code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
KERNELS = ("segment_combine", "csr_spmv", "scatter_combine",
           "sort_fold_dense", "bucket_pack", "flash_attention", "moe_gmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all at once. Returns the seconds it took."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names
            if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel library ``name``, built on
    first use. Every entry point returns a ``cudaError_t`` as an int."""
    if name not in _libs:
        build_all((name,))
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    fn = getattr(_libs[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


class LaunchCounter:
    """A plain count of one kernel's launches, set to 0 by ``reset``."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


def check(name: str, rc: int):
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
