"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with `ctypes` (no PyTorch headers, so
a build takes seconds). Libraries go to `build/kernels/` at the root of
the checkout (listed in `.gitignore`) and are built at first use; a
library newer than its source is reused. Nothing here runs at import.

Flags: `-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false`.
  * no `--use_fast_math`: it flushes denormals, and the coefficient table
    folds `log(max(op, 1e-30))` into the exponent;
  * `--fmad=false`: products and sums round one by one, exactly as the
    plain PyTorch versions (one elementwise kernel per op) round them, so
    a kernel and its plain version agree bit for bit instead of flipping
    the 1/255 alpha threshold on rounding noise.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
KERNELS = ("composite_strips", "composite_tiles", "smallgather", "windowdma")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _paths(name: str) -> tuple[str, str, str]:
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"),
            os.path.join(BUILD_DIR, f"{name}.log"))


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def build(names=KERNELS) -> dict[str, str]:
    """Compile every stale kernel library, all `nvcc`s started together.
    Returns {name: compiler log}; raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib, log = _paths(name)
        if not _stale(name):
            continue
        with open(log, "w") as fh:
            procs[name] = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", lib + ".tmp", src],
                stdout=fh, stderr=subprocess.STDOUT)
    failed = []
    for name, proc in procs.items():
        _, lib, _ = _paths(name)
        if proc.wait() != 0:
            failed.append(name)
        else:
            os.replace(lib + ".tmp", lib)
    logs = {}
    for name in names:
        log = _paths(name)[2]
        if os.path.exists(log):
            with open(log) as fh:
                logs[name] = fh.read()
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if stale."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(_paths(name)[1])
        _libs[name] = lib
    return lib


def function(lib: str, name: str, argtypes: list):
    """The C function `name` of kernel library `lib`, returning a
    cudaError_t. Its ctypes signature is set once, here, and the function
    is kept, so a launch costs one dictionary lookup and no attribute
    writes."""
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib, name)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
