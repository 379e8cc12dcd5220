"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface under :func:`build_dir`,
named by a hash of the source so an edited kernel rebuilds and an
unchanged one is reused.  :func:`build` starts one ``nvcc`` per missing
library, all at once, and waits for them; :func:`load` builds on first
use and opens the library with ``ctypes``.  Nothing here runs at import
time: the CPU tests import every module on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
KERNELS = ("topk", "dfa")
GENCODE = "arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "gatekeeper_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def build_dir() -> str:
    """Where built libraries and generated kernel sources go:
    ``$GATEKEEPER_TORCH_BUILD_DIR`` when set (for an install the process
    cannot write to), else ``gatekeeper_tpu_torch/_build/``."""
    return os.environ.get("GATEKEEPER_TORCH_BUILD_DIR") \
        or os.path.join(PKG_DIR, "_build")


def so_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir(), f"lib{name}_{digest}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Compile every missing library in ``names`` in parallel; returns
    seconds per library actually built (0.0 for one already built).
    Raises RuntimeError with nvcc's output when a build fails."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    out: dict[str, float] = {}
    for name in names:
        path = so_path(name)
        if os.path.exists(path):
            out[name] = 0.0
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), tmp, path)
    errors = []
    for name, (proc, t0, tmp, path) in procs.items():
        log, _ = proc.communicate(timeout=600)
        out[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = so_path(name)
            if not os.path.exists(path):
                build((name,))
            lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point (a
    launch the runtime refused never runs, and a later synchronise does
    not report it)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
