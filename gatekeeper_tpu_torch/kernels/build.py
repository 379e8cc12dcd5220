"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface under :func:`build_dir` (in a
subdirectory keyed by the card and toolchain), named by a hash of the
source so an edited kernel rebuilds and an unchanged one is reused.  :func:`build` starts one ``nvcc`` per missing
library, all at once, and waits for them; :func:`load` builds on first
use and opens the library with ``ctypes``; :func:`entry` hands out a C
entry point with its argument types bound once.  Each library looked up
counts in the build caches' stats (utils/compile_cache.py): found on
disk a hit, built by ``nvcc`` a miss.  Nothing here runs at import
time: the CPU tests import every module on hosts without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
KERNELS = ("topk", "dfa", "scatter", "devdelta", "invjoin",
           "residency")
GENCODE = "arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
# held around the C launches of K2 and K3, which raise a kernel's
# dynamic shared-memory limit (cudaFuncSetAttribute, process-wide) the
# first time a launch needs more: two threads raising it to different
# sizes at once (an audit sweep beside an admission batch, or an engine
# worker's request threads) could leave it below what one of them
# launches with.  A launch only enqueues, so holding it is cheap
LAUNCH_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}     # (name, symbol) -> bound C function


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
    """The library of ``csrc/<name>.cu``: under the build directory's
    subdirectory for this card and toolchain (utils/compile_cache.py
    ``resolve_cache_path``), named by the source's hash, so a tree
    carried to another card or toolchain builds anew."""
    from gatekeeper_tpu_torch.utils.compile_cache import resolve_cache_path
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(resolve_cache_path("cuda", build_dir()),
                        f"lib{name}_{digest}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Compile every missing library in ``names`` in parallel; returns
    seconds per library actually built (0.0 for one already built).
    Raises RuntimeError with nvcc's output when a build fails."""
    from gatekeeper_tpu_torch.utils.compile_cache import \
        persistent_cache_stats
    stats = persistent_cache_stats()
    procs = {}
    out: dict[str, float] = {}
    for name in names:
        path = so_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):
            out[name] = 0.0
            stats.note_nvcc(built=False)
            continue
        stats.note_nvcc(built=True)
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
            # build() counts the library a hit or a miss
            path = so_path(name)
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


def entry(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``, its ``argtypes``
    and ``restype`` set once, at its first use, not on every call."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _ENTRIES[(name, symbol)] = fn
    return fn


def on_device(device: torch.device):
    """Context for a launch on ``device``: ``torch.cuda.device`` only
    when it is not already the current CUDA device."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, read
    without building a ``torch.cuda.Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if device.index is None
        else device.index)


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point (a
    launch the runtime refused never runs, and a later synchronise does
    not report it)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
