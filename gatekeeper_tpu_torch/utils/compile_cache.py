# Copied from gatekeeper_tpu/utils/compile_cache.py for the PyTorch port.
"""The build caches, their hit/miss counters, and the audit warm-up.

The reference persists XLA executables on disk so a restarted process
reloads them instead of recompiling.  The port's compiled artifacts are
its two build caches, both on disk:

- ``kernels/build.py``: each ``csrc/<name>.cu`` built by ``nvcc`` into a
  shared library under ``build_dir()``, in the subdirectory
  :func:`resolve_cache_path` keys by card and toolchain, named by the
  source's hash, so a restarted process loads the library and builds
  nothing (a library found is a hit, an ``nvcc`` run a miss);
- Triton's own disk cache (``TRITON_CACHE_DIR``, else
  ``~/.triton/cache``): each K1 variant the generated kernels
  specialise into is compiled once and loaded from disk by a later
  process (a variant loaded is a hit, one compiled from scratch a miss;
  ``kernels/ir_eval.py`` tells the two apart by the new entries a
  compile leaves in the cache directory).

:class:`PersistentCacheStats` counts both; ``resilience/snapshot.py``
``restart_report`` sums them with the snapshot tiers.  The reference's
XLA two-tier compile marker (``is_upgraded`` / ``mark_upgraded`` /
``key_hash``) has no counterpart: a Triton variant compiles once, at
one optimisation level.

``warm_audit`` runs one capped audit on a background thread so the
first sweep's variants compile off the serving path.  Unlike the
reference's, it keeps its exception instead of swallowing it:
:class:`AuditWarm` holds it, and the audit manager's next
``audit_once`` raises it, as the driver's delta and ingest warms do.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import platform
import threading
import time

import torch

_lock = threading.Lock()


def cache_root() -> str:
    """The on-disk root of the port's persistence:
    ``$GATEKEEPER_TORCH_CACHE_DIR`` when set, else the kernels' build
    directory (``gatekeeper_tpu_torch/_build/``, or
    ``$GATEKEEPER_TORCH_BUILD_DIR``).  ``cmd/manager.py`` ``main``
    defaults the warm-restart snapshots to ``<root>/snapshots``."""
    from gatekeeper_tpu_torch.kernels import build
    return os.environ.get("GATEKEEPER_TORCH_CACHE_DIR") or build.build_dir()


def _package_version(name: str) -> str:
    try:
        from importlib.metadata import version
        return version(name)
    except Exception:   # noqa: BLE001 — not installed on this host
        return "none"


@functools.lru_cache(maxsize=1)
def host_fingerprint() -> str:
    """A short stable fingerprint of what the port's compiled artifacts
    and snapshot entries depend on: the host's CPU (model and feature
    flags), the card's name and compute capability (``nocard`` without
    one), and the torch, Triton and CUDA versions.  Snapshot entries
    hold marshalled code and the build caches hold device code, so a
    tree carried to another host or card lands in directories this one
    never reads."""
    model, flags = "", ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not flags and line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                elif not model and line.startswith(("model name",
                                                    "CPU part")):
                    model = line.split(":", 1)[1].strip()
                if flags and model:
                    break
    except OSError:
        pass
    if not (flags or model):  # non-Linux fallback: coarse but safe
        model = f"{platform.machine()}-{platform.processor()}"
    card = "nocard"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        card = f"{torch.cuda.get_device_name(0)}-sm{major}{minor}"
    parts = (model, flags, card, torch.__version__,
             str(torch.version.cuda), _package_version("triton"))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def _backend_subdir(backend: str) -> str:
    """The cache subdirectory for a device type: ``cuda`` artifacts are
    keyed by :func:`host_fingerprint` (card, compute capability and
    toolchain versions); any other type passes through."""
    if backend == "cuda":
        return f"cuda-{host_fingerprint()}"
    return backend


def resolve_cache_path(backend: str, root: str) -> str | None:
    """The machine-safe build-cache directory for a device type under
    ``root``, or None where nothing is compiled: on the CPU every kernel
    runs its plain version, so there is no artifact to keep."""
    if backend == "cpu":
        return None
    return os.path.join(root, _backend_subdir(backend))


def triton_cache_dir() -> str:
    """Where Triton keeps compiled variants: ``TRITON_CACHE_DIR`` (the
    package never sets it), else Triton's default."""
    return os.environ.get("TRITON_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".triton", "cache")


def triton_cache_entries() -> int:
    """Entries in Triton's cache directory (one a compiled kernel or
    launcher); a compile that adds none loaded its variant from disk."""
    try:
        return len(os.listdir(triton_cache_dir()))
    except OSError:
        return 0


class PersistentCacheStats:
    """Process-wide hit/miss counters of the two build caches.  A
    restart that reloads every artifact shows hits and no misses; one
    that rebuilds shows misses (``nvcc`` runs, Triton variants compiled
    from scratch)."""

    _FIELDS = ("nvcc_hits", "nvcc_misses", "triton_hits", "triton_misses")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def note_nvcc(self, built: bool) -> None:
        """One library lookup: built by ``nvcc`` (a miss) or found."""
        with self._lock:
            if built:
                self.nvcc_misses += 1
            else:
                self.nvcc_hits += 1

    def note_triton(self, compiled: bool) -> None:
        """One Triton variant made ready: compiled from scratch (a miss)
        or loaded from the disk cache."""
        with self._lock:
            if compiled:
                self.triton_misses += 1
            else:
                self.triton_hits += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {f: getattr(self, f) for f in self._FIELDS}
        out["hits"] = out["nvcc_hits"] + out["triton_hits"]
        out["misses"] = out["nvcc_misses"] + out["triton_misses"]
        return out

    def delta_since(self, snap: dict) -> dict:
        cur = self.snapshot()
        return {k: cur[k] - snap.get(k, 0) for k in cur}


_stats: PersistentCacheStats | None = None


def persistent_cache_stats() -> PersistentCacheStats:
    """The process-wide stats singleton."""
    global _stats
    with _lock:
        if _stats is None:
            _stats = PersistentCacheStats()
        return _stats


@dataclasses.dataclass
class AuditWarm:
    """One background audit warm-up: its thread, its seconds once it
    ended, and the exception it ended with (None when it succeeded or
    still runs)."""

    thread: threading.Thread | None = None
    seconds: float | None = None
    error: BaseException | None = None


def warm_audit(driver, target: str, cap: int = 20) -> AuditWarm:
    """Compile (and run once, on throwaway output) the capped-audit
    variants for every template kind currently registered, in the
    background.  (The reference's ``block`` flag has no caller.)

    The warm is one capped ``driver.query_audit``: on a TorchDriver its
    staging, uploads and launches run under the driver's ``_prep_lock``,
    as every sweep's and the ingest warm's do, so they never interleave
    with a sweep's."""
    warm = AuditWarm()

    def run():
        t0 = time.perf_counter()
        try:
            from gatekeeper_tpu_torch.client.interface import QueryOpts
            driver.query_audit(target, QueryOpts(limit_per_constraint=cap))
        except Exception as exc:    # raised by the next audit_once
            warm.error = exc
        finally:
            warm.seconds = time.perf_counter() - t0

    # route through the executor's background-thread registry so the
    # warm is joined before interpreter teardown (a compile in flight
    # at exit aborts the process)
    from gatekeeper_tpu_torch.engine.executor import spawn_bg
    warm.thread = spawn_bg(run, "audit-warmup")
    return warm
