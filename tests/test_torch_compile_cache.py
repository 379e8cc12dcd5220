"""The port's build caches (gatekeeper_tpu_torch/utils/compile_cache.py),
counterparts of tests/test_compile_cache.py.

The reference keys its XLA executable cache by host and device; the
port's compiled artifacts are the nvcc-built libraries of
``kernels/build.py`` and Triton's disk cache, keyed and counted here.
This host has neither nvcc nor Triton, so the library path and the
Triton directory are faked: what is held is the accounting (a library
found is a hit, an nvcc run a miss; a Triton variant loaded from disk a
hit, one compiled from scratch a miss), and that nothing sets a cache
or snapshot directory behind a caller's back.
"""

import os
import subprocess
import sys

import pytest
import torch

from gatekeeper_tpu_torch.kernels import build
from gatekeeper_tpu_torch.utils import compile_cache as cc
from gatekeeper_tpu_torch.utils.compile_cache import (
    PersistentCacheStats, _backend_subdir, cache_root, host_fingerprint,
    persistent_cache_stats, resolve_cache_path)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestHostFingerprint:
    def test_stable_and_short(self):
        a, b = host_fingerprint(), host_fingerprint()
        assert a == b
        assert len(a) == 12
        assert all(c in "0123456789abcdef" for c in a)

    def test_stable_across_processes(self):
        code = ("from gatekeeper_tpu_torch.utils.compile_cache import "
                "host_fingerprint; print(host_fingerprint())")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == host_fingerprint()

    def test_cuda_subdir_is_fingerprinted(self):
        assert _backend_subdir("cuda") == f"cuda-{host_fingerprint()}"
        assert _backend_subdir("cuda") != "cuda"
        # another device type passes through unchanged
        assert _backend_subdir("meta") == "meta"


class TestResolvePolicy:
    def test_cpu_has_nothing_to_cache(self):
        # every kernel runs its plain version on the CPU: no artifact
        assert resolve_cache_path("cpu", "/tmp/x") is None

    def test_cuda_is_fingerprinted_under_the_root(self):
        p = resolve_cache_path("cuda", "/tmp/x")
        assert p == f"/tmp/x/cuda-{host_fingerprint()}"

    def test_cache_root_defaults_to_the_build_dir(self, monkeypatch):
        monkeypatch.delenv("GATEKEEPER_TORCH_CACHE_DIR", raising=False)
        monkeypatch.delenv("GATEKEEPER_TORCH_BUILD_DIR", raising=False)
        assert cache_root() == build.build_dir()
        assert cache_root().endswith(os.path.join("gatekeeper_tpu_torch",
                                                  "_build"))
        monkeypatch.setenv("GATEKEEPER_TORCH_CACHE_DIR", "/tmp/gk-cache")
        assert cache_root() == "/tmp/gk-cache"


class TestPersistentCacheStats:
    def test_counts_both_caches(self):
        assert persistent_cache_stats() is persistent_cache_stats()
        # a fresh instance, NOT the live singleton: builds elsewhere in
        # the process tick the singleton's counters
        stats = PersistentCacheStats()
        snap = stats.snapshot()
        stats.note_nvcc(built=False)
        stats.note_nvcc(built=True)
        stats.note_triton(compiled=False)
        stats.note_triton(compiled=False)
        stats.note_triton(compiled=True)
        d = stats.delta_since(snap)
        assert d == {"nvcc_hits": 1, "nvcc_misses": 1, "triton_hits": 2,
                     "triton_misses": 1, "hits": 3, "misses": 2}

    def test_delta_isolated_instances(self):
        assert PersistentCacheStats().snapshot() == {
            "nvcc_hits": 0, "nvcc_misses": 0, "triton_hits": 0,
            "triton_misses": 0, "hits": 0, "misses": 0}

    def test_build_counts_a_library_found_as_a_hit(self, monkeypatch,
                                                   tmp_path):
        """``build()`` on a library already on disk runs no nvcc and
        counts a hit; a missing one is a miss (here nvcc is absent, so
        the build raises after counting it)."""
        monkeypatch.setenv("GATEKEEPER_TORCH_BUILD_DIR", str(tmp_path))
        stats = PersistentCacheStats()
        monkeypatch.setattr(cc, "_stats", stats)
        path = build.so_path("topk")
        # keyed by card and toolchain under the build directory
        assert os.path.dirname(path) == resolve_cache_path(
            "cuda", str(tmp_path))
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as f:
            f.write(b"\x7fELF")
        assert build.build(("topk",)) == {"topk": 0.0}
        assert stats.snapshot()["nvcc_hits"] == 1
        os.remove(path)
        monkeypatch.setattr(build, "_nvcc",
                            lambda: (_ for _ in ()).throw(
                                RuntimeError("nvcc not found")))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build(("topk",))
        assert stats.snapshot()["nvcc_misses"] == 1

    def test_triton_compiles_are_told_apart_by_new_cache_entries(
            self, monkeypatch, tmp_path):
        """A variant whose compile leaves a new entry in Triton's cache
        directory was compiled from scratch; one that leaves none came
        from disk.  A launch the in-memory JIT cache serves counts
        nothing."""
        from gatekeeper_tpu_torch.kernels import ir_eval
        monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path))
        stats = PersistentCacheStats()
        monkeypatch.setattr(cc, "_stats", stats)

        class FakeKernel:
            """A JIT function: compiling adds a variant and, unless the
            disk cache held it, a cache-directory entry."""

            def __init__(self):
                self.cache = {0: {}}
                self.on_disk = set()

            def __getitem__(self, grid):
                def run(*args, **kw):
                    key = (args[-2], len(self.cache[0]))
                    self.cache[0][key] = True
                    if key not in self.on_disk:
                        self.on_disk.add(key)
                        os.makedirs(tmp_path / f"k{len(self.on_disk)}")
                    return None     # not indexable: no direct launch
                return run

        kern = FakeKernel()

        class Plan:
            names = ()
            tail = ()
            kw = {}
            cvals = ()
            grid = (1,)
            r_pad = 16
            program = None

            def __init__(self):
                self.kern = kern
                self.compiled = {}

        assert cc.triton_cache_dir() == str(tmp_path)
        plan = Plan()
        out = torch.zeros((1, 1))
        monkeypatch.setattr(ir_eval, "_make_plan",
                            lambda *a, **k: plan)
        monkeypatch.setattr(ir_eval, "_PLANS", {})
        ir_eval._launch(object(), {}, out, None, "fake")
        assert stats.snapshot()["triton_misses"] == 1
        # the same variant after a "restart": on disk, not in memory
        kern.cache = {0: {}}
        ir_eval._launch(object(), {}, out, None, "fake")
        snap = stats.snapshot()
        assert (snap["triton_hits"], snap["triton_misses"]) == (1, 1)


class TestHermeticByDefault:
    def test_a_bare_driver_or_manager_sets_no_directory(self,
                                                        monkeypatch):
        """A TorchDriver or a Manager built directly points no cache
        and no snapshot directory anywhere: only ``cmd/manager.main``
        defaults the snapshot directory."""
        from gatekeeper_tpu_torch.cmd.manager import Manager, parse_args
        from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
        for var in ("GATEKEEPER_SNAPSHOT_DIR", "TRITON_CACHE_DIR",
                    "GATEKEEPER_TORCH_CACHE_DIR",
                    "GATEKEEPER_TORCH_BUILD_DIR"):
            monkeypatch.delenv(var, raising=False)
        TorchDriver(device="cpu")
        Manager(parse_args(["--port", "-1", "--device", "cpu"]))
        for var in ("GATEKEEPER_SNAPSHOT_DIR", "TRITON_CACHE_DIR",
                    "GATEKEEPER_TORCH_CACHE_DIR",
                    "GATEKEEPER_TORCH_BUILD_DIR"):
            assert var not in os.environ, var
