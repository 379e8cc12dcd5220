"""The PyTorch port stands alone: importing it pulls in neither jax nor
any module of the JAX package, its default device is CUDA with no quiet
CPU fallback, and it builds nothing at import time."""

import json
import os
import subprocess
import sys

import pytest
import torch

import gatekeeper_tpu_torch
from gatekeeper_tpu_torch import convert
from gatekeeper_tpu_torch.engine.executor import ProgramExecutor
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.utils import device as tdevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, importlib, sys
import gatekeeper_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                      pkg.__name__ + "."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "gatekeeper_tpu" or m.startswith("gatekeeper_tpu."))
print(json.dumps({"modules": names, "bad": bad,
                  "triton": "triton" in sys.modules}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["bad"] == []
    # triton is imported only inside the launching functions
    assert rep["triton"] is False
    for mod in ("gatekeeper_tpu_torch.engine.torch_driver",
                "gatekeeper_tpu_torch.engine.executor",
                "gatekeeper_tpu_torch.kernels.ir_eval",
                "gatekeeper_tpu_torch.kernels.topk",
                "gatekeeper_tpu_torch.kernels.dfa",
                "gatekeeper_tpu_torch.convert",
                "gatekeeper_tpu_torch.utils.device"):
        assert mod in rep["modules"]


def test_no_source_line_imports_the_reference():
    pkg_dir = os.path.dirname(gatekeeper_tpu_torch.__file__)
    offenders = []
    for root, _, files in os.walk(pkg_dir):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for i, line in enumerate(open(path, encoding="utf-8"), 1):
                s = line.strip()
                if s.startswith(("import jax", "from jax")) or \
                        "gatekeeper_tpu." in s and "import" in s:
                    offenders.append(f"{path}:{i}: {s}")
    assert offenders == []


def test_cuda_is_the_default_and_absence_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchDriver()
    with pytest.raises(RuntimeError):
        ProgramExecutor()
    with pytest.raises(RuntimeError):
        convert.arrays_to_device({})
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert TorchDriver(device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """The CUDA wrappers never take a silent plain path for a device
    they do not launch on."""
    from gatekeeper_tpu_torch.kernels import topk
    meta = torch.zeros((4, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        topk.topk_packed(meta, None, 20)
