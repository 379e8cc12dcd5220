"""Device resolution for the PyTorch port (counterpart of the JAX
package's utils/device_probe.py ``probe_devices``).

The JAX package probes its backend on a watchdog thread because a TPU
plugin can hang inside backend init.  CUDA initialisation through torch
either answers or raises, so the port resolves its device explicitly:
every entry point runs on ``cuda`` unless the caller names another
device (the CPU tests pass ``device="cpu"``), and asking for ``cuda`` on
a host without a usable GPU raises instead of quietly moving to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` by default.
    Raises RuntimeError when a CUDA device is asked for and none is
    usable — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gatekeeper_tpu_torch: CUDA is not available on this host; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

