# Copied from gatekeeper_tpu/cmd/worker.py for the PyTorch port.
"""Engine worker process: a TorchDriver (owning the CUDA card) served
over the Driver seam (reference drivers/remote analogue, remote.go:49).

Run ``python -m gatekeeper_tpu_torch.cmd.worker --port 8686`` next to a
manager started with ``--engine-worker-url http://127.0.0.1:8686`` —
the control plane stays responsive while evaluation (and the kernels'
builds and compiles) happens out of process.

``--device`` is ``cuda`` by default; without a card the worker raises
(utils/device), and it never falls back to the CPU.  ``--device cpu``
runs the kernels' plain PyTorch versions.  Each ``init`` from a
(re)connecting control plane gets a fresh driver on that device.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from gatekeeper_tpu_torch.client.remote_driver import EngineWorker
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="gatekeeper-tpu-torch-worker")
    p.add_argument("--port", type=int, default=8686)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (cuda by default; "
                        "cpu runs the kernels' plain PyTorch versions)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    worker = EngineWorker(lambda: TorchDriver(device=args.device),
                          host=args.host, port=args.port)
    worker.start()
    print(f"engine worker up at {worker.url}", file=sys.stderr, flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    worker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
