# Copied from gatekeeper_tpu/enforce/__init__.py for the PyTorch port.
"""Continuous enforcement: incremental verdict maintenance.

The paged sweep (engine/torch_driver.py) re-evaluates only dirty pages ×
affected constraints — or, under ``GATEKEEPER_DEVPAGES``, consumes the
device's delta stream (enforce/devpages.py) — and applies the deltas to
a :class:`~gatekeeper_tpu_torch.enforce.ledger.VerdictLedger`, which
holds the continuously-true violation set per kind and emits an ordered
event stream of violations appearing/clearing.  The watch-driven reactor
(enforce/reactor.py) folds single watch events into the ledger between
sweeps.
"""

from gatekeeper_tpu_torch.enforce.ledger import (VerdictLedger, export_all,
                                                 pages_mode)

__all__ = ["VerdictLedger", "export_all", "pages_mode"]
