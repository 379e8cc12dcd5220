# Copied from gatekeeper_tpu/resilience/__init__.py for the PyTorch port.
"""Runtime resilience: warm-restart persistence + backend supervision.

- ``snapshot``: versioned on-disk persistence of the expensive startup
  artifacts — each template's parsed module and lowered IR, the
  install-time certificates, the dedup plan, the columnar store and the
  verdict ledger's pagemap — keyed by host fingerprint + artifact
  digest.  A restarted process skips Rego lowering and store
  replication and adopts its verdicts instead of rebuilding them.
- ``supervisor``: a supervised state machine over each torch device
  (healthy -> degraded -> recovering -> healthy, or poisoned).  Serving
  paths consult the supervisor of their driver's device per dispatch;
  bounded re-probes with exponential backoff bring a lost card back.
- ``faults``: the fault-injection harness (``GATEKEEPER_FAULT=...``)
  exercising both halves, the watch stream, external data, admission
  batching and the fleet graduator in tests.
- ``smoke``: the two-process cold/warm restart measurement.
"""

from gatekeeper_tpu_torch.resilience import faults  # noqa: F401
from gatekeeper_tpu_torch.resilience.supervisor import (  # noqa: F401
    DEGRADED, HEALTHY, POISONED, RECOVERING, BackendSupervisor,
    get_supervisor)
