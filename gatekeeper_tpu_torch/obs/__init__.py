# Copied from gatekeeper_tpu/obs/__init__.py for the PyTorch port.
"""Observability: the span tracer, the flight recorder and the
per-template attribution of measured device time.

The VerdictLedger records every delta event in the flight recorder, the
devpages path each kind that falls back to the host page loop, the
driver and the audit manager each sweep, and the admission
micro-batcher each batch it forms; a fired fault dumps the ring with the
tracer's spans to disk, and the webhook persists the admission corpus
under ``GATEKEEPER_FLIGHT_ADMISSION``.  The audit sweep (with a full
sweep's per-kind stages), the micro-batcher and the driver's
review-batch device pass record spans (:mod:`.trace`); a full sweep's
device time is apportioned per template by :mod:`.attribution`.
"""

from gatekeeper_tpu_torch.obs.flightrecorder import (FlightRecorder,
                                                     get_flight_recorder,
                                                     record_event)

__all__ = ["FlightRecorder", "get_flight_recorder", "record_event"]
