# Copied from gatekeeper_tpu/obs/__init__.py for the PyTorch port.
"""Observability: the flight recorder's in-memory ring and the span
tracer.

The VerdictLedger records every delta event in the flight recorder, the
devpages path each kind that falls back to the host page loop, and the
admission micro-batcher each batch it forms; the micro-batcher and the
driver's review-batch device pass record spans (:mod:`.trace`).  The
device-time attribution of the JAX package is not part of the port yet.
"""

from gatekeeper_tpu_torch.obs.flightrecorder import (FlightRecorder,
                                                     get_flight_recorder,
                                                     record_event)

__all__ = ["FlightRecorder", "get_flight_recorder", "record_event"]
