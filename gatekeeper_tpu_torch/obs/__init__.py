# Copied from gatekeeper_tpu/obs/__init__.py for the PyTorch port.
"""Observability: the flight recorder's in-memory ring.

Only what the continuous-enforcement slice calls is ported: the
VerdictLedger records every delta event, and the devpages path records
each kind that falls back to the host page loop.  The span tracer and
device-time attribution of the JAX package are not part of the port yet.
"""

from gatekeeper_tpu_torch.obs.flightrecorder import (FlightRecorder,
                                                     get_flight_recorder,
                                                     record_event)

__all__ = ["FlightRecorder", "get_flight_recorder", "record_event"]
