# Copied from gatekeeper_tpu/obs/flightrecorder.py for the PyTorch port.
"""Degradation flight recorder — the last N events, in memory.

A bounded ring (``RING`` events) of small structured events: verdict
deltas of the VerdictLedger and devpages fallbacks.  Recording is cheap
(one dict + deque append under a lock) and never raises, so it is safe
to call from any seam including failure paths.

Trimmed for the port: the JAX package also dumps the ring with the span
tracer's export to JSON files on degradation (``dump``), persists the
admission corpus into a capture log (``record_admission``) and reads it
back (``load_admission_corpus``).  Those wait for the webhook slice;
here the ring lives in memory only.  An event recorded under an open
span carries its trace id (obs/trace.py).  Nothing in the port reads the ring
yet, so its size is fixed: the JAX package's ``GATEKEEPER_FLIGHT_RING``
comes back with the webhook slice, whose dumps read it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional


RING = 2048


class FlightRecorder:
    def __init__(self):
        self._lock = threading.Lock()
        self._events: collections.deque[dict] = collections.deque(maxlen=RING)

    def record(self, etype: str, **fields: Any) -> None:
        """Append one event; never raises."""
        try:
            ev = {"ts": round(time.time(), 6), "type": etype}
            try:
                from gatekeeper_tpu_torch.obs.trace import get_tracer
                tid = get_tracer().current_trace_id()
                if tid:
                    ev["trace"] = tid
            except Exception:
                pass
            for k, v in fields.items():
                if isinstance(v, float):
                    v = round(v, 6)
                ev[k] = v
            with self._lock:
                self._events.append(ev)
        except Exception:
            pass

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record_event(etype: str, **fields: Any) -> None:
    """Module-level convenience for instrumentation seams."""
    get_flight_recorder().record(etype, **fields)
