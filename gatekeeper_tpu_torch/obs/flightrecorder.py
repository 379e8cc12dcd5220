# Copied from gatekeeper_tpu/obs/flightrecorder.py for the PyTorch port.
"""Degradation flight recorder — the last N events, dumped on failure.

A bounded ring (``GATEKEEPER_FLIGHT_RING``, default 2048) of small
structured events: sweep phase summaries, admission batch sizes, probe
results, supervisor transitions, circuit-breaker flips, fault trips.
Recording is cheap (one dict + deque append under a lock) and never
raises, so it is safe to call from any seam including failure paths.

``dump(reason)`` serializes the ring plus the tracer's current span
export (so the in-flight sweep's span tree survives) to a JSON
artifact under ``GATEKEEPER_FLIGHT_DIR`` (default
``$TMPDIR/gatekeeper-flight``), pruning to the newest
``GATEKEEPER_FLIGHT_KEEP`` (default 20) files.  It is invoked on
``GATEKEEPER_FAULT=*`` trips (resilience/faults.py) and on a backend
supervisor's degradation (resilience/supervisor.py).

Admission corpus (replay and rollout read it): with
``GATEKEEPER_FLIGHT_ADMISSION=1`` the webhook also persists each
AdmissionReview — payload capped at
``GATEKEEPER_FLIGHT_PAYLOAD_BYTES`` (default 8192) and redacted
(``metadata.managedFields`` stripped, secret-shaped values replaced)
BEFORE anything touches disk — into the durable capture log
(rollout/capture.py): segmented, CRC-framed ``capture-*.seg`` files
under ``<flight dir>/capture``, fed through a bounded queue so the
admission path never blocks on disk (drops are counted, committed
records survive crashes).  ``load_admission_corpus`` reads the capture
segments back (plus any legacy ``admission-*.jsonl`` files from older
recordings) for replay.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Any, Optional

from gatekeeper_tpu_torch.utils.log import logger

log = logger("obs.flight")


def _flight_dir() -> str:
    return os.environ.get(
        "GATEKEEPER_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), "gatekeeper-flight"))


# ---------------------------------------------------------------------------
# admission corpus hygiene: redact, then cap, then persist

REDACTED = "[REDACTED]"

_SECRET_KEY_HINTS = ("password", "passwd", "token", "secret", "credential",
                     "apikey", "api_key", "authorization", "private_key",
                     "privatekey", "client_key")


def _secret_shaped_key(key: str) -> bool:
    k = key.lower()
    return any(h in k for h in _SECRET_KEY_HINTS)


def redact_payload(obj: Any, _secretish: bool = False) -> Any:
    """Deep-copying redaction for a to-be-persisted k8s object:
    ``metadata.managedFields`` is dropped outright, string values under
    secret-shaped keys (and every string of a Secret's ``data`` /
    ``stringData`` maps) are replaced with a marker.  Only strings are
    secret material — booleans/numbers under a matching key (e.g. the
    ``automountServiceAccountToken`` flag) pass through, so replaying a
    redacted corpus still evaluates them faithfully.  The input is
    never mutated — the webhook still evaluates the original."""
    if isinstance(obj, dict):
        is_secret = obj.get("kind") == "Secret"
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                out[k] = redact_payload(v, _secretish)
                continue
            if k == "metadata" and isinstance(v, dict):
                out[k] = {mk: redact_payload(mv, _secretish)
                          for mk, mv in v.items() if mk != "managedFields"}
                continue
            blob = (_secretish or _secret_shaped_key(k)
                    or (is_secret and k in ("data", "stringData")))
            out[k] = redact_payload(v, blob)
        return out
    if isinstance(obj, list):
        return [redact_payload(v, _secretish) for v in obj]
    if _secretish and isinstance(obj, str):
        return REDACTED
    return obj


def payload_byte_cap() -> int:
    try:
        return int(os.environ.get("GATEKEEPER_FLIGHT_PAYLOAD_BYTES", "8192"))
    except ValueError:
        return 8192


def cap_payload(obj: Any, cap: Optional[int] = None) -> Any:
    """Bound one persisted object to ``cap`` serialized bytes.  An
    oversize object is deterministically reduced to its identifying
    envelope (apiVersion/kind/name/namespace/labels) plus a truncation
    marker carrying the original size — replay treats truncated events
    as unreplayable rather than silently evaluating a partial object."""
    if cap is None:
        cap = payload_byte_cap()
    try:
        size = len(json.dumps(obj, sort_keys=True, default=str))
    except Exception:
        return {"__truncated__": True, "__bytes__": -1}
    if size <= cap or not isinstance(obj, dict):
        return obj
    meta = obj.get("metadata") or {}
    return {
        "apiVersion": obj.get("apiVersion"),
        "kind": obj.get("kind"),
        "metadata": {k: meta.get(k) for k in ("name", "namespace", "labels")
                     if k in meta},
        "__truncated__": True,
        "__bytes__": size,
    }


def admission_corpus_enabled() -> bool:
    return os.environ.get("GATEKEEPER_FLIGHT_ADMISSION", "") not in ("", "0")


class FlightRecorder:
    def __init__(self, ring: Optional[int] = None):
        if ring is None:
            ring = int(os.environ.get("GATEKEEPER_FLIGHT_RING", "2048"))
        self._lock = threading.Lock()
        self._events: collections.deque[dict] = collections.deque(maxlen=ring)
        self._dump_seq = 0
        self._capture = None           # lazy rollout.capture.CaptureLog
        self._capture_dir: Optional[str] = None

    def _capture_log(self):
        """The durable capture log under the CURRENT flight dir,
        re-opened if GATEKEEPER_FLIGHT_DIR moved (tests point each case
        at a fresh tmpdir).  Called under self._lock."""
        from gatekeeper_tpu_torch.rollout.capture import CaptureLog
        d = os.path.join(_flight_dir(), "capture")
        if self._capture is None or self._capture_dir != d:
            if self._capture is not None:
                try:
                    self._capture.close()
                except Exception:
                    pass
            self._capture = CaptureLog(d)
            self._capture_dir = d
        return self._capture

    def capture_stats(self) -> Optional[dict]:
        """Capture-log health (segments, drops, queue depth); None when
        nothing was ever captured by this recorder."""
        with self._lock:
            return self._capture.stats() if self._capture else None

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

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Write the ring + current span export to a JSON artifact.
        Returns the path, or None on any failure (dumping evidence
        must never become its own failure mode)."""
        try:
            d = _flight_dir()
            os.makedirs(d, exist_ok=True)
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            try:
                from gatekeeper_tpu_torch.obs.trace import get_tracer
                trace = get_tracer().export()
            except Exception:
                trace = {"traceEvents": []}
            payload = {
                "reason": reason,
                "dumped_at": round(time.time(), 6),
                "pid": os.getpid(),
                "events": self.snapshot(),
                "trace": trace,
            }
            if extra:
                payload["extra"] = extra
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            path = os.path.join(
                d, f"flight-{stamp}-{os.getpid()}-{seq:03d}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, path)
            self._prune(d)
            log.info("flight recorder dumped", reason=reason, path=path,
                     events=len(payload["events"]))
            return path
        except Exception as exc:  # pragma: no cover - best effort
            try:
                log.warning("flight recorder dump failed", error=exc)
            except Exception:
                pass
            return None

    @staticmethod
    def _prune(d: str, prefix: str = "flight-",
               suffix: str = ".json") -> None:
        keep = int(os.environ.get("GATEKEEPER_FLIGHT_KEEP", "20"))
        try:
            files = sorted(
                f for f in os.listdir(d)
                if f.startswith(prefix) and f.endswith(suffix))
            for stale in files[:-keep] if keep > 0 else files:
                try:
                    os.unlink(os.path.join(d, stale))
                except OSError:
                    pass
        except OSError:
            pass

    def record_admission(self, request: dict, allowed: bool,
                         verdicts: Optional[list] = None,
                         warnings: Optional[list] = None) -> None:
        """Record one AdmissionReview as a replayable corpus event.

        The ring always gets a small summary event.  When the corpus is
        enabled (GATEKEEPER_FLIGHT_ADMISSION=1) the full — redacted,
        byte-capped — request is enqueued onto this recorder's durable
        capture log (rollout/capture.py): the admission path only pays
        a queue put, the background writer owns the disk.  Never
        raises: recording must not become an admission failure mode."""
        try:
            obj = (request.get("object") or {})
            self.record("admission",
                        operation=request.get("operation"),
                        kind=((request.get("kind") or {}).get("kind")),
                        name=(obj.get("metadata") or {}).get("name"),
                        allowed=allowed, verdicts=len(verdicts or ()))
            if not admission_corpus_enabled():
                return
            cap = payload_byte_cap()
            req = dict(request)
            for f in ("object", "oldObject"):
                if isinstance(req.get(f), dict):
                    req[f] = cap_payload(redact_payload(req[f]), cap)
            event = {
                "ts": round(time.time(), 6),
                "request": req,
                "allowed": bool(allowed),
                "warnings": list(warnings or ()),
                "verdicts": [
                    {"kind": (v.constraint or {}).get("kind"),
                     "name": ((v.constraint or {}).get("metadata") or {})
                     .get("name"),
                     "action": v.enforcement_action,
                     "msg": v.msg}
                    for v in (verdicts or ())],
            }
            with self._lock:
                self._capture_log().append(event)
        except Exception:  # pragma: no cover - best effort
            pass


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


def load_admission_corpus(directory: Optional[str] = None) -> list[dict]:
    """Read the recorded admission corpus back into replayable events.

    Primary source is the durable capture log's segments under
    ``<directory>/capture`` (committed records, in segment order across
    process restarts — open in-process writers are flushed first so a
    same-process record-then-replay flow sees everything it enqueued).
    Legacy ``admission-*.jsonl`` files from older recordings are still
    read, torn/unparsable lines skipped."""
    d = directory or _flight_dir()
    events: list[dict] = []
    try:
        from gatekeeper_tpu_torch.rollout import capture as _capture
        cap_dir = os.path.join(d, "capture")
        _capture.flush_all()
        recs, _report = _capture.scan(cap_dir)
        events.extend(ev for ev in recs
                      if isinstance(ev, dict) and "request" in ev)
    except Exception:   # noqa: BLE001 — capture dir may not exist yet
        pass
    try:
        names = sorted(f for f in os.listdir(d)
                       if f.startswith("admission-") and f.endswith(".jsonl"))
    except OSError:
        return events
    for name in names:
        try:
            with open(os.path.join(d, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(ev, dict) and "request" in ev:
                        events.append(ev)
        except OSError:
            continue
    return events
