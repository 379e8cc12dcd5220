# Copied from gatekeeper_tpu/obs/trace.py for the PyTorch port.
"""Span-based tracer with context propagation and Chrome trace export.

Spans nest through a ``contextvars`` context: a span opened while
another is active becomes its child and inherits the trace id; a span
opened with no active context starts a fresh trace.  Cross-thread
hand-offs (the micro-batcher worker) pass
the parent explicitly via ``parent=tracer.current()`` since context
vars do not flow into pre-existing pool threads.

Finished spans land in a bounded ring (``GATEKEEPER_TRACE_RING``,
default 4096) so memory is flat no matter how long the process runs;
open spans are tracked separately so a crash dump can include the
in-flight sweep.  ``export()`` renders the ring as Chrome trace-event
JSON (``ph:"X"`` complete events, microsecond timestamps) which
Perfetto and chrome://tracing load directly.

Tracing is on by default, and ``GATEKEEPER_TRACE=off`` kills it,
making ``span()`` a no-op yielding ``None``.  In the port the admission
micro-batcher (``admission.batch``) and the driver's review-batch device
pass (``admission.device_batch``) record spans.

Importing this module registers a context provider with
``utils.log`` so every structured log line emitted under a span
carries ``trace=<id> span=<id>``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, Iterator, Optional, Tuple

from gatekeeper_tpu_torch.utils import log as _log

# (trace_id, span_id) of the innermost active span on this context
_CTX: contextvars.ContextVar[Optional[Tuple[str, int]]] = \
    contextvars.ContextVar("gatekeeper_span", default=None)

_span_ids = itertools.count(1)
_trace_ids = itertools.count(1)


class Span:
    """One timed region. ``args`` may be mutated while the span is
    open to attach results (e.g. allowed/denied) post-hoc."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "t0_us", "dur_us", "tid", "args")

    def __init__(self, name: str, cat: str, trace_id: str, span_id: int,
                 parent_id: int, t0_us: float, tid: int, args: dict):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0_us = t0_us
        self.dur_us: Optional[float] = None  # None while open
        self.tid = tid
        self.args = args

    def event(self, now_us: Optional[float] = None) -> dict:
        """Chrome trace-event dict (ph "X" complete event)."""
        dur = self.dur_us
        args = dict(self.args)
        args["trace_id"] = self.trace_id
        args["span_id"] = self.span_id
        if self.parent_id:
            args["parent_span_id"] = self.parent_id
        if dur is None:  # still open: clamp to "now", flag it
            dur = max(0.0, (now_us or self.t0_us) - self.t0_us)
            args["incomplete"] = True
        return {
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": round(self.t0_us, 3), "dur": round(dur, 3),
            "pid": os.getpid(), "tid": self.tid, "args": args,
        }


class Tracer:
    """Process-wide span collector.  Thread-safe; near-zero cost when
    ``enabled`` is False (one attribute check per span site)."""

    def __init__(self, ring: Optional[int] = None):
        if ring is None:
            ring = int(os.environ.get("GATEKEEPER_TRACE_RING", "4096"))
        self._lock = threading.Lock()
        self._done: collections.deque[Span] = collections.deque(maxlen=ring)
        self._open: dict[int, Span] = {}
        self._epoch = time.perf_counter()
        self.enabled = os.environ.get("GATEKEEPER_TRACE", "on") != "off"

    # -- clock -------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    # -- context -----------------------------------------------------
    def current(self) -> Optional[Tuple[str, int]]:
        """(trace_id, span_id) of the active span, for explicit
        cross-thread parenting."""
        return _CTX.get()

    def current_trace_id(self) -> Optional[str]:
        ctx = _CTX.get()
        return ctx[0] if ctx else None

    # -- span lifecycle ----------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host",
             parent: Optional[Tuple[str, int]] = None,
             **args: Any) -> Iterator[Optional[Span]]:
        if not self.enabled:
            yield None
            return
        ctx = parent if parent is not None else _CTX.get()
        if ctx is None:
            trace_id = f"t{next(_trace_ids):06d}.{os.getpid()}"
            parent_id = 0
        else:
            trace_id, parent_id = ctx
        sid = next(_span_ids)
        sp = Span(name, cat, trace_id, sid, parent_id, self._now_us(),
                  threading.get_ident() & 0xFFFFFFFF, dict(args))
        with self._lock:
            self._open[sid] = sp
        token = _CTX.set((trace_id, sid))
        try:
            yield sp
        finally:
            _CTX.reset(token)
            sp.dur_us = max(0.0, self._now_us() - sp.t0_us)
            with self._lock:
                self._open.pop(sid, None)
                self._done.append(sp)

    def add_complete(self, name: str, cat: str, t0: float, t1: float,
                     parent: Optional[Tuple[str, int]] = None,
                     **args: Any) -> None:
        """Record an already-measured region (``t0``/``t1`` are
        ``time.perf_counter()`` values) as a complete span — for hot
        loops that already meter themselves and multi-exit blocks
        where a context manager would be intrusive."""
        if not self.enabled:
            return
        ctx = parent if parent is not None else _CTX.get()
        if ctx is None:
            trace_id = f"t{next(_trace_ids):06d}.{os.getpid()}"
            parent_id = 0
        else:
            trace_id, parent_id = ctx
        sp = Span(name, cat, trace_id, next(_span_ids), parent_id,
                  (t0 - self._epoch) * 1e6,
                  threading.get_ident() & 0xFFFFFFFF, dict(args))
        sp.dur_us = max(0.0, (t1 - t0) * 1e6)
        with self._lock:
            self._done.append(sp)

    # -- export ------------------------------------------------------
    def export(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON object.  Open spans are included as
        clamped-to-now complete events flagged ``incomplete`` so a
        mid-sweep dump still shows the sweep's span tree."""
        now = self._now_us()
        with self._lock:
            spans = list(self._done) + list(self._open.values())
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return {
            "traceEvents": [s.event(now) for s in spans],
            "displayTimeUnit": "ms",
        }

    def export_json(self, trace_id: Optional[str] = None) -> str:
        return json.dumps(self.export(trace_id), sort_keys=True)

    def reset(self) -> None:
        """Drop all recorded spans (tests)."""
        with self._lock:
            self._done.clear()
            self._open.clear()


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def _log_context() -> Optional[dict]:
    ctx = _CTX.get()
    if ctx is None:
        return None
    return {"trace": ctx[0], "span": ctx[1]}


_log.set_context_provider(_log_context)
