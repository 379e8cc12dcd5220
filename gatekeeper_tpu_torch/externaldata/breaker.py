# Copied from gatekeeper_tpu/externaldata/breaker.py for the PyTorch port.
"""Per-provider circuit breaker: closed -> open -> half-open.

Counts consecutive failed fetch *rounds* (a round is one batched call
after its own bounded retries).  After ``failure_threshold`` consecutive
failures the breaker opens: calls short-circuit without touching the
endpoint until ``cooldown_s`` elapses, then exactly one probe round is
admitted (half-open).  A successful probe closes the breaker; a failed
probe re-opens it for another cool-down (the classic Nygard shape —
release-it circuit breaker, same state machine Hystrix/gobreaker use).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}
"""Numeric encoding for the metrics gauge (0 healthy .. 2 tripped)."""


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.short_circuits = 0
        self.transitions: list[str] = [CLOSED]

    # ------------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May a fetch round proceed right now?  In half-open state only
        one probe is admitted at a time; concurrent callers short-circuit
        until the probe resolves."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            self.short_circuits += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                # failed probe: straight back to open, fresh cool-down
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            self._consecutive_failures += 1
            if self._state == CLOSED and \
                    self._consecutive_failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition(OPEN)

    # ------------------------------------------------------------------

    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            self._transition(HALF_OPEN)

    def _transition(self, state: str) -> None:
        if state != self._state:
            prev = self._state
            self._state = state
            self.transitions.append(state)
            # flight-record the flip (non-blocking append; safe under
            # the breaker lock)
            try:
                from gatekeeper_tpu_torch.obs.flightrecorder import record_event
                record_event("breaker_flip", frm=prev, to=state)
            except Exception:   # noqa: BLE001
                pass

    def code(self) -> int:
        return STATE_CODES[self.state]
