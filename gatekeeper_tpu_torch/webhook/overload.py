# Copied from gatekeeper_tpu/webhook/overload.py for the PyTorch port.
"""Brownout ladder: graded admission degradation under overload.

Upstream Gatekeeper's only overload story is binary — the webhook
either answers or the apiserver's ``failurePolicy: Ignore`` drops
policy wholesale (bootstrap.py:135).  Between "healthy" and "ignore
everything" there is a ladder of cheaper service levels, ordered by
how much policy value each rung gives up:

    rung 0  HEALTHY      full evaluation, all enforcement actions
    rung 1  SHED_DRYRUN  skip ``enforcementAction: dryrun`` constraints
                         (observability-only; no admission effect)
    rung 2  SHED_WARN    also skip ``warn`` (advisory warnings lost,
                         verdicts unchanged)
    rung 3  SCALAR_ONLY  deny-only, scalar engine, batcher bypassed —
                         the floor that still enforces policy
    rung 4  FAIL_STATIC  stop evaluating; answer per-template
                         failurePolicy (warn/dryrun-only policy sets
                         fail open, ``deny`` NEVER fails open — those
                         requests are rejected 429)

Pressure is queue depth / queue capacity (the bounded batcher queue is
the one place load accumulates); the supervisor state adds a floor
(degraded/recovering backend ⇒ at least rung 1, poisoned ⇒ at least
SCALAR_ONLY, since the device path is gone anyway).  Escalation is
instant — overload is now; de-escalation is one rung per
``GATEKEEPER_BROWNOUT_DECAY_S`` of sustained pressure below the rung's
engage threshold minus a margin, so the ladder doesn't flap across a
load oscillation.  Every transition is flight-recorded; every shed
decision is counted (``admission_shed_total{reason=}``).

``GATEKEEPER_BROWNOUT`` = ``auto`` (default) | ``off`` | ``0``..``4``
(pin a rung — chaos/bench use this to hold a service level steady).

The floor reads the backend supervisor handed to the controller, the
one of the serving driver's device (resilience/supervisor.py); without
one (a driver that has no device) it is HEALTHY.
"""

from __future__ import annotations

import os
import threading
import time

from gatekeeper_tpu_torch.utils.metrics import Metrics

HEALTHY = 0
SHED_DRYRUN = 1
SHED_WARN = 2
SCALAR_ONLY = 3
FAIL_STATIC = 4

RUNG_NAMES = {HEALTHY: "healthy", SHED_DRYRUN: "shed_dryrun",
              SHED_WARN: "shed_warn", SCALAR_ONLY: "scalar_only",
              FAIL_STATIC: "fail_static"}

# queue-pressure (depth/capacity) thresholds at which each rung engages
ENGAGE = {SHED_DRYRUN: 0.50, SHED_WARN: 0.70,
          SCALAR_ONLY: 0.85, FAIL_STATIC: 0.95}
# hysteresis margin below the engage threshold required to de-escalate
MARGIN = 0.10

# enforcement actions evaluation skips at each rung; deny is never a
# member — deny constraints are shed only by FAIL_STATIC's reject path
_SHED_AT = {HEALTHY: frozenset(),
            SHED_DRYRUN: frozenset({"dryrun"}),
            SHED_WARN: frozenset({"dryrun", "warn"}),
            SCALAR_ONLY: frozenset({"dryrun", "warn"}),
            FAIL_STATIC: frozenset({"dryrun", "warn"})}


def _decay_s() -> float:
    try:
        return float(os.environ.get("GATEKEEPER_BROWNOUT_DECAY_S", "1.0"))
    except ValueError:
        return 1.0


class OverloadController:
    """Computes the current brownout rung from queue pressure + the
    supervisor floor.  One instance per webhook handler; ``rung()`` is
    called on every admission request, so the hot path is a couple of
    float compares under a small lock."""

    def __init__(self, depth_fn, capacity: int,
                 metrics: Metrics | None = None, supervisor=None):
        # depth_fn: () -> current pending-queue depth (batcher.depth)
        self.depth_fn = depth_fn
        # the serving driver's device supervisor (the floor), or None
        self.supervisor = supervisor
        self.capacity = max(1, capacity)
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.Lock()
        self._rung = HEALTHY
        self.max_rung = HEALTHY        # high-water mark, for reports
        self._scalar_inflight = 0      # SCALAR_ONLY bypasses in flight
        self._calm_since: float | None = None
        self._listeners: list = []     # fn(frm, to, pressure) on change
        self._gauge(HEALTHY)

    def add_listener(self, fn) -> None:
        """Register ``fn(frm, to, pressure)`` to fire on every rung
        transition.  Listeners are invoked under the controller lock
        (keep them cheap and never call back into ``rung()``) and are
        best-effort: one failing listener cannot wedge the ladder.
        The rollout PromotionController uses this to roll a candidate
        back when a brownout escalation lands mid-promotion."""
        with self._lock:
            self._listeners.append(fn)

    # ------------------------------------------------------------------

    def _gauge(self, rung: int) -> None:
        self.metrics.gauge(
            "admission_brownout_rung",
            "current brownout ladder rung (0 healthy .. 4 fail-static)"
        ).set(rung)

    def _mode(self) -> str:
        return os.environ.get("GATEKEEPER_BROWNOUT", "auto")

    def _supervisor_floor(self) -> int:
        """Backend degradation sets a minimum rung: a degraded backend
        is already slower (scalar fallback), so start shedding
        observability-only work before the queue proves it; a poisoned
        backend has no device path at all.  ``peek_state`` is one
        attribute read — this runs per admission request."""
        from gatekeeper_tpu_torch.resilience import supervisor
        if self.supervisor is None:
            return HEALTHY
        st = self.supervisor.peek_state()
        if st == supervisor.POISONED:
            return SCALAR_ONLY
        if st in (supervisor.DEGRADED, supervisor.RECOVERING):
            return SHED_DRYRUN
        return HEALTHY

    def scalar_begin(self) -> None:
        """A request entered the SCALAR_ONLY bypass — it still counts
        as backlog (see pressure)."""
        with self._lock:
            self._scalar_inflight += 1

    def scalar_end(self) -> None:
        with self._lock:
            self._scalar_inflight = max(0, self._scalar_inflight - 1)

    def pressure(self) -> float:
        """Backlog relative to the queue bound.  In-flight SCALAR_ONLY
        bypasses count too: at rung 3 the queue is out of the loop, so
        without them the signal would read calm the moment the rung
        engaged and the ladder could never reach FAIL_STATIC."""
        try:
            # unlocked read (callers may hold self._lock): a stale int
            # is fine, the signal is re-sampled every request
            inflight = self._scalar_inflight
            return min(1.0, (self.depth_fn() + inflight) / self.capacity)
        except Exception:   # noqa: BLE001 — a broken signal reads calm;
            return 0.0      # the queue bound still protects memory

    def rung(self) -> int:
        """Current rung; escalates instantly, de-escalates one rung per
        decay window of sustained calm."""
        mode = self._mode()
        if mode == "off":
            return HEALTHY
        if mode not in ("auto", ""):
            try:
                forced = max(HEALTHY, min(FAIL_STATIC, int(mode)))
            except ValueError:
                forced = HEALTHY
            with self._lock:
                if forced != self._rung:
                    self._transition(self._rung, forced, self.pressure())
                    self._rung = forced
            return forced
        p = self.pressure()
        floor = self._supervisor_floor()
        # highest rung whose engage threshold the pressure meets
        target = HEALTHY
        for r in (SHED_DRYRUN, SHED_WARN, SCALAR_ONLY, FAIL_STATIC):
            if p >= ENGAGE[r]:
                target = r
        target = max(target, floor)
        now = time.monotonic()
        with self._lock:
            cur = self._rung
            if target > cur:
                self._transition(cur, target, p)
                self._rung = target
                self._calm_since = None
                return target
            if cur == HEALTHY or cur <= floor:
                self._calm_since = None
                return cur
            # de-escalation: sustained pressure below (engage - margin)
            # of the CURRENT rung steps down one rung per decay window
            if p < ENGAGE[cur] - MARGIN:
                if self._calm_since is None:
                    self._calm_since = now
                elif now - self._calm_since >= _decay_s():
                    nxt = max(cur - 1, floor)
                    self._transition(cur, nxt, p)
                    self._rung = nxt
                    self._calm_since = None
                    return nxt
            else:
                self._calm_since = None
            return cur

    def _transition(self, frm: int, to: int, pressure: float) -> None:
        # called under self._lock; recording is best-effort
        self.max_rung = max(self.max_rung, to)
        self._gauge(to)
        self.metrics.counter(
            "admission_brownout_transitions",
            "brownout ladder rung changes",
            direction="up" if to > frm else "down").inc()
        try:
            from gatekeeper_tpu_torch.obs.flightrecorder import record_event
            record_event("brownout_rung", frm=RUNG_NAMES[frm],
                         to=RUNG_NAMES[to], pressure=round(pressure, 3))
        except Exception:   # noqa: BLE001
            pass
        for fn in self._listeners:
            try:
                fn(frm, to, pressure)
            except Exception:   # noqa: BLE001 — listeners are advisory
                pass

    # ------------------------------------------------------------------
    # what a rung means for evaluation

    def shed_actions(self, rung: int | None = None) -> frozenset[str]:
        """Enforcement actions evaluation skips at ``rung`` (current
        rung when None).  Passed down as ``QueryOpts.shed_actions``."""
        return _SHED_AT[self.rung() if rung is None else rung]

    def count_shed(self, reason: str, n: int = 1) -> None:
        self.metrics.counter(
            "admission_shed_total",
            "admission requests shed by overload control",
            reason=reason).inc(n)
