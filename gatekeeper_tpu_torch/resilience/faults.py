# Copied from gatekeeper_tpu/resilience/faults.py for the PyTorch port.
"""Fault-injection harness: ``GATEKEEPER_FAULT=<name>[,<name>...]``.

Tests and CI arm faults through the environment; the production code
consults this module at the exact seams a real failure would hit:

- ``queue_storm``      — fires ONCE, stalling admission batch
                         formation so the bounded queue fills and the
                         overload ladder engages (a simulated consumer
                         stall: slow device, GC pause, noisy
                         neighbor).
- ``slow_provider``    — external-data provider fetches stall for
                         ``GATEKEEPER_FAULT_STALL_S`` while armed,
                         simulating a saturated/far-away provider
                         (drives deadline expiry + brownout, not
                         breaker-open errors).
- ``fleet_straggler``  — fires ONCE, inside the fleet graduator's
                         candidate-twin build (rollout/fleet.py),
                         failing exactly one cluster of the fleet; the
                         map-reduce isolation contract marks only that
                         cluster ``held``, never the fleet.

Watch-class faults (consumed at the reactor's ingest edge,
``enforce/reactor.py`` — each models one way a watch stream breaks):

- ``watch_stall``      — while armed, frames buffer unstamped (bytes
                         stuck in the socket); past the stall timeout
                         the reactor declares the connection dead and
                         degrades to sweep cadence, reconnecting under
                         exponential backoff (attempts while armed
                         fail, as against a still-sick API server).
- ``watch_gap``        — fires ONCE: a stamped frame is lost on the
                         wire; the gap detector confirms the missing
                         sequence after the grace window and takes a
                         rung-2 kind resync.
- ``watch_duplicate``  — fires ONCE: a frame is delivered twice with
                         the same sequence; classified ``duplicate``
                         and dropped (verdict application is
                         idempotent regardless).
- ``watch_reorder``    — fires ONCE: a frame arrives late, below the
                         high-water sequence; classified
                         ``out_of_order`` and HEALS the suspected gap
                         — no resync.
- ``watch_flood``      — while armed, every real frame is followed by
                         a replay storm of recent frames; coalescing
                         absorbs small storms, a storm past the queue
                         bound is an ``overflow`` pathology escalating
                         to a rung-2 resync.

``active`` faults apply every time they are consulted; ``take`` faults
are one-shot per process (the set of already-fired names is kept here)
so a single armed fault produces one discrete failure event rather
than a permanently broken subsystem.  ``rearm`` forgets that a one-shot
fault fired.

Trimmed for the port: the seams of ``probe_hang`` and ``device_lost``
(the backend supervisor, ROADMAP A8) and ``snapshot_corrupt`` (the
snapshot tier, A8) are not in the port yet.
Arming one of them raises ``ClientError`` naming its item wherever the
armed set is read (``check_armed``, ``active``, ``take``): a fault that
no seam would fire is never silently ignored.  A fired fault is put on
the flight recorder's ring and the ring is dumped to disk
(obs/flightrecorder.py ``dump``).
"""

from __future__ import annotations

import os
import threading

from gatekeeper_tpu_torch.errors import ClientError

_fired: set[str] = set()
_lock = threading.Lock()

UNPORTED = {
    "probe_hang": "ROADMAP A8, the backend supervisor",
    "device_lost": "ROADMAP A8, the backend supervisor",
    "snapshot_corrupt": "ROADMAP A8, the snapshot tier",
}


def _armed() -> set[str]:
    spec = os.environ.get("GATEKEEPER_FAULT", "")
    armed = {f.strip() for f in spec.split(",") if f.strip()}
    missing = sorted(armed & set(UNPORTED))
    if missing:
        raise ClientError(
            f"GATEKEEPER_FAULT={spec}: the seam of {missing[0]} is not yet "
            f"ported to gatekeeper_tpu_torch ({UNPORTED[missing[0]]}); "
            f"unset it")
    return armed


def check_armed() -> None:
    """Raise ClientError when GATEKEEPER_FAULT arms a fault whose seam
    the port lacks (entry points call it before they start)."""
    _armed()


def active(name: str) -> bool:
    """Is the fault armed right now?  (Re-reads the env every call so
    tests can arm/disarm without process restarts.)"""
    return name in _armed()


def take(name: str) -> bool:
    """One-shot: True exactly once per process while the fault is
    armed; later calls return False even if it stays armed."""
    if name not in _armed():
        return False
    with _lock:
        if name in _fired:
            return False
        _fired.add(name)
    # a fired fault is a synthetic failure event: put it on the flight
    # recorder and dump the ring (best-effort — the injection seam must
    # behave exactly like the real failure it simulates)
    try:
        from gatekeeper_tpu_torch.obs.flightrecorder import \
            get_flight_recorder
        rec = get_flight_recorder()
        rec.record("fault_trip", fault=name)
        rec.dump(f"fault:{name}")
    except Exception:   # noqa: BLE001
        pass
    return True


def rearm(name: str) -> None:
    """Forget that a one-shot fault fired, so the next ``take`` while
    armed fires again."""
    with _lock:
        _fired.discard(name)


def reset_for_tests() -> None:
    with _lock:
        _fired.clear()
