# Copied from gatekeeper_tpu/resilience/supervisor.py for the PyTorch port.
"""Backend supervisor: a state machine over one torch device.

Supervised transitions::

    healthy ──failure──> degraded ──re-probe──> recovering ──ok──> healthy
                             ^                       │
                             └───────fail────────────┘
    (any)  ──poisoned failure──> poisoned            (terminal)

Serving paths consult ``use_device()`` per dispatch (TorchDriver's
``scalar_only`` is a property over it), so a mid-sweep demotion routes
the *remaining* kinds through the scalar oracle while the sweep still
completes with correct verdicts, and a recovery routes later sweeps
back onto the card.

Re-probes are *bounded*: a tiny op on the supervised device
(``torch.ones(1, device=dev).add_(1).item()``) on a daemon thread with
a join deadline, run with exponential backoff from a background thread.
A probe that hangs past its deadline poisons the supervisor, because
its thread may still sit inside the CUDA driver; ``poisoned`` is
terminal.

On the degraded->healthy edge, registered recovery listeners fire
(drivers drop their device arrays and masks; the audit manager
re-warms; controllers re-reconcile templates; the webhook registration
refreshes its annotations).  State, reason, and transition counts are
exported through ``utils.metrics`` and surfaced by ``probe --health``
and the webhook's ``/healthz``.

The port's rules, where the reference differs:

- **One supervisor per torch device**, not one per process
  (:func:`get_supervisor` keys them by device): a CPU driver beside a
  card driver (the tests' oracle, the plain checks of ``chip_smoke.py``)
  is never demoted by the card's fault, nor the reverse.  Each consumer
  reads the supervisor of the driver it serves.
- **It never seeds degraded.**  ``utils/device.py`` resolves a device or
  raises, so a supervisor starts healthy, stamped as probed when it is
  made; there is no initial probe thread.
- **It demotes only on** :meth:`BackendSupervisor.report_failure`: the
  ``device_lost`` seam, or a re-probe that fails or hangs.  A kernel
  that raises, or fails to build or launch, still ends its sweep;
  nothing catches a kernel exception in order to demote.
- Children are not pinned to the CPU on a demotion (the reference's
  ``_pin_children_to_cpu``): a child process of a degraded pod asks for
  the card and raises if it is gone.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Callable

import torch

from gatekeeper_tpu_torch.utils.log import logger
from gatekeeper_tpu_torch.utils.metrics import Metrics

_log = logger("supervisor")

HEALTHY = "healthy"
DEGRADED = "degraded"
RECOVERING = "recovering"
POISONED = "poisoned"

# stable numeric encoding for the state gauge (dashboards alert on >0)
STATE_CODE = {HEALTHY: 0, RECOVERING: 1, DEGRADED: 2, POISONED: 3}

DEFAULT_BACKOFF_S = 2.0
BACKOFF_FACTOR = 2.0
BACKOFF_CAP_S = 60.0
DEFAULT_REPROBE_TIMEOUT_S = 10.0

_HUNG = "re-probe hung"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class BackendSupervisor:
    """The serving posture of one torch device (``get_supervisor``)."""

    def __init__(self, device, metrics: Metrics | None = None):
        self.device = torch.device(device)
        self.metrics = metrics or Metrics()
        self._lock = threading.RLock()
        self._state = HEALTHY
        self._reason = ""
        now = time.time()
        self._since = now
        # the device was resolved (utils/device.py) before anything asks
        # for its supervisor: that resolution is the first probe
        self._last_probe_at: float | None = now
        self._last_ok_at: float | None = now
        self._reprobe_attempts = 0
        self._platform = self.device.type
        self._n_devices = 1
        # recovery listeners: weakly-held (owner, method-name) pairs so
        # short-lived drivers don't accumulate in the registry, plus
        # strong plain callables for process-lifetime hooks.
        self._weak_listeners: list[tuple[weakref.ref, str]] = []
        self._listeners: list[Callable[[], None]] = []
        self._reprobe_thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._gauge_state()

    # ------------------------------------------------------------------
    # read side (hot path: lock-free state read)

    @property
    def state(self) -> str:
        return self._state

    @property
    def reason(self) -> str:
        return self._reason

    def use_device(self) -> bool:
        """May callers dispatch onto the device path right now?
        Consulted per dispatch (driver ``scalar_only`` property), so it
        must stay cheap: one attribute read."""
        return self._state == HEALTHY

    def peek_state(self) -> str:
        """The state, for hot-path readers (the overload ladder runs on
        every admission request).  The same as :attr:`state`: there is
        no seed probe to avoid here."""
        return self._state

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "reason": self._reason,
                "since": self._since,
                "last_probe_at": self._last_probe_at,
                "last_ok_at": self._last_ok_at,
                "reprobe_attempts": self._reprobe_attempts,
                "platform": self._platform,
                "n_devices": self._n_devices,
                "backend": (str(self.device) if self._state == HEALTHY
                            else "cpu-fallback"),
            }

    # ------------------------------------------------------------------
    # transitions

    def report_failure(self, reason: str, poisoned: bool = False) -> None:
        """An execution (or the probe) discovered the device is gone.
        ``poisoned=True`` is terminal: a hung probe may still sit inside
        the CUDA driver, so this process must never dispatch to the
        device again."""
        with self._lock:
            if self._state == POISONED:
                return
            target = POISONED if poisoned else DEGRADED
            if self._state == target and not poisoned:
                self._reason = reason
                return
            prev = self._state
            self._state = target
            self._reason = reason
            self._since = time.time()
            self.metrics.counter("backend_degradations").inc()
            self._gauge_state()
        _log.warning("backend degraded", device=str(self.device),
                     state=target, reason=reason)
        # flight recorder: the degradation edge is THE moment the last
        # minute of evidence matters — record the transition, then dump
        # the ring (outside the lock; dump does file I/O)
        self._flight_transition(prev, target, reason, dump=True)
        if not poisoned:
            self._maybe_start_reprobe_loop()

    @staticmethod
    def _flight_transition(prev: str, new: str, reason: str,
                           dump: bool = False) -> None:
        """Record a supervisor transition in the flight recorder and
        optionally dump the ring.  Best-effort: observability must
        never alter supervisor behavior."""
        try:
            from gatekeeper_tpu_torch.obs.flightrecorder import \
                get_flight_recorder
            rec = get_flight_recorder()
            rec.record("supervisor_transition", frm=prev, to=new,
                       reason=reason)
            if dump:
                rec.dump(f"supervisor:{new}")
        except Exception:   # noqa: BLE001
            pass

    def reprobe_now(self, timeout_s: float | None = None) -> bool:
        """Synchronous bounded re-probe; True iff the device is (or
        becomes) healthy.  Poisoned supervisors never re-probe; a probe
        that hangs past ``timeout_s`` poisons this one."""
        with self._lock:
            if self._state == POISONED:
                return False
            if self._state == HEALTHY:
                return True
            prev = self._state
            self._state = RECOVERING
            self._gauge_state()
        self._flight_transition(prev, RECOVERING, "re-probe")
        if timeout_s is None:
            timeout_s = _env_float("GATEKEEPER_SUPERVISOR_REPROBE_TIMEOUT_S",
                                   DEFAULT_REPROBE_TIMEOUT_S)
        ok, n, platform, err = self._device_check(timeout_s)
        if not ok and err.startswith(_HUNG):
            with self._lock:
                self._last_probe_at = time.time()
                self._reprobe_attempts += 1
                self.metrics.counter("backend_reprobe_failures").inc()
                self._state = DEGRADED      # report_failure's edge below
            self.report_failure(err, poisoned=True)
            return False
        now = time.time()
        with self._lock:
            self._last_probe_at = now
            self._reprobe_attempts += 1
            if ok:
                self._state = HEALTHY
                self._reason = f"recovered: {n} {platform} device(s)"
                self._since = now
                self._last_ok_at = now
                self._platform = platform
                self._n_devices = n
                self.metrics.counter("backend_recoveries").inc()
            else:
                self._state = DEGRADED
                self.metrics.counter("backend_reprobe_failures").inc()
                if err:
                    self._reason = f"{self._reason} (re-probe: {err})" \
                        if "(re-probe:" not in self._reason else self._reason
            self._gauge_state()
        self._flight_transition(
            RECOVERING, HEALTHY if ok else DEGRADED,
            self._reason if ok else "re-probe failed")
        if ok:
            _log.info("backend recovered", device=str(self.device))
            self._fire_recovery()
        return ok

    def _device_check(self, timeout_s: float):
        """Run one tiny op on the supervised device on a daemon thread
        with a join deadline.  Returns (ok, n_devices, platform, err)."""
        from gatekeeper_tpu_torch.resilience import faults
        box: dict = {}
        dev = self.device

        def _check():
            try:
                if faults.active("probe_hang"):
                    time.sleep(3600)    # simulated driver call that hangs
                # an actual launch and read-back, not just enumeration: a
                # half-dead card can enumerate but not execute
                v = torch.ones(1, device=dev).add_(1).item()
                if v != 2.0:
                    raise RuntimeError(f"probe op read back {v}, not 2")
                box["ok"] = True
            except BaseException as e:   # noqa: BLE001 — report, don't die
                box["err"] = e

        t = threading.Thread(target=_check, name="backend-reprobe",
                             daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            return False, 0, "", f"{_HUNG} past {timeout_s:.0f}s"
        if "err" in box:
            return False, 0, "", str(box["err"])
        return True, 1, dev.type, ""

    # ------------------------------------------------------------------
    # background re-probe loop (exponential backoff)

    def _maybe_start_reprobe_loop(self) -> None:
        if os.environ.get("GATEKEEPER_SUPERVISOR_REPROBE", "1") == "0":
            return
        with self._lock:
            if (self._reprobe_thread is not None
                    and self._reprobe_thread.is_alive()):
                return
            self._stop_evt.clear()
            self._reprobe_thread = threading.Thread(
                target=self._reprobe_loop, name="backend-reprobe-loop",
                daemon=True)
            self._reprobe_thread.start()

    def _reprobe_loop(self) -> None:
        delay = _env_float("GATEKEEPER_SUPERVISOR_BACKOFF_S",
                           DEFAULT_BACKOFF_S)
        while True:
            if self._stop_evt.wait(delay):
                return
            with self._lock:
                st = self._state
            if st in (HEALTHY, POISONED):
                return
            if self.reprobe_now():
                return
            delay = min(delay * BACKOFF_FACTOR, BACKOFF_CAP_S)

    # ------------------------------------------------------------------
    # recovery listeners

    def on_recovery(self, fn: Callable[[], None]) -> None:
        """Register a process-lifetime recovery hook (strong ref)."""
        with self._lock:
            self._listeners.append(fn)

    def add_recovery_listener(self, owner: object, method: str) -> None:
        """Register ``getattr(owner, method)()`` to run on recovery.
        The owner is held weakly: short-lived drivers (tests construct
        hundreds) don't leak into the registry."""
        with self._lock:
            self._weak_listeners.append((weakref.ref(owner), method))

    def _fire_recovery(self) -> None:
        with self._lock:
            weak = list(self._weak_listeners)
            strong = list(self._listeners)
        live: list[tuple[weakref.ref, str]] = []
        for ref, method in weak:
            owner = ref()
            if owner is None:
                continue
            live.append((ref, method))
            try:
                getattr(owner, method)()
            except Exception as e:   # noqa: BLE001 — a listener must not
                _log.warning("recovery listener failed",   # break recovery
                             listener=method, error=e)
        with self._lock:
            self._weak_listeners = live
        for fn in strong:
            try:
                fn()
            except Exception as e:   # noqa: BLE001
                _log.warning("recovery listener failed",
                             listener=getattr(fn, "__name__", "fn"), error=e)

    # ------------------------------------------------------------------
    # plumbing

    def _gauge_state(self) -> None:
        self.metrics.gauge("backend_supervisor_state").set(
            STATE_CODE.get(self._state, -1))

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._reprobe_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)


_SUPS: dict[str, BackendSupervisor] = {}
_SUP_LOCK = threading.Lock()


def get_supervisor(device) -> BackendSupervisor:
    """The supervisor of one resolved torch device (``cuda:0``,
    ``cpu``), made on first use."""
    key = str(torch.device(device))
    sup = _SUPS.get(key)
    if sup is not None:
        return sup
    with _SUP_LOCK:
        sup = _SUPS.get(key)
        if sup is None:
            sup = _SUPS[key] = BackendSupervisor(key)
        return sup


def supervisor_of(driver) -> BackendSupervisor | None:
    """The supervisor of the device a driver serves on, or None for a
    driver without a device (LocalDriver, a RemoteDriver whose worker
    owns the card)."""
    return getattr(driver, "supervisor", None)


def reset_for_tests() -> None:
    """Drop every supervisor (tests only)."""
    with _SUP_LOCK:
        sups = list(_SUPS.values())
        _SUPS.clear()
    for sup in sups:
        sup.stop()
