# Copied from gatekeeper_tpu/controllers/runtime.py for the PyTorch port.
"""Reconcile runtime — the controller-runtime analogue.

The reference builds on sigs.k8s.io/controller-runtime: each controller
watches GVKs, watch events enqueue ``reconcile.Request{NamespacedName}``
work items, and workers call ``Reconcile`` until the queue drains,
requeueing on error or explicit ``Result{Requeue: true}``
(pkg/controller/controller.go:26-57 and every Reconcile method).

This runtime keeps that shape with a deterministic twist: a single
work queue that tests drive with ``run_until_idle()`` (every event and
requeue processed to a fixed point) and the process entry point drives
with ``start()`` (a worker thread).  Reconcilers are idempotent by
contract — failure recovery is re-running them (SURVEY §5 failure
detection: "recovery is reconcile idempotence").
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable

from gatekeeper_tpu_torch.utils.log import logger
from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.cluster.fake import Event, FakeCluster

_log = logger("controller")


@dataclasses.dataclass(frozen=True)
class Request:
    """reconcile.Request: the identity of the object to reconcile."""

    name: str
    namespace: str | None = None


@dataclasses.dataclass
class ReconcileResult:
    requeue: bool = False


DONE = ReconcileResult()
REQUEUE = ReconcileResult(requeue=True)


class Reconciler:
    """Implementations override reconcile(); ``name`` labels logs/metrics."""

    name = "reconciler"

    def reconcile(self, request: Request) -> ReconcileResult:  # pragma: no cover
        raise NotImplementedError


class ControllerManager:
    """Owns the work queue and the watch→enqueue plumbing."""

    def __init__(self, cluster: FakeCluster, max_attempts: int = 12):
        self.cluster = cluster
        self.max_attempts = max_attempts
        self._queue: collections.deque = collections.deque()
        self._attempts: dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._thread: threading.Thread | None = None
        self.errors: list[tuple[str, Request, Exception]] = []

    # ------------------------------------------------------------------
    # wiring

    def watch(self, gvk: GVK, reconciler: Reconciler) -> Callable[[], None]:
        """Subscribe reconciler to a GVK's events and enqueue the initial
        list (informer list+watch semantics — the reference's child
        manager re-lists everything when watches (re)start)."""

        def on_event(event: Event):
            meta = event.obj.get("metadata") or {}
            self.enqueue(reconciler,
                         Request(name=meta.get("name", ""),
                                 namespace=meta.get("namespace")))
        unsubscribe = self.cluster.watch(gvk, on_event)
        for obj in self.cluster.list(gvk):
            meta = obj.get("metadata") or {}
            self.enqueue(reconciler, Request(name=meta.get("name", ""),
                                             namespace=meta.get("namespace")))
        return unsubscribe

    def enqueue(self, reconciler: Reconciler, request: Request) -> None:
        with self._wake:
            self._queue.append((reconciler, request))
            self._wake.notify()

    # ------------------------------------------------------------------
    # deterministic pump (tests, demo loops)

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Process work items to a fixed point; returns steps executed."""
        steps = 0
        while steps < max_steps:
            with self._wake:
                if not self._queue:
                    return steps
                reconciler, request = self._queue.popleft()
            self._process(reconciler, request)
            steps += 1
        raise RuntimeError(f"work queue did not drain in {max_steps} steps")

    def _process(self, reconciler: Reconciler, request: Request) -> None:
        key = (id(reconciler), request)
        try:
            result = reconciler.reconcile(request)
            failed = False
        except Exception as e:
            # any reconcile error requeues (controller-runtime requeues on
            # error-result; a raising reconciler must never kill the
            # worker loop)
            _log.warning("reconcile failed; requeueing",
                         controller=reconciler.name,
                         request=str(request), error=e)
            self.errors.append((reconciler.name, request, e))
            result, failed = REQUEUE, True
        if result is not None and result.requeue:
            attempts = self._attempts.get(key, 0) + 1
            if attempts >= self.max_attempts:
                self._attempts.pop(key, None)
                if failed:
                    raise RuntimeError(
                        f"{reconciler.name} gave up on {request} after "
                        f"{attempts} attempts: {self.errors[-1][2]}")
                return
            self._attempts[key] = attempts
            self.enqueue(reconciler, request)
        else:
            self._attempts.pop(key, None)

    # ------------------------------------------------------------------
    # threaded mode (process entry point)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="reconcile-worker")
        self._thread.start()

    def stop(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._queue and not self._stop:
                    self._wake.wait(timeout=1.0)
                if self._stop:
                    return
                reconciler, request = self._queue.popleft()
            try:
                self._process(reconciler, request)
            except RuntimeError:
                pass  # gave up after max attempts; error already recorded
