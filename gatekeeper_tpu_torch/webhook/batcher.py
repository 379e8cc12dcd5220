# Copied from gatekeeper_tpu/webhook/batcher.py for the PyTorch port.
"""Admission micro-batcher.

Collect concurrent AdmissionReviews for up to ``max_wait`` seconds (or
``max_batch`` requests), then run the whole batch through the engine in
one pass.  Gatekeeper has nothing like this — every HTTPS callback runs
its own single-threaded topdown query — but a device engine wants
batches: one pass amortizes the client lock, the constraint-set
snapshot, and (for the device path) the kernel launches.

Callers block in ``submit`` until their batch is evaluated; a dedicated
worker thread owns batch formation, so latency is bounded by
``max_wait + evaluation``.

Overload control: the pending queue is BOUNDED
(``GATEKEEPER_ADMISSION_QUEUE``) — a full queue rejects the submit with
``QueueFull`` instead of buffering unboundedly (the Podracer-style
feeder/evaluator split only works if the feeder sheds instead of
buffering; an unbounded list under a 100k rps storm is an OOM, not a
queue).  Each request carries its propagated deadline (apiserver
``?timeout=`` → server request deadline), and batch formation drops
entries that are already expired or withdrawn *before* device dispatch,
then sizes the batch so the cost-model-predicted evaluation latency
fits the tightest deadline in the batch.

The Stage-7 rung ladder (``certified_rungs``) is kept: the port's
client returns None for it (no Stage 7 yet), so deadline shrinking
halves.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

from gatekeeper_tpu_torch.errors import GatekeeperError
from gatekeeper_tpu_torch.resilience import faults
from gatekeeper_tpu_torch.utils.metrics import Metrics

DEFAULT_QUEUE_CAPACITY = 2048


def queue_capacity_env(default: int = DEFAULT_QUEUE_CAPACITY) -> int:
    try:
        cap = int(os.environ.get("GATEKEEPER_ADMISSION_QUEUE", default))
    except ValueError:
        cap = default
    return max(1, cap)


class _Pending:
    __slots__ = ("request", "event", "response", "error", "ctx",
                 "deadline", "withdrawn")

    def __init__(self, request, ctx=None, deadline: float | None = None):
        self.request = request
        self.event = threading.Event()
        self.response = None
        self.error: Exception | None = None
        # submitting request's (trace_id, span_id): the batch span on
        # the worker thread links back to every member request trace
        self.ctx = ctx
        # absolute monotonic deadline propagated from the caller; batch
        # formation drops expired entries before dispatch
        self.deadline = deadline
        # caller gave up (SubmitTimeout) but the entry was already out
        # of reach of the remove() — formation must not evaluate it
        self.withdrawn = False


class SubmitTimeout(GatekeeperError):
    """submit() waited past its deadline for batch evaluation.  A
    GatekeeperError so the webhook handler's existing catch turns it
    into a clean deny-500 instead of a severed connection."""


class QueueFull(GatekeeperError):
    """The bounded pending queue is at capacity: the submit is REJECTED
    rather than buffered.  Distinct from SubmitTimeout so the webhook
    can ride the failurePolicy path (fail open for warn/dryrun-only
    policy sets, fail closed — 429 — when deny constraints are
    installed; policy.py)."""


class MicroBatcher:
    def __init__(self, evaluate_batch: Callable[[list[dict]], list],
                 max_batch: int = 64, max_wait: float = 0.002,
                 metrics: Metrics | None = None,
                 submit_timeout: float = 30.0,
                 prefetch: Callable[[list[dict]], None] | None = None,
                 capacity: int | None = None,
                 predict_seconds: Callable[[int], float | None]
                 | None = None,
                 certified_rungs: Callable[[], list[int] | None]
                 | None = None):
        self.evaluate_batch = evaluate_batch
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.metrics = metrics if metrics is not None else Metrics()
        # deadline on the caller's wait: a wedged evaluation (hung
        # device dispatch, stuck external fetch) must not pin webhook
        # handler threads forever — the server derives this from its
        # own request deadline
        self.submit_timeout = submit_timeout
        # best-effort per-batch warm hook (external-data prefetch): runs
        # once per formed batch before evaluation so provider fetch
        # latency is paid once for the whole batch
        self.prefetch = prefetch
        # bounded pending queue: reject-over-capacity, never buffer
        self.capacity = queue_capacity_env() if capacity is None \
            else max(1, capacity)
        # cost-model latency predictor (seconds for a batch of n
        # reviews, None while uncalibrated): batch formation shrinks the
        # batch until the prediction fits the tightest member deadline
        self.predict_seconds = predict_seconds
        # Stage-7 certified batch rungs (compile-surface certificates):
        # batch sizes whose padded review signature is provably inside
        # the certified surface.  Deadline shrinking steps along these
        # rungs — halving 50 -> 25 keeps the same padded signature
        # (bucket 32) and re-predicts the same latency, while stepping
        # 50 -> 32 -> 16 actually changes the executable the cost model
        # priced.  None (stage off / surface unbounded / no certs yet)
        # falls back to blind halving.
        self.certified_rungs = certified_rungs
        self._queue: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="admission-batcher")
            self._thread.start()

    def stop(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # ------------------------------------------------------------------

    def depth(self) -> int:
        """Current pending-queue depth (the brownout ladder's pressure
        signal; also exported as the admission_queue_depth gauge)."""
        with self._lock:
            return len(self._queue)

    def _gauge_depth(self, n: int) -> None:
        self.metrics.gauge(
            "admission_queue_depth",
            "pending admission requests awaiting batch formation").set(n)

    def submit(self, request: dict, timeout: float | None = None,
               deadline: float | None = None):
        """Block until the batch containing this request is evaluated,
        or until the effective deadline expires — then raise
        SubmitTimeout.  ``deadline`` is an absolute ``time.monotonic``
        instant propagated from the caller (apiserver ``?timeout=`` /
        server request deadline); ``timeout`` is a relative cap
        (default: the batcher's submit_timeout).  A full queue raises
        QueueFull immediately — the request is shed, not buffered.  A
        timed-out request still queued is withdrawn so the worker never
        evaluates for a caller that already gave up; one already taken
        into a batch keeps evaluating (the result is discarded, the
        thread is freed)."""
        if self._thread is None:
            # no worker: degrade to a single-request batch inline
            return self.evaluate_batch([request])[0]
        now = time.monotonic()
        wait = self.submit_timeout if timeout is None else timeout
        if deadline is not None:
            wait = min(wait, deadline - now)
        if wait <= 0:
            self.metrics.counter("admission_expired_dropped").inc()
            raise SubmitTimeout("admission deadline already expired "
                                "before evaluation")
        from gatekeeper_tpu_torch.obs.trace import get_tracer
        p = _Pending(request, ctx=get_tracer().current(),
                     deadline=now + wait)
        with self._wake:
            if len(self._queue) >= self.capacity:
                self.metrics.counter(
                    "admission_shed_total",
                    "admission requests shed by overload control",
                    reason="queue_full").inc()
                raise QueueFull(
                    f"admission queue at capacity ({self.capacity})")
            self._queue.append(p)
            self._gauge_depth(len(self._queue))
            self._wake.notify()
        if not p.event.wait(wait):
            with self._wake:
                p.withdrawn = True
                try:
                    self._queue.remove(p)
                    self._gauge_depth(len(self._queue))
                except ValueError:
                    pass    # already taken into a batch
            self.metrics.counter("admission_submit_timeouts").inc()
            raise SubmitTimeout(
                f"admission batch evaluation exceeded {wait:.3f}s")
        if p.error is not None:
            raise p.error
        return p.response

    # ------------------------------------------------------------------
    # batch formation

    def _take_batch(self, now: float) -> list[_Pending]:
        """Pop up to max_batch live entries under the lock, dropping
        withdrawn and already-expired entries first — an expired entry
        would be evaluated for a caller whose apiserver already gave
        up, pure wasted device time under overload.  With certificates
        installed, formation additionally caps at the top certified
        rung — the rung ladder is already clipped to the largest batch
        whose Stage-8 memory surface fits the remaining HBM budget, so
        a batch that would blow the budget is never even formed."""
        cap = self.max_batch
        rungs = self._rungs()
        if rungs is not None and rungs[-1] < cap:
            cap = rungs[-1]
        take: list[_Pending] = []
        rest: list[_Pending] = []
        expired: list[_Pending] = []
        for p in self._queue:
            if p.withdrawn:
                continue
            if p.deadline is not None and p.deadline <= now:
                expired.append(p)
                continue
            (take if len(take) < cap else rest).append(p)
        if rest and cap < self.max_batch:
            self.metrics.counter(
                "admission_batch_budget_caps",
                "batch formations truncated at the largest certified "
                "rung fitting the HBM budget").inc()
        self._queue = rest
        self._gauge_depth(len(rest))
        if expired:
            self.metrics.counter(
                "admission_expired_dropped",
                "expired admission requests dropped at batch formation"
            ).inc(len(expired))
            for p in expired:
                p.error = SubmitTimeout(
                    "admission deadline expired before evaluation")
                p.event.set()
        return take

    def _rungs(self) -> list[int] | None:
        """Certified batch rungs (ascending), or None for the halving
        fallback.  Advisory: a broken provider must not shed."""
        if self.certified_rungs is None:
            return None
        try:
            rungs = self.certified_rungs()
        except Exception:   # noqa: BLE001
            return None
        if not rungs:
            return None
        return sorted({int(r) for r in rungs if int(r) >= 1})

    def _fit_to_deadline(self, take: list[_Pending]) -> list[_Pending]:
        """Shrink the batch until the cost-model-predicted evaluation
        latency fits the tightest member deadline (the static cost
        model, analysis/costmodel.py, re-calibrated by its samples) —
        predicted-over-budget members beyond the cut stay queued for
        the next, smaller, batch.  The predictor is seeded with the
        static cost-model prior (costmodel.effective_scale), so
        shrinking has an opinion from the very first batch — it no
        longer no-ops through the uncalibrated window.  With
        Stage-7 certificates installed the shrink steps down the
        certified rung ladder (each step changes the padded signature
        the cost model priced); otherwise it halves blindly."""
        if self.predict_seconds is None or len(take) <= 1:
            return take
        deadlines = [p.deadline for p in take if p.deadline is not None]
        if not deadlines:
            return take
        budget = min(deadlines) - time.monotonic()
        rungs = self._rungs()
        n = len(take)
        while n > 1:
            try:
                pred = self.predict_seconds(n)
            except Exception:   # noqa: BLE001 — prediction is advisory;
                return take     # a broken predictor must not shed
            if pred is None or pred <= budget:
                break
            if rungs is not None:
                below = [r for r in rungs if r < n]
                n = below[-1] if below else 1
                self.metrics.counter(
                    "admission_batch_rung_shrinks",
                    "deadline shrinks stepped along certified "
                    "compile-surface rungs").inc()
            else:
                n = max(1, n // 2)
        if n == len(take):
            return take
        self.metrics.counter(
            "admission_batch_deadline_shrinks",
            "batches shrunk so predicted latency fits the tightest "
            "deadline").inc()
        keep, back = take[:n], take[n:]
        with self._wake:
            self._queue[:0] = back
            self._gauge_depth(len(self._queue))
            self._wake.notify()
        return keep

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._queue and not self._stop:
                    self._wake.wait(timeout=0.5)
                if self._stop:
                    for p in self._queue:
                        p.error = RuntimeError("batcher stopped")
                        p.event.set()
                    self._queue.clear()
                    self._gauge_depth(0)
                    return
                # natural batching: under load, requests that arrived
                # while the previous batch evaluated are already queued
                # — take them all immediately (a timed window would only
                # add latency without growing the batch).  The window
                # engages solely for a singleton queue, giving one more
                # arrival the chance to share the evaluation pass.
                if self.max_wait > 0 and len(self._queue) == 1 \
                        and not self._stop:
                    self._wake.wait(self.max_wait)
            # fault seam: queue_storm stalls batch formation once (a
            # simulated consumer stall) so the bounded queue absorbs —
            # and then sheds — a pressure spike; the sleep is outside
            # the lock so submits keep landing against the bound
            if faults.take("queue_storm"):
                time.sleep(float(os.environ.get(
                    "GATEKEEPER_FAULT_STALL_S", "0.25")))
            with self._wake:
                batch = self._take_batch(time.monotonic())
            batch = self._fit_to_deadline(batch)
            if not batch:
                continue
            self.metrics.counter("admission_batches").inc()
            self.metrics.timer("admission_batch_size").observe(len(batch))
            from gatekeeper_tpu_torch.obs.flightrecorder import record_event
            from gatekeeper_tpu_torch.obs.trace import get_tracer
            record_event("admission_batch", size=len(batch))
            # one batch span on the worker thread; member_traces links
            # it back to every submitting request's own trace, and the
            # driver's dispatch span nests under it via the context var
            with get_tracer().span(
                    "admission.batch", cat="webhook",
                    batch_size=len(batch),
                    member_traces=sorted({p.ctx[0] for p in batch
                                          if p.ctx is not None})):
                if self.prefetch is not None:
                    try:
                        self.prefetch([p.request for p in batch])
                    except Exception:   # noqa: BLE001 — warm-up only;
                        pass            # evaluation applies real policy
                try:
                    responses = self.evaluate_batch(
                        [p.request for p in batch])
                    for p, r in zip(batch, responses):
                        p.response = r
                except Exception as e:
                    for p in batch:
                        p.error = e
            for p in batch:
                p.event.set()
