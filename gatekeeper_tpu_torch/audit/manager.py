# Copied from gatekeeper_tpu/audit/manager.py for the PyTorch port.
"""Audit sweep manager.

Reference: pkg/audit/manager.go.  The loop that makes the engine a
product: every ``interval`` seconds run one sweep (:84-119) —

1. don't audit until the ConstraintTemplate CRD exists (:148-151);
2. ``client.audit()`` — the full cross-product evaluation (the
   north-star hot spot; here it runs on the TorchDriver's device path,
   with the per-constraint cap pushed down as a device top-k instead of
   the reference's format-everything-then-truncate);
3. group results per constraint selfLink capped at
   ``constraint_violations_limit`` (default 20, :35,161-199), truncating
   messages to 256 chars (:27-31,302-311);
4. discover all constraint kinds on constraints.gatekeeper.sh/v1alpha1
   (:153-159);
5. write ``status.violations`` + ``status.auditTimestamp`` on every
   constraint with exponential-backoff retry (:201-248,313-379);
   constraints with no violations get their stale ``status.violations``
   removed (:267-283).

Sweep observability (SURVEY §5 asks the build to beat the reference's
zero metrics): every sweep records device/host timings, result counts
and per-phase durations into ``last_sweep`` and the cumulative
``metrics`` registry.

Each sweep report carries the serving posture of the driver's device
(``backend_state``, and ``degraded`` with its reason while the backend
supervisor is not healthy, resilience/supervisor.py); a recovery of that
device re-warms the audit variants while the loop runs; each sweep
persists the store snapshot when ``GATEKEEPER_SNAPSHOT_DIR`` is set.
The audit warm-up's error is raised by
the next ``audit_once`` instead of being swallowed, and so is the
attached event reactor's kept error (enforce/reactor.py), after that
sweep has run: the sweep is the fallback that repairs the ledger.  The
loop logs a kept reactor error after each sweep and leaves it kept, so
the reactor's ``stop()`` raises it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.errors import ApiError, NotFoundError
from gatekeeper_tpu_torch.utils.metrics import Metrics
from gatekeeper_tpu_torch.utils.log import logger

_log = logger("audit")

CRD_NAME = "constrainttemplates.templates.gatekeeper.sh"
CRD_GVK = GVK("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition")
CONSTRAINTS_GV = "constraints.gatekeeper.sh/v1alpha1"
MSG_SIZE = 256

DEFAULT_AUDIT_INTERVAL = 60           # -auditInterval (manager.go:34)
DEFAULT_VIOLATIONS_LIMIT = 20         # -constraintViolationsLimit (:35)


def truncate_message(msg: str, size: int = MSG_SIZE) -> str:
    """manager.go:302-311 truncateString."""
    if len(msg) <= size:
        return msg
    if size > 3:
        size -= 3
    return msg[:size] + "..."


class AuditManager:
    def __init__(self, cluster: FakeCluster, client: Client,
                 interval: int = DEFAULT_AUDIT_INTERVAL,
                 violations_limit: int = DEFAULT_VIOLATIONS_LIMIT,
                 sleep: Callable[[float], None] = time.sleep,
                 now: Callable[[], float] = time.time,
                 metrics: Metrics | None = None):
        self.cluster = cluster
        self.client = client
        self.interval = interval
        self.violations_limit = violations_limit
        self._sleep = sleep
        self._now = now
        self.metrics = metrics if metrics is not None else Metrics()
        self.last_sweep: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # continuous enforcement (opt-in via attach_ledger): constraint
        # keys (kind, name) whose written status still reflects the
        # ledger's verdicts — a delta event dirties its key, and a
        # non-full sweep skips the status write for clean keys, so
        # status updates come from deltas instead of full resyncs
        self._ledger = None
        self._ledger_clean: set[tuple[str, str]] = set()
        self._ledger_lock = threading.Lock()
        # the audit warm-ups start() began (utils/compile_cache.AuditWarm)
        self._warms: list = []
        # the event reactor observing sweep completions (attach_reactor)
        self._reactor = None

    # ------------------------------------------------------------------
    # continuous enforcement subscription

    def attach_ledger(self, ledger) -> None:
        """Subscribe to a VerdictLedger's delta events (enforce/
        ledger.py).  Once attached, a non-full sweep skips the
        ``status.violations`` write for any ledger-maintained
        constraint whose verdicts did not change since its last write —
        the reference rewrites every constraint's status every
        ``--audit-interval`` regardless.  Default (unattached) behavior
        is byte-identical to before."""
        self._ledger = ledger
        with self._ledger_lock:
            self._ledger_clean.clear()
        ledger.subscribe(self._on_verdict_delta)

    def _on_verdict_delta(self, ev: dict) -> None:
        with self._ledger_lock:
            self._ledger_clean.discard((ev.get("kind", ""),
                                        ev.get("constraint", "")))

    def attach_reactor(self, reactor) -> None:
        """Let the event reactor (enforce/reactor.py) observe sweep
        completions: while its watch stream is degraded the periodic
        sweep is the enforcement freshness bound, and the reactor's
        health payload reports the age of the last one.  The next
        ``audit_once`` raises the reactor's kept error after its sweep."""
        self._reactor = reactor

    # ------------------------------------------------------------------
    # one sweep

    def audit_once(self, full: bool = False) -> dict:
        """One audit() sweep (manager.go:84-119).  Returns the sweep
        report (also stored as ``last_sweep``).

        ``full=True`` forces a genuine full sweep: the driver's
        mask/bindings/format memoization is dropped for this sweep, and
        the report carries the driver's per-phase pipeline breakdown
        (``host_prep_s``, ``h2d_s``, ``device_s``, ``overlap_fraction``)
        so "full sweep" and "memoized steady" stay two separately
        metered numbers.

        A kept event-reactor error is raised once the sweep is done."""
        report = self._cycle(full)
        err = self._reactor.take_error() if self._reactor is not None \
            else None
        if err is not None:
            raise err
        return report

    def _cycle(self, full: bool = False) -> dict:
        """The sweep and its report: ``audit_once`` without the reactor's
        kept error."""
        self._raise_warm_error()
        t0 = self._now()
        # audit.cycle parents the driver's audit.sweep span, so one
        # trace covers evaluate + status writes end to end
        from gatekeeper_tpu_torch.obs.trace import get_tracer
        with get_tracer().span("audit.cycle", cat="audit", full=full):
            report = self._sweep(t0, full=full)
        if not report["skipped"]:
            report.setdefault("total_seconds", self._now() - t0)
            self.metrics.counter("audit_sweeps").inc()
            self.metrics.counter("audit_violations").inc(report["violations"])
            self.metrics.timer("audit_sweep_seconds").observe(
                report["total_seconds"])
            if self._reactor is not None:
                self._reactor.note_sweep()
        self.last_sweep = report
        if report["skipped"]:
            _log.debug("audit skipped: template CRD not deployed")
        else:
            _log.info("audit sweep complete",
                      violations=report["violations"],
                      constraints_updated=report["constraints_updated"],
                      seconds=round(report.get("total_seconds", 0.0), 3))
        return report

    def _sweep(self, t0: float, full: bool = False) -> dict:
        timestamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        report = {"timestamp": timestamp, "skipped": False,
                  "violations": 0, "constraints_updated": 0}

        # don't audit anything until the template CRD is deployed
        crd = self.cluster.try_get(CRD_GVK, CRD_NAME)
        if crd is None:
            # v1-first bootstrap stores the CRD under apiextensions v1
            crd = self.cluster.try_get(
                GVK("apiextensions.k8s.io", "v1",
                    "CustomResourceDefinition"), CRD_NAME)
        if crd is None:
            report["skipped"] = True
            return report

        t_eval = self._now()
        resp = self.client.audit(limit_per_constraint=self.violations_limit,
                                 full=full)
        results = resp.results()
        report["eval_seconds"] = self._now() - t_eval
        report["violations"] = len(results)
        report["full"] = full
        # surface the driver's sweep stanzas (a forced full sweep's
        # host_prep_s / h2d_s / device_s / overlap_fraction and its
        # attribution, every sweep's pages stanza; the scalar oracle and
        # a remote driver report nothing)
        phases = getattr(self.client.driver, "last_sweep_phases", None)
        if phases:
            for k in ("host_prep_s", "h2d_s", "device_s",
                      "overlap_fraction", "external", "dedup",
                      "attribution", "pages"):
                if k in phases:
                    report[k] = phases[k]

        # flight recorder: one structured event per sweep so a later
        # degradation dump shows the sweeps that led up to it
        from gatekeeper_tpu_torch.obs.flightrecorder import record_event
        record_event("audit_sweep", full=full,
                     violations=report["violations"],
                     eval_seconds=report["eval_seconds"],
                     device_s=report.get("device_s"),
                     host_prep_s=report.get("host_prep_s"),
                     overlap_fraction=report.get("overlap_fraction"))

        # serving posture (resilience/supervisor): a sweep that ran —
        # partly or wholly — on the scalar oracle after its device was
        # lost is correct but must say so (maps to the reference's
        # status.byPod[] operating report; see BASELINE.md).  A driver
        # without a device (LocalDriver, an engine worker's remote
        # driver) has nothing to degrade
        from gatekeeper_tpu_torch.resilience.supervisor import (
            HEALTHY, supervisor_of)
        sup = supervisor_of(getattr(self.client, "driver", None))
        report["backend_state"] = sup.state if sup is not None else HEALTHY
        if sup is not None and sup.state != HEALTHY:
            report["degraded"] = True
            report["degraded_reason"] = sup.reason
            self.metrics.counter("audit_sweeps_degraded").inc()

        update_lists = self._update_lists(results)

        # discovery: constraint kinds under constraints.gatekeeper.sh/v1alpha1
        try:
            kinds = self.cluster.server_resources_for_group_version(
                CONSTRAINTS_GV)
        except NotFoundError:
            # no constraint kind exists yet -> nothing to write (:111-115)
            return report

        t_write = self._now()
        # delta-skip is live only when the ledger actually served this
        # sweep (pages enabled, non-full) — a legacy sweep emits no
        # delta events, so skipping on its strength would go stale
        allow_skip = self._ledger is not None and not full and \
            bool((phases or {}).get("pages", {}).get("enabled"))
        updated, skipped = self._write_audit_results(
            kinds, update_lists, timestamp, allow_skip=allow_skip)
        report["write_seconds"] = self._now() - t_write
        report["constraints_updated"] = updated
        if self._ledger is not None:
            report["status_writes_skipped"] = skipped
            self.metrics.counter("status_writes_skipped").inc(skipped)
        self._maybe_snapshot_store()
        return report

    def _maybe_snapshot_store(self) -> None:
        """Warm-restart persistence: after a successful sweep, persist
        each target's columnar store (with the ledger's pagemap) so a
        restarted process restores the inventory from disk instead of
        replaying it.  No-op unless GATEKEEPER_SNAPSHOT_DIR is set."""
        drv = getattr(self.client, "driver", None)
        if drv is None or not hasattr(drv, "save_store_snapshot"):
            return
        try:
            from gatekeeper_tpu_torch.resilience import snapshot as _snap
            if not _snap.enabled():
                return
            for target in getattr(drv, "targets", {}):
                drv.save_store_snapshot(target)
        except Exception as e:   # noqa: BLE001 — persistence is
            _log.warning("store snapshot failed", error=e)   # best-effort

    def _update_lists(self, results) -> dict[str, list[dict]]:
        """Group results per constraint selfLink with cap + truncation
        (getUpdateListsFromAuditResponses, :161-199)."""
        out: dict[str, list[dict]] = {}
        for r in results:
            constraint = r.constraint or {}
            meta = constraint.get("metadata") or {}
            self_link = meta.get("selfLink") or \
                f"{constraint.get('kind', '')}/{meta.get('name', '')}"
            bucket = out.setdefault(self_link, [])
            if len(bucket) == self.violations_limit:
                continue
            resource = r.resource or {}
            rmeta = resource.get("metadata") or {}
            entry = {
                "kind": resource.get("kind", ""),
                "name": rmeta.get("name", ""),
                "message": truncate_message(r.msg),
                "enforcementAction": r.enforcement_action or "deny",
            }
            if rmeta.get("namespace"):
                entry["namespace"] = rmeta["namespace"]
            bucket.append(entry)
        return out

    def _write_audit_results(self, kinds: list[dict],
                             update_lists: dict[str, list[dict]],
                             timestamp: str,
                             allow_skip: bool = False) -> tuple[int, int]:
        """writeAuditResults + updateConstraintLoop (:201-248,313-379):
        list every constraint of every kind and write its status with
        exponential-backoff retry; constraints without violations get
        stale status.violations removed.  With ``allow_skip`` (ledger
        attached + paged sweep), ledger-maintained constraints whose
        verdicts didn't change since their last write are skipped."""
        pending: dict[str, dict] = {}
        for res in kinds:
            gvk = GVK("constraints.gatekeeper.sh", "v1alpha1", res["kind"])
            for item in self.cluster.list(gvk):
                link = (item.get("metadata") or {}).get("selfLink", "")
                pending[link] = item

        led_kinds = set(self._ledger.entries) if self._ledger is not None \
            else set()
        updated = 0
        skipped = 0
        delay = 1.0
        for _ in range(5):  # wait.Backoff{Duration:1s, Factor:2, Steps:5}
            for link, item in list(pending.items()):
                ckey = (item.get("kind", ""),
                        (item.get("metadata") or {}).get("name", ""))
                if allow_skip and ckey[0] in led_kinds:
                    with self._ledger_lock:
                        clean = ckey in self._ledger_clean
                    if clean:
                        del pending[link]
                        skipped += 1
                        continue
                try:
                    latest = self.cluster.get(
                        gvk_of_constraint(item),
                        (item.get("metadata") or {}).get("name", ""),
                        (item.get("metadata") or {}).get("namespace"))
                    self._update_constraint_status(
                        latest, update_lists.get(link, []), timestamp)
                except ApiError:
                    continue  # retried next backoff round
                del pending[link]
                updated += 1
                if self._ledger is not None and ckey[0] in led_kinds:
                    with self._ledger_lock:
                        self._ledger_clean.add(ckey)
            if not pending:
                break
            self._sleep(delay)
            delay *= 2
        return updated, skipped

    def _update_constraint_status(self, instance: dict,
                                  violations: list[dict],
                                  timestamp: str) -> None:
        """updateConstraintStatus (:250-300)."""
        status = instance.setdefault("status", {})
        status["auditTimestamp"] = timestamp
        if violations:
            status["violations"] = violations
        else:
            status.pop("violations", None)
        self.cluster.update(instance)

    # ------------------------------------------------------------------
    # loop (auditManagerLoop, :120-146)

    def start(self) -> None:
        if self._thread is not None:
            return
        # async warmup: compile the capped-audit variants before the
        # first interval tick so a restart or template churn doesn't
        # stall the first sweep.  Its error is raised by the next
        # audit_once (the reference swallows it)
        from gatekeeper_tpu_torch.utils.compile_cache import warm_audit
        drv = getattr(self.client, "driver", None)
        if drv is not None and hasattr(drv, "executor"):
            for target in getattr(drv, "targets", {}):
                self._warms.append(
                    warm_audit(drv, target, cap=self.violations_limit))
            # backend recovery => the driver drops its device state; the
            # same warm-up rebuilds it in the background so the next
            # interval tick sweeps on the device without compiling
            from gatekeeper_tpu_torch.resilience.supervisor import \
                supervisor_of
            sup = supervisor_of(drv)
            if sup is not None:
                sup.add_recovery_listener(self, "_rewarm_on_recovery")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="audit-manager")
        self._thread.start()

    def _rewarm_on_recovery(self) -> None:
        """Recovery listener: re-warm the audit variants after the
        driver dropped its device state.  A stopped manager warms
        nothing; the warm's error is raised by the next ``audit_once``."""
        from gatekeeper_tpu_torch.utils.compile_cache import warm_audit
        drv = getattr(self.client, "driver", None)
        if self._thread is None or drv is None \
                or not hasattr(drv, "executor"):
            return
        for target in getattr(drv, "targets", {}):
            self._warms.append(
                warm_audit(drv, target, cap=self.violations_limit))

    def _raise_warm_error(self) -> None:
        for warm in self._warms:
            if warm.error is not None:
                err, warm.error = warm.error, None
                raise err

    def stop(self) -> None:
        """Stop the loop and join it and the audit warm-ups (a warm's
        error stays for the next ``audit_once``)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for warm in self._warms:
            if warm.thread is not None:
                warm.thread.join()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._stop.wait(timeout=self.interval):
                return
            try:
                self._cycle()
            except Exception as e:  # log-and-continue (:130-133)
                _log.error("audit sweep failed", error=e)
                self.metrics.counter("audit_errors").inc()
            # a kept reactor error stays kept (the reactor's stop()
            # raises it) and is logged after every sweep
            err = self._reactor.error if self._reactor is not None \
                else None
            if err is not None:
                _log.error("event reactor failed", error=err)


def gvk_of_constraint(obj: dict) -> GVK:
    return GVK.from_api_version(obj.get("apiVersion", ""),
                                obj.get("kind", ""))
