# Copied from gatekeeper_tpu/webhook/policy.py for the PyTorch port.
"""Validating admission webhook — Handle semantics.

Reference: pkg/webhook/policy.go:125-277.  The latency-critical serving
path:

- requests from Gatekeeper's own service account are allowed through
  ("Gatekeeper does not self-manage", :127,199-207);
- DELETE reviews validate ``oldObject`` (apiservers ≥1.15 send it;
  otherwise error 500, :131-147);
- writes of ConstraintTemplate / constraint kinds are validated
  synchronously (CreateCRD / ValidateConstraint, :149,211-241) — user
  errors deny with 422, internal errors with 500;
- everything else is reviewed against the engine with per-user/kind
  trace toggles from the Config CR (:244-277); violations deny with 403
  and one ``[denied by <constraint>] <msg>`` line per result (:173-184).

Requests ride the micro-batcher when one is attached (SURVEY §7 step 7):
concurrent Handle calls coalesce into one engine pass per batch window.

In the port ``_batching_pays`` reads the port's own
``engine/torch_driver.REVIEW_BATCH_MIN_EVALS``.  Every admission goes to
the flight recorder: a summary event on its ring and, under
``GATEKEEPER_FLIGHT_ADMISSION=1``, the redacted request in the durable
admission corpus (obs/flightrecorder.py ``record_admission``).
"""

from __future__ import annotations

import time

from gatekeeper_tpu_torch.api.config import (CONFIG_NAME, CONFIG_NAMESPACE, Config,
                                       GVK)
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.controllers.config import CONFIG_GVK
from gatekeeper_tpu_torch.errors import ClientError, GatekeeperError, RegoError
from gatekeeper_tpu_torch.utils.metrics import Metrics

NAMESPACE = "gatekeeper-system"
TEMPLATE_GROUP = "templates.gatekeeper.sh"
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"


def allow(message: str = "") -> dict:
    return {"allowed": True, "status": {"code": 200, "message": message}}


def deny(code: int, message: str) -> dict:
    return {"allowed": False, "status": {"code": code, "message": message}}


def is_gk_service_account(user_info: dict) -> bool:
    """policy.go:199-207: group system:serviceaccounts:gatekeeper-system."""
    groups = (user_info or {}).get("groups") or []
    return f"system:serviceaccounts:{NAMESPACE}" in groups


class ValidationHandler:
    def __init__(self, client: Client, cluster=None, injected_config=None,
                 batcher=None, metrics: Metrics | None = None,
                 log=lambda *_: None, batch_mode: str = "auto",
                 overload=None):
        self.client = client
        self.cluster = cluster
        self.injected_config = injected_config  # test hook (policy.go:121)
        self.batcher = batcher
        self.metrics = metrics if metrics is not None else Metrics()
        self.log = log
        # "auto": batch only when a full batch clears the device
        # engine's small-workload threshold; "always"/"never" force it
        self.batch_mode = batch_mode
        # brownout ladder controller (webhook/overload.py); None keeps
        # the pre-ladder behavior (always rung 0)
        self.overload = overload
        # cached Counter of installed enforcement actions (see
        # _installed_actions): (expires_at_monotonic, counter)
        self._actions_cache: tuple[float, dict] = (0.0, {})

    # ------------------------------------------------------------------

    def handle(self, request: dict, deadline: float | None = None) -> dict:
        """AdmissionRequest dict -> AdmissionResponse dict.
        ``deadline`` is an absolute ``time.monotonic`` instant derived
        from the apiserver's per-request timeout (server.py parses the
        webhook URL's ``?timeout=``); batch formation drops the request
        once it passes."""
        from gatekeeper_tpu_torch.obs.trace import get_tracer
        t0 = time.perf_counter()
        kind = request.get("kind") or {}
        # request root span: each admission gets its own trace; the
        # batcher records which request traces each batch served
        with get_tracer().span(
                "admission.request", cat="webhook",
                operation=request.get("operation", ""),
                kind=kind.get("kind", "")) as sp:
            try:
                resp = self._handle(request, deadline)
                if sp is not None:
                    sp.args["allowed"] = bool(resp.get("allowed"))
                return resp
            finally:
                self.metrics.timer("admission_seconds").observe(
                    time.perf_counter() - t0)
                self.metrics.counter("admission_requests").inc()

    def _installed_actions(self) -> dict:
        """Count of installed constraints per enforcement action — the
        failurePolicy decision ("does a rejected request lose a deny
        constraint?") and the shed accounting both need it.  Cached
        ~0.5s: the constraint set changes at reconcile cadence, not
        per request."""
        now = time.monotonic()
        expires, cached = self._actions_cache
        if now < expires:
            return cached
        from gatekeeper_tpu_torch.client.types import enforcement_action_of
        counts: dict = {}
        for by_name in self.client.constraints.values():
            for c in by_name.values():
                a = enforcement_action_of(c)
                counts[a] = counts.get(a, 0) + 1
        self._actions_cache = (now + 0.5, counts)
        return counts

    def _fail_per_policy(self, reason: str) -> dict:
        """The failurePolicy path for a request that will NOT be
        evaluated (queue full / fail-static rung).  Upstream's webhook
        registration says ``failurePolicy: Ignore`` (bootstrap.py:135)
        — but blanket Ignore silently admits everything a deny
        constraint would have caught.  Per-template instead: if any
        ``enforcementAction: deny`` constraint is installed, fail
        CLOSED (429, retriable — the apiserver retries with backoff);
        a warn/dryrun-only policy set fails open, losing only advisory
        output."""
        if self._installed_actions().get("deny", 0) > 0:
            self.metrics.counter(
                "admission_failclosed",
                "unevaluated requests rejected because deny "
                "constraints are installed").inc()
            if self.overload is not None:
                self.overload.count_shed("fail_closed")
            return deny(429, f"admission overloaded ({reason}); "
                             "deny policies are enforced, retry")
        self.metrics.counter(
            "admission_failopen",
            "unevaluated requests admitted (no deny constraints "
            "installed)").inc()
        if self.overload is not None:
            self.overload.count_shed("fail_open")
        return allow(f"admission overloaded ({reason}); "
                     "no deny policies installed, failing open")

    def _handle(self, request: dict,
                deadline: float | None = None) -> dict:
        if is_gk_service_account(request.get("userInfo") or {}):
            return allow("Gatekeeper does not self-manage")

        if request.get("operation") == "DELETE":
            if request.get("oldObject") is None:
                return deny(500, "For admission webhooks registered for "
                                 "DELETE operations, please use Kubernetes "
                                 "v1.15.0+.")
            request = dict(request)
            request["object"] = request["oldObject"]

        user_err, err = self._validate_gatekeeper_resources(request)
        if err is not None:
            return deny(422 if user_err else 500, err)

        # brownout ladder: pick the service level for THIS request
        rung = 0
        shed: frozenset | None = None
        if self.overload is not None:
            from gatekeeper_tpu_torch.webhook.overload import FAIL_STATIC
            rung = self.overload.rung()
            if rung >= FAIL_STATIC:
                out = self._fail_per_policy("brownout: fail-static rung")
                self._record_admission(request, out, [], [])
                return out
            shed = self.overload.shed_actions(rung) or None
            if shed:
                installed = self._installed_actions()
                for a in sorted(shed):
                    if installed.get(a, 0):
                        self.overload.count_shed(f"shed_{a}")

        from gatekeeper_tpu_torch.webhook.batcher import QueueFull
        try:
            resp = self._review(request, deadline=deadline, shed=shed,
                                rung=rung)
        except QueueFull as e:
            out = self._fail_per_policy(str(e))
            self._record_admission(request, out, [], [])
            return out
        except GatekeeperError as e:
            return deny(500, str(e))
        results = resp.results()
        # enforcementAction routing (reference webhook validateGatekeeper
        # resources + getValidationMessages): deny blocks the request;
        # warn admits it with AdmissionResponse warnings; dryrun admits
        # silently — all three still report the violation (metrics +
        # admission corpus), which is what makes dryrun a shadow rollout
        # primitive (see whatif/shadow.py for the sweep-scale version).
        denials = [r for r in results if r.enforcement_action
                   not in ("warn", "dryrun")]
        warns = [r for r in results if r.enforcement_action == "warn"]
        dryruns = [r for r in results if r.enforcement_action == "dryrun"]
        if warns:
            self.metrics.counter("admission_warn_violations").inc(len(warns))
        if dryruns:
            self.metrics.counter("admission_dryrun_violations").inc(
                len(dryruns))
        warnings = [f"[warn by {(r.constraint.get('metadata') or {}).get('name', '')}] "
                    f"{r.msg}" for r in warns]
        if denials:
            msgs = [f"[denied by {(r.constraint.get('metadata') or {}).get('name', '')}] "
                    f"{r.msg}" for r in denials]
            self.metrics.counter("admission_denied").inc()
            out = deny(403, "\n".join(msgs))
        else:
            out = allow()
        if warnings:
            out["warnings"] = warnings
        self._record_admission(request, out, results, warnings)
        return out

    def _record_admission(self, request, out, results, warnings) -> None:
        """Flight-recorder hook: the ring gets a summary event, and with
        GATEKEEPER_FLIGHT_ADMISSION=1 the durable capture log gets the
        full (redacted, byte-capped) request plus verdicts for
        offline replay — enqueued only, never a disk write on this
        path.  Never raises.  The capture log's health (segments
        written, records dropped under flood) is surfaced as webhook
        gauges so a starved capture path is visible."""
        try:
            from gatekeeper_tpu_torch.obs.flightrecorder import \
                get_flight_recorder
            rec = get_flight_recorder()
            rec.record_admission(
                request, bool(out.get("allowed")), verdicts=results,
                warnings=warnings)
            st = rec.capture_stats()
            if st is not None:
                self.metrics.gauge(
                    "admission_capture_segments",
                    "capture-log segments on disk").set(st["segments"])
                self.metrics.gauge(
                    "admission_capture_drops",
                    "corpus records dropped by the bounded capture "
                    "queue").set(st["dropped"])
        except Exception:
            pass

    # ------------------------------------------------------------------

    def _validate_gatekeeper_resources(self, request) -> tuple[bool, str | None]:
        """policy.go:211-241: (user_error, message)."""
        kind = request.get("kind") or {}
        obj = request.get("object")
        if kind.get("group") == TEMPLATE_GROUP and \
                kind.get("kind") == "ConstraintTemplate":
            try:
                self.client.create_crd(obj)
            except (RegoError, ClientError) as e:
                return True, str(e)
            return False, None
        if kind.get("group") == CONSTRAINT_GROUP:
            try:
                self.client.validate_constraint(obj)
            except ClientError as e:
                return True, str(e)
            return False, None
        return False, None

    def _get_config(self) -> Config:
        """policy.go:188-197 getConfig (injected test hook first)."""
        if self.injected_config is not None:
            return Config.from_dict(self.injected_config)
        if self.cluster is not None:
            obj = self.cluster.try_get(CONFIG_GVK, CONFIG_NAME,
                                       CONFIG_NAMESPACE)
            if obj is not None:
                return Config.from_dict(obj)
        return Config()

    def _trace_switch(self, request: dict) -> tuple[bool, bool]:
        cfg = self._get_config()
        kind = request.get("kind") or {}
        gvk = GVK(kind.get("group", ""), kind.get("version", ""),
                  kind.get("kind", ""))
        username = (request.get("userInfo") or {}).get("username", "")
        enabled = dump = False
        for trace in cfg.spec.traces:
            if trace.user != username or trace.kind != gvk:
                continue
            enabled = True
            if trace.dump == "All":
                dump = True
        return enabled, dump

    def _batching_pays(self) -> bool:
        """Micro-batching helps only when a coalesced batch can clear
        the device engine's small-workload threshold — below it, the
        batcher would serialize scalar evaluations that the client's
        read lock already runs concurrently (reference RWMutex,
        local.go:43-48), costing ~10x on p50."""
        if self.batch_mode != "auto":
            return self.batch_mode == "always"
        if not hasattr(self.client.driver, "query_review_batch"):
            return False
        # the port's own threshold, read at each call (tests set it)
        from gatekeeper_tpu_torch.engine import torch_driver
        n_cons = sum(len(v) for v in self.client.constraints.values())
        return n_cons * self.batcher.max_batch >= \
            torch_driver.REVIEW_BATCH_MIN_EVALS

    def _review(self, request: dict, deadline: float | None = None,
                shed: frozenset | None = None, rung: int = 0):
        """reviewRequest (policy.go:244-277).  ``deadline`` rides into
        the batcher so formation drops the request once it expires;
        ``shed``/``rung`` come from the brownout ladder — at
        SCALAR_ONLY and above the batcher is bypassed (its queue is the
        thing that's congested) and the request runs deny-only through
        the scalar path."""
        tracing, dump = self._trace_switch(request)
        scalar_rung = False
        if rung:
            from gatekeeper_tpu_torch.webhook.overload import SCALAR_ONLY
            scalar_rung = rung >= SCALAR_ONLY
        if self.batcher is not None and not tracing and not scalar_rung \
                and self._batching_pays():
            resp = self.batcher.submit(request, deadline=deadline)
        elif scalar_rung and self.overload is not None:
            # the bypass must stay visible to the pressure signal: with
            # the queue out of the loop, in-flight scalar reviews ARE
            # the backlog — without this, rung 3 empties the queue,
            # pressure reads calm, and FAIL_STATIC can never engage
            self.overload.scalar_begin()
            try:
                resp = self.client.review(request, tracing=tracing,
                                          shed_actions=shed)
            finally:
                self.overload.scalar_end()
        else:
            resp = self.client.review(request, tracing=tracing,
                                      shed_actions=shed)
        if tracing:
            self.log(resp.trace_dump())
        if dump:
            self.log(self.client.dump())
        return resp
