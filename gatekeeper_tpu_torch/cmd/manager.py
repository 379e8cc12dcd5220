# Copied from gatekeeper_tpu/cmd/manager.py for the PyTorch port.
"""Process entry point — driver → backend → client → controllers →
webhook → audit wiring.

Reference: cmd/manager/main.go:35-103.  Same wiring order: construct the
engine driver (tracing on, main.go:68), the Backend + Client with the
K8s target (main.go:69-74), add controllers (controller.AddToManager,
main.go:81), webhook (main.go:87) and audit manager (main.go:93), then
start everything and block (main.go:100).

Flags mirror the reference's flag set (audit/manager.go:34-35,
webhook/policy.go:47-49).  The cluster is this build's in-memory
apiserver, or a real one through ``--kubeconfig`` (cluster/kube.py);
``--demo`` seeds the demo/basic scenario (1k namespaces +
required-labels template) and runs one audit sweep so the whole stack
is observable end-to-end.

The port builds a ``TorchDriver`` on ``--device`` (``cuda`` by default;
without a card that raises, as utils/device does — pass ``--device cpu``
for the plain PyTorch path), or with ``--engine-worker-url`` a
``RemoteDriver`` to an engine worker process (cmd/worker.py), which then
owns the card.  Run it as ``python -m gatekeeper_tpu_torch.cmd.manager``.

Under ``GATEKEEPER_PAGES`` (on by default) the manager builds the event
reactor (enforce/reactor.py), which turns each watch event into a
single-page re-evaluation of the verdict ledger between sweeps.

``main`` turns warm-restart snapshots on (``GATEKEEPER_SNAPSHOT_DIR``
defaults to ``<cache_root>/snapshots``, utils/compile_cache.py); a
``Manager`` built directly stays hermetic.  The webhook's ``/healthz``,
the overload ladder's floor, the VWC's annotations and the audit
reports read the backend supervisor of the driver's device
(resilience/supervisor.py).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

from gatekeeper_tpu_torch.utils.log import logger
from gatekeeper_tpu_torch.api.config import GVK, empty_config_object
from gatekeeper_tpu_torch.api.externaldata import PROVIDER_GVK
from gatekeeper_tpu_torch.audit.manager import (CRD_NAME, AuditManager,
                                          DEFAULT_AUDIT_INTERVAL,
                                          DEFAULT_VIOLATIONS_LIMIT)
from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.controllers.config import CONFIG_GVK
from gatekeeper_tpu_torch.controllers.constrainttemplate import TEMPLATE_GVK
from gatekeeper_tpu_torch.controllers.registry import ControlPlane, add_to_manager
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.resilience.supervisor import supervisor_of
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
from gatekeeper_tpu_torch.utils.metrics import Metrics
from gatekeeper_tpu_torch.webhook.batcher import MicroBatcher
from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
from gatekeeper_tpu_torch.webhook.server import DEFAULT_PORT, WebhookServer

_log = logger("manager")

NS_GVK = GVK("", "v1", "Namespace")


def bootstrap_cluster(cluster) -> None:
    """Install what deploy/gatekeeper.yaml installs: the base CRDs /
    served kinds the controllers and audit manager expect.  A real
    apiserver (cluster.kube.KubeCluster) serves core kinds already and
    gets only the CRDs applied; the FakeCluster also needs its
    discovery seeded."""
    if hasattr(cluster, "register_kind"):
        cluster.register_kind(TEMPLATE_GVK, "constrainttemplates")
        cluster.register_kind(CONFIG_GVK, "configs")
        cluster.register_kind(PROVIDER_GVK, "providers")
        # core kinds every conformant apiserver serves (sync configs
        # routinely watch these; the fake's discovery must agree)
        for kind, plural in (("Namespace", "namespaces"), ("Pod", "pods"),
                             ("Service", "services"),
                             ("ConfigMap", "configmaps"),
                             ("Secret", "secrets"),
                             ("ServiceAccount", "serviceaccounts")):
            cluster.register_kind(GVK("", "v1", kind), plural)
        cluster.register_kind(GVK("apps", "v1", "Deployment"),
                              "deployments")
        cluster.register_kind(GVK("networking.k8s.io", "v1", "Ingress"),
                              "ingresses")
    from gatekeeper_tpu_torch.webhook.bootstrap import apply_crd
    apply_crd(cluster, CRD_NAME, "templates.gatekeeper.sh", "v1alpha1",
              "ConstraintTemplate", "constrainttemplates")
    apply_crd(cluster, "configs.config.gatekeeper.sh", "config.gatekeeper.sh",
              "v1alpha1", "Config", "configs")
    apply_crd(cluster, "providers.externaldata.gatekeeper.sh",
              "externaldata.gatekeeper.sh", "v1beta1", "Provider",
              "providers", namespaced=False)


class Manager:
    """Everything main() builds, held together for tests and the demo."""

    def __init__(self, args: argparse.Namespace, cluster=None):
        self.metrics = Metrics()
        if cluster is not None:
            self.cluster = cluster
        elif getattr(args, "kubeconfig", None):
            # real apiserver: the whole control plane binds to it through
            # the cluster protocol (reference main.go:43-51)
            from gatekeeper_tpu_torch.cluster.kube import KubeCluster
            self.cluster = KubeCluster.from_kubeconfig(args.kubeconfig)
        else:
            self.cluster = FakeCluster()
        # async clusters deliver watch events on stream threads; the
        # deterministic pump must settle instead of assuming inline events
        self.async_cluster = not isinstance(self.cluster, FakeCluster)
        bootstrap_cluster(self.cluster)
        if getattr(args, "engine_worker_url", None):
            # engine-process split: the evaluation engine (and the card)
            # live in a worker process behind the Driver seam
            # (reference drivers/remote analogue, remote.go:49)
            from gatekeeper_tpu_torch.client.remote_driver import \
                RemoteDriver
            driver = RemoteDriver(args.engine_worker_url)
        else:
            # the engine on the card unless --device says otherwise; no
            # CPU fallback when the card is missing (utils/device)
            driver = TorchDriver(tracing=False,
                                 device=getattr(args, "device", None))
        self.client = Backend(driver).new_client([K8sValidationTarget()])
        # external-data runtime: installed process-globally (the
        # `external_data` builtin resolves it there) and instrumented
        # through the manager's metrics registry
        from gatekeeper_tpu_torch.externaldata.runtime import (
            ExternalDataRuntime, set_runtime)
        self.external_data = ExternalDataRuntime(metrics=self.metrics)
        set_runtime(self.external_data)
        self.plane: ControlPlane = add_to_manager(
            self.cluster, self.client, external_data=self.external_data)
        from gatekeeper_tpu_torch.webhook.overload import OverloadController
        from gatekeeper_tpu_torch.webhook.server import REQUEST_TIMEOUT_S
        self.batcher = MicroBatcher(
            # shed_actions is consulted at evaluation time (not submit
            # time): a batch formed while healthy but evaluated under
            # brownout still sheds dryrun/warn work
            lambda reqs: self.client.review_batch(
                reqs, shed_actions=self.overload.shed_actions() or None),
            max_batch=args.max_batch, max_wait=args.batch_window_ms / 1000.0,
            metrics=self.metrics,
            # a submit must give up before the server's own request
            # deadline so the caller still gets a clean 500, not a
            # severed connection
            submit_timeout=REQUEST_TIMEOUT_S * 0.9,
            prefetch=self.client.prefetch_external,
            predict_seconds=self.client.predict_review_seconds,
            # Stage-7: deadline shrinks step along the certified
            # compile-surface rungs instead of halving blindly
            certified_rungs=lambda: self.client.certified_review_rungs(
                args.max_batch))
        self.overload = OverloadController(
            self.batcher.depth, self.batcher.capacity, metrics=self.metrics,
            supervisor=supervisor_of(self.client.driver))
        self.handler = ValidationHandler(self.client, cluster=self.cluster,
                                         batcher=self.batcher,
                                         metrics=self.metrics,
                                         overload=self.overload,
                                         log=lambda m: _log.info("admission trace", dump=m))
        # TLS engages when the cert dir exists (reference /certs,
        # policy.go:76-79); otherwise plain HTTP (tests/demo)
        cert_dir = getattr(args, "cert_dir", None)
        cert_dir = cert_dir if cert_dir and os.path.isdir(cert_dir) else None
        self.webhook = WebhookServer(self.handler, port=args.port,
                                     cert_dir=cert_dir) \
            if args.port >= 0 else None
        self._manual_deploy = getattr(args, "enable_manual_deploy", False)
        self._cert_dir = cert_dir
        self.audit = AuditManager(self.cluster, self.client,
                                  interval=args.audit_interval,
                                  violations_limit=args.constraint_violations_limit,
                                  metrics=self.metrics)
        # continuous enforcement (pages on): couple the watch stream to
        # the paged store so a single-object event becomes a single-page
        # re-eval, with the periodic sweep as degraded-mode fallback.
        # The sync controllers own store writes; the reactor only
        # schedules re-evaluation (apply_objects stays False).
        from gatekeeper_tpu_torch.enforce.ledger import pages_mode
        self.reactor = None
        if pages_mode():
            from gatekeeper_tpu_torch.enforce.reactor import Reactor
            self.reactor = Reactor(self.client, cluster=self.cluster,
                                   metrics=self.metrics)
            self.audit.attach_reactor(self.reactor)
        self.watch_poll_interval = getattr(args, "watch_poll_interval", 5.0)
        self._poll_stop = None
        self._poll_thread = None

    def start(self) -> None:
        self.plane.mgr.start()
        self.batcher.start()
        if self.webhook is not None:
            self.webhook.start()
            if self.webhook.tls and not self._manual_deploy:
                # self-register the ValidatingWebhookConfiguration +
                # cert secret + service (policy.go:81-100)
                from gatekeeper_tpu_torch.webhook.bootstrap import bootstrap_webhook
                from gatekeeper_tpu_torch.webhook.server import backend_of
                try:
                    bootstrap_webhook(
                        self.cluster, self._cert_dir, self.webhook.port,
                        backend=backend_of(self.client),
                        supervisor=supervisor_of(self.client.driver))
                except Exception as e:
                    _log.error("webhook bootstrap failed", error=e)
        self.audit.start()
        if self.reactor is not None:
            self.reactor.sync_subscriptions(
                self.plane.watch_manager.watched_gvks())
            self.reactor.start()
        # roster poll loop (reference updateManagerLoop, 5 s —
        # watch/manager.go:165-178): a GVK whose CRD becomes served
        # AFTER registration is picked up without any roster mutation
        self._poll_stop = threading.Event()

        def poll_loop():
            while not self._poll_stop.wait(self.watch_poll_interval):
                try:
                    self.plane.watch_manager.poll_once()
                    if self.reactor is not None:
                        # the reactor's subscriptions track the watch
                        # roster: a kind gaining/losing sync intent
                        # attaches/detaches its stream
                        self.reactor.sync_subscriptions(
                            self.plane.watch_manager.watched_gvks())
                except Exception as e:   # log-and-continue like the loop
                    _log.warning("watch poll error", error=e)
        self._poll_thread = threading.Thread(
            target=poll_loop, daemon=True, name="watch-roster-poll")
        self._poll_thread.start()

    def stop(self) -> None:
        """Stop every thread the manager started, and join the driver's
        background warms too, so no thread launches on the card once
        this returns (a CUDA-graph capture fails if another thread
        launches).  A warm's error stays with the driver for its next
        query; the reactor's kept error, when no sweep took it, is raised
        once everything has stopped."""
        if getattr(self, "_poll_stop", None) is not None:
            self._poll_stop.set()
            self._poll_thread.join(timeout=10)
            self._poll_stop = None
        try:
            if self.reactor is not None:
                self.reactor.stop()
        finally:
            self.audit.stop()
            if self.webhook is not None:
                self.webhook.stop()
            self.batcher.stop()
            self.plane.mgr.stop()
            drv = self.client.driver
            warms = [getattr(drv, "delta_warm", None),
                     getattr(drv, "ingest_warm", None)]
            for warm in warms:
                for t in ([warm.thread] if hasattr(warm, "thread")
                          else getattr(warm, "threads", None) or []):
                    if t is not None:
                        t.join()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="gatekeeper-tpu-torch-manager")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (cuda by default; "
                        "cpu runs the kernels' plain PyTorch versions)")
    p.add_argument("--audit-interval", type=int,
                   default=DEFAULT_AUDIT_INTERVAL,
                   help="interval to run audit in seconds (manager.go:34)")
    p.add_argument("--constraint-violations-limit", type=int,
                   default=DEFAULT_VIOLATIONS_LIMIT,
                   help="violations reported per constraint (manager.go:35)")
    p.add_argument("--port", type=int, default=DEFAULT_PORT,
                   help="webhook port; -1 disables (policy.go:48)")
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="admission micro-batch window")
    p.add_argument("--max-batch", type=int, default=64,
                   help="admission micro-batch size cap")
    p.add_argument("--engine-worker-url", default=None,
                   help="run evaluation in a separate engine worker "
                        "process at this URL (cmd/worker.py; --device is "
                        "then the worker's)")
    p.add_argument("--watch-poll-interval", type=float, default=5.0,
                   help="watch roster poll period in seconds "
                        "(watch/manager.go:172)")
    p.add_argument("--kubeconfig", default=None,
                   help="kubeconfig path for a real apiserver; absent -> "
                        "in-memory cluster (tests/demo) unless running "
                        "in-cluster")
    p.add_argument("--cert-dir", default="/certs",
                   help="TLS cert dir for the webhook server "
                        "(tls.crt/tls.key, policy.go:76-79)")
    p.add_argument("--enable-manual-deploy", action="store_true",
                   help="skip self-registering the "
                        "ValidatingWebhookConfiguration (policy.go:81-100)")
    p.add_argument("--demo", action="store_true",
                   help="seed demo/basic (1k namespaces + required-labels) "
                        "and run one audit sweep")
    return p.parse_args(argv)


def run_demo(mgr: Manager, n_namespaces: int = 1000) -> dict:
    """The demo/basic flow (reference demo/basic/demo.sh): sync config →
    template → constraint → resources → one audit sweep → statuses."""
    cluster = mgr.cluster
    cfg = empty_config_object()
    cfg["spec"] = {"sync": {"syncOnly": [
        {"group": "", "version": "v1", "kind": "Namespace"}]}}
    cluster.create(cfg)
    for i in range(n_namespaces):
        obj = {"apiVersion": "v1", "kind": "Namespace",
               "metadata": {"name": f"ns-{i:04d}"}}
        if i % 2:
            obj["metadata"]["labels"] = {"gatekeeper": "true"}
        cluster.create(obj)
    cluster.create({
        "apiVersion": "templates.gatekeeper.sh/v1alpha1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8srequiredlabels"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sRequiredLabels"},
                             "validation": {"openAPIV3Schema": {"properties": {
                                 "labels": {"type": "array",
                                            "items": {"type": "string"}}}}}}},
            "targets": [{
                "target": "admission.k8s.gatekeeper.sh",
                "rego": 'package k8srequiredlabels\n'
                        'violation[{"msg": msg, "details": '
                        '{"missing_labels": missing}}] {\n'
                        '  provided := {label | '
                        'input.review.object.metadata.labels[label]}\n'
                        '  required := {label | label := '
                        'input.constraint.spec.parameters.labels[_]}\n'
                        '  missing := required - provided\n'
                        '  count(missing) > 0\n'
                        '  msg := sprintf("you must provide labels: %v", '
                        '[missing])\n}\n'}]},
    })
    mgr.plane.run_until_idle(settle=2.0 if mgr.async_cluster else 0.0)
    cluster.create({
        "apiVersion": "constraints.gatekeeper.sh/v1alpha1",
        "kind": "K8sRequiredLabels",
        "metadata": {"name": "ns-must-have-gk"},
        "spec": {"match": {"kinds": [{"apiGroups": [""],
                                      "kinds": ["Namespace"]}]},
                 "parameters": {"labels": ["gatekeeper"]}},
    })
    mgr.plane.run_until_idle(settle=2.0 if mgr.async_cluster else 0.0)
    report = mgr.audit.audit_once()
    con = cluster.get(GVK("constraints.gatekeeper.sh", "v1alpha1",
                          "K8sRequiredLabels"), "ns-must-have-gk")
    return {"sweep": report,
            "status_violations": len((con.get("status") or {})
                                     .get("violations") or []),
            "audit_timestamp": (con.get("status") or {}).get("auditTimestamp")}


def main(argv=None) -> int:
    args = parse_args(argv)
    # warm-restart persistence defaults ON for the managed entry point:
    # snapshots (lowered IR / dedup plan / store / pagemap) live next to
    # the build caches.  GATEKEEPER_SNAPSHOT_DIR="" disables; tests
    # constructing Manager directly stay hermetic (no default there).
    if "GATEKEEPER_SNAPSHOT_DIR" not in os.environ:
        from gatekeeper_tpu_torch.utils.compile_cache import cache_root
        os.environ["GATEKEEPER_SNAPSHOT_DIR"] = \
            os.path.join(cache_root(), "snapshots")
    mgr = Manager(args)
    if args.demo:
        out = run_demo(mgr)
        print(json.dumps(out, indent=2, default=str))
        return 0
    mgr.start()
    _log.info("gatekeeper-tpu-torch manager up",
              webhook_port=mgr.webhook.port if mgr.webhook else "off",
              audit_interval_s=args.audit_interval,
              device=str(getattr(mgr.client.driver, "device",
                                 args.engine_worker_url)))
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    mgr.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
