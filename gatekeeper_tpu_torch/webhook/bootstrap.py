# Copied from gatekeeper_tpu/webhook/bootstrap.py for the PyTorch port.
"""Webhook self-bootstrap: certs + in-cluster registration.

Reference: pkg/webhook/policy.go:81-100 — unless ``-enable-manual-deploy``
is set, the webhook installs its own serving secret, service, and
``ValidatingWebhookConfiguration`` so the apiserver starts calling back.
Here the same three objects are written through the cluster protocol
(works identically against the FakeCluster and a real apiserver), and
the self-signed serving cert is generated with the system openssl when
the cert dir is empty (no cert library is vendored).

The VWC's serving-posture annotations state what ``/healthz`` states:
the backend supervisor's state and backend for the serving driver's
device (resilience/supervisor.py), refreshed when that device recovers;
without a supervisor (a driver with no device), healthy on ``backend``.
"""

from __future__ import annotations

import base64
import os
import subprocess

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.errors import (AlreadyExistsError, ApiError,
                                   NotFoundError)

NAMESPACE = "gatekeeper-system"
SERVICE_NAME = "gatekeeper-webhook-service"
SECRET_NAME = "gatekeeper-webhook-server-secret"
DEFAULT_WEBHOOK_NAME = "validation.gatekeeper.sh"
VWC_GVK = GVK("admissionregistration.k8s.io", "v1beta1",
              "ValidatingWebhookConfiguration")


def ensure_certs(cert_dir: str, service: str = SERVICE_NAME,
                 namespace: str = NAMESPACE) -> str | None:
    """Generate a self-signed serving cert into cert_dir when absent;
    returns the PEM CA bundle (the cert itself — self-signed) or None
    when generation is unavailable."""
    crt = os.path.join(cert_dir, "tls.crt")
    key = os.path.join(cert_dir, "tls.key")
    if not (os.path.exists(crt) and os.path.exists(key)):
        os.makedirs(cert_dir, exist_ok=True)
        cn = f"{service}.{namespace}.svc"
        try:
            subprocess.run(
                ["openssl", "req", "-x509", "-newkey", "rsa:2048",
                 "-keyout", key, "-out", crt, "-days", "3650", "-nodes",
                 "-subj", f"/CN={cn}",
                 "-addext", f"subjectAltName=DNS:{cn},DNS:localhost,"
                            f"IP:127.0.0.1"],
                check=True, capture_output=True, timeout=60)
        except (OSError, subprocess.SubprocessError):
            return None
    with open(crt) as f:
        return f.read()


def _apply(cluster, obj: dict) -> None:
    """create-or-update through the cluster protocol."""
    try:
        cluster.create(obj)
    except AlreadyExistsError:
        gvk = GVK.from_api_version(obj["apiVersion"], obj["kind"])
        meta = obj.get("metadata") or {}
        current = cluster.try_get(gvk, meta.get("name", ""),
                                  meta.get("namespace"))
        if current is not None:
            obj = dict(obj)
            obj["metadata"] = dict(meta)
            obj["metadata"]["resourceVersion"] = \
                (current.get("metadata") or {}).get("resourceVersion")
            cluster.update(obj)


def apply_crd(cluster, name: str, group: str, version: str, kind: str,
              plural: str, namespaced: bool = True) -> None:
    """Install a CustomResourceDefinition, v1-first (apiextensions
    v1beta1 was removed in Kubernetes 1.22) with a v1beta1 fallback for
    older apiservers; idempotent."""
    v1 = {"apiVersion": "apiextensions.k8s.io/v1",
          "kind": "CustomResourceDefinition",
          "metadata": {"name": name},
          "spec": {"group": group,
                   "names": {"kind": kind, "plural": plural},
                   "scope": "Namespaced" if namespaced else "Cluster",
                   "versions": [{"name": version, "served": True,
                                 "storage": True,
                                 "schema": {"openAPIV3Schema": {
                                     "type": "object",
                                     "x-kubernetes-preserve-unknown-fields":
                                         True}}}]}}
    try:
        _apply(cluster, v1)
        return
    except NotFoundError:
        pass                     # pre-1.16 apiserver: fall back
    _apply(cluster, {"apiVersion": "apiextensions.k8s.io/v1beta1",
                     "kind": "CustomResourceDefinition",
                     "metadata": {"name": name},
                     "spec": {"group": group, "version": version,
                              "names": {"kind": kind, "plural": plural}}})


def bootstrap_webhook(cluster, cert_dir: str, port: int,
                      webhook_name: str = DEFAULT_WEBHOOK_NAME,
                      namespace: str = NAMESPACE,
                      service: str = SERVICE_NAME,
                      backend: str = "scalar", supervisor=None) -> bool:
    """Install the serving secret + service + VWC (policy.go:81-100).
    Returns False (and installs nothing) when certs are unavailable —
    the operator then deploys manually, exactly the
    ``-enable-manual-deploy`` posture.  The VWC's annotations state the
    posture of ``supervisor`` (the serving driver's device's) and are
    refreshed on its recovery; without one, healthy on ``backend``
    (webhook/server.backend_of)."""
    ca = ensure_certs(cert_dir, service, namespace)
    if ca is None:
        return False
    with open(os.path.join(cert_dir, "tls.key")) as f:
        key_pem = f.read()
    b64 = lambda s: base64.b64encode(s.encode()).decode()
    try:
        _apply(cluster, {
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": SECRET_NAME, "namespace": namespace},
            "type": "kubernetes.io/tls",
            "data": {"tls.crt": b64(ca), "tls.key": b64(key_pem)}})
        _apply(cluster, {
            "apiVersion": "v1", "kind": "Service",
            "metadata": {"name": service, "namespace": namespace},
            "spec": {"ports": [{"port": 443, "targetPort": port}],
                     "selector": {"control-plane": "controller-manager"}}})
        hook = {
            "name": webhook_name,
            "clientConfig": {
                "service": {"name": service, "namespace": namespace,
                            "path": "/v1/admit"},
                "caBundle": b64(ca)},
            "rules": [{"apiGroups": ["*"], "apiVersions": ["*"],
                       "operations": ["CREATE", "UPDATE"],
                       "resources": ["*"]}],
            "failurePolicy": "Ignore"}
        try:
            # v1 first: admissionregistration v1beta1 was removed in
            # Kubernetes 1.22 (v1 additionally requires sideEffects +
            # admissionReviewVersions)
            _apply(cluster, {
                "apiVersion": "admissionregistration.k8s.io/v1",
                "kind": "ValidatingWebhookConfiguration",
                "metadata": {"name": webhook_name,
                             "annotations": _backend_annotations(
                                 backend, supervisor)},
                "webhooks": [{**hook, "sideEffects": "None",
                              "admissionReviewVersions": ["v1", "v1beta1"]}]})
        except NotFoundError:
            _apply(cluster, {
                "apiVersion": "admissionregistration.k8s.io/v1beta1",
                "kind": "ValidatingWebhookConfiguration",
                "metadata": {"name": webhook_name,
                             "annotations": _backend_annotations(
                                 backend, supervisor)},
                "webhooks": [hook]})
    except ApiError:
        return False        # registration kinds not served: manual deploy
    if supervisor is not None:
        _watch_backend_recovery(cluster, webhook_name, supervisor)
    return True


def _backend_annotations(backend: str, supervisor=None) -> dict:
    """Serving-posture annotations on the VWC — the operator-visible
    analogue of the reference's ``status.byPod[]`` report (BASELINE.md):
    failurePolicy stays Ignore either way (a degraded webhook serves
    correct verdicts from the scalar oracle; it never fails closed),
    but the annotations say which engine answers admissions right now.
    Without a supervisor the driver has no device to lose: healthy, on
    ``backend``."""
    if supervisor is None:
        return {"gatekeeper.sh/backend-state": "healthy",
                "gatekeeper.sh/backend": backend}
    st = supervisor.status()
    ann = {"gatekeeper.sh/backend-state": st["state"],
           "gatekeeper.sh/backend": st["backend"]}
    if st["state"] != "healthy" and st["reason"]:
        ann["gatekeeper.sh/backend-reason"] = st["reason"][:256]
    return ann


def _watch_backend_recovery(cluster, webhook_name: str, supervisor) -> None:
    """Refresh the VWC's backend annotations when the supervisor
    transitions back to healthy, so the operating report recovers with
    the backend."""

    def _refresh():
        for api in ("admissionregistration.k8s.io/v1",
                    "admissionregistration.k8s.io/v1beta1"):
            try:
                gvk = GVK.from_api_version(
                    api, "ValidatingWebhookConfiguration")
                obj = cluster.get(gvk, webhook_name)
                meta = obj.setdefault("metadata", {})
                ann = meta.setdefault("annotations", {})
                ann.pop("gatekeeper.sh/backend-reason", None)
                ann.update(_backend_annotations("", supervisor))
                cluster.update(obj)
                return
            except ApiError:
                continue

    supervisor.on_recovery(_refresh)
