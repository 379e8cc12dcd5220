# Copied from gatekeeper_tpu/controllers/provider.py for the PyTorch port.
"""Provider reconciler — external-data provider lifecycle.

Reference: the frameworks external-data design registers Providers into
a ProviderCache consulted by the builtin at query time
(open-policy-agent/frameworks externaldata cache); the reconciler shape
follows this build's config controller.  Create/update (re)installs the
typed Provider into the ExternalDataRuntime — which drops the
provider's cache and breaker, since a spec change invalidates both —
and delete uninstalls it.  An invalid spec is recorded in the object's
status and is terminal (DONE, not REQUEUE: requeuing cannot fix a bad
spec; the next user edit triggers a fresh reconcile).
"""

from __future__ import annotations

from gatekeeper_tpu_torch.api.externaldata import PROVIDER_GVK, Provider
from gatekeeper_tpu_torch.controllers.runtime import (DONE,
                                                      ReconcileResult,
                                                      Reconciler, Request)
from gatekeeper_tpu_torch.externaldata.runtime import ExternalDataRuntime
from gatekeeper_tpu_torch.utils.log import logger

_log = logger("controller.provider")


class ReconcileProvider(Reconciler):
    name = "provider-controller"

    def __init__(self, cluster, runtime: ExternalDataRuntime):
        self.cluster = cluster
        self.runtime = runtime

    def reconcile(self, request: Request) -> ReconcileResult:
        instance = self.cluster.try_get(PROVIDER_GVK, request.name)
        if instance is None or \
                (instance.get("metadata") or {}).get("deletionTimestamp"):
            self.runtime.unregister(request.name)
            _log.info("provider unregistered", provider=request.name)
            return DONE
        try:
            provider = Provider.from_dict(instance)
        except (ValueError, TypeError) as e:
            self.runtime.unregister(request.name)
            _log.warning("provider spec invalid", provider=request.name,
                         error=str(e))
            self._set_status(instance, error=str(e))
            return DONE
        try:
            self.runtime.register(provider)
        except ValueError as e:     # unsupported URL scheme
            self._set_status(instance, error=str(e))
            return DONE
        _log.info("provider registered", provider=provider.name,
                  url=provider.url, failure_policy=provider.failure_policy)
        self._set_status(instance, error=None)
        return DONE

    def _set_status(self, instance: dict, error: str | None) -> None:
        from gatekeeper_tpu_torch.errors import ApiError
        status = instance.setdefault("status", {})
        want = {"state": "Active"} if error is None else \
            {"state": "Error", "error": error}
        if status.get("byPod") == [want]:
            return
        status["byPod"] = [want]
        try:
            self.cluster.update(instance)
        except ApiError:
            pass    # status is advisory; the registry is authoritative
