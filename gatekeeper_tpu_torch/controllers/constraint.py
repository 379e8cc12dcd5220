# Copied from gatekeeper_tpu/controllers/constraint.py for the PyTorch port.
"""Per-constraint-kind reconciler.

Reference: pkg/controller/constraint/constraint_controller.go:97-158.
Instantiated per constraint kind as the template controller registrar's
addFn (constrainttemplate_controller.go:76-79): finalizer, clear
``status.byPod[].errors``, AddConstraint into the engine, set
``status.byPod[].enforced``; deletion removes the constraint and strips
the finalizer.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.controllers.runtime import (DONE, REQUEUE, ReconcileResult,
                                                Reconciler, Request)
from gatekeeper_tpu_torch.errors import ApiConflictError, ClientError, NotFoundError
from gatekeeper_tpu_torch.utils.finalizers import (add_finalizer, has_finalizer,
                                             strip_finalizer)
from gatekeeper_tpu_torch.utils.ha_status import get_ha_status, set_ha_status

FINALIZER = "finalizers.gatekeeper.sh/constraint"


class ReconcileConstraint(Reconciler):
    def __init__(self, cluster: FakeCluster, client: Client, gvk: GVK):
        self.cluster = cluster
        self.client = client
        self.gvk = gvk
        self.name = f"constraint-controller[{gvk.kind}]"

    def reconcile(self, request: Request) -> ReconcileResult:
        instance = self.cluster.try_get(self.gvk, request.name,
                                        request.namespace)
        if instance is None:
            return DONE
        if not (instance.get("metadata") or {}).get("deletionTimestamp"):
            if add_finalizer(instance, FINALIZER):
                instance, result = self._update(instance)
                if instance is None:
                    return result
            status = get_ha_status(instance)
            status.pop("errors", None)
            status.pop("warnings", None)
            set_ha_status(instance, status)
            try:
                self.client.add_constraint(instance)
            except ClientError as err:
                status.setdefault("errors", []).append(
                    {"code": "add_error", "message": str(err)})
                set_ha_status(instance, status)
                self._update(instance)
                return DONE
            # Stage-3 set analysis (analysis/policyset.py): flag this
            # constraint as shadowed/unreachable against the other
            # installed constraints of its kind.  Warnings only — the
            # constraint still enforces (a shadowed constraint is
            # redundant, not wrong).
            try:
                from gatekeeper_tpu_torch.analysis.policyset import (
                    constraint_set_warnings)
                name = (instance.get("metadata") or {}).get("name", "")
                installed = [
                    (n, d) for n, d in
                    self.client.constraints.get(self.gvk.kind, {}).items()
                    if n != name]
                for d in constraint_set_warnings(
                        self.gvk.kind, name, instance, installed):
                    status.setdefault("warnings", []).append(
                        {"code": d.code, "message": d.message,
                         "location": str(d.location)})
            except Exception:
                pass        # set analysis must never block enforcement
            # unknown enforcementAction values fail closed to deny in
            # the webhook (client/types.enforcement_action_of); surface
            # the typo here so the author learns before a rollout does
            action = (instance.get("spec") or {}).get("enforcementAction")
            if action is not None:
                from gatekeeper_tpu_torch.client.types import ENFORCEMENT_ACTIONS
                if action not in ENFORCEMENT_ACTIONS:
                    status.setdefault("warnings", []).append(
                        {"code": "unknown_enforcement_action",
                         "message": f"unknown enforcementAction "
                                    f"{action!r}; treating as deny",
                         "location": "spec.enforcementAction"})
            status["enforced"] = True
            set_ha_status(instance, status)
            _, result = self._update(instance)
            return result
        # deletion (:139-152)
        if has_finalizer(instance, FINALIZER):
            self.client.remove_constraint(instance)
            strip_finalizer(instance, FINALIZER)
            _, result = self._update(instance)
            return result
        return DONE

    def _update(self, instance: dict) -> tuple[dict | None, ReconcileResult]:
        try:
            return self.cluster.update(instance), DONE
        except ApiConflictError:
            return None, REQUEUE
        except NotFoundError:
            return None, DONE
