# Copied from gatekeeper_tpu/controllers/sync.py for the PyTorch port.
"""Per-synced-GVK data-ingest reconciler.

Reference: pkg/controller/sync/sync_controller.go:99-176.  Instantiated
per synced GVK as the config controller registrar's addFn
(config_controller.go:83-86).  Upsert: add the sync finalizer then
AddData; delete: RemoveData then strip the finalizer.  This is the
resource-cache ingest path feeding the engine's columnar store.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.cluster.fake import FakeCluster, gvk_of
from gatekeeper_tpu_torch.controllers.runtime import (DONE, REQUEUE, ReconcileResult,
                                                Reconciler, Request)
from gatekeeper_tpu_torch.errors import ApiConflictError, NotFoundError
from gatekeeper_tpu_torch.utils.finalizers import (add_finalizer, has_finalizer,
                                             strip_finalizer)

FINALIZER = "finalizers.gatekeeper.sh/sync"


def has_sync_finalizer(obj: dict) -> bool:
    return has_finalizer(obj, FINALIZER)


def remove_sync_finalizer(cluster: FakeCluster, obj: dict) -> None:
    strip_finalizer(obj, FINALIZER)
    cluster.update(obj)


class ReconcileSync(Reconciler):
    def __init__(self, cluster: FakeCluster, client: Client, gvk: GVK):
        self.cluster = cluster
        self.client = client
        self.gvk = gvk
        self.name = f"sync-controller[{gvk.kind}]"

    def reconcile(self, request: Request) -> ReconcileResult:
        instance = self.cluster.try_get(self.gvk, request.name,
                                        request.namespace)
        if instance is None:
            return DONE
        if gvk_of(instance) != self.gvk:
            return DONE  # unexpected data (:113-116)
        meta = instance.setdefault("metadata", {})
        if not meta.get("deletionTimestamp"):
            if add_finalizer(instance, FINALIZER):
                try:
                    instance = self.cluster.update(instance)
                except ApiConflictError:
                    return REQUEUE
                except NotFoundError:
                    return DONE
            self.client.add_data(instance)
        elif has_sync_finalizer(instance):
            self.client.remove_data(instance)
            try:
                remove_sync_finalizer(self.cluster, instance)
            except ApiConflictError:
                return REQUEUE
            except NotFoundError:
                pass
        return DONE
