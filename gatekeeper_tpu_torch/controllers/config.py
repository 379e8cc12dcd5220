# Copied from gatekeeper_tpu/controllers/config.py for the PyTorch port.
"""Config reconciler — sync roster + data wipe + finalizer cleanup.

Reference: pkg/controller/config/config_controller.go:130-314.  Reconciles
the singleton ``gatekeeper-system/config``: reads ``spec.sync.syncOnly``,
**wipes all cached data when the set changes** (pausing the watch manager
so sync can't race the wipe), replaces the sync registrar's watch roster,
and maintains per-pod ``status.byPod[].allFinalizers`` so sync finalizers
on no-longer-watched kinds get cleaned up even across restarts.

Deviation: the reference runs finalizer cleanup in an async goroutine
with exponential backoff (:247-314); this build runs one cleanup pass
inline per reconcile and requeues while any GVK still fails — same
eventual behavior, deterministic under the test pump.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.api.config import (CONFIG_GROUP, CONFIG_NAME,
                                       CONFIG_NAMESPACE, CONFIG_VERSION,
                                       Config, GVK)
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.client.targets import WipeData
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.controllers.runtime import (DONE, REQUEUE, ReconcileResult,
                                                Reconciler, Request)
from gatekeeper_tpu_torch.controllers.sync import (has_sync_finalizer,
                                             remove_sync_finalizer)
from gatekeeper_tpu_torch.errors import ApiConflictError, ApiError, NotFoundError
from gatekeeper_tpu_torch.utils.finalizers import add_finalizer, strip_finalizer
from gatekeeper_tpu_torch.utils.ha_status import get_ha_status, set_ha_status
from gatekeeper_tpu_torch.watch.manager import Registrar

CONFIG_GVK = GVK(CONFIG_GROUP, CONFIG_VERSION, "Config")
FINALIZER = "finalizers.gatekeeper.sh/config"


class ReconcileConfig(Reconciler):
    name = "config-controller"

    def __init__(self, cluster: FakeCluster, client: Client,
                 sync_registrar: Registrar):
        self.cluster = cluster
        self.client = client
        self.watcher = sync_registrar
        self.watched: set[GVK] = set()

    def reconcile(self, request: Request) -> ReconcileResult:
        if (request.namespace, request.name) != (CONFIG_NAMESPACE, CONFIG_NAME):
            return DONE  # unsupported config name (:137-139)
        instance = self.cluster.try_get(CONFIG_GVK, CONFIG_NAME,
                                        CONFIG_NAMESPACE)
        if instance is None:
            return DONE

        meta = instance.setdefault("metadata", {})
        terminating = bool(meta.get("deletionTimestamp"))
        new_sync_only: set[GVK] = set()
        if not terminating:
            if add_finalizer(instance, FINALIZER):
                try:
                    instance = self.cluster.update(instance)
                    meta = instance["metadata"]
                except ApiConflictError:
                    return REQUEUE
                except NotFoundError:
                    return DONE
            new_sync_only = set(Config.from_dict(instance).spec.sync_only)

        status = get_ha_status(instance)
        to_clean = {GVK.from_dict(g)
                    for g in status.get("allFinalizers") or []}

        paused = False
        try:
            if self.watched != new_sync_only:
                # wipe all data to avoid stale state (:178-188)
                self.watcher.pause()
                paused = True
                self.client.remove_data(WipeData())

            to_clean |= self.watched
            status["allFinalizers"] = [g.to_dict() for g in sorted(to_clean)]
            stale = to_clean - new_sync_only
            failed = self._clean_finalizers(stale, status) if stale else set()

            self.watcher.replace_watch(sorted(new_sync_only))

            # only release the config's own finalizer once every stale
            # sync finalizer is cleaned — otherwise the allFinalizers
            # record (the durable cleanup intent) dies with the object
            if terminating and not failed:
                strip_finalizer(instance, FINALIZER)
            set_ha_status(instance, status)
            try:
                self.cluster.update(instance)
            except ApiConflictError:
                return REQUEUE
            except NotFoundError:
                pass
            self.watched = set(new_sync_only)
            return REQUEUE if failed else DONE
        finally:
            if paused:
                self.watcher.unpause()

    def _clean_finalizers(self, gvks: set[GVK], status: dict) -> set[GVK]:
        """One pass of the finalizerCleanup loop (:247-314): strip sync
        finalizers from every object of each stale GVK; on full success
        drop the GVK from allFinalizers.  Returns the GVKs that still
        have work (caller requeues)."""
        failed: set[GVK] = set()
        for gvk in sorted(gvks):
            ok = True
            for obj in self.cluster.list(gvk):
                if not has_sync_finalizer(obj):
                    continue
                try:
                    remove_sync_finalizer(self.cluster, obj)
                except ApiError:
                    ok = False
            if ok:
                status["allFinalizers"] = [
                    g for g in status.get("allFinalizers") or []
                    if GVK.from_dict(g) != gvk]
            else:
                failed.add(gvk)
        return failed
