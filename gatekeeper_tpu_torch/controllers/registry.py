# Copied from gatekeeper_tpu/controllers/registry.py for the PyTorch port.
"""Controller registry — AddToManager equivalent.

Reference: pkg/controller/controller.go:26-57.  The reference's Injector
pattern injects the policy client and a shared WatchManager into each
controller package.  Here ``add_to_manager`` wires the whole control
plane: watch manager, the constraint-kind registrar (owned by the
template controller), the sync registrar (owned by the config
controller), and the two statically-watched reconcilers.  A recovery of
the client driver's device re-enqueues every ConstraintTemplate
(resilience/supervisor.py).
"""

from __future__ import annotations

import dataclasses

from gatekeeper_tpu_torch.api.externaldata import PROVIDER_GVK
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.controllers.config import CONFIG_GVK, ReconcileConfig
from gatekeeper_tpu_torch.controllers.constraint import ReconcileConstraint
from gatekeeper_tpu_torch.controllers.constrainttemplate import (
    TEMPLATE_GVK, ReconcileConstraintTemplate)
from gatekeeper_tpu_torch.controllers.provider import ReconcileProvider
from gatekeeper_tpu_torch.controllers.runtime import ControllerManager
from gatekeeper_tpu_torch.controllers.sync import ReconcileSync
from gatekeeper_tpu_torch.externaldata.runtime import (ExternalDataRuntime,
                                                       get_runtime,
                                                       set_runtime)
from gatekeeper_tpu_torch.watch.manager import Registrar, WatchManager


@dataclasses.dataclass
class ControlPlane:
    cluster: FakeCluster
    client: Client
    mgr: ControllerManager
    watch_manager: WatchManager
    constraint_registrar: Registrar
    sync_registrar: Registrar
    template_controller: ReconcileConstraintTemplate
    config_controller: ReconcileConfig
    provider_controller: "ReconcileProvider | None" = None
    external_data: "ExternalDataRuntime | None" = None

    def run_until_idle(self, max_steps: int = 100_000,
                       settle: float = 0.0) -> int:
        """Pump reconciles to a fixed point, interleaving watch-roster
        polls (the reference's 5 s updateManagerLoop picks up CRDs that
        appeared mid-reconcile; here the poll happens whenever the work
        queue drains).

        ``settle`` (seconds): with an asynchronous cluster (real
        apiserver — watch events arrive on stream threads, not inline
        with mutations) an empty queue may just mean "events in flight";
        keep waiting up to `settle` for more work before declaring the
        fixed point."""
        import time as _time
        total = 0
        while True:
            total += self.mgr.run_until_idle(max_steps)
            gen = self.watch_manager.generation
            self.watch_manager.poll_once()
            if self.watch_manager.generation != gen or self.mgr._queue:
                continue
            if settle <= 0:
                return total
            deadline = _time.monotonic() + settle
            while _time.monotonic() < deadline and not self.mgr._queue:
                _time.sleep(0.02)
            if not self.mgr._queue:
                return total


def _template_requeuer(cluster, mgr, template_controller):
    from gatekeeper_tpu_torch.controllers.runtime import Request

    def _requeue():
        for obj in cluster.list(TEMPLATE_GVK):
            meta = obj.get("metadata") or {}
            mgr.enqueue(template_controller,
                        Request(name=meta.get("name", ""),
                                namespace=meta.get("namespace")))
    return _requeue


def add_to_manager(cluster: FakeCluster, client: Client,
                   mgr: ControllerManager | None = None,
                   external_data: ExternalDataRuntime | None = None) \
        -> ControlPlane:
    mgr = mgr if mgr is not None else ControllerManager(cluster)
    wm = WatchManager(cluster, mgr)
    # external-data: the runtime the `external_data` builtin consults is
    # process-global (the builtin registry can't thread per-eval state);
    # reuse an installed one so tests composing several control planes
    # share provider state the way one process shares one registry
    if external_data is None:
        external_data = get_runtime()
    if external_data is None:
        external_data = ExternalDataRuntime()
        set_runtime(external_data)
    constraint_registrar = wm.new_registrar(
        "constraint-controller",
        lambda gvk: ReconcileConstraint(cluster, client, gvk))
    sync_registrar = wm.new_registrar(
        "sync-controller",
        lambda gvk: ReconcileSync(cluster, client, gvk))
    template_controller = ReconcileConstraintTemplate(
        cluster, client, constraint_registrar)
    mgr.watch(TEMPLATE_GVK, template_controller)
    config_controller = ReconcileConfig(cluster, client, sync_registrar)
    mgr.watch(CONFIG_GVK, config_controller)
    # gated on discovery (like the reference gates its external-data
    # controller on the Provider CRD): a cluster that does not serve
    # the kind gets no provider watch — bootstrap_cluster applies the
    # CRD, so the managed path always does
    provider_controller = None
    served = getattr(cluster, "kind_served", None)
    if served is None or served(PROVIDER_GVK):
        provider_controller = ReconcileProvider(cluster, external_data)
        mgr.watch(PROVIDER_GVK, provider_controller)
    # backend recovery (resilience/supervisor): re-enqueue every
    # ConstraintTemplate so the idempotent reconcile re-installs each
    # template through the driver's warm put_template path (failure
    # recovery is reconcile idempotence).  The manager is held weakly by
    # the supervisor of the client driver's device: test-built control
    # planes don't accumulate there
    from gatekeeper_tpu_torch.resilience.supervisor import supervisor_of
    sup = supervisor_of(getattr(client, "driver", None))
    if sup is not None:
        mgr._requeue_templates = _template_requeuer(  # type: ignore[attr-defined]
            cluster, mgr, template_controller)
        sup.add_recovery_listener(mgr, "_requeue_templates")
    return ControlPlane(cluster=cluster, client=client, mgr=mgr,
                        watch_manager=wm,
                        constraint_registrar=constraint_registrar,
                        sync_registrar=sync_registrar,
                        template_controller=template_controller,
                        config_controller=config_controller,
                        provider_controller=provider_controller,
                        external_data=external_data)
