# Copied from gatekeeper_tpu/controllers/registry.py for the PyTorch port.
"""Controller registry — AddToManager equivalent.

Reference: pkg/controller/controller.go:26-57.  The reference's Injector
pattern injects the policy client and a shared WatchManager into each
controller package.  Here ``add_to_manager`` wires the whole control
plane: watch manager, the constraint-kind registrar (owned by the
template controller), the sync registrar (owned by the config
controller), and the two statically-watched reconcilers.

Trimmed for the port: the external-data runtime and the provider
controller (ROADMAP A5) and the backend supervisor's template re-queue
on recovery (ROADMAP A8).  ``add_to_manager`` takes no external-data
runtime, and ``ControlPlane`` carries neither field.
"""

from __future__ import annotations

import dataclasses

from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.controllers.config import CONFIG_GVK, ReconcileConfig
from gatekeeper_tpu_torch.controllers.constraint import ReconcileConstraint
from gatekeeper_tpu_torch.controllers.constrainttemplate import (
    TEMPLATE_GVK, ReconcileConstraintTemplate)
from gatekeeper_tpu_torch.controllers.runtime import ControllerManager
from gatekeeper_tpu_torch.controllers.sync import ReconcileSync
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

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Pump reconciles to a fixed point, interleaving watch-roster
        polls (the reference's 5 s updateManagerLoop picks up CRDs that
        appeared mid-reconcile; here the poll happens whenever the work
        queue drains).  The in-memory cluster delivers watch events
        inline with each mutation, so an empty queue is the fixed point
        (the reference's ``settle`` wait for a real apiserver's stream
        threads comes with cluster/kube.py: ROADMAP A3, the next slice)."""
        total = 0
        while True:
            total += self.mgr.run_until_idle(max_steps)
            gen = self.watch_manager.generation
            self.watch_manager.poll_once()
            if self.watch_manager.generation == gen and not self.mgr._queue:
                return total


def add_to_manager(cluster: FakeCluster, client: Client,
                   mgr: ControllerManager | None = None) -> ControlPlane:
    mgr = mgr if mgr is not None else ControllerManager(cluster)
    wm = WatchManager(cluster, mgr)
    # (the reference installs the process-global external-data runtime
    # here and, when discovery serves the Provider kind, a provider
    # controller: ROADMAP A5, not part of the port yet)
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
    # (the reference also registers a recovery listener with the backend
    # supervisor that re-enqueues every ConstraintTemplate: ROADMAP A8;
    # the port has no supervisor, so nothing recovers and nothing
    # re-enqueues)
    return ControlPlane(cluster=cluster, client=client, mgr=mgr,
                        watch_manager=wm,
                        constraint_registrar=constraint_registrar,
                        sync_registrar=sync_registrar,
                        template_controller=template_controller,
                        config_controller=config_controller)
