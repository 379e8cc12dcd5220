# Copied from gatekeeper_tpu/cluster/protocol.py for the PyTorch port.
"""The cluster seam: what the control plane requires of an apiserver.

Every controller, the watch manager, the audit manager, and the webhook
bootstrap talk to a cluster exclusively through this surface — the
reference's equivalent is the controller-runtime client + discovery +
informer stack over a live kube-apiserver (cmd/manager/main.go:43-51,
sync_controller.go:99-148, audit/manager.go:153-159).

Implementations:
- cluster.fake.FakeCluster — in-memory envtest analogue (tests, demo);
- cluster.kube.KubeCluster — a real apiserver over raw HTTPS
  (kubeconfig auth, discovery, list+watch streams).
"""

from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.cluster.fake import Event


@runtime_checkable
class Cluster(Protocol):
    # discovery
    def kind_served(self, gvk: GVK) -> bool: ...
    def server_resources_for_group_version(self, group_version: str) -> list[dict]: ...

    # CRUD (unstructured objects; ApiError family on failure)
    def create(self, obj: dict) -> dict: ...
    def update(self, obj: dict) -> dict: ...
    def delete(self, gvk: GVK, name: str, namespace: str | None = None) -> None: ...
    def get(self, gvk: GVK, name: str, namespace: str | None = None) -> dict: ...
    def try_get(self, gvk: GVK, name: str, namespace: str | None = None) -> dict | None: ...
    def list(self, gvk: GVK) -> list[dict]: ...

    # watch: subscribe a callback to a GVK's event stream; returns an
    # unsubscribe handle
    def watch(self, gvk: GVK, callback: Callable[[Event], None]) -> Callable[[], None]: ...
