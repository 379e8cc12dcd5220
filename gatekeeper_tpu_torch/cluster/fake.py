# Copied from gatekeeper_tpu/cluster/fake.py for the PyTorch port.
"""In-memory fake cluster — the envtest analogue.

The reference's controller suites boot a real etcd + kube-apiserver via
controller-runtime's envtest (constrainttemplate_controller_suite_test.go:37-43)
to exercise reconcilers end-to-end.  This build substitutes a small
in-memory apiserver with the semantics the control plane actually relies
on:

- CRUD over unstructured objects with resourceVersion conflict checks
  (optimistic concurrency — drives the controllers' Requeue-on-conflict
  paths);
- k8s finalizer semantics: deleting an object with finalizers only sets
  ``metadata.deletionTimestamp``; the object is removed when the last
  finalizer is stripped by an update (what the template/sync/config
  controllers' finalizer flows assume);
- watch event streams (ADDED/MODIFIED/DELETED) per GVK;
- discovery of served kinds, auto-registered from CustomResourceDefinition
  objects (the audit manager's constraint-kind discovery,
  audit/manager.go:153-159, and the watch manager's pending-CRD filter,
  watch/manager.go:303-327, both ride this);
- failure injection for exponential-backoff paths
  (audit/manager.go:371-378).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import threading
from typing import Callable

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.errors import (ApiError, ApiConflictError,
                                   AlreadyExistsError, NotFoundError)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclasses.dataclass(frozen=True)
class Event:
    type: str           # ADDED | MODIFIED | DELETED
    obj: dict           # deep copy of the object at event time


def _strip_rv(obj: dict) -> dict:
    c = copy.deepcopy(obj)
    meta = c.get("metadata")
    if isinstance(meta, dict):
        meta.pop("resourceVersion", None)
        meta.pop("selfLink", None)
    return c


def gvk_of(obj: dict) -> GVK:
    return GVK.from_api_version(obj.get("apiVersion", ""), obj.get("kind", ""))


def namespaced_name(obj: dict) -> tuple[str | None, str]:
    meta = obj.get("metadata") or {}
    return meta.get("namespace"), meta.get("name", "")


class FakeCluster:
    def __init__(self):
        self._lock = threading.RLock()
        self._objects: dict[GVK, dict[tuple, dict]] = {}
        self._kinds: dict[str, dict[str, str]] = {}   # group/version -> kind -> plural
        self._watchers: dict[GVK, list] = {}
        self._rv = itertools.count(1)
        self._ts = itertools.count(1)
        self._update_failures = 0

    # ------------------------------------------------------------------
    # discovery

    def register_kind(self, gvk: GVK, plural: str | None = None) -> None:
        with self._lock:
            self._kinds.setdefault(gvk.group_version, {})[gvk.kind] = (
                plural or gvk.kind.lower())

    def unregister_kind(self, gvk: GVK) -> None:
        with self._lock:
            self._kinds.get(gvk.group_version, {}).pop(gvk.kind, None)

    def kind_served(self, gvk: GVK) -> bool:
        with self._lock:
            return gvk.kind in self._kinds.get(gvk.group_version, {})

    def server_resources_for_group_version(self, group_version: str) -> list[dict]:
        """Discovery: kinds served under a group/version; raises
        NotFoundError when none (the audit manager treats that as "no
        constraints yet" and returns early)."""
        with self._lock:
            kinds = self._kinds.get(group_version)
            if not kinds:
                raise NotFoundError(f"no resources for {group_version}")
            return [{"kind": k, "name": plural}
                    for k, plural in sorted(kinds.items())]

    # ------------------------------------------------------------------
    # CRUD

    def create(self, obj: dict) -> dict:
        with self._lock:
            gvk = gvk_of(obj)
            key = namespaced_name(obj)
            if not key[1]:
                raise ApiError("object has no metadata.name")
            store = self._objects.setdefault(gvk, {})
            if key in store:
                raise AlreadyExistsError(f"{gvk.kind} {key} already exists")
            stored = copy.deepcopy(obj)
            meta = stored.setdefault("metadata", {})
            meta["resourceVersion"] = str(next(self._rv))
            meta["selfLink"] = self._self_link(gvk, key)
            store[key] = stored
            self._maybe_register_crd(stored, deleted=False)
            out = copy.deepcopy(stored)
        self._notify(gvk, Event(ADDED, copy.deepcopy(stored)))
        return out

    def update(self, obj: dict) -> dict:
        with self._lock:
            if self._update_failures > 0:
                self._update_failures -= 1
                raise ApiError("injected update failure")
            gvk = gvk_of(obj)
            key = namespaced_name(obj)
            store = self._objects.setdefault(gvk, {})
            current = store.get(key)
            if current is None:
                raise NotFoundError(f"{gvk.kind} {key} not found")
            meta = obj.get("metadata") or {}
            rv = meta.get("resourceVersion")
            if rv is not None and rv != current["metadata"]["resourceVersion"]:
                raise ApiConflictError(
                    f"{gvk.kind} {key}: resourceVersion conflict "
                    f"(have {current['metadata']['resourceVersion']}, got {rv})")
            # no-op updates don't bump resourceVersion or emit events
            # (apiserver semantics; controllers whose reconcile writes
            # status unconditionally rely on this to reach a fixed point)
            if _strip_rv(current) == _strip_rv(obj):
                return copy.deepcopy(current)
            stored = copy.deepcopy(obj)
            smeta = stored.setdefault("metadata", {})
            smeta["resourceVersion"] = str(next(self._rv))
            smeta["selfLink"] = current["metadata"].get("selfLink")
            # finalizer semantics: a terminating object whose finalizers
            # have all been stripped is removed by this update
            events: list[tuple[GVK, Event]] = []
            if smeta.get("deletionTimestamp") and not smeta.get("finalizers"):
                del store[key]
                self._maybe_register_crd(stored, deleted=True)
                events.append((gvk, Event(DELETED, copy.deepcopy(stored))))
                events += self._finish_crd_cleanup(gvk)
            else:
                store[key] = stored
                events.append((gvk, Event(MODIFIED, copy.deepcopy(stored))))
            out = copy.deepcopy(stored)
        for egvk, event in events:
            self._notify(egvk, event)
        return out

    def delete(self, gvk: GVK, name: str, namespace: str | None = None) -> None:
        events: list[tuple[GVK, Event]] = []
        with self._lock:
            store = self._objects.setdefault(gvk, {})
            key = (namespace, name)
            current = store.get(key)
            if current is None:
                raise NotFoundError(f"{gvk.kind} {key} not found")
            meta = current["metadata"]
            # apiextensions semantics: deleting a CRD cascades to its
            # custom resources; the CRD stays terminating until every CR
            # is finalized (the template controller's delete flow waits
            # on exactly this, constrainttemplate_controller.go:281-288)
            events += self._cascade_crd_delete(current)
            served = self._crd_served_gvk(current)
            blocked = served is not None and bool(self._objects.get(served))
            if meta.get("finalizers") or blocked:
                if not meta.get("deletionTimestamp"):
                    meta["deletionTimestamp"] = f"T{next(self._ts):08d}"
                    meta["resourceVersion"] = str(next(self._rv))
                    events.append((gvk, Event(MODIFIED, copy.deepcopy(current))))
            else:
                del store[key]
                self._maybe_register_crd(current, deleted=True)
                events.append((gvk, Event(DELETED, copy.deepcopy(current))))
                events += self._finish_crd_cleanup(gvk)
        for egvk, event in events:
            self._notify(egvk, event)

    @staticmethod
    def _crd_version(spec: dict) -> str:
        """v1beta1 CRDs carry spec.version; v1 CRDs carry
        spec.versions[] (the served one, or the first)."""
        if spec.get("version"):
            return spec["version"]
        for v in spec.get("versions") or []:
            if v.get("served", True):
                return v.get("name", "")
        return ""

    def _crd_served_gvk(self, obj: dict) -> GVK | None:
        if obj.get("kind") != "CustomResourceDefinition":
            return None
        spec = obj.get("spec") or {}
        names = spec.get("names") or {}
        if not names.get("kind"):
            return None
        return GVK(group=spec.get("group", ""),
                   version=self._crd_version(spec), kind=names["kind"])

    def _cascade_crd_delete(self, crd: dict) -> list[tuple[GVK, Event]]:
        """Issue deletes for every CR of a CRD being deleted (with lock
        held; per-CR finalizer semantics apply individually)."""
        served = self._crd_served_gvk(crd)
        if served is None or crd["metadata"].get("deletionTimestamp"):
            return []
        events: list[tuple[GVK, Event]] = []
        store = self._objects.get(served, {})
        for key in list(store):
            cr = store[key]
            meta = cr["metadata"]
            if meta.get("finalizers"):
                if not meta.get("deletionTimestamp"):
                    meta["deletionTimestamp"] = f"T{next(self._ts):08d}"
                    meta["resourceVersion"] = str(next(self._rv))
                    events.append((served, Event(MODIFIED, copy.deepcopy(cr))))
            else:
                del store[key]
                events.append((served, Event(DELETED, copy.deepcopy(cr))))
        return events

    def _finish_crd_cleanup(self, removed_gvk: GVK) -> list[tuple[GVK, Event]]:
        """When the last CR of a terminating CRD is finalized, remove the
        CRD itself (with lock held)."""
        if self._objects.get(removed_gvk):
            return []
        events: list[tuple[GVK, Event]] = []
        for crd_version in ("v1beta1", "v1"):
            crd_gvk = GVK("apiextensions.k8s.io", crd_version,
                          "CustomResourceDefinition")
            store = self._objects.get(crd_gvk, {})
            for key in list(store):
                crd = store[key]
                if not crd["metadata"].get("deletionTimestamp"):
                    continue
                if crd["metadata"].get("finalizers"):
                    continue
                if self._crd_served_gvk(crd) != removed_gvk:
                    continue
                del store[key]
                self._maybe_register_crd(crd, deleted=True)
                events.append((crd_gvk, Event(DELETED, copy.deepcopy(crd))))
        return events

    def get(self, gvk: GVK, name: str, namespace: str | None = None) -> dict:
        with self._lock:
            obj = self._objects.get(gvk, {}).get((namespace, name))
            if obj is None:
                raise NotFoundError(f"{gvk.kind} {(namespace, name)} not found")
            return copy.deepcopy(obj)

    def try_get(self, gvk: GVK, name: str, namespace: str | None = None) -> dict | None:
        try:
            return self.get(gvk, name, namespace)
        except NotFoundError:
            return None

    def list(self, gvk: GVK) -> list[dict]:
        with self._lock:
            return [copy.deepcopy(o) for _, o in sorted(
                self._objects.get(gvk, {}).items(),
                key=lambda kv: (kv[0][0] or "", kv[0][1]))]

    # ------------------------------------------------------------------
    # watch

    def watch(self, gvk: GVK, callback: Callable[[Event], None]):
        """Subscribe to events for a GVK.  Returns an unsubscribe handle."""
        with self._lock:
            handles = self._watchers.setdefault(gvk, [])
            handles.append(callback)

        def unsubscribe():
            with self._lock:
                if callback in self._watchers.get(gvk, []):
                    self._watchers[gvk].remove(callback)
        return unsubscribe

    def _notify(self, gvk: GVK, event: Event) -> None:
        with self._lock:
            watchers = list(self._watchers.get(gvk, []))
        for cb in watchers:
            cb(event)

    # ------------------------------------------------------------------
    # failure injection

    def inject_update_failures(self, n: int) -> None:
        with self._lock:
            self._update_failures = n

    # ------------------------------------------------------------------

    def _self_link(self, gvk: GVK, key: tuple) -> str:
        ns, name = key
        plural = self._kinds.get(gvk.group_version, {}).get(
            gvk.kind, gvk.kind.lower() + "s")
        prefix = "/api" if gvk.group == "" else f"/apis/{gvk.group}"
        mid = f"namespaces/{ns}/" if ns else ""
        return f"{prefix}/{gvk.version}/{mid}{plural}/{name}"

    def _maybe_register_crd(self, obj: dict, deleted: bool) -> None:
        """CustomResourceDefinition objects drive discovery (the template
        controller creates the per-constraint-kind CRDs in-cluster;
        discovery must then serve the kind)."""
        if obj.get("kind") != "CustomResourceDefinition":
            return
        spec = obj.get("spec") or {}
        names = spec.get("names") or {}
        gvk = GVK(group=spec.get("group", ""),
                  version=self._crd_version(spec),
                  kind=names.get("kind", ""))
        if not gvk.kind:
            return
        if deleted:
            self.unregister_kind(gvk)
        else:
            self.register_kind(gvk, names.get("plural"))
