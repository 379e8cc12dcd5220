# Copied from gatekeeper_tpu/api/config.py for the PyTorch port.
"""Config CRD types — the runtime-dynamic knob surface.

Reference: pkg/apis/config/v1alpha1/config_types.go:24-99.  The Config CR
is a singleton (``gatekeeper-system/config`` only, enforced by the config
controller, config_controller.go:55,137) carrying:

- ``spec.sync.syncOnly[]{group,version,kind}`` — the GVK roster to
  replicate into the engine's data cache;
- ``spec.validation.traces[]{user,kind,dump}`` — per-user/kind trace
  toggles consumed by the webhook (policy.go:246-263);
- ``status.byPod[]{id,allFinalizers}`` — per-pod HA bookkeeping of which
  synced GVKs still carry sync finalizers.
"""

from __future__ import annotations

import dataclasses

CONFIG_NAMESPACE = "gatekeeper-system"
CONFIG_NAME = "config"
CONFIG_GROUP = "config.gatekeeper.sh"
CONFIG_VERSION = "v1alpha1"


@dataclasses.dataclass(frozen=True, order=True)
class GVK:
    """GroupVersionKind (config_types.go:84-88).  Core group is ""."""

    group: str = ""
    version: str = ""
    kind: str = ""

    @property
    def group_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version

    @classmethod
    def from_api_version(cls, api_version: str, kind: str) -> "GVK":
        if "/" in api_version:
            group, version = api_version.split("/", 1)
        else:
            group, version = "", api_version
        return cls(group=group, version=version, kind=kind)

    @classmethod
    def from_dict(cls, d: dict) -> "GVK":
        d = d or {}
        return cls(group=d.get("group", ""), version=d.get("version", ""),
                   kind=d.get("kind", ""))

    def to_dict(self) -> dict:
        return {"group": self.group, "version": self.version, "kind": self.kind}


@dataclasses.dataclass(frozen=True)
class Trace:
    """A trace-request selector (config_types.go:39-46)."""

    user: str = ""
    kind: GVK = GVK()
    dump: str = ""          # "All" -> also dump engine state


@dataclasses.dataclass
class ConfigSpec:
    sync_only: list[GVK] = dataclasses.field(default_factory=list)
    traces: list[Trace] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Config:
    """Typed view over the unstructured Config CR.  ``raw`` keeps the
    live object so status writes round-trip untouched fields."""

    spec: ConfigSpec = dataclasses.field(default_factory=ConfigSpec)
    raw: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict) -> "Config":
        obj = obj or {}
        spec = obj.get("spec") or {}
        sync = (spec.get("sync") or {}).get("syncOnly") or []
        traces_raw = (spec.get("validation") or {}).get("traces") or []
        traces = [
            Trace(user=t.get("user", ""),
                  kind=GVK.from_dict(t.get("kind") or {}),
                  dump=t.get("dump", ""))
            for t in traces_raw if isinstance(t, dict)
        ]
        return cls(spec=ConfigSpec(
            sync_only=[GVK.from_dict(e) for e in sync if isinstance(e, dict)],
            traces=traces), raw=obj)


def empty_config_object() -> dict:
    return {
        "apiVersion": f"{CONFIG_GROUP}/{CONFIG_VERSION}",
        "kind": "Config",
        "metadata": {"name": CONFIG_NAME, "namespace": CONFIG_NAMESPACE},
        "spec": {},
    }
