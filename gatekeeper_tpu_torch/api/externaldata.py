# Copied from gatekeeper_tpu/api/externaldata.py for the PyTorch port.
"""External-data Provider CRD types.

Reference: open-policy-agent/frameworks external-data
(apis/externaldata/v1beta1/provider_types.go) — a cluster-scoped
``Provider`` names an endpoint policies may consult for facts that live
outside the cluster (image signatures, registry metadata, allowlists).
The reference snapshot predates the subsystem entirely (it hard-rejects
``http.send``); this build adds the Provider surface so the sanctioned
egress path is declarative and circuit-broken rather than ad-hoc.

Spec fields:

- ``url``        — endpoint; ``fake://<name>`` binds an in-process
                   FakeProvider (tests/bench), http(s) URLs use the
                   batched JSON POST transport;
- ``timeout``    — per-call deadline in seconds;
- ``failurePolicy`` — Fail | Ignore | UseDefault: what a lookup failure
                   means for the calling policy (deny / undefined /
                   substitute ``default``);
- ``default``    — the substitute value for UseDefault;
- ``caching.ttlSeconds`` / ``caching.maxEntries`` — provider cache knobs;
- ``retries``    — bounded fetch retries (exponential backoff + jitter);
- ``circuitBreaker.failureThreshold`` / ``.cooldownSeconds`` — breaker
                   tuning (closed -> open after N consecutive failed
                   rounds, half-open probe after the cool-down).
"""

from __future__ import annotations

import dataclasses

from gatekeeper_tpu_torch.api.config import GVK

PROVIDER_GROUP = "externaldata.gatekeeper.sh"
PROVIDER_VERSION = "v1beta1"
PROVIDER_GVK = GVK(PROVIDER_GROUP, PROVIDER_VERSION, "Provider")

FAIL = "Fail"
IGNORE = "Ignore"
USE_DEFAULT = "UseDefault"
FAILURE_POLICIES = (FAIL, IGNORE, USE_DEFAULT)


@dataclasses.dataclass(frozen=True)
class Provider:
    """Typed view over the unstructured Provider CR."""

    name: str
    url: str = ""
    timeout_s: float = 1.0
    failure_policy: str = FAIL
    default: object = None
    cache_ttl_s: float = 30.0
    cache_max_entries: int = 65536
    retries: int = 2
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 30.0

    def validate(self) -> None:
        if not self.name:
            raise ValueError("Provider: metadata.name is required")
        if not self.url:
            raise ValueError(f"Provider {self.name!r}: spec.url is required")
        if self.failure_policy not in FAILURE_POLICIES:
            raise ValueError(
                f"Provider {self.name!r}: failurePolicy must be one of "
                f"{'/'.join(FAILURE_POLICIES)}, got {self.failure_policy!r}")
        if self.timeout_s <= 0:
            raise ValueError(f"Provider {self.name!r}: timeout must be > 0")
        if self.retries < 0:
            raise ValueError(f"Provider {self.name!r}: retries must be >= 0")

    @classmethod
    def from_dict(cls, obj: dict) -> "Provider":
        obj = obj or {}
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        caching = spec.get("caching") or {}
        breaker = spec.get("circuitBreaker") or {}
        p = cls(
            name=meta.get("name", ""),
            url=spec.get("url", ""),
            timeout_s=float(spec.get("timeout", 1.0)),
            failure_policy=spec.get("failurePolicy", FAIL),
            default=spec.get("default"),
            cache_ttl_s=float(caching.get("ttlSeconds", 30.0)),
            cache_max_entries=int(caching.get("maxEntries", 65536)),
            retries=int(spec.get("retries", 2)),
            breaker_threshold=int(breaker.get("failureThreshold", 5)),
            breaker_cooldown_s=float(breaker.get("cooldownSeconds", 30.0)),
        )
        p.validate()
        return p

    def to_dict(self) -> dict:
        return {
            "apiVersion": f"{PROVIDER_GROUP}/{PROVIDER_VERSION}",
            "kind": "Provider",
            "metadata": {"name": self.name},
            "spec": {
                "url": self.url,
                "timeout": self.timeout_s,
                "failurePolicy": self.failure_policy,
                "default": self.default,
                "retries": self.retries,
                "caching": {"ttlSeconds": self.cache_ttl_s,
                            "maxEntries": self.cache_max_entries},
                "circuitBreaker": {
                    "failureThreshold": self.breaker_threshold,
                    "cooldownSeconds": self.breaker_cooldown_s},
            },
        }
