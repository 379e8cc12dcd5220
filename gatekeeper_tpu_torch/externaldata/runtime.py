# Copied from gatekeeper_tpu/externaldata/runtime.py for the PyTorch port.
"""External-data runtime: provider registry + cache + batched fetches.

The one object the rest of the engine talks to.  Registration comes
from the Provider controller (or tests directly); consumption comes
from three places:

- the **key-collection prefetch** hooks (``ir/prep.py`` table builds,
  the audit sweep's overlapped bulk warm, the webhook's per-batch warm)
  call :meth:`prefetch` — batched, single-flight, outcome-cached;
- the **scalar oracle** (``rego/builtins.py`` ``external_data``) calls
  :meth:`builtin_call` per review — by construction the prefetch hooks
  have already warmed every key the vectorized path will gather, so the
  oracle almost always serves from cache;
- the **audit report / metrics endpoint** call :meth:`stats`.

Failure policy is applied at :meth:`builtin_call` time, not at fetch
time: the cache stores raw outcomes (value or error) so one fetch can
serve providers' keys regardless of how each calling policy wants
failures interpreted.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable

from gatekeeper_tpu_torch.api.externaldata import (FAIL, IGNORE,
                                                   USE_DEFAULT, Provider)
from gatekeeper_tpu_torch.errors import ExternalDataError
from gatekeeper_tpu_torch.externaldata.cache import Outcome, TTLCache
from gatekeeper_tpu_torch.externaldata.client import FetchError, ProviderClient


def _metric_name(provider: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", provider)


def _http_transport(provider: Provider, keys: list[str]) -> dict:
    """Batched JSON POST, matching the reference provider protocol
    (ExternalData{Request,Response}: keys in, key/value items out).
    stdlib-only on purpose — no new dependencies."""
    import json
    import urllib.request
    body = json.dumps({"apiVersion": "externaldata.gatekeeper.sh/v1beta1",
                       "kind": "ProviderRequest",
                       "request": {"keys": list(keys)}}).encode()
    req = urllib.request.Request(
        provider.url, data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=provider.timeout_s) as resp:
        payload = json.loads(resp.read())
    items = (payload.get("response") or {}).get("items") or []
    out = {}
    for item in items:
        if item.get("error"):
            continue    # absent key -> error outcome at the caller
        out[item["key"]] = item.get("value")
    return out


class _ProviderEntry:
    __slots__ = ("provider", "transport", "cache", "fetch_batches",
                 "fetch_keys", "fetch_errors", "fetch_seconds")

    def __init__(self, provider: Provider, transport: Callable):
        self.provider = provider
        self.transport = transport
        self.cache = TTLCache(max_entries=provider.cache_max_entries,
                              ttl_s=provider.cache_ttl_s)
        self.fetch_batches = 0
        self.fetch_keys = 0
        self.fetch_errors = 0
        self.fetch_seconds = 0.0


class ExternalDataRuntime:
    def __init__(self, metrics=None,
                 client: ProviderClient | None = None):
        self.metrics = metrics
        self.client = client if client is not None else ProviderClient()
        self._entries: dict[str, _ProviderEntry] = {}
        self._lock = threading.Lock()

    # -- registry ------------------------------------------------------

    def register(self, provider: Provider,
                 transport: Callable | None = None) -> None:
        """Install (or replace) a provider.  Replacement drops the cache
        and breaker: a spec change means the old endpoint's history no
        longer predicts the new one's health."""
        provider.validate()
        if transport is None:
            transport = self._resolve_transport(provider)
        with self._lock:
            self._entries[provider.name] = _ProviderEntry(provider, transport)
        self.client.drop_breaker(provider.name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)
        self.client.drop_breaker(name)

    def provider(self, name: str) -> Provider | None:
        with self._lock:
            ent = self._entries.get(name)
            return ent.provider if ent else None

    def provider_names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def _entry(self, name: str) -> _ProviderEntry | None:
        with self._lock:
            return self._entries.get(name)

    @staticmethod
    def _resolve_transport(provider: Provider) -> Callable:
        if provider.url.startswith("fake://"):
            from gatekeeper_tpu_torch.externaldata.fake import fake_transport
            return fake_transport
        if provider.url.startswith(("http://", "https://")):
            return _http_transport
        raise ValueError(
            f"Provider {provider.name!r}: unsupported url scheme in "
            f"{provider.url!r} (expected fake:// or http(s)://)")

    # -- fetching ------------------------------------------------------

    def prefetch(self, name: str, keys) -> dict[str, Outcome]:
        """Resolve keys through cache + one batched fetch round for the
        misses (single-flight: concurrent callers of overlapping key
        sets produce one upstream round per key).  Returns every key's
        Outcome; never raises — errors are outcomes, policy is applied
        later at builtin_call time."""
        ent = self._entry(name)
        keys = [k for k in dict.fromkeys(keys)]     # dedupe, keep order
        if ent is None:
            return {k: Outcome(error=f"provider {name!r} not registered")
                    for k in keys}
        cached, mine, waits = ent.cache.lease(keys)
        out = dict(cached)
        if mine:
            out.update(self._fetch_round(ent, mine))
        for ev in waits:
            ev.wait(ent.provider.timeout_s * (ent.provider.retries + 2))
        for k in keys:
            if k not in out:
                got = ent.cache.get(k)
                out[k] = got if got is not None else \
                    Outcome(error="single-flight wait expired")
        return out

    def _fetch_round(self, ent: _ProviderEntry,
                     keys: list[str]) -> dict[str, Outcome]:
        t0 = time.perf_counter()
        out: dict[str, Outcome] = {}
        try:
            values = self.client.fetch(ent.provider, ent.transport, keys)
            for k in keys:
                out[k] = Outcome(value=values[k]) if k in values else \
                    Outcome(error="no value for key")
        except FetchError as e:
            reason = str(e)
            for k in keys:
                out[k] = Outcome(error=reason)
        finally:
            dt = time.perf_counter() - t0
            for k in keys:
                # complete() even on the error path: the lease must be
                # released and the (capped-TTL) error outcome cached
                ent.cache.complete(k, out[k])
            ent.fetch_batches += 1
            ent.fetch_keys += len(keys)
            ent.fetch_errors += sum(1 for o in out.values() if not o.ok)
            ent.fetch_seconds += dt
            self._observe(ent, dt, keys, out)
        return out

    def _observe(self, ent: _ProviderEntry, dt: float,
                 keys: list[str], out: dict[str, Outcome]) -> None:
        if self.metrics is None:
            return
        self.metrics.timer("external_fetch_seconds").observe(dt)
        self.metrics.counter("external_fetch_batches").inc()
        self.metrics.counter("external_fetch_keys").inc(len(keys))
        errs = sum(1 for o in out.values() if not o.ok)
        if errs:
            self.metrics.counter("external_fetch_errors").inc(errs)
        mname = _metric_name(ent.provider.name)
        self.metrics.gauge(f"external_breaker_state_{mname}").set(
            self.client.breaker(ent.provider).code())
        self.metrics.gauge(f"external_cache_hit_ratio_{mname}").set(
            round(ent.cache.hit_ratio(), 4))

    # -- the builtin ---------------------------------------------------

    def builtin_call(self, name: str, keys) -> dict:
        """``external_data({"provider": name, "keys": keys})`` semantics:
        resolve through the cache, then apply the provider's
        failurePolicy to each failed key.  Returns the reference's
        response shape (responses / errors / system_error)."""
        ent = self._entry(name)
        if ent is None:
            # unknown provider is a policy-authoring error, not an
            # endpoint failure: no failurePolicy to consult
            raise ExternalDataError(
                f"external_data: provider {name!r} not registered")
        outcomes = self.prefetch(name, keys)
        policy = ent.provider.failure_policy
        responses: dict[str, object] = {}
        errors: dict[str, str] = {}
        for k, o in outcomes.items():
            if o.ok:
                responses[k] = o.value
            elif policy == FAIL:
                raise ExternalDataError(
                    f"external_data: provider {name!r} key {k!r}: {o.error}")
            elif policy == USE_DEFAULT:
                responses[k] = ent.provider.default
                errors[k] = o.error or ""
            else:       # IGNORE: recorded, not substituted
                errors[k] = o.error or ""
        return {"responses": responses, "errors": errors,
                "system_error": ""}

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        """Per-provider health snapshot for the audit report."""
        with self._lock:
            entries = dict(self._entries)
        out: dict = {}
        for name, ent in sorted(entries.items()):
            br = self.client.breaker(ent.provider)
            out[name] = {
                "breaker_state": br.state,
                "breaker_transitions": list(br.transitions),
                "short_circuits": br.short_circuits,
                "cache_entries": len(ent.cache),
                "cache_hit_ratio": round(ent.cache.hit_ratio(), 4),
                "cache_evictions": ent.cache.evictions,
                "fetch_batches": ent.fetch_batches,
                "fetch_keys": ent.fetch_keys,
                "fetch_errors": ent.fetch_errors,
                "fetch_seconds": round(ent.fetch_seconds, 6),
            }
        return out


# -- process-global runtime handle -------------------------------------
#
# The builtin registry is a flat name->function table with no way to
# thread per-evaluation state, so the runtime the `external_data`
# builtin consults is process-global, one per process and apart from
# the JAX package's own.  cmd/manager.py installs the managed instance;
# tests install their own and reset to None in teardown.

_runtime: ExternalDataRuntime | None = None
_runtime_lock = threading.Lock()


def get_runtime() -> ExternalDataRuntime | None:
    return _runtime


def set_runtime(rt: ExternalDataRuntime | None) -> ExternalDataRuntime | None:
    """Install the process-global runtime; returns the previous one so
    tests can restore it."""
    global _runtime
    with _runtime_lock:
        prev = _runtime
        _runtime = rt
        return prev
