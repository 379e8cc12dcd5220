# Copied from gatekeeper_tpu/externaldata/fake.py for the PyTorch port.
"""In-process fake provider (sibling of cluster/fake.py).

Backs tests and the bench: a ``Provider`` whose ``url`` is
``fake://<name>`` resolves, at fetch time, to the :class:`FakeProvider`
registered under that name.  The fake records every batched call so
tests can assert batching (one round per provider per sweep) and
single-flight (concurrent misses collapse to one call), and can be
degraded on demand (latency, per-key failures, full outage) to drive
the breaker and failure-policy paths.
"""

from __future__ import annotations

import threading
import time


class FakeProvider:
    def __init__(self, data: dict | None = None, latency_s: float = 0.0):
        self.data = dict(data or {})
        self.latency_s = latency_s
        self.outage = False          # raise on every call
        self.fail_keys: set = set()  # omit these keys from responses
        self.calls = 0
        self.batches: list[list[str]] = []
        self._lock = threading.Lock()

    def __call__(self, provider, keys: list[str]) -> dict:
        with self._lock:
            self.calls += 1
            self.batches.append(list(keys))
            outage = self.outage
        if self.latency_s:
            time.sleep(self.latency_s)
        if outage:
            raise RuntimeError("fake provider outage")
        return {k: self.data[k] for k in keys
                if k in self.data and k not in self.fail_keys}


_FAKES: dict[str, FakeProvider] = {}
_lock = threading.Lock()


def register_fake(name: str, fake: FakeProvider) -> FakeProvider:
    with _lock:
        _FAKES[name] = fake
    return fake


def get_fake(name: str) -> FakeProvider | None:
    with _lock:
        return _FAKES.get(name)


def clear_fakes() -> None:
    with _lock:
        _FAKES.clear()


def fake_transport(provider, keys: list[str]) -> dict:
    """Transport bound by ExternalDataRuntime for ``fake://`` URLs."""
    name = provider.url[len("fake://"):]
    fake = get_fake(name)
    if fake is None:
        raise RuntimeError(f"no FakeProvider registered as {name!r}")
    return fake(provider, keys)
