# Copied from gatekeeper_tpu/externaldata/cache.py for the PyTorch port.
"""TTL'd key -> outcome cache with single-flight stampede protection.

Per-provider: bounded size (LRU eviction), per-entry TTL, and a
single-flight lease per key so N concurrent misses on the same key
produce exactly one upstream fetch — the other N-1 callers block on the
leader's lease and read the cached outcome it installs (groupcache's
singleflight shape, applied per key).

Both successes and failures are cached: a provider outage must not turn
every evaluation into a fresh timeout — the error outcome serves from
cache until its TTL lapses (errors use a shorter TTL so recovery is
observed promptly).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Outcome:
    """Result of one key's lookup: a value or an error reason."""

    value: object = None
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


ERROR_TTL_CAP_S = 5.0
"""Failure outcomes are cached at most this long regardless of the
provider's TTL: a long value-TTL must not pin an outage's errors past
the breaker's own recovery probe cadence."""


class TTLCache:
    def __init__(self, max_entries: int = 65536, ttl_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_entries = max(1, int(max_entries))
        self.ttl_s = ttl_s
        self._clock = clock
        # key -> (outcome, expires_at); OrderedDict gives O(1) LRU
        self._entries: collections.OrderedDict[str, tuple[Outcome, float]] = \
            collections.OrderedDict()
        # single-flight leases: key -> Event set when the leader resolves
        self._leases: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------------

    def get(self, key: str) -> Outcome | None:
        """Fresh outcome for key, or None (missing/expired)."""
        with self._lock:
            return self._get_locked(key)

    def _get_locked(self, key: str) -> Outcome | None:
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        outcome, expires = ent
        if self._clock() >= expires:
            del self._entries[key]
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return outcome

    def put(self, key: str, outcome: Outcome) -> None:
        ttl = self.ttl_s if outcome.ok else min(self.ttl_s, ERROR_TTL_CAP_S)
        with self._lock:
            self._entries[key] = (outcome, self._clock() + ttl)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    # ------------------------------------------------------------------
    # single-flight

    def lease(self, keys: list[str]) -> tuple[dict[str, Outcome],
                                              list[str],
                                              list[threading.Event]]:
        """Partition keys under one lock: (cached, mine, waits).

        ``cached``: keys already fresh.  ``mine``: keys this caller now
        leads (it MUST later call :meth:`complete` or :meth:`abandon`
        for every one).  ``waits``: other leaders' in-flight leases this
        caller should wait on, then re-read from cache."""
        cached: dict[str, Outcome] = {}
        mine: list[str] = []
        waits: list[threading.Event] = []
        with self._lock:
            for key in keys:
                out = self._get_locked(key)
                if out is not None:
                    cached[key] = out
                    continue
                ev = self._leases.get(key)
                if ev is not None:
                    waits.append(ev)
                else:
                    self._leases[key] = threading.Event()
                    mine.append(key)
        return cached, mine, waits

    def complete(self, key: str, outcome: Outcome) -> None:
        self.put(key, outcome)
        with self._lock:
            ev = self._leases.pop(key, None)
        if ev is not None:
            ev.set()

    def abandon(self, key: str) -> None:
        """Release a lease without caching (leader crashed mid-fetch)."""
        with self._lock:
            ev = self._leases.pop(key, None)
        if ev is not None:
            ev.set()

    # ------------------------------------------------------------------

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
