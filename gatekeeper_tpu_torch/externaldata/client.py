# Copied from gatekeeper_tpu/externaldata/client.py for the PyTorch port.
"""Provider fetch client: deadline, bounded retry, breaker.

One *round* = one batched ``transport(provider, keys)`` call guarded by
the provider's per-call deadline, retried up to ``provider.retries``
times with exponential backoff + jitter.  Rounds are what the
per-provider circuit breaker counts: a round that exhausts its retries
records one consecutive failure; a successful round resets the count.

The deadline is enforced with a disposable worker thread joined against
the timeout — an in-process transport (the fake) or a socket read stuck
past its own timeout cannot be preempted from Python, so the caller
stops waiting and the zombie call is abandoned (daemon thread, its
result discarded).  This is the same containment posture as the bench
watchdog: never let one wedged call strand the serving path.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable

from gatekeeper_tpu_torch.api.externaldata import Provider
from gatekeeper_tpu_torch.externaldata.breaker import CircuitBreaker

BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 2.0


class FetchError(Exception):
    """A fetch round failed (transport error, timeout, or breaker open)."""


class BreakerOpenError(FetchError):
    """Short-circuited: the provider's breaker is open."""


def _call_with_deadline(fn: Callable, args: tuple, timeout_s: float):
    """Run fn(*args) on a disposable daemon thread; raise FetchError on
    deadline.  The box is a plain dict — no locking needed, the join is
    the happens-before edge."""
    box: dict = {}

    def run():
        try:
            box["value"] = fn(*args)
        except Exception as e:      # noqa: BLE001 — transport errors
            box["error"] = e        # become fetch failures by contract

    t = threading.Thread(target=run, daemon=True,
                         name="external-data-fetch")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise FetchError(f"deadline exceeded ({timeout_s:.3f}s)")
    if "error" in box:
        e = box["error"]
        raise FetchError(f"{type(e).__name__}: {e}")
    return box.get("value")


class ProviderClient:
    """Batched fetches for one runtime; transports and breakers are
    per-provider, the backoff/jitter policy is shared."""

    def __init__(self, sleep: Callable[[float], None] = time.sleep,
                 rng: random.Random | None = None):
        self._sleep = sleep
        # deterministic default jitter source: reproducible test runs,
        # and the jitter's only job is decorrelating retry storms
        self._rng = rng if rng is not None else random.Random(0x5EED)
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def breaker(self, provider: Provider) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(provider.name)
            if br is None:
                br = CircuitBreaker(
                    failure_threshold=provider.breaker_threshold,
                    cooldown_s=provider.breaker_cooldown_s)
                self._breakers[provider.name] = br
            return br

    def drop_breaker(self, name: str) -> None:
        with self._lock:
            self._breakers.pop(name, None)

    def _backoff(self, attempt: int) -> float:
        base = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2 ** attempt))
        return base * (0.5 + self._rng.random())     # 0.5x..1.5x jitter

    def fetch(self, provider: Provider, transport: Callable,
              keys: list[str]) -> dict:
        """One breaker-guarded round: transport(provider, keys) ->
        {key: value}.  Raises FetchError when the round fails after its
        bounded retries, BreakerOpenError when short-circuited."""
        br = self.breaker(provider)
        if not br.allow():
            raise BreakerOpenError(
                f"provider {provider.name!r}: circuit breaker open")
        # fault seam: slow_provider stalls every fetch while armed — a
        # saturated provider, not a broken one (no breaker trip): the
        # latency surfaces as deadline pressure on the admission path
        from gatekeeper_tpu_torch.resilience import faults
        if faults.active("slow_provider"):
            import os as _os
            self._sleep(float(_os.environ.get(
                "GATEKEEPER_FAULT_STALL_S", "0.25")))
        last: Exception | None = None
        for attempt in range(provider.retries + 1):
            if attempt:
                self._sleep(self._backoff(attempt - 1))
            try:
                result = _call_with_deadline(
                    transport, (provider, list(keys)), provider.timeout_s)
                if not isinstance(result, dict):
                    raise FetchError(
                        f"provider {provider.name!r}: transport returned "
                        f"{type(result).__name__}, expected dict")
                br.record_success()
                return result
            except FetchError as e:
                last = e
        br.record_failure()
        raise FetchError(
            f"provider {provider.name!r}: fetch failed after "
            f"{provider.retries + 1} attempts: {last}")
