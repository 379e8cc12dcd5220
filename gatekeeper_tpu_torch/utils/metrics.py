# Copied from gatekeeper_tpu/utils/metrics.py for the PyTorch port.
"""Metrics registry — counters, gauges, histogram timers, labels.

The reference vendors OPA's metrics registry
(vendor/.../opa/metrics/metrics.go:30-44) but never surfaces it;
SURVEY §5 asks this build to do better.  This registry backs the audit
manager's per-sweep counters, the jax driver's device/host timing
breakdown, the webhook's latency distribution, and the per-template
device-time attribution gauges, and snapshots to a plain dict for
bench output.

Exposition hygiene: names are sanitized to the Prometheus
charset ``[a-zA-Z_][a-zA-Z0-9_]*`` at registration time, every family
gets a ``# HELP`` line, and metrics may carry labels
(``metrics.gauge("template_device_seconds", template=kind)``) rendered
as ``name{template="..."} value``.  Timers are fixed-bucket
histograms (log-spaced seconds buckets) so Prometheus quantiles are
honest aggregations rather than pre-computed summary quantiles that
cannot be merged across pods.
"""

from __future__ import annotations

import re
import threading
from typing import Optional, Tuple

_NAME_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    """Coerce a metric name into ``[a-zA-Z_][a-zA-Z0-9_]*``."""
    if _NAME_OK.match(name):
        return name
    s = _NAME_BAD.sub("_", name) or "_"
    if not (s[0].isalpha() or s[0] == "_"):
        s = "_" + s
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Timer:
    """Observation accumulator: count/total/mean/min/max, percentiles
    over a bounded reservoir, and fixed log-spaced histogram buckets
    for the Prometheus exposition."""

    RESERVOIR = 4096

    # log-spaced seconds buckets, 100µs .. 10s.  Timers carry their
    # unit in their registered name (admission_seconds); unitless
    # observations (admission_batch_size) still get exact _sum/_count
    # even where the bucket boundaries are a poor fit.
    BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
               0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, buckets: Optional[tuple] = None):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: list[float] = []
        self.buckets = buckets or self.BUCKETS
        # per-bucket (non-cumulative) counts; [-1] is the +Inf bucket
        self.bucket_counts = [0] * (len(self.buckets) + 1)

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.min = seconds if self.min is None else min(self.min, seconds)
        self.max = seconds if self.max is None else max(self.max, seconds)
        if len(self._samples) < self.RESERVOIR:
            self._samples.append(seconds)
        else:  # reservoir is full: overwrite deterministically
            self._samples[self.count % self.RESERVOIR] = seconds
        for i, le in enumerate(self.buckets):
            if seconds <= le:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def cumulative_buckets(self) -> list[tuple[str, int]]:
        """[("0.001", n_le), ..., ("+Inf", count)] cumulative counts."""
        out = []
        acc = 0
        for le, n in zip(self.buckets, self.bucket_counts):
            acc += n
            out.append((format(le, "g"), acc))
        out.append(("+Inf", acc + self.bucket_counts[-1]))
        return out

    def percentile(self, p: float) -> float | None:
        if not self._samples:
            return None
        s = sorted(self._samples)
        idx = min(len(s) - 1, int(p / 100.0 * len(s)))
        return s[idx]

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None


class _Family:
    """One metric name: HELP text + instances keyed by label set."""

    __slots__ = ("help", "instances")

    def __init__(self, help_text: str):
        self.help = help_text
        self.instances: dict[Tuple[Tuple[str, str], ...], object] = {}


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, _Family] = {}
        self._gauges: dict[str, _Family] = {}
        self._timers: dict[str, _Family] = {}

    @staticmethod
    def _key(labels: dict) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((sanitize_name(k), str(v))
                            for k, v in labels.items()))

    def _get(self, table: dict, name: str, factory, help_text: Optional[str],
             labels: dict):
        name = sanitize_name(name)
        key = self._key(labels)
        with self._lock:
            fam = table.get(name)
            if fam is None:
                fam = table[name] = _Family(
                    help_text or name.replace("_", " "))
            elif help_text:
                fam.help = help_text
            inst = fam.instances.get(key)
            if inst is None:
                inst = fam.instances[key] = factory()
            return inst

    def counter(self, name: str, help: Optional[str] = None,
                **labels: str) -> Counter:
        return self._get(self._counters, name, Counter, help, labels)

    def gauge(self, name: str, help: Optional[str] = None,
              **labels: str) -> Gauge:
        return self._get(self._gauges, name, Gauge, help, labels)

    def timer(self, name: str, help: Optional[str] = None,
              **labels: str) -> Timer:
        return self._get(self._timers, name, Timer, help, labels)

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {}
            for name, fam in self._counters.items():
                for key, c in fam.instances.items():
                    out[name + _label_str(key)] = c.value
            for name, fam in self._gauges.items():
                for key, g in fam.instances.items():
                    out[name + _label_str(key)] = g.value
            for name, fam in self._timers.items():
                for key, t in fam.instances.items():
                    out[name + _label_str(key)] = {
                        "count": t.count,
                        "total_seconds": round(t.total, 6),
                        "mean_seconds": (round(t.mean, 6)
                                         if t.mean is not None else None),
                        "p50": t.percentile(50), "p99": t.percentile(99),
                    }
            return out

    def render_prometheus(self, prefix: str = "gatekeeper") -> str:
        """Prometheus text exposition (the /metrics export surface —
        SURVEY §5 set the bar at real exported counters; the reference
        plumbs OPA's registry but never serves it)."""
        prefix = sanitize_name(prefix)
        lines: list[str] = []
        with self._lock:
            for name, fam in sorted(self._counters.items()):
                base = f"{prefix}_{name}"
                lines.append(f"# HELP {base} {fam.help}")
                lines.append(f"# TYPE {base} counter")
                for key, c in sorted(fam.instances.items()):
                    lines.append(f"{base}{_label_str(key)} {c.value}")
            for name, fam in sorted(self._gauges.items()):
                base = f"{prefix}_{name}"
                lines.append(f"# HELP {base} {fam.help}")
                lines.append(f"# TYPE {base} gauge")
                for key, g in sorted(fam.instances.items()):
                    lines.append(f"{base}{_label_str(key)} {g.value}")
            for name, fam in sorted(self._timers.items()):
                # timers carry their unit in their registered name
                # (admission_seconds, admission_batch_size) — don't
                # force a _seconds suffix onto unitless observations
                base = f"{prefix}_{name}"
                lines.append(f"# HELP {base} {fam.help}")
                lines.append(f"# TYPE {base} histogram")
                for key, t in sorted(fam.instances.items()):
                    for le, acc in t.cumulative_buckets():
                        lk = key + (("le", le),)
                        lines.append(f"{base}_bucket{_label_str(lk)} {acc}")
                    ls = _label_str(key)
                    lines.append(f"{base}_sum{ls} {t.total:.6f}")
                    lines.append(f"{base}_count{ls} {t.count}")
        return "\n".join(lines) + "\n"
