"""Unified metrics registry: counters, gauges, histograms, one schema.

Replaces the divergent ad-hoc ``stats()`` dicts as the cross-engine
aggregation point: every engine records the SAME instrument names
(``sweeps``, ``steps``, ``completed``, ``prefill_dispatches``,
``kv_bytes_touched``, ``plan_drift_ratio``, ...) labeled by engine, so a
fleet-level re-tuner or a scrape reads comparable series without knowing
which engine class produced them — the comparable cross-engine telemetry
ROADMAP item 4's global re-tuner needs.

Threading contract ("lock-free-ish"): instrument *creation* takes the
registry lock once; *recording* on an existing instrument is a plain
attribute update — atomic enough under the GIL for the single-writer
pattern the runtime has (one stepper thread owns all engine-side
recording; caller threads only touch their own submit-side counters).
Snapshots are non-destructive reads: two concurrent scrapes see the same
values instead of racing over a read-and-reset window.
"""
from __future__ import annotations

import math
import threading


class Counter:
    """Monotonically increasing count (events, bytes, sweeps)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, v=1) -> None:
        self.value += v


class Gauge:
    """Last-set value (slot counts, drift ratios, structural constants)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Log-bucketed distribution (latencies, span durations).

    Buckets are decade-spanning log10 edges over ``(lo, hi)``; observations
    outside clamp to the end buckets.  ``percentile`` interpolates within
    the winning bucket — coarse but monotone, and snapshot-stable (reading
    never resets).
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 per_decade: int = 4):
        n = int(round(math.log10(hi / lo) * per_decade))
        self.edges = [lo * 10 ** (i / per_decade) for i in range(n + 1)]
        self.buckets = [0] * (n + 2)  # + underflow/overflow
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def observe(self, v) -> None:
        v = float(v)
        i = 0
        while i < len(self.edges) and v >= self.edges[i]:
            i += 1
        self.buckets[i] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> float | None:
        return _bucket_quantile(self.count, self.edges, self.buckets,
                                self.min, self.max, q)

    def summary(self) -> dict:
        """Snapshot dict.  Includes the raw ``edges``/``buckets`` arrays so a
        consumer of a SNAPSHOT (not the live instrument) can compute any
        quantile via :func:`quantile` — the SLO layer needs real p95/p99 from
        scraped data, not just the pre-baked pair."""
        return {"count": self.count,
                "mean": self.total / self.count if self.count else None,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "edges": list(self.edges), "buckets": list(self.buckets)}


def _bucket_quantile(count, edges, buckets, mn, mx, q: float) -> float | None:
    """Shared quantile math over (edges, buckets): walk to the bucket holding
    the q-th observation and interpolate linearly inside it, clamping the end
    buckets to the observed min/max so quantiles never exceed the data
    range."""
    if not count:
        return None
    target = q / 100.0 * count
    seen = 0
    for i, c in enumerate(buckets):
        seen += c
        if seen >= target:
            lo = edges[i - 1] if i >= 1 else (mn or 0.0)
            hi = edges[i] if i < len(edges) else (mx if mx is not None else lo)
            lo = lo if mn is None else max(lo, mn)
            hi = hi if mx is None else min(hi, mx)
            frac = (target - (seen - c)) / max(c, 1)
            return lo + frac * max(hi - lo, 0.0)
    return mx


def quantile(snapshot: dict, q: float) -> float | None:
    """Quantile from a histogram SNAPSHOT — the ``summary()`` dict as found in
    ``MetricsRegistry.snapshot()`` (or a Chrome trace's ``otherData.metrics``).
    Same interpolation as the live instrument's ``percentile``; returns None
    for an empty histogram.  ``q`` is in percent (95 -> p95)."""
    if not 0 <= q <= 100:
        raise ValueError(f"q must be a percentage in [0, 100], got {q}")
    return _bucket_quantile(snapshot["count"], snapshot["edges"],
                            snapshot["buckets"], snapshot["min"],
                            snapshot["max"], q)


def _key(name: str, labels: dict) -> tuple:
    return (name,) + tuple(sorted(labels.items()))


class MetricsRegistry:
    """Get-or-create instrument store keyed by (name, sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = _key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls()
                    self._instruments[key] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} {labels} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """Non-destructive ``{name: {label_str: value}}`` view.  Histograms
        render as their summary dict; the label string is ``k=v,...`` (empty
        labels -> ``""``) so snapshots are json-serializable as-is."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict = {}
        for key, inst in items:
            name, labels = key[0], key[1:]
            label_s = ",".join(f"{k}={v}" for k, v in labels)
            val = inst.summary() if isinstance(inst, Histogram) else inst.value
            out.setdefault(name, {})[label_s] = val
        return out
