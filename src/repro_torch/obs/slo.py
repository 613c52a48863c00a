"""Per-class SLO attainment over the serving runtime's request outcomes.

The port of the reference package's ``obs/slo.py``.  The fleet's
steady-state contract is expressed per request *class* ("interactive" vs
"batch" vs per-engine-kind defaults), not per engine: the global re-tuner
moves slots between engines based on which class is missing its latency
target, so attainment has to be computed where outcomes land — in the
Runtime's future-resolution path — and read without disturbing the data
(non-destructive snapshots, same contract as ``obs.metrics``).

The tracker is host-side arithmetic like ``runtime.telemetry`` and is
always on: it never touches a tensor, never records into the obs layer itself,
so the zero-overhead-when-disabled contract of ``obs.NULL`` is untouched
(class labels only reach spans/metrics when a real recorder is attached).

Outcome taxonomy mirrors ``runtime.faults``:

- ``completed``  — future resolved with a result; latency = resolve - submit.
- ``deadline_missed`` — future failed with ``DeadlineExceededError``.
- ``shed``       — refused before service: at submit (``ShedError``,
  dead-engine fast-fail, fleet admission shed — no future exists, the
  Runtime reports it directly) or at ingest (dead engine, chaos submit
  rejection — the future fails and ``on_rejected`` reclassifies the
  submit).
- ``failed``     — any other exception (injected faults, engine death
  mid-service).

Attainment is computed over a bounded rolling window of completion
latencies (deadline misses count as *misses* in ``attainment`` too — a
request that never produced a result did not meet its target), so a long
run converges to steady-state attainment instead of averaging over cold
start forever.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

DEFAULT_WINDOW_CAP = 2048

#: Percentiles reported for every class window.
REPORT_PERCENTILES = (50.0, 95.0, 99.0)


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """A latency objective: ``percentile`` of completions must finish within
    ``latency_s``.  The default percentile matches the industry-standard
    p95 contract."""

    latency_s: float
    percentile: float = 95.0

    def __post_init__(self):
        if self.latency_s <= 0:
            raise ValueError(f"latency_s must be > 0, got {self.latency_s}")
        if not 0 < self.percentile <= 100:
            raise ValueError(
                f"percentile must be in (0, 100], got {self.percentile}")


def _as_target(t) -> SLOTarget:
    if isinstance(t, SLOTarget):
        return t
    if isinstance(t, (int, float)):
        return SLOTarget(float(t))
    raise TypeError(f"SLO target must be SLOTarget or seconds, got {t!r}")


class _ClassWindow:
    """Mutable per-class record: lifetime counters + rolling latency window."""

    __slots__ = ("submitted", "completed", "deadline_missed", "shed",
                 "failed", "latencies", "cap")

    def __init__(self, cap: int):
        self.submitted = 0
        self.completed = 0
        self.deadline_missed = 0
        self.shed = 0
        self.failed = 0
        self.latencies: list[float] = []
        self.cap = cap

    def push(self, lat_s: float) -> None:
        self.latencies.append(float(lat_s))
        if len(self.latencies) > self.cap:
            # Amortized trim: drop the oldest half in one slice instead of
            # popping per-append.
            del self.latencies[: self.cap // 2]


class SLOTracker:
    """Windowed per-class attainment math, fed by the Runtime.

    ``targets`` maps class name -> ``SLOTarget`` (or plain seconds);
    classes without a target still get full latency percentiles and rates,
    just ``attainment=None``.  ``default_target`` applies to any class not
    named explicitly.

    Thread-safety: outcome callbacks run on whichever thread resolves the
    future (stepper, resolver pool, deadline expirer), so every mutation
    and snapshot takes the tracker lock — the critical sections are a few
    scalar updates, never device work.
    """

    def __init__(self, targets=None, *, default_target=None,
                 window_cap: int = DEFAULT_WINDOW_CAP):
        if window_cap < 2:
            raise ValueError(f"window_cap must be >= 2, got {window_cap}")
        self._targets = {str(k): _as_target(v)
                         for k, v in dict(targets or {}).items()}
        self._default = (_as_target(default_target)
                         if default_target is not None else None)
        self._cap = int(window_cap)
        self._lock = threading.Lock()
        self._classes: dict[str, _ClassWindow] = {}

    # -- feed side (Runtime calls these) ---------------------------------

    def _cls(self, class_: str) -> _ClassWindow:
        w = self._classes.get(class_)
        if w is None:
            w = self._classes.setdefault(class_, _ClassWindow(self._cap))
        return w

    def on_submit(self, class_: str) -> None:
        with self._lock:
            self._cls(class_).submitted += 1

    def on_complete(self, class_: str, latency_s: float) -> None:
        with self._lock:
            w = self._cls(class_)
            w.completed += 1
            w.push(latency_s)

    def on_deadline_miss(self, class_: str) -> None:
        with self._lock:
            self._cls(class_).deadline_missed += 1

    def on_shed(self, class_: str) -> None:
        with self._lock:
            self._cls(class_).shed += 1

    def on_rejected(self, class_: str) -> None:
        """A request that WAS counted by ``on_submit`` got refused before
        any service (dead engine discovered at ingest, chaos submit
        rejection): move it from the submitted column to the shed column,
        so ``shed_rate`` reflects every rejection flavor — not only the
        pre-future paths that never reached ``on_submit``."""
        with self._lock:
            w = self._cls(class_)
            w.shed += 1
            if w.submitted > 0:
                w.submitted -= 1

    def on_failure(self, class_: str) -> None:
        with self._lock:
            self._cls(class_).failed += 1

    # -- read side --------------------------------------------------------

    def target_for(self, class_: str) -> SLOTarget | None:
        return self._targets.get(class_, self._default)

    def classes(self) -> list[str]:
        with self._lock:
            return sorted(self._classes)

    def snapshot(self) -> dict:
        """Non-destructive per-class view; safe to call concurrently with
        outcome callbacks.  Latency fields are in seconds (None while the
        window is empty)."""
        with self._lock:
            rows = {c: (w.submitted, w.completed, w.deadline_missed, w.shed,
                        w.failed, np.asarray(w.latencies, dtype=np.float64))
                    for c, w in self._classes.items()}
        out = {}
        for c in sorted(rows):
            sub, done, miss, shed, failed, lat = rows[c]
            tgt = self.target_for(c)
            row = {
                "submitted": sub, "completed": done,
                "deadline_missed": miss, "shed": shed, "failed": failed,
                "window": int(lat.size),
                "target_s": tgt.latency_s if tgt else None,
                "target_percentile": tgt.percentile if tgt else None,
            }
            if lat.size:
                for q in REPORT_PERCENTILES:
                    row[f"latency_p{q:g}_s"] = float(np.percentile(lat, q))
                row["latency_mean_s"] = float(lat.mean())
                row["latency_max_s"] = float(lat.max())
            else:
                for q in REPORT_PERCENTILES:
                    row[f"latency_p{q:g}_s"] = None
                row["latency_mean_s"] = None
                row["latency_max_s"] = None
            # Attainment: fraction of windowed OUTCOMES meeting the target.
            # Deadline misses never produced a result, so they count against
            # attainment alongside windowed completions that ran long.
            if tgt is not None and (lat.size or miss):
                hit = int((lat <= tgt.latency_s).sum())
                row["attainment"] = hit / (lat.size + miss)
                if lat.size:
                    row["attained"] = bool(
                        float(np.percentile(lat, tgt.percentile))
                        <= tgt.latency_s and miss == 0)
                else:
                    row["attained"] = False
            else:
                row["attainment"] = None
                row["attained"] = None
            resolved = done + miss + failed
            row["deadline_miss_rate"] = miss / resolved if resolved else 0.0
            row["shed_rate"] = shed / (sub + shed) if (sub + shed) else 0.0
            out[c] = row
        return out
