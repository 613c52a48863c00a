"""Span-derived cost attribution: where each request's wall time went.

The port of the reference package's ``obs/report.py``.

The recorder captures request lifecycles, engine phases, and
supervision episodes on ONE monotonic clock but leaves interpretation to
the reader.  This module is that reader: it folds a finished
:class:`SpanStore` snapshot into

- **per-request** decomposition: queue-wait (submit -> admit) vs service
  time, the service interval split across the engine phases that actually
  ran during it (``fill`` / ``sweep_burst`` / ``decode_burst`` /
  ``retire`` / ``resize`` / ``replay``), supervision stalls
  (``quarantine_backoff``, ``retune``), time the shared stepper spent
  serving *other* engines (``cross_engine``), and an explicit ``other``
  remainder for uninstrumented host work;
- **per-engine** phase totals plus a span-derived modeled-vs-measured
  drift ratio: total burst seconds / total burst units against the
  planner's ``modeled_unit_s`` gauge — the same quantity as
  ``telemetry.plan_drift_ratio`` but integrated over the whole trace
  instead of EWMA'd at step instants;
- **per-class** aggregates (requests, outcomes, queue-wait/service
  quantiles, attribution coverage).

Attribution semantics: for each request's service interval the candidate
spans are layered by priority — own-engine phase children (5) over the
own-engine ``step`` envelope (4, surfacing as ``step_other``: host-side
fill/retire bookkeeping inside a step but outside its instrumented children)
over own-engine supervision episodes (3) over the runtime's own-engine
``dispatch`` envelope (2, surfacing as ``dispatch``: stepper host work
around the engine step — telemetry, gauges, future resolution) over other
engines' dispatch/step envelopes and re-tunes (1, ``cross_engine``; the
reference's report leaves another engine's re-tune unattributed, in
``other``) and the runtime's admission envelopes (1, ``ingest``: the stepper
admitting other arrivals of the same burst — engine ``submit()``
host-to-device copies).  Each elementary time slice goes to the
highest-priority span covering it, so overlapping layers never double count
and the per-request bucket sums can be asserted against the span's own wall
time (the >= 95% coverage contract tested on seeded mixed traffic).
"""
from __future__ import annotations

import bisect
import json

from . import metrics as _metrics

#: Bucket names in render order.  ``queue_wait`` is submit->admit; the rest
#: decompose the service interval; ``other`` is the unattributed remainder.
BUCKETS = ("queue_wait", "fill", "sweep_burst", "decode_burst", "retire",
           "resize", "replay", "step_other", "retune", "quarantine_backoff",
           "dispatch", "ingest", "cross_engine", "other")

_PHASE_NAMES = {"fill": "fill", "sweep-burst": "sweep_burst",
                "decode-burst": "decode_burst", "retire": "retire",
                "resize": "resize", "recover": "replay"}

(_PRIO_PHASE, _PRIO_STEP, _PRIO_SUPERVISION,
 _PRIO_DISPATCH, _PRIO_CROSS) = 5, 4, 3, 2, 1


class _Layer:
    """Sorted candidate intervals of one (bucket, priority) family."""

    __slots__ = ("iv",)

    def __init__(self):
        self.iv: list[tuple[float, float, str, int]] = []

    def add(self, t0, t1, bucket, prio):
        if t1 > t0:
            self.iv.append((t0, t1, bucket, prio))

    def sort(self):
        self.iv.sort()

    def overlapping(self, a: float, b: float):
        """Candidates intersecting [a, b] (iv must be sorted).  Binary-search
        the start bound; intervals are engine steps, effectively
        non-overlapping within one layer, so the scan stays local."""
        out = []
        lo = bisect.bisect_left(self.iv, (a,)) - 1
        for i in range(max(lo, 0), len(self.iv)):
            t0, t1, bucket, prio = self.iv[i]
            if t0 >= b:
                break
            if t1 > a:
                out.append((max(t0, a), min(t1, b), bucket, prio))
        return out


def _split(candidates, a: float, b: float) -> dict[str, float]:
    """Decompose [a, b] over possibly-overlapping candidate intervals:
    each elementary slice between consecutive boundary times goes to the
    highest-priority candidate covering it."""
    out: dict[str, float] = {}
    if b <= a:
        return out
    cuts = {a, b}
    for t0, t1, _, _ in candidates:
        cuts.add(t0)
        cuts.add(t1)
    times = sorted(cuts)
    for s, e in zip(times[:-1], times[1:]):
        best = None
        for t0, t1, bucket, prio in candidates:
            if t0 <= s and t1 >= e and (best is None or prio > best[0]):
                best = (prio, bucket)
        if best is not None:
            out[best[1]] = out.get(best[1], 0.0) + (e - s)
    return out


def _pctl(vals, q):
    if not vals:
        return None
    vs = sorted(vals)
    idx = min(int(round(q / 100.0 * (len(vs) - 1))), len(vs) - 1)
    return vs[idx]


def attribution(rec=None, *, spans=None, metrics=None) -> dict:
    """Build the attribution report from a recorder (or a raw span snapshot
    plus a metrics snapshot).  Returns a JSON-serializable dict with
    ``requests`` / ``engines`` / ``classes`` / ``coverage`` sections."""
    if spans is None:
        spans = rec.spans.snapshot()
    if metrics is None:
        metrics = rec.metrics.snapshot() if rec is not None else {}

    requests = [sp for sp in spans
                if sp.track == "requests" and sp.name == "request"
                and sp.t1 is not None and not sp.instant]
    admits = {}  # request sid -> admit time
    for sp in spans:
        if sp.track == "requests" and sp.name == "admit" and sp.instant \
                and sp.parent is not None:
            admits[sp.parent] = sp.t0

    # Candidate layers per engine track.
    engine_tracks = sorted(
        {sp.track for sp in spans if sp.cat == "engine"}
        | {sp.args.get("engine") for sp in spans
           if sp.cat == "runtime" and sp.name == "dispatch"
           and sp.args.get("engine") is not None})
    phases: dict[str, _Layer] = {e: _Layer() for e in engine_tracks}
    steps: dict[str, _Layer] = {e: _Layer() for e in engine_tracks}
    supervision: dict[str, _Layer] = {e: _Layer() for e in engine_tracks}
    dispatch: dict[str, _Layer] = {e: _Layer() for e in engine_tracks}
    ingest = _Layer()  # admission work delays every in-flight request
    eng_stats: dict[str, dict] = {
        e: {"phase_s": {}, "steps": 0, "burst_s": 0.0, "burst_units": 0}
        for e in engine_tracks}

    for sp in spans:
        if sp.t1 is None or sp.instant:
            continue
        dur = sp.t1 - sp.t0
        if sp.cat == "engine" and sp.track in phases:
            st = eng_stats[sp.track]
            if sp.name == "step":
                steps[sp.track].add(sp.t0, sp.t1, "step_other", _PRIO_STEP)
                st["steps"] += 1
                st["phase_s"]["step"] = st["phase_s"].get("step", 0.) + dur
            elif sp.name in _PHASE_NAMES:
                bucket = _PHASE_NAMES[sp.name]
                phases[sp.track].add(sp.t0, sp.t1, bucket, _PRIO_PHASE)
                st["phase_s"][bucket] = st["phase_s"].get(bucket, 0.) + dur
                if bucket in ("sweep_burst", "decode_burst"):
                    st["burst_s"] += dur
                    st["burst_units"] += int(
                        sp.args.get("sweeps", sp.args.get("decodes", 0)))
        elif sp.cat == "runtime" and sp.name == "dispatch":
            eng = sp.args.get("engine")
            if eng in dispatch:
                dispatch[eng].add(sp.t0, sp.t1, "dispatch", _PRIO_DISPATCH)
                st = eng_stats[eng]
                st["phase_s"]["dispatch"] = \
                    st["phase_s"].get("dispatch", 0.) + dur
        elif sp.cat == "runtime" and sp.name == "ingest":
            ingest.add(sp.t0, sp.t1, "ingest", _PRIO_CROSS)
        elif sp.cat == "supervision":
            eng = sp.args.get("engine")
            if eng in supervision:
                bucket = ("quarantine_backoff" if sp.name == "fault-cycle"
                          else "retune" if sp.name == "retune" else None)
                if bucket:
                    supervision[eng].add(sp.t0, sp.t1, bucket,
                                         _PRIO_SUPERVISION)
                    st = eng_stats[eng]
                    st["phase_s"][bucket] = \
                        st["phase_s"].get(bucket, 0.) + dur

    for layer in (*phases.values(), *steps.values(), *supervision.values(),
                  *dispatch.values(), ingest):
        layer.sort()

    req_rows = []
    for sp in sorted(requests, key=lambda s: s.t0):
        eng = sp.args.get("engine")
        total = sp.t1 - sp.t0
        admit = admits.get(sp.sid)
        row = {"gid": sp.args.get("gid"), "engine": eng,
               "class": sp.args.get("class"),
               "outcome": sp.args.get("outcome"),
               "total_s": total, "phases": {}}
        if admit is None:
            # Never admitted (shed at ingest, deadline before admission):
            # the whole interval is queue wait by definition.
            row["queue_wait_s"] = total
            row["service_s"] = 0.0
            row["accounted_s"] = total
            row["coverage"] = 1.0
        else:
            qwait = max(admit - sp.t0, 0.0)
            a, b = admit, sp.t1
            cands = []
            if eng in phases:
                cands += phases[eng].overlapping(a, b)
                cands += steps[eng].overlapping(a, b)
                cands += supervision[eng].overlapping(a, b)
                cands += dispatch[eng].overlapping(a, b)
            for other in engine_tracks:
                if other != eng:
                    # another engine's re-tune is stepper work too (a
                    # measured-cost re-tune times sweeps on the stepper);
                    # its quarantine backoff is not, the stepper serves on
                    retunes = [c for c in supervision[other].overlapping(a, b)
                               if c[2] == "retune"]
                    for t0, t1, _, _ in phases[other].overlapping(a, b) + \
                            steps[other].overlapping(a, b) + \
                            dispatch[other].overlapping(a, b) + retunes:
                        cands.append((t0, t1, "cross_engine", _PRIO_CROSS))
            cands += ingest.overlapping(a, b)
            split = _split(cands, a, b)
            # step_other = step envelope minus its instrumented children;
            # the split's priority layering computed exactly that.
            row["queue_wait_s"] = qwait
            row["service_s"] = b - a
            row["phases"] = {k: v for k, v in sorted(split.items())}
            accounted = qwait + sum(split.values())
            row["accounted_s"] = accounted
            row["coverage"] = accounted / total if total > 0 else 1.0
        row["phases"]["other"] = max(total - row["accounted_s"], 0.0)
        req_rows.append(row)

    engines_out = {}
    modeled = metrics.get("modeled_unit_s", {})
    for e in engine_tracks:
        st = eng_stats[e]
        mu = modeled.get(f"engine={e}")
        measured = (st["burst_s"] / st["burst_units"]
                    if st["burst_units"] else None)
        engines_out[e] = {
            "steps": st["steps"],
            "phase_s": {k: v for k, v in sorted(st["phase_s"].items())},
            "burst_s": st["burst_s"], "burst_units": st["burst_units"],
            "measured_unit_s": measured, "modeled_unit_s": mu,
            "span_drift_ratio": (measured / mu
                                 if measured is not None and mu else None),
        }

    classes_out = {}
    for cls in sorted({r["class"] for r in req_rows}, key=str):
        rows = [r for r in req_rows if r["class"] == cls]
        outcomes: dict[str, int] = {}
        for r in rows:
            outcomes[str(r["outcome"])] = outcomes.get(str(r["outcome"]), 0) + 1
        qs = [r["queue_wait_s"] for r in rows]
        ss = [r["service_s"] for r in rows]
        classes_out[str(cls)] = {
            "requests": len(rows), "outcomes": outcomes,
            "queue_wait_s": {"mean": sum(qs) / len(qs), "p50": _pctl(qs, 50),
                             "max": max(qs)},
            "service_s": {"mean": sum(ss) / len(ss), "p50": _pctl(ss, 50),
                          "max": max(ss)},
            "coverage_min": min(r["coverage"] for r in rows),
        }

    covs = [r["coverage"] for r in req_rows]
    lat = metrics.get("request_latency_s", {})
    lat_p95 = {k: _metrics.quantile(v, 95) for k, v in lat.items()
               if isinstance(v, dict) and "buckets" in v}
    return {
        "requests": req_rows,
        "engines": engines_out,
        "classes": classes_out,
        "runtime": {
            "ingest_s": sum(t1 - t0 for t0, t1, _, _ in ingest.iv),
            "ingest_spans": len(ingest.iv)},
        "coverage": {"min": min(covs) if covs else None,
                     "mean": sum(covs) / len(covs) if covs else None,
                     "requests": len(covs)},
        "latency_p95_s": lat_p95,
    }


def render_text(report: dict) -> str:
    """Human-readable multi-section rendering of :func:`attribution`."""
    out = []
    cov = report["coverage"]
    out.append("== attribution ==")
    out.append(f"requests={cov['requests']}"
               + (f" coverage min={cov['min']:.3f} mean={cov['mean']:.3f}"
                  if cov["requests"] else ""))
    out.append("-- engines --")
    for e, st in report["engines"].items():
        drift = st["span_drift_ratio"]
        out.append(
            f"{e}: steps={st['steps']}"
            f" burst_units={st['burst_units']}"
            + (f" measured_unit_s={st['measured_unit_s']:.3g}"
               if st["measured_unit_s"] is not None else "")
            + (f" span_drift={drift:.3g}" if drift is not None else ""))
        for k, v in st["phase_s"].items():
            out.append(f"    {k:<20s} {v:.6f}s")
    out.append("-- classes --")
    for c, st in report["classes"].items():
        out.append(
            f"{c}: n={st['requests']} outcomes={st['outcomes']}"
            f" queue_p50={st['queue_wait_s']['p50']:.6f}s"
            f" service_p50={st['service_s']['p50']:.6f}s"
            f" coverage_min={st['coverage_min']:.3f}")
    return "\n".join(out)


def render_json(report: dict, **kwargs) -> str:
    kwargs.setdefault("indent", 2)
    kwargs.setdefault("sort_keys", True)
    return json.dumps(report, **kwargs)
