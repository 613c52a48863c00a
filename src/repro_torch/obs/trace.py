"""Chrome-trace / Perfetto JSON export of a :class:`Recorder`'s spans.

Emits the Trace Event Format (the JSON ``chrome://tracing`` and
https://ui.perfetto.dev both load): one process, one ``tid`` row per track
— engine rows next to the runtime supervisor and the request-lifecycle
row — so a mixed nvsa+lvrf+lm chaos run renders as a single timeline with
sweep bursts, prefill chunks, resize/retune decisions, and
fault→quarantine→recovery cycles all on the same monotonic clock.

Mapping: closed spans -> ``X`` (complete) events, instants -> ``i``
(thread-scoped), still-open spans -> ``B`` (begin-only; Perfetto renders
them to the end of the trace), plus ``M`` metadata naming the rows.
Timestamps are microseconds relative to the recorder's epoch; explicit
span parentage survives in ``args._span_id``/``args._parent`` for tools
that want the tree (the on-screen nesting comes from same-tid time
containment, which stack-scoped spans guarantee).
"""
from __future__ import annotations

import json


def _events(rec) -> list[dict]:
    spans = rec.spans.snapshot()
    tracks: list[str] = []
    for sp in spans:
        if sp.track not in tracks:
            tracks.append(sp.track)
    tid = {t: i for i, t in enumerate(tracks)}
    events = []
    for t, i in tid.items():
        events.append({"ph": "M", "pid": 0, "tid": i, "name": "thread_name",
                       "args": {"name": t}})
        events.append({"ph": "M", "pid": 0, "tid": i,
                       "name": "thread_sort_index", "args": {"sort_index": i}})
    for sp in spans:
        ts = (sp.t0 - rec.t_epoch) * 1e6
        args = {**sp.args, "_span_id": sp.sid}
        if sp.parent is not None:
            args["_parent"] = sp.parent
        ev = {"pid": 0, "tid": tid[sp.track], "name": sp.name, "ts": ts,
              "args": args}
        if sp.cat is not None:
            ev["cat"] = sp.cat
        if sp.instant:
            ev.update(ph="i", s="t")
        elif sp.t1 is not None:
            ev.update(ph="X", dur=(sp.t1 - sp.t0) * 1e6)
        else:
            ev["ph"] = "B"  # still open at export time
        events.append(ev)
    return events


def to_chrome_trace(rec) -> dict:
    """The loadable trace dict: ``{"traceEvents": [...], ...}``."""
    return {"traceEvents": _events(rec), "displayTimeUnit": "ms",
            "otherData": {"clock": "repro-monotonic",
                          "metrics": rec.metrics.snapshot()}}


def write_chrome_trace(rec, path: str) -> dict:
    """Serialize to `path`; open the file in https://ui.perfetto.dev or
    chrome://tracing.  Returns the trace dict."""
    trace = to_chrome_trace(rec)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1, default=str)  # args may hold repr-ables
    return trace
