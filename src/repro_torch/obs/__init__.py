"""repro_torch.obs — spans and metrics recorded around the serving loop.

The port of the reference package's ``obs``: request span tracing on one
monotonic clock across every layer (resonator sweep bursts -> Engine ->
ShardedEngine -> Runtime supervision -> paged LM serving), a metrics
registry, per-class SLO attainment (:class:`SLOTracker`) and the
span-derived attribution of each request's wall time (:func:`attribution`).

Three rules keep it honest:

  * **injectable** — ``Runtime(obs=)`` / ``Engine(obs=)`` with the
    :data:`NULL` recorder as the default (every method a constant-time
    no-op); nothing global, nothing ambient except the opt-in
    ``REPRO_OBS=1`` seam, :func:`maybe_obs`;
  * **around the device, never inside it** — recording happens on the host
    around kernel launches; the kernels launched are the same with tracing
    on or off;
  * **non-destructive reads** — metric snapshots and trace exports never
    reset recording state, so a scrape and the re-tuner cannot race.

Typical use::

    from repro_torch import obs, runtime
    rec = obs.Recorder()
    rt = runtime.Runtime(obs=rec)           # engines bind on register()
    ... serve ...
    rec.write_chrome_trace("trace.json")    # open in ui.perfetto.dev
    print(obs.render_text(obs.attribution(rec)))
"""
from __future__ import annotations

import os

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, quantile)
from repro_torch.obs.recorder import (DEFAULT_CLOCK, NULL, NullRecorder,
                                      Recorder)
from repro_torch.obs.report import attribution, render_json, render_text
from repro_torch.obs.slo import SLOTarget, SLOTracker
from repro_torch.obs.spans import Span, SpanStore, validate
from repro_torch.obs.trace import to_chrome_trace, write_chrome_trace

__all__ = [
    "Counter", "DEFAULT_CLOCK", "Gauge", "Histogram", "MetricsRegistry",
    "NULL", "NullRecorder", "Recorder", "SLOTarget", "SLOTracker", "Span",
    "SpanStore", "attribution", "maybe_obs", "quantile", "render_json",
    "render_text", "to_chrome_trace", "validate", "write_chrome_trace",
]


def maybe_obs(obs=None, *, env: str = "REPRO_OBS"):
    """Resolve a layer's ``obs=`` argument: an explicit recorder wins, the
    env seam (``REPRO_OBS=1``) turns on a real recorder for an
    instrumented-path-is-a-no-op run, and otherwise the :data:`NULL`
    recorder keeps the whole layer free."""
    if obs is not None:
        return obs
    if os.environ.get(env):
        return Recorder()
    return NULL
