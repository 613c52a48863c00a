"""The observability seam: ``Recorder`` when you want traces, ``NULL`` when
you don't.

Every serving layer takes an ``obs=`` recorder (``Engine``, ``LMEngine``,
``ServeEngine``, ``Runtime``) defaulting to the :data:`NULL` singleton,
whose every method is a constant-time no-op returning shared singletons —
no per-step allocation, no device work, no captured state inside jitted
code (recording always happens AROUND dispatches).  The disabled path is
therefore a behavioral no-op: bit-identical result streams and identical
dispatch counts, asserted in tests/test_obs.py.

One clock rules all layers: the recorder owns the monotonic clock
(injectable for tests), and layers built with default clocks adopt it, so
span timestamps, request latencies, EWMA telemetry, and quarantine backoff
expiries are mutually comparable — the clock-domain split between
``time.perf_counter`` (engines) and ``time.monotonic`` (runtime) that used
to make cross-layer timelines incoherent is gone.
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import SpanStore

DEFAULT_CLOCK = time.monotonic  # THE serving-stack clock (engines + runtime)


class _SpanCtx:
    """Context manager over one stack-scoped span; yields the live Span so
    callers can attach args discovered mid-body (sweep counts, retirements).
    Reusable is NOT needed here — one per ``span()`` call on the enabled
    path only."""

    __slots__ = ("_store", "_sid")

    def __init__(self, store, sid):
        self._store = store
        self._sid = sid

    def __enter__(self):
        return self._store.get(self._sid)

    def __exit__(self, *exc):
        self._store.pop(self._sid)
        return False


class _NullSpanCtx:
    """Shared no-op context manager: the whole disabled-path span cost is
    one method call returning this singleton."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpanCtx()


class Recorder:
    """Span tracing + unified metrics behind one injectable object."""

    enabled = True

    def __init__(self, *, clock=DEFAULT_CLOCK):
        self.clock = clock
        self.t_epoch = clock()  # trace time zero (export offsets from here)
        self.spans = SpanStore(clock)
        self.metrics = MetricsRegistry()

    def now(self) -> float:
        return self.clock()

    # -- spans -------------------------------------------------------------

    def span(self, name: str, *, track: str = "runtime",
             cat: str | None = None, args: dict | None = None):
        """Stack-scoped span: ``with rec.span("step", track=...) as sp:``.
        Nested calls on the same track parent automatically."""
        return _SpanCtx(self.spans, self.spans.push(name, track=track,
                                                    cat=cat, args=args))

    def begin(self, name: str, *, track: str, parent: int | None = None,
              cat: str | None = None, args: dict | None = None) -> int:
        """Open a long-lived span (request lifecycle, fault cycle) whose
        ``end`` happens on another code path; returns its id."""
        return self.spans.begin(name, track=track, parent=parent, cat=cat,
                                args=args)

    def end(self, sid, args: dict | None = None) -> None:
        if sid is not None:
            self.spans.end(sid, args)

    def instant(self, name: str, *, track: str, parent: int | None = None,
                cat: str | None = None, args: dict | None = None) -> int:
        return self.spans.instant(name, track=track, parent=parent, cat=cat,
                                  args=args)

    # -- metrics -----------------------------------------------------------

    def count(self, name: str, value=1, **labels) -> None:
        self.metrics.counter(name, **labels).add(value)

    def gauge(self, name: str, value, **labels) -> None:
        self.metrics.gauge(name, **labels).set(value)

    def observe(self, name: str, value, **labels) -> None:
        self.metrics.histogram(name, **labels).observe(value)

    # -- export ------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        from repro_torch.obs.trace import to_chrome_trace
        return to_chrome_trace(self)

    def write_chrome_trace(self, path: str) -> dict:
        from repro_torch.obs.trace import write_chrome_trace
        return write_chrome_trace(self, path)


class NullRecorder:
    """Disabled observability: every method is a no-op; ``span`` returns one
    shared context manager.  ``clock``/``now`` still expose the unified
    monotonic clock so layers can stamp timestamps through their recorder
    regardless of whether tracing is on."""

    enabled = False
    clock = staticmethod(DEFAULT_CLOCK)

    def now(self) -> float:
        return DEFAULT_CLOCK()

    def span(self, name, *, track="runtime", cat=None, args=None):
        return _NULL_SPAN

    def begin(self, name, *, track, parent=None, cat=None, args=None):
        return None

    def end(self, sid, args=None) -> None:
        return None

    def instant(self, name, *, track, parent=None, cat=None, args=None):
        return None

    def count(self, name, value=1, **labels) -> None:
        return None

    def gauge(self, name, value, **labels) -> None:
        return None

    def observe(self, name, value, **labels) -> None:
        return None


NULL = NullRecorder()
