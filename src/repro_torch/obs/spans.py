"""Span model: one request's journey through the serving stack as a tree.

A :class:`Span` is a named interval on one *track* (an engine, the runtime
supervisor, the request lifecycle row), stamped against ONE monotonic clock
— the same clock the runtime, the engines, and the telemetry use, which is
what makes a mixed nvsa+lvrf+lm run render as one coherent timeline.
Parentage is explicit (``parent`` span id): stack-scoped spans (the
``with rec.span(...)`` form) parent under whatever is open on their track,
long-lived spans (a request from submit to resolve, a fault→quarantine→
recovery cycle) carry their parent across threads and engine steps by id.

Everything here is host-side bookkeeping — spans are recorded AROUND device
dispatches, never inside jitted code — and the store is append-only: a
snapshot or an export never mutates recording state, so a metrics scrape
and a trace dump cannot race each other.
"""
from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class Span:
    """One recorded interval (or instant marker) on a track."""

    sid: int
    name: str
    track: str
    t0: float
    t1: float | None = None  # None while open; == t0 for instants
    parent: int | None = None
    cat: str | None = None
    args: dict = dataclasses.field(default_factory=dict)
    instant: bool = False

    @property
    def duration(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    @property
    def open(self) -> bool:
        return self.t1 is None


class SpanStore:
    """Thread-safe append-only span recorder.

    ``begin``/``end`` manage explicit (possibly cross-thread) spans;
    ``push``/``pop`` additionally maintain a per-track open-span stack so
    context-manager spans nest without the caller naming parents.  Ids are
    process-local and monotone — a parent's id is always smaller than its
    children's, which tests use as a cheap happened-before check.
    """

    def __init__(self, clock):
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._by_id: dict[int, Span] = {}
        self._stacks: dict[str, list[int]] = {}  # track -> open span ids
        self._next = 0

    # -- recording ---------------------------------------------------------

    def begin(self, name: str, *, track: str, parent: int | None = None,
              cat: str | None = None, args: dict | None = None) -> int:
        now = self._clock()
        with self._lock:
            sid = self._next
            self._next += 1
            if parent is None:
                stack = self._stacks.get(track)
                parent = stack[-1] if stack else None
            sp = Span(sid, name, track, now, parent=parent, cat=cat,
                      args=dict(args) if args else {})
            self._spans.append(sp)
            self._by_id[sid] = sp
        return sid

    def end(self, sid: int, args: dict | None = None) -> None:
        now = self._clock()
        with self._lock:
            sp = self._by_id.get(sid)
            if sp is None or sp.t1 is not None:
                return  # unknown / already closed: never raise from telemetry
            sp.t1 = max(now, sp.t0)  # clamp: injectable clocks may be frozen
            if args:
                sp.args.update(args)

    def push(self, name: str, *, track: str, cat: str | None = None,
             args: dict | None = None) -> int:
        """``begin`` + make this span the open parent for its track."""
        sid = self.begin(name, track=track, cat=cat, args=args)
        with self._lock:
            self._stacks.setdefault(track, []).append(sid)
        return sid

    def pop(self, sid: int, args: dict | None = None) -> None:
        """``end`` + close the track's stack down to (and including) `sid`."""
        with self._lock:
            stack = self._stacks.get(self._by_id[sid].track, [])
            while stack and stack[-1] != sid:
                stack.pop()  # unbalanced exits (exceptions) still unwind
            if stack:
                stack.pop()
        self.end(sid, args)

    def instant(self, name: str, *, track: str, parent: int | None = None,
                cat: str | None = None, args: dict | None = None) -> int:
        sid = self.begin(name, track=track, parent=parent, cat=cat, args=args)
        with self._lock:
            sp = self._by_id[sid]
            sp.t1 = sp.t0
            sp.instant = True
        return sid

    # -- reading (non-destructive) -----------------------------------------

    def snapshot(self) -> list[Span]:
        """Point-in-time copy of every recorded span (recording continues)."""
        with self._lock:
            return [dataclasses.replace(sp, args=dict(sp.args))
                    for sp in self._spans]

    def get(self, sid: int) -> Span | None:
        with self._lock:
            return self._by_id.get(sid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def validate(spans: list[Span]) -> list[str]:
    """Structural trace checks; returns a list of violation strings (empty =
    valid).  The trace-schema contract tests assert against:

      * no negative durations;
      * every parent id exists and was begun no later than its child;
      * a closed parent contains its closed children's intervals (small
        clock-read slop tolerated: parent ``end`` reads the clock after the
        child's).
    """
    by_id = {sp.sid: sp for sp in spans}
    bad = []
    eps = 1e-6
    for sp in spans:
        if sp.t1 is not None and sp.t1 < sp.t0:
            bad.append(f"span {sp.sid} ({sp.name}): negative duration")
        if sp.parent is not None:
            par = by_id.get(sp.parent)
            if par is None:
                bad.append(f"span {sp.sid} ({sp.name}): unknown parent "
                           f"{sp.parent}")
                continue
            if sp.t0 < par.t0 - eps:
                bad.append(f"span {sp.sid} ({sp.name}): starts before its "
                           f"parent {par.sid} ({par.name})")
            if (par.t1 is not None and sp.t1 is not None
                    and sp.t1 > par.t1 + eps):
                bad.append(f"span {sp.sid} ({sp.name}): ends after its "
                           f"closed parent {par.sid} ({par.name})")
    return bad
