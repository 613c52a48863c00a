"""The ``Steppable`` protocol: what the runtime needs from an engine.

The port of the reference package's ``runtime/protocol.py``.

The online runtime (:mod:`repro_torch.runtime.runtime`) orchestrates
heterogeneous engines — the factorizer ``Engine``, its mesh-parallel
``ShardedEngine``, and the LM adapter
:class:`repro_torch.runtime.lm.LMEngine` — through one structural
interface.  Anything that slots requests into a fixed device-resident batch
and advances it in host-scanned bursts fits:

  * ``submit(payload, **kw) -> int`` — enqueue one request, return its
    engine-local id (must not block on device work);
  * ``step() -> list`` — fill free slots, run one adSCH-sized burst, retire;
    returns the request objects completed by this step (each carrying
    ``.id`` and ``.result``);
  * ``drain() -> list`` — run until idle (synchronous fallback path);
  * ``in_flight`` — queued + slotted requests not yet completed;
  * ``stats() -> dict`` — counters + rolling latency percentiles.

Engines are NOT thread-safe; the runtime serializes every mutating call
(``submit``/``step``/``resize``/``stats``) onto its stepper thread and one
lock.  The protocol is structural (no inheritance): ``Engine`` and
``ShardedEngine`` already satisfy it unmodified.

Five optional members refine the runtime's behavior when present:

  * ``step_cost_s() -> float`` — adSCH-modeled wall seconds of one ``step()``
    burst, feeding the cost-weighted engine picking
    (:func:`step_cost_seconds` provides the fallback);
  * ``resize(slots)`` — warm-handoff slot re-tune, the hook the EWMA-driven
    re-tuner calls (engines without it are never re-tuned);
  * ``recover() -> int`` — rebuild after a fault and replay in-flight work
    from pinned keys (the bit-safe re-queue contract ``resize`` introduced).
    The supervisor's quarantine/restart path needs it: engines WITHOUT it
    go straight to dead on their first fault (their in-flight futures fail
    with a structured error instead of being replayed);
  * ``cancel(local_id) -> bool`` — preemption-safe single-request reclaim,
    used when a ``submit(deadline_s=)`` budget expires (without it the
    future still fails on time, but the slot runs the row to completion);
  * ``health_check() -> str | None`` — cadenced corruption probe (e.g.
    non-finite resonator state); a non-None description routes the engine
    through the same quarantine/replay path as a step exception.
  * ``preempt(local_id) -> int`` — bit-safe preemption: park the request's
    live rows and RE-QUEUE them from their pinned keys (the ``recover``
    replay contract), unlike ``cancel`` which discards the work.  The
    fleet controller uses it to clear slots for higher-priority classes;
    with it come ``live_requests()``/``queued_requests()`` introspection
    (``{local_id: {"priority": p, "rows": n}}``) for victim selection.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

DEFAULT_STEP_COST_S = 1e-3


@runtime_checkable
class Steppable(Protocol):
    """Structural interface every runtime-managed engine satisfies."""

    def submit(self, payload, **kwargs) -> int: ...

    def step(self) -> list: ...

    def drain(self) -> list: ...

    @property
    def in_flight(self) -> int: ...

    def stats(self) -> dict: ...


def step_cost_seconds(engine) -> float:
    """Modeled seconds of one ``step()`` of `engine`, with a neutral fallback
    for engines that don't expose ``step_cost_s`` (they then round-robin at
    equal weight)."""
    fn = getattr(engine, "step_cost_s", None)
    if fn is None:
        return DEFAULT_STEP_COST_S
    try:
        cost = float(fn())
    except (ValueError, TypeError):
        return DEFAULT_STEP_COST_S
    return cost if cost > 0 else DEFAULT_STEP_COST_S


def supports_resize(engine) -> bool:
    """Whether the EWMA re-tuner may call ``engine.resize``."""
    return callable(getattr(engine, "resize", None))


def supports_recover(engine) -> bool:
    """Whether the supervisor may quarantine-and-replay this engine (no
    ``recover`` means a fault kills it outright)."""
    return callable(getattr(engine, "recover", None))


def supports_cancel(engine) -> bool:
    """Whether deadline expiry can reclaim the request's slot immediately."""
    return callable(getattr(engine, "cancel", None))


def supports_health_check(engine) -> bool:
    """Whether the supervisor's cadenced corruption probe applies."""
    return callable(getattr(engine, "health_check", None))


def supports_preempt(engine) -> bool:
    """Whether the fleet controller may preempt-and-requeue live requests
    (bit-safe replay from pinned keys — unlike ``cancel``, no work is
    discarded, only deferred)."""
    return callable(getattr(engine, "preempt", None))
