"""Closed loop through the port's ``LMEngine``: ``clients`` callers, each
with one generation request outstanding, submitting its next as soon as its
last retires.

Traffic keys: ``block_size`` and ``prefill_chunk`` (the engine's, read by
the system, which takes its slots and their length from the
configuration), ``clients``, ``warm_retired`` (requests retired before the
window opens: the slots full and turning over), ``pool``, ``strata``,
``prompt_len`` and ``new_tokens`` (read by the system).  Request i of a
run is the system's request i.

The window opens after the warm-up and closes at the end of the first
engine step that ends ``seconds`` or more after it opened; a request counts
in it when the harness saw it retire inside.  Then the loop stops
submitting and drains what is in flight, for up to ``patience_s`` seconds,
as ``closed_loop`` does.

Besides the submit and retire times, each request's ``t_first`` is the end
of the engine step in which it left the queue: that step's fill prefilled
it and its decode burst produced its first token; ``step_first`` and
``step_retire`` number that step and the one that retired it.  The loop
keeps the decode steps of every engine step's burst (``decode_dispatches``,
a plain counter) on the window as ``decodes``, the numbers of the window's
first and last steps as ``window_steps``, and for each step of the window
its start and end and the KV lengths before the burst of the slots that
decoded in it, from the host mirror (``serve.lens``, ``serve.active``; no
device sync), as ``steps``.

An engine step lasts seconds (its fill prefills every admitted prompt), and
the window can close only between steps, so a traced run starts the device
trace before the step that is likely the window's last, where that comes
before the harness's own start (the window's last ``TRACE_SECONDS``), and
where a step ran longer than the one before it and the window would close
with no whole step traced, runs one step more: the trace then holds at
least one whole step.  The loop's phases are printed on standard error.
"""
from __future__ import annotations

import sys

import numpy as np

from perfbench.bench.harness import Window
from perfbench.bench.records import RecordBook

WARM_LIMIT_S = 300.0  # the warm-up ends here even short of its count


def run(system, traffic: dict, seconds: float, probe, patience_s: float) -> Window:
    clock = probe.clock
    eng = system.engine(probe.obs)
    live: dict = {}  # engine request id -> (i, t_submit)
    first: dict = {}  # engine request id -> (t_first, step_first)
    retired: list = []  # (i, t_submit, (t_first, step_first), t_retire,
    #                      step_retire, request)
    decodes: list = []  # decode steps of each engine step's burst
    steps: list = []  # (t_start, t_end, decodes, KV lengths before the burst)
    state = {"next": 0, "resubmit": True, "steps": False}

    def submit() -> None:
        i = state["next"]
        state["next"] += 1
        prompt, new = system.request(i)
        with probe.span("submit"):
            t = clock()
            rid = eng.submit(prompt, max_new_tokens=new)
        live[rid] = (i, t)

    def step() -> None:
        serve = eng.serve
        queued = eng.queued_requests()
        lens0, d0 = serve.lens.copy(), serve.decode_dispatches
        t0 = clock()
        done = eng.step()
        t = clock()
        with probe.span("harness"):
            k, n = len(decodes), serve.decode_dispatches - d0
            decodes.append(n)
            for rid in queued.keys() - eng.queued_requests().keys():
                first[rid] = (t, k)
            if state["steps"]:
                ran = serve.active | (serve.lens != lens0)
                steps.append((t0, t, n, (serve.lens[ran] - n).astype(np.int32)))
            for req in done:
                i, ts = live.pop(req.id)
                eng.completed.pop(req.id, None)
                retired.append((i, ts, first.pop(req.id), t, k, req))
                if state["resubmit"]:
                    submit()

    for _ in range(int(traffic["clients"])):
        submit()
    t_warm = clock()
    warm_steps, t_fill = 0, 0.0
    while len(retired) < int(traffic["warm_retired"]) \
            and clock() - t_warm < WARM_LIMIT_S:
        step()
        warm_steps += 1
        if warm_steps == 1:
            t_fill = clock() - t_warm
    t_warm = clock() - t_warm
    retired.clear()
    w0 = len(decodes)
    win = Window.open(probe)
    state["steps"] = True
    dt = probe.device_trace
    traced = dt is None  # a whole step ran under the device trace
    while True:
        on = dt is not None and dt.t0 is not None
        t = clock()
        step()
        last = clock() - t
        traced = traced or on
        if dt is not None and dt.t0 is None and \
                clock() + last >= win.t0 + seconds:
            dt.start()
        if not win.tick() and traced:
            break
    t_close = clock()
    win.window_steps = (w0, len(decodes) - 1)
    win.close(len(retired))
    t_close = clock() - t_close  # the device trace's collection, if any
    state["steps"] = False
    in_flight = len(live)
    state["resubmit"] = False
    t_drain = clock()
    while live and clock() - t_drain < patience_s:
        step()
    print(f"lm_closed_loop: warm-up {t_warm:.1f} s in {warm_steps} steps "
          f"(the first, filling {traffic['clients']} slots, {t_fill:.1f} s); "
          f"window {win.seconds:.1f} s in {len(steps)} steps, "
          f"{win.completed} retired; close {t_close:.1f} s; drain "
          f"{clock() - t_drain:.1f} s",
          file=sys.stderr, flush=True)
    book = RecordBook(system.fields(), capacity=max(len(retired), 1))
    for i, ts, (tf, kf), tr, kr, req in retired:
        book.add({"i": i, "t_submit": ts, "t_first": tf, "t_retire": tr,
                  "step_first": kf, "step_retire": kr, **system.outcome(req)})
    cols = book.view()
    system.short_total = int(np.sum(cols["truncated"]
                                    | (cols["iterations"] != cols["max_new"])))
    system.pool_dtype = str(eng.serve.pool["k"].dtype)
    win.steps, win.decodes = steps, np.asarray(decodes, dtype=np.int64)
    win.finish(book, attempted=win.completed + in_flight,
               unanswered=len(live), engine=eng)
    return win
