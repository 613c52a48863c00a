"""Closed loop through the port's ``Engine``: ``clients`` callers, each with
one request outstanding, submitting its next as soon as its last retires.

Traffic keys: ``slots`` (the engine's), ``clients``, ``warm_retired``
(requests retired before the window opens: the slots full and turning
over), ``pool`` (distinct requests, read by the system).  Request i of a run
is the system's request i with the keys of rows ``k i .. k i + k - 1`` of
the seed's key stream, pinned through ``submit(keys=)``.

The window opens after the warm-up and closes at the end of the first
engine step that ends ``seconds`` or more after it opened; a request counts
in it when the harness saw it retire inside.  Then the loop stops
submitting and drains what is in flight, for up to ``patience_s`` seconds, so
that every request submitted before the close can be judged.  What the
harness does between engine calls is kept small: request inputs are views
made in the set-up, and outcomes are copied into columns after the drain.
"""
from __future__ import annotations

import torch

from perfbench.bench import inputs
from perfbench.bench.harness import Window
from perfbench.bench.records import RecordBook

KEY_CHUNK = 1 << 15  # requests whose keys are made at once


def run(system, traffic: dict, seconds: float, probe, patience_s: float) -> Window:
    from repro_torch import engine

    clock = probe.clock
    k = system.rows
    eng = engine.Engine(system.spec(tail=probe.tail), slots=int(traffic["slots"]),
                        obs=probe.obs, device=system.device)
    chunks: dict = {}  # chunk -> (host keys [KEY_CHUNK, k, 2], device views)
    live: dict = {}  # engine request id -> (i, t_submit)
    retired: list = []  # (i, t_submit, t_retire, factorization, result)
    state = {"next": 0, "resubmit": True, "record": False}

    def keys_of(i: int):
        c, j = divmod(i, KEY_CHUNK)
        if c not in chunks:
            host = inputs.row_keys(system.seed, c * KEY_CHUNK * k,
                                   KEY_CHUNK * k).reshape(KEY_CHUNK, k, 2)
            dev = torch.as_tensor(host, device=system.device)
            chunks[c] = (host, dev.unbind(0))
        return chunks[c][1][j]

    def submit() -> None:
        i = state["next"]
        state["next"] += 1
        q, meta = system.request(i)
        keys = keys_of(i)
        with probe.span("submit"):
            t = clock()
            rid = eng.submit(q, keys=keys, meta=meta)
        live[rid] = (i, t)

    def step() -> int:
        done = eng.step()
        t = clock()
        with probe.span("harness"):
            for req in done:
                i, ts = live.pop(req.id)
                eng.completed.pop(req.id, None)
                if state["record"]:
                    retired.append((i, ts, t, req.factorization, req.result))
                if state["resubmit"]:
                    submit()
        return len(done)

    keys_of(0)
    for _ in range(int(traffic["clients"])):
        submit()
    n, t_warm = 0, clock()
    while n < int(traffic["warm_retired"]) and clock() - t_warm < patience_s:
        n += step()
    keys_of(state["next"] + KEY_CHUNK // 2)  # the window's keys, made now
    win = Window.open(probe)
    state["record"] = True
    while True:
        step()
        if not win.tick():
            break
    win.close(len(retired))
    in_flight = len(live)
    state["resubmit"] = False
    t_drain = clock()
    while live and clock() - t_drain < patience_s:
        step()
    book = RecordBook(system.fields(), capacity=max(len(retired), 1))
    for i, ts, tr, fact, result in retired:
        keys = chunks[i // KEY_CHUNK][0][i % KEY_CHUNK]
        book.add({"i": i, "t_submit": ts, "t_retire": tr, "keys": keys,
                  **system.outcome(fact, result)})
    win.finish(book, attempted=win.completed + in_flight,
               unanswered=len(live), engine=eng)
    return win
