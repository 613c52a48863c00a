"""The port's ``Engine`` queue discipline: a binary heap keyed by
``(priority, id, qi)``.

A heap pops the lowest key, as the linear scan it replaced did (walk the
whole queue, build each row's key, delete the smallest from the middle).
Driven side by side on one seeded schedule of submits, steps, preemptions,
cancellations, resizes and recoveries, the two disciplines put the same row
in every slot after every call and complete the same requests in the same
order with bit-equal results.  The heap keeps its order through ``cancel``,
and rows re-queued by ``preempt``, ``resize`` and ``recover`` come out ahead
of same-priority newcomers.
"""
import numpy as np
import pytest
import torch

from repro_torch import engine as P
from repro_torch.core import factorizer as fz
from repro_torch.core import vsa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _LinearScanEngine(P.Engine):
    """The discipline the heap replaced: rows appended unordered, and each
    pop scans the whole queue for the lowest ``(priority, id, qi)``."""

    def _requeue(self, req, qi):
        self._queue.append((req.priority, req.id, qi, req))

    def _pop_next(self):
        best_i, best = 0, None
        for i, (*_, qi, req) in enumerate(self._queue):
            k = (req.priority, req.id, qi)
            if best is None or k < best:
                best_i, best = i, k
        *_, qi, req = self._queue[best_i]
        del self._queue[best_i]
        return req, qi


@pytest.fixture(scope="module")
def spec():
    """Bipolar Gauss-Seidel with Philox noise and restarts: each row's
    trajectory turns on its pinned key and its own sweep index."""
    cfg = fz.FactorizerConfig(vsa=vsa.VSAConfig(256, 256), num_factors=3,
                              codebook_size=10, noise_std=0.3,
                              proj_noise_std=0.1, restart_every=4,
                              max_iters=24, conv_threshold=0.95)
    return P.ServeSpec("queue", codebooks=fz.make_codebooks(3, cfg,
                                                            device="cpu"),
                       cfg=cfg)


def _queries(spec, n, rng):
    """``n`` bound queries with a tenth of their signs flipped."""
    qs = fz.bind_combo(spec.codebooks,
                       torch.from_numpy(rng.integers(0, 10, (n, 3))),
                       spec.cfg.vsa)
    flip = torch.from_numpy(rng.random(tuple(qs.shape)) < 0.1)
    return torch.where(flip, -qs, qs)


def _owners(eng):
    return [None if o is None else (o[0].id, o[1]) for o in eng._owner]


def _schedule(seed, slots):
    """A seeded list of calls: submits of 1-8 queries at priorities 0-3,
    steps, and at fixed points a preempt, a cancel of a queued and of a
    live request, a resize below the live-row count then back, and a
    recover."""
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(48):
        calls.append(("submit", int(rng.integers(1, 9)),
                      int(rng.integers(0, 4))))
        if i % 3 == 2:
            calls.append(("step",))
        if i == 10:
            calls += [("preempt",), ("step",), ("cancel", "queued")]
        if i == 20:
            calls += [("shrink",), ("step",), ("cancel", "live")]
        if i == 26:
            calls += [("grow", slots), ("step",), ("preempt",)]
        if i == 34:
            calls += [("recover",), ("step",), ("cancel", "queued")]
        if i == 40:
            calls += [("shrink",), ("step",), ("grow", slots)]
    return calls


def _apply(eng, call, submit_args, pick):
    """One call on ``eng``; ``pick`` names the request a preempt or cancel
    takes, from the first engine's state (the two must agree)."""
    op = call[0]
    if op == "submit":
        q, k, prio = submit_args
        return eng.submit(q, keys=k, priority=prio)
    if op == "step":
        return eng.step()
    if op == "preempt":
        return eng.preempt(pick)
    if op == "cancel":
        return eng.cancel(pick)
    if op == "shrink":
        return eng.resize(pick)
    if op == "grow":
        return eng.resize(call[1])
    return eng.recover()


@pytest.mark.parametrize("slots", [4, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heap_fills_slots_as_the_linear_scan_did(spec, seed, slots):
    heap = P.Engine(spec, slots=slots, sweeps_per_step=2, device="cpu")
    scan = _LinearScanEngine(spec, slots=slots, sweeps_per_step=2,
                             device="cpu")
    rng = np.random.default_rng(1000 + seed)
    done_heap, done_scan = [], []
    disturbed = {"preempt": 0, "cancel": 0, "shrink": 0, "recover": 0}
    for call in _schedule(seed, slots):
        op, args, pick = call[0], None, None
        if op == "submit":
            args = (_queries(spec, call[1], rng),
                    fz.draw_keys(int(rng.integers(2**31)), call[1]),
                    call[2])
        elif op == "preempt" or (op == "cancel" and call[1] == "live"):
            live = sorted(heap.live_requests())
            if not live:
                continue
            pick = live[int(rng.integers(len(live)))]
        elif op == "cancel":
            queued = sorted(heap.queued_requests())
            if not queued:
                continue
            pick = queued[int(rng.integers(len(queued)))]
        elif op == "shrink":
            live = sum(o is not None for o in heap._owner)
            if live < 2:
                continue
            pick = live // 2
        out_heap = _apply(heap, call, args, pick)
        out_scan = _apply(scan, call, args, pick)
        if op == "step":
            done_heap += out_heap
            done_scan += out_scan
        else:
            assert out_heap == out_scan, call
        if op in disturbed:
            disturbed[op] += 1
        assert _owners(heap) == _owners(scan), call
        assert heap.queued_requests() == scan.queued_requests(), call
        assert heap.in_flight == scan.in_flight, call
    done_heap += heap.drain()
    done_scan += scan.drain()
    assert all(disturbed.values()), disturbed
    assert [r.id for r in done_heap] == [r.id for r in done_scan]
    assert len(done_heap) > 30
    for a, b in zip(done_heap, done_scan):
        for name in fz.FactorizerResult._fields:
            np.testing.assert_array_equal(getattr(a.factorization, name),
                                          getattr(b.factorization, name),
                                          err_msg=f"request {a.id} {name}")
    assert heap.sweeps_total == scan.sweeps_total


def _submit(eng, spec, rng, k, priority=0):
    return eng.submit(_queries(spec, k, rng), keys=fz.draw_keys(
        int(rng.integers(2**31)), k), priority=priority)


def _drain_queue(eng):
    out = []
    while eng._queue:
        req, qi = eng._pop_next()
        out.append((req.priority, req.id, qi))
    return out


def test_cancel_keeps_the_heap_ordered(spec):
    """Cancel a queued request and one with a row in a slot and rows in
    the queue: what is left pops in sorted order, and the counts equal a
    plain count of the rows."""
    rng = np.random.default_rng(3)
    eng = P.Engine(spec, slots=4, sweeps_per_step=1, device="cpu")
    ids = [_submit(eng, spec, rng, k, p)
           for k, p in [(3, 2), (3, 0), (2, 1), (4, 0), (1, 3), (5, 1),
                        (2, 0), (3, 2)]]
    eng._fill()
    # slots hold ids[1] x 3 and ids[3]'s row 0: ids[3] is half slotted
    assert _owners(eng) == [(ids[1], 0), (ids[1], 1), (ids[1], 2),
                            (ids[3], 0)]
    assert eng.cancel(ids[3]) and eng.cancel(ids[5])
    queued = {(ids[i], qi): p for i, (k, p) in enumerate(
        [(3, 2), (3, 0), (2, 1), (4, 0), (1, 3), (5, 1), (2, 0), (3, 2)])
        if i not in (1, 3, 5) for qi in range(k)}
    rows = {}
    for rid, _ in queued:
        rows[rid] = rows.get(rid, 0) + 1
    assert eng.queued_requests() == {
        rid: {"priority": queued[(rid, 0)], "rows": n}
        for rid, n in rows.items()}
    slotted = sum(o is not None for o in eng._owner)
    assert eng.in_flight == slotted + len(queued) == 3 + 11
    got = _drain_queue(eng)
    assert got == sorted((p, rid, qi) for (rid, qi), p in queued.items())


@pytest.mark.parametrize("how", ["preempt", "resize", "recover"])
def test_requeued_rows_come_out_ahead_of_newcomers(spec, how):
    """Rows a preempt, a shrinking resize or a recover puts back come out
    before rows of the same priority submitted after them, in their own
    (id, qi) order, and behind rows of a better priority."""
    rng = np.random.default_rng(4)
    eng = P.Engine(spec, slots=4, sweeps_per_step=1, device="cpu")
    first = [_submit(eng, spec, rng, 2, 1) for _ in range(2)]
    eng.step()
    assert _owners(eng) == [(first[0], 0), (first[0], 1), (first[1], 0),
                            (first[1], 1)]
    late = [_submit(eng, spec, rng, 2, 1), _submit(eng, spec, rng, 1, 0)]
    if how == "preempt":
        assert eng.preempt(first[1]) == 2
        back = [(1, first[1], 0), (1, first[1], 1)]
    elif how == "resize":
        eng.resize(1)
        back = [(1, first[0], 1), (1, first[1], 0), (1, first[1], 1)]
    else:
        assert eng.recover() == 4
        back = [(1, rid, qi) for rid in first for qi in range(2)]
    got = _drain_queue(eng)
    assert got == [(0, late[1], 0)] + back + [(1, late[0], 0),
                                              (1, late[0], 1)]
