"""One run of one cell: set-up, the measured window, the check, the result.

:func:`run_cell` builds the cell's system from the port, hands its traffic
generator a :class:`Probe` (the clock, and in a traced run the ``obs``
recorder the engine binds, the harness's own spans and a device trace over
the window's last seconds), then judges a sample of what the window produced
against the plain reference and reads the cell's metrics.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import subprocess
import sys
import time

import numpy as np
import torch

from perfbench.bench import judge, peaks, reduce, spec
from perfbench.bench.trace import DeviceTrace, short_name

TRACE_SECONDS = 5.0  # the device trace's stretch of a traced window
FOREIGN = ("jax", "jaxlib", "flax", "repro")  # top-level names a run may not load


class Probe:
    """What the harness records beside the program in one run."""

    def __init__(self, seconds: float, trace: bool, device: torch.device):
        self.clock = time.monotonic
        self.seconds = seconds
        self.tracing = trace
        self.rec = self.device_trace = None
        if trace:
            from repro_torch import obs

            self.rec = obs.Recorder(clock=self.clock)
            if device.type == "cuda":
                self.device_trace = DeviceTrace(self.clock)
                self.device_trace.prepare()
        self._trace_at = None

    @property
    def obs(self):
        from repro_torch import obs

        return self.rec if self.rec is not None else obs.NULL

    @property
    def tail(self):
        """A span factory for a system's tail, or None when not tracing."""
        return (lambda: self.span("tail")) if self.tracing else None

    def span(self, name: str):
        if self.rec is None:
            return contextlib.nullcontext()
        return self.rec.span(name, track="harness", cat="harness")

    def spans(self) -> list:
        return [] if self.rec is None else [
            s for s in self.rec.spans.snapshot() if s.t1 is not None]

    def window_opened(self, t0: float) -> None:
        """The device trace records the window's last ``TRACE_SECONDS``; it
        is collected once the window has closed."""
        if self.device_trace is not None:
            self._trace_at = t0 + self.seconds - min(self.seconds, TRACE_SECONDS)

    def tick(self, now: float) -> None:
        dt = self.device_trace
        if dt is not None and dt.t0 is None and now >= self._trace_at:
            dt.start()

    def window_closed(self) -> None:
        dt = self.device_trace
        if dt is not None and dt.t0 is not None and dt.t1 is None:
            dt.stop()


class Window:
    """The measured window of a run, and what the traffic generator hands
    back."""

    def __init__(self, probe: Probe, t0: float):
        self.probe, self.t0 = probe, t0
        self.t1 = None
        self.completed = 0
        self.book = self.engine = None
        self.attempted = self.unanswered = 0

    @classmethod
    def open(cls, probe: Probe) -> "Window":
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        gc.collect()
        gc.freeze()
        win = cls(probe, probe.clock())
        probe.window_opened(win.t0)
        return win

    def tick(self) -> bool:
        """Between two units of work: False once the window is over."""
        now = self.probe.clock()
        self.probe.tick(now)
        return now - self.t0 < self.probe.seconds

    def close(self, completed: int) -> None:
        self.t1 = self.probe.clock()
        self.completed = completed
        self.probe.window_closed()

    def finish(self, book, *, attempted: int, unanswered: int, engine) -> None:
        self.book, self.engine = book, engine
        self.attempted, self.unanswered = attempted, unanswered

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Readings:
    """What a metric's reader reads."""

    cell: spec.Cell
    system: object
    window: Window
    setup_s: float
    spans: list
    ops: list  # device operations of the traced stretch
    trace_window: tuple | None  # (t0, t1) of the device trace
    peaks: dict

    @property
    def records(self) -> dict:
        """The columns of the requests retired inside the window."""
        return self.window.book.view(np.arange(self.window.completed))

    def within(self, spans, lo=None, hi=None) -> list:
        lo = self.window.t0 if lo is None else lo
        hi = self.window.t1 if hi is None else hi
        return [s for s in spans if s.t0 >= lo and s.t1 <= hi]


def foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def host_speed() -> float:
    """Seconds of a fixed pure-Python loop: a diagnostic of how fast this
    run's host is, since every cell is paced by the host."""
    t = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    return time.perf_counter() - t


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def sample(book, seed: int, n: int, slowest: int, t0: float) -> tuple:
    """Rows of ``book`` to judge, and which of them were drawn: ``n`` drawn
    from the seed among the requests submitted after the window opened
    (those in flight at its start are the slow ones, whose share would
    tilt the sample's statistics), and the ``slowest`` with the most sweeps
    in a row among all."""
    total = book.n
    if not total:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    cols = book.view()
    pool = np.flatnonzero(cols["t_submit"] >= t0)
    rng = np.random.default_rng([seed % 2 ** 63, 0x6A756467])
    drawn = set(rng.choice(pool, size=min(n, len(pool)), replace=False)
                .tolist())
    iters = cols["iterations"].reshape(total, -1).max(-1)
    pick = drawn | set(np.argsort(-iters, kind="stable")[:slowest].tolist())
    rows = np.array(sorted(pick), dtype=np.int64)
    return rows, np.isin(rows, list(drawn))


def breakdown(r: Readings) -> dict:
    lo, hi = r.trace_window
    ops = [(short_name(o.name), min(o.t1, hi) - max(o.t0, lo)) for o in r.ops
           if o.t1 > lo and o.t0 < hi]
    idle = reduce.gaps([(o.t0, o.t1) for o in r.ops], lo, hi)
    labels = reduce.innermost(r.spans, [(a + b) / 2 for a, b in idle])
    return {"device_ops": reduce.top(ops),
            "idle_gaps": reduce.top((lab or "outside any span", b - a)
                                    for lab, (a, b) in zip(labels, idle))}


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
            device="cuda", patience_s: float = 60.0):
    """Set-up and the window of one run: ``(system, window, probe)``.  The
    program's state is freed before this returns; the peak of device
    memory is on the window as ``memory_peak``."""
    dev = torch.device(device)
    torch.set_num_threads(1)  # one process, one intra-op thread: steadier
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    system = spec.load_module("systems", cell.config["system"]).System(
        cell.config, cell.traffic, seed, dev)
    generator = spec.load_module("generators", cell.traffic["generator"])
    probe = Probe(seconds, trace, dev)
    win = generator.run(system, cell.traffic, seconds, probe, patience_s)
    win.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
    win.engine = None  # the program's state goes before the reference runs
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return system, win, probe


def judged(cell: spec.Cell, system, win: Window, seed: int, fmt=None,
           overrides=None) -> tuple:
    """``(numbers, diagnostics)`` of a run's sample against the reference;
    with ``fmt`` or ``overrides`` the reference computed in ``fmt`` under the
    configuration with ``overrides`` stands in the program's place (the
    control, or a planted fault)."""
    rows, drawn = sample(win.book, seed, int(cell.traffic["sample"]),
                         int(cell.traffic["sample_slowest"]), win.t0)
    if not len(rows):
        return {"unanswered": win.unanswered, "score_gap": 1.0}, {"sampled": 0}
    prog = win.book.view(rows)
    if fmt is not None or overrides is not None:
        prog = {**prog, **system.reference(prog, fmt, overrides)}
    values, diag = system.compare(prog, drawn)
    values["unanswered"] = win.unanswered
    retired = win.book.view()["t_retire"][:win.completed] - win.t0
    diag.update(sampled=len(rows), requests_in_window=win.completed,
                window_s=win.seconds,
                per_second=np.bincount(retired.astype(int)).tolist())
    return values, diag


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             patience_s: float = 60.0) -> dict:
    """One run of ``cell``; returns the result line's object (with the
    checks under ``checks``, last)."""
    t_start = time.monotonic() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    limit_w = power_limit() if cuda else None
    speed = host_speed()
    system, win, probe = measure(cell, seed, seconds, trace, device=device,
                                 patience_s=patience_s)
    setup_s = win.t0 - t_start
    values, diag = judged(cell, system, win, seed)
    chk = judge.checks(values, cell.config["limits"])

    dt = probe.device_trace
    traced = dt is not None and dt.t1 is not None
    readings = Readings(cell, system, win, setup_s, probe.spans(),
                        dt.ops if traced else [],
                        (dt.t0, dt.t1) if traced else None,
                        peaks.for_device(kind))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                "count": 1, "memory_peak_bytes": int(win.memory_peak)}
    if limit_w is not None:
        dev_info["power_limit"] = limit_w
    result = {"correct": judge.passed(chk) and win.completed > 0,
              "attempted": int(win.attempted), "failed": int(win.unanswered),
              "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = reduce.union_seconds(
            [(o.t0, o.t1) for o in dt.ops], dt.t0, dt.t1)
        dev_info["window_s"] = dt.t1 - dt.t0
        result["breakdown"] = breakdown(readings)
    result["diagnostics"] = {**values, **diag, "host_loop_s": speed,
                             "host_loop_s_after": host_speed()}
    result["checks"] = chk
    return result
