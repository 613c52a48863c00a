"""The device side of a traced run: ``torch.profiler`` over CUDA activity.

Only CUDA activity is recorded (no per-operator CPU events), so the host
pays for the trace at each launch and not at each operator.  The events are
read straight from the profiler's results, without building its operator
tables: each GPU operation's name and interval, and for a kernel the host
time at which its launch call began (joined by correlation id), all on the
run's monotonic clock.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class DeviceOp:
    name: str
    t0: float
    t1: float
    launched: float | None  # host time of the launch call, where recorded


class DeviceTrace:
    """A CUDA trace of one stretch; ``ops`` holds its GPU operations.

    The first profiler of a process spends seconds starting CUPTI up, so
    :meth:`prepare` runs an empty one in the set-up; :meth:`start` then
    opens the stretch in milliseconds.  :meth:`stop` closes it and collects
    the events (seconds for ~10^5 of them)."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.ops: list = []
        self.t0 = self.t1 = None
        self._prof = None

    @staticmethod
    def _profiler():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def prepare(self) -> None:
        import torch

        warm = self._profiler()
        warm.start()
        torch.cuda.synchronize()
        warm.stop()

    def start(self) -> None:
        self._prof = self._profiler()
        self._prof.start()
        self.t0 = self.clock()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = self.clock()
        # The profiler stamps events on the wall clock (ns since the epoch).
        offset = time.time() - self.clock()
        self._prof.stop()
        self.ops = read_ops(self._prof.profiler.kineto_results.events(), offset)
        self._prof = None


def read_ops(events, offset: float) -> list:
    """GPU operations of kineto ``events`` with their launch times; stamps
    are moved to the run's clock by subtracting ``offset`` seconds."""
    from torch.autograd import DeviceType

    launches, gpu = {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            gpu.append(e)
        elif e.name().startswith(("cudaLaunch", "cuLaunch")):
            launches[e.correlation_id()] = e.start_ns() * 1e-9 - offset
    return [DeviceOp(e.name(), e.start_ns() * 1e-9 - offset,
                     (e.start_ns() + e.duration_ns()) * 1e-9 - offset,
                     launches.get(e.correlation_id()))
            for e in gpu]


def is_kernel(op: DeviceOp) -> bool:
    return not op.name.startswith(("Memcpy", "Memset"))


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without the namespaces and launch plumbing that every
    PyTorch kernel's name repeats."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "std::array<char*, 2ul>", "std::array<char*, 3ul>",
                  "binary_internal::"):
        name = name.replace(noise, "")
    return name[:width]
