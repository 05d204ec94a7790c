"""The traced run: device activity read from ``torch.profiler``'s events in
memory.

As ``chip_smoke.py:_profiled`` reads its exported trace, a device
operation is an event of category kernel, gpu_memcpy or gpu_memset; here
the events are read from the profiler's results directly and nothing is
written to disk (a decode call holds some 200,000 operations).  The
benchmark marks its window and each unit of work (a step, a call) with
``record_function`` ranges, which appear as host events of their own.
"""

from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
UNIT = "bench.unit"
#: the longest name kept in a breakdown
NAME_CHARS = 160


@dataclass
class Span:
    name: str
    start: int                    # ns, the profiler's clock
    end: int
    thread: int = 0


@dataclass
class TraceData:
    device: list[Span] = field(default_factory=list)   # by start
    host: list[Span] = field(default_factory=list)     # by start
    window: Span | None = None
    units: list[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e9

    def device_in(self, lo: int, hi: int) -> list[Span]:
        """Device operations that start in [lo, hi)."""
        starts = [d.start for d in self.device]
        return self.device[bisect.bisect_left(starts, lo):
                           bisect.bisect_left(starts, hi)]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of device operations inside the window."""
        lo, hi = self.window.start, self.window.end
        out: list[list[int]] = []
        for d in self.device:
            a, b = max(d.start, lo), min(d.end, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def syncs_in(self, unit: Span,
                 names=("cudaDeviceSynchronize", "cudaStreamSynchronize")
                 ) -> list[Span]:
        """The host's synchronisations inside ``unit`` whose runtime call
        is one of ``names``."""
        return [h for h in self.host
                if unit.start <= h.start and h.end <= unit.end
                and h.name in names]


def _kind(e, annotations: set) -> str:
    """The event's category.  Where the binding has no ``activity_type``
    (torch 2.11), a device event is an operation unless it bears the name
    of one of the benchmark's ranges (its device-side annotation)."""
    try:
        return e.activity_type()
    except AttributeError:
        pass
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if name in annotations else "kernel"
    return "user_annotation" if name in annotations else "cpu_op"


def read(prof) -> TraceData:
    """The device and host events of a finished ``torch.profiler.profile``,
    the window and the units."""
    t = TraceData()
    annotations = {WINDOW, UNIT}
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, annotations)
        start = e.start_ns()
        span = Span(e.name(), start, start + e.duration_ns(),
                    e.start_thread_id())
        if kind in DEVICE_KINDS:
            t.device.append(span)
        elif kind in HOST_KINDS:
            t.host.append(span)
            if kind == "user_annotation":
                if span.name == WINDOW:
                    t.window = span
                elif span.name == UNIT:
                    t.units.append(span)
    if t.window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    t.device.sort(key=lambda s: s.start)
    t.host.sort(key=lambda s: s.start)
    t.units.sort(key=lambda s: s.start)
    return t


def _innermost(host: list[Span], starts: list[int], at: int) -> str:
    """The latest-starting host event that covers ``at``."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(-1, i - 20000), -1):
        if host[j].end >= at:
            return host[j].name
    return "host: no event"


def breakdown(t: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps inside
    the window summed by what the host was doing at each gap's middle."""
    lo, hi = t.window.start, t.window.end
    ops: Counter = Counter()
    for d in t.device:
        a, b = max(d.start, lo), min(d.end, hi)
        if b > a:
            ops[d.name[:NAME_CHARS]] += (b - a) / 1e9
    gaps: Counter = Counter()
    starts = [h.start for h in t.host]
    prev = lo
    for a, b in t.busy_intervals() + [(hi, hi)]:
        if a > prev:
            gaps[_innermost(t.host, starts, (a + prev) // 2)[:NAME_CHARS]] \
                += (a - prev) / 1e9
        prev = max(prev, b)
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


def kernel_seconds(t: TraceData, match) -> float | None:
    """Device seconds inside the window of the operations whose name
    ``match`` accepts; None when there is none."""
    lo, hi = t.window.start, t.window.end
    found, total = False, 0
    for d in t.device:
        if match(d.name):
            a, b = max(d.start, lo), min(d.end, hi)
            if b > a:
                found = True
                total += b - a
    return total / 1e9 if found else None
