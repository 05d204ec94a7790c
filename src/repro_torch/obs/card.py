"""Card spans and counters: which layer of the port a stretch of the card's
time belongs to, in a run traced by ``torch.profiler``.

A span opens at a layer boundary of the program (``with card.span(name)``)
and records only while ``torch.profiler`` records: it has no switch of its
own, so an untraced run pays a flag test and a return at each site.  While
the profiler records, a span

* opens a host range of FUNCTION scope (``_RecordFunctionFast``), which the
  profiler's trace shows as a host event (``cpu_op``) of the span's name
  and which has no device-side annotation: the spans add no event to the
  card's side of the trace, and an idle gap of the card is named by the
  innermost host event that covers it;
* records a CUDA event where it opens and where it closes, both on the
  stream current where it opens, once the process uses the card (an
  event record is a runtime call, not a device operation), resolved only
  when read;
* keeps counters, tensors among them, reduced only when read.

A model region (``attn``, ``attn.core``, ``moe.*``) also times its
backward pass: ``sp.output(y)`` hooks the gradient of the region's output,
which opens the backward half, and ``sp.input(x)`` gives the region its own
view of an input, whose gradient hook closes it once the region's
gradients have all reached their inputs.  The hooks are registered only
while the profiler records and gradients are on.  A region that runs again
inside a backward pass (a checkpoint's recompute) is recorded as pass
``recompute`` and registers no hook: nothing would reach them.  A backward
half opens and closes in the autograd engine's hooks, in two different
nodes' host ranges, so it has device times and no host range.

Inside ``with card.off():`` no span records, profiler or not: a CUDA graph
is captured there, and a span's CUDA events must never go into one.

Records live in memory, at most ``MAX_RECORDS`` (later spans are counted in
``dropped()``), and are read with :func:`read`.  A unit span (a training
step, a ``generate`` call) numbers every record opened while it is open.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from dataclasses import dataclass, field

import torch

#: Whether ``torch.profiler`` records now: the spans' only switch.
_profiling = torch._C._autograd._profiler_enabled
#: -1 outside a backward pass, else the running graph task's id.
_graph_task = torch._C._current_graph_task_id
_Range = torch._C._profiler._RecordFunctionFast

#: the most records kept at once
MAX_RECORDS = 1 << 16


@dataclass(eq=False)
class Record:
    """One span.  ``parent`` is the name of the innermost span open when it
    began, ``unit`` the number of the unit span it belongs to, and
    ``phase`` how it was opened: ``forward`` by the code at its site,
    ``backward`` by its region's gradient hooks, ``recompute`` by the code
    at its site inside a backward pass.  Host times are ns on the
    profiler's clock (the Unix clock, ``time.time_ns``); device times are
    ns on the card from the start of the record's unit (from its own start
    outside a unit), None until :func:`read` resolves them or where the
    run made no CUDA event."""
    name: str
    parent: str | None
    unit: int | None
    phase: str
    host_start: int
    host_end: int | None = None
    device_start: int | None = None
    device_end: int | None = None
    counters: dict = field(default_factory=dict)
    events: list | None = field(default=None, repr=False)
    stream: object = field(default=None, repr=False)


class _Store:
    def __init__(self):
        self.records: list[Record] = []
        self.dropped = 0
        self.open: list[Record] = []        # innermost last
        self.unit: int | None = None
        self.n_units = 0
        self.unit_start: dict[int, object] = {}   # unit -> its start event


_STORE = _Store()


def _event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _begin(name: str, phase: str, unit: bool) -> Record | None:
    s = _STORE
    if len(s.records) >= MAX_RECORDS:
        s.dropped += 1
        return None
    if unit:
        # backward halves whose gradient never came stay open: drop them
        s.open = [r for r in s.open if r.phase != "backward"]
        s.unit = s.n_units
        s.n_units += 1
    rec = Record(name, s.open[-1].name if s.open else None, s.unit, phase,
                 time.time_ns())
    if torch.cuda.is_initialized():
        # both ends on the stream current where the span opens
        rec.stream = torch.cuda.current_stream()
        rec.events = [_event(rec.stream), None]
        if unit:
            s.unit_start[rec.unit] = rec.events[0]
    s.records.append(rec)
    s.open.append(rec)
    return rec


def _end(rec: Record, unit: bool) -> None:
    if rec.events is not None:
        rec.events[1] = _event(rec.stream)
    rec.host_end = time.time_ns()
    s = _STORE
    if rec in s.open:
        s.open.remove(rec)
    if unit and s.unit == rec.unit:
        s.unit = None


class _Backward:
    """The backward half of one region: opened by the hook on its output's
    gradient, closed by the last of the hooks on its inputs' views."""

    __slots__ = ("name", "waiting", "rec")

    def __init__(self, name: str, waiting: int):
        self.name, self.waiting, self.rec = name, waiting, None

    def opened(self, grad):
        if self.rec is None and self.waiting:
            self.rec = _begin(self.name, "backward", False)

    def closed(self, grad):
        self.waiting -= 1
        if not self.waiting and self.rec is not None:
            _end(self.rec, False)


class Span:
    """An open span while the profiler records; ``span`` returns it."""

    __slots__ = ("name", "unit", "rec", "range", "views")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit
        self.rec = self.range = None
        self.views: list = []

    def __enter__(self) -> "Span":
        if len(_STORE.records) < MAX_RECORDS:
            # the range first: the record's host start falls inside it
            self.range = _Range(self.name)
            self.range.__enter__()
        self.rec = _begin(self.name, "forward" if _graph_task() == -1
                          else "recompute", self.unit)
        return self

    def __exit__(self, *exc) -> bool:
        if self.rec is not None:
            _end(self.rec, self.unit)
            self.range.__exit__(*exc)
        return False

    def _hooks(self) -> bool:
        return (self.rec is not None and self.rec.phase == "forward"
                and torch.is_grad_enabled())

    def input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the region should use it: its own view of ``x`` (the
        same values), whose gradient hook ends the backward half."""
        if not (self._hooks() and x.requires_grad):
            return x
        v = x.view_as(x)
        self.views.append(v)
        return v

    def output(self, y: torch.Tensor) -> torch.Tensor:
        """``y``, the region's output, with the hook that begins the
        backward half when its gradient arrives."""
        if self._hooks() and y.requires_grad and self.views:
            bw = _Backward(self.name, len(self.views))
            y.register_hook(bw.opened)
            for v in self.views:
                v.register_hook(bw.closed)
        self.views = []
        return y

    def count(self, **counters) -> None:
        """Add to the record's counters; a tensor is summed when read."""
        if self.rec is not None:
            self.rec.counters.update(counters)


class _Off:
    """What ``span`` returns while the profiler does not record."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def input(self, x):
        return x

    def output(self, y):
        return y

    def count(self, **counters) -> None:
        pass


OFF = _Off()


#: Open ``off()`` blocks.
_OFF_DEPTH = 0


@contextlib.contextmanager
def off():
    """No span records inside the block, whether the profiler records or
    not (a CUDA graph's capture: the spans' events would be captured)."""
    global _OFF_DEPTH
    _OFF_DEPTH += 1
    try:
        yield
    finally:
        _OFF_DEPTH -= 1


def span(name: str, unit: bool = False):
    """``with span(name) as sp:`` times the block as ``name`` while
    ``torch.profiler`` records, outside ``off()``; ``unit=True`` makes it a
    unit that numbers the records opened inside it."""
    if _OFF_DEPTH or not _profiling():
        return OFF
    return Span(name, unit)


def _resolve(rec: Record) -> None:
    ev = rec.events
    if ev is not None and ev[1] is not None:
        ref = _STORE.unit_start.get(rec.unit, ev[0])
        rec.device_start = round(ref.elapsed_time(ev[0]) * 1e6)
        rec.device_end = round(ref.elapsed_time(ev[1]) * 1e6)
    rec.events = rec.stream = None
    rec.counters = {k: int(v.sum()) if isinstance(v, torch.Tensor) else v
                    for k, v in rec.counters.items()}


def read(since_ns: int | None = None,
         until_ns: int | None = None) -> list[Record]:
    """The records whose host start lies in [``since_ns``, ``until_ns``]
    (ns, the profiler's clock), oldest first, their device times and
    counters resolved.  Call it after the traced window: it waits for the
    card."""
    recs = [r for r in _STORE.records
            if (since_ns is None or r.host_start >= since_ns)
            and (until_ns is None or r.host_start <= until_ns)]
    pending = [r for r in recs if r not in _STORE.open and (
        r.events is not None or any(isinstance(v, torch.Tensor)
                                    for v in r.counters.values()))]
    if pending and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for r in pending:
        _resolve(r)
    return recs


def dropped() -> int:
    """Spans not recorded because ``MAX_RECORDS`` were kept."""
    return _STORE.dropped


def clear() -> None:
    """Forget every record (open spans close unrecorded)."""
    global _STORE
    _STORE = _Store()


def exclusive_ns(records: list[Record]) -> dict[str, int]:
    """Device ns by span name, each instant of a unit's device timeline
    given to the innermost record covering it: the latest to start, the
    later-opened among equals.  No instant counts twice, and a unit's own
    name takes what no other record covers."""
    by_unit: dict = {}
    for i, r in enumerate(records):
        if r.device_start is not None and r.device_end > r.device_start:
            by_unit.setdefault(r.unit, []).append((r.device_start, i, r))
    out: dict[str, int] = {}
    for spans in by_unit.values():
        spans.sort(key=lambda s: (s[0], s[1]))
        cuts = sorted({t for _, _, r in spans
                       for t in (r.device_start, r.device_end)})
        active: list = []                 # (-start, -order, end, name)
        k = 0
        for a, b in zip(cuts, cuts[1:]):
            while k < len(spans) and spans[k][0] <= a:
                start, i, r = spans[k]
                heapq.heappush(active, (-start, -i, r.device_end, r.name))
                k += 1
            # a record that has ended leaves when it comes to the top
            while active and active[0][2] <= a:
                heapq.heappop(active)
            if active:
                name = active[0][3]
                out[name] = out.get(name, 0) + (b - a)
    return out


def units(records: list[Record], name: str) -> list[Record]:
    """The unit records called ``name`` whose device times are known."""
    return [r for r in records if r.name == name and r.unit is not None
            and r.device_end is not None]


def share(records: list[Record], names, unit: str) -> float | None:
    """The exclusive device time of the spans ``names`` inside the units
    called ``unit``, over those units' device time, in %; None where no
    such unit or span was timed."""
    whole = units(records, unit)
    ids = {r.unit for r in whole}
    inside = [r for r in records if r.unit in ids]
    total = sum(r.device_end - r.device_start for r in whole)
    if not total or not any(r.name in names and r.device_end is not None
                            for r in inside):
        return None
    ex = exclusive_ns(inside)
    return 100.0 * sum(ex.get(n, 0) for n in names) / total
