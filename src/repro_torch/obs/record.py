"""Issue-slot trace recorder — the event side of ``repro_torch.obs``.

A self-standing copy of the JAX package's ``repro.obs.record`` (which
imports only the standard library), so that the port needs nothing of
``repro``.  The discrete-event simulator in ``core.timing`` and
``api.evaluate`` feed it; its module switch ``_HOOKS_ENABLED`` also gates
the metrics registry (``obs.metrics``).

From the original:

A :class:`TraceRecorder` captures, opt-in via a ContextVar, which lane (int
core vs FPSS) issued which instruction and why an issue slot was lost (RAW
dependence, the single integer-RF write port, TCDM contention, an FREP
launch).  Lanes are hierarchical strings (``core3/int``, ``core3/fpss``)
pushed with :meth:`TraceRecorder.lane`; ``repeat`` scopes mark windows
executed many times, whose aggregates scale exactly while their micro
events are recorded once.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar

#: Module-level master switch.  ``hooks_bypassed`` flips it off to measure
#: an *as-if-uninstrumented* reference: every hook short-circuits on this
#: plain global before touching any ContextVar.
_HOOKS_ENABLED = True

_RECORDER: ContextVar["TraceRecorder | None"] = ContextVar(
    "repro_torch_obs_recorder", default=None)


def active_recorder() -> "TraceRecorder | None":
    """The recorder for the current context, or ``None`` (the fast path)."""
    if not _HOOKS_ENABLED:
        return None
    return _RECORDER.get()


@contextmanager
def hooks_bypassed():
    """Scope with ALL observability hooks short-circuited at the module
    flag — the reference measurement ("what would this cost if the
    instrumentation had never been added").  Not thread-safe."""
    global _HOOKS_ENABLED
    prev = _HOOKS_ENABLED
    _HOOKS_ENABLED = False
    try:
        yield
    finally:
        _HOOKS_ENABLED = prev


@contextmanager
def recording(rec: "TraceRecorder"):
    """Scope with ``rec`` installed as the active recorder."""
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


class TraceRecorder:
    """Collects issue events, lane aggregates, spans, and run summaries.

    Event volume is bounded twice: ``max_events_per_stream`` caps one
    simulated stream (baseline streams can run to thousands of unrolled
    instructions) and ``max_events`` caps the run; overflow increments
    ``dropped_events`` while the exact per-lane aggregates keep counting.
    """

    def __init__(self, max_events: int = 200_000,
                 max_events_per_stream: int = 2048):
        self.created_s = time.perf_counter()
        self.max_events = max_events
        self.max_events_per_stream = max_events_per_stream
        #: (lane, ts_cycle, dur_cycles, name, cat) — cat is "instr" or
        #: "stall"; stalls carry the class in ``name`` ("raw", "wb_port").
        self.events: list[tuple] = []
        self.dropped_events = 0
        #: lane -> {"busy": ..., "raw": ..., "wb_port": ...,
        #:          "tcdm_contention": ..., "block_overhead": ...,
        #:          "frep_launch": ...} — exact, repeat-scaled cycle counts.
        self.lane_micro: dict[str, dict[str, float]] = {}
        #: stream-level memo provenance totals (hit = cached counts existed).
        self.memo_provenance = {"hit": 0, "cold": 0}
        self.block_records: list[dict] = []
        self.summaries: list[dict] = []
        self.spans: list[dict] = []
        self._lanes: list[str] = []
        self._cursor: dict[str, int] = {}
        self._repeat = 1
        self._span_depth = 0

    # -- lane / repeat scoping (used by core.timing) ------------------------

    @contextmanager
    def lane(self, name: str):
        """Push a (hierarchical) lane; events land on the innermost lane."""
        full = f"{self._lanes[-1]}/{name}" if self._lanes else name
        self._lanes.append(full)
        try:
            yield full
        finally:
            self._lanes.pop()

    def current_lane(self) -> str:
        return self._lanes[-1] if self._lanes else "sim"

    @contextmanager
    def repeat(self, n: int):
        """Scope marking that enclosed streams are executed ``n`` times
        (``thread_cycles``' windowing): aggregates scale by ``n``, micro
        events are recorded once as a representative window."""
        prev = self._repeat
        self._repeat = prev * n
        try:
            yield
        finally:
            self._repeat = prev

    # -- producers ----------------------------------------------------------

    def _lane_tot(self, lane: str) -> dict[str, float]:
        tot = self.lane_micro.get(lane)
        if tot is None:
            tot = self.lane_micro[lane] = {}
        return tot

    def stream(self, cycles: int, n_instrs: int, stalls: dict[str, int],
               events: list[tuple], provenance: str) -> None:
        """Record one simulated stream on the current lane.

        ``events`` is the instrumented simulator's list of
        ``(issue_cycle_1based, opcode, stall_cycles, stall_kind)``;
        ``stalls`` the exact per-class totals; ``provenance`` whether the
        memo already held this stream's counts ("hit") or not ("cold").
        """
        lane = self.current_lane()
        rep = self._repeat
        self.memo_provenance[provenance] = \
            self.memo_provenance.get(provenance, 0) + 1
        tot = self._lane_tot(lane)
        tot["busy"] = tot.get("busy", 0) + n_instrs * rep
        for k, v in stalls.items():
            tot[k] = tot.get(k, 0) + v * rep
        base = self._cursor.get(lane, 0)
        kept = 0
        for t_issue, opcode, stall, kind in events:
            if (kept >= self.max_events_per_stream
                    or len(self.events) >= self.max_events):
                self.dropped_events += len(events) - kept
                break
            if stall:
                self.events.append((lane, base + t_issue - 1 - stall, stall,
                                    kind, "stall"))
            self.events.append((lane, base + t_issue - 1, 1, opcode, "instr"))
            kept += 1
        self._cursor[lane] = base + cycles * rep

    def annotate(self, kind: str, cycles: float, advance: bool = True) -> None:
        """Charge ``cycles`` of lane-level overhead/stall that has no
        per-instruction event (block overhead, FREP launch, fractional TCDM
        contention).  Repeat-scaled like :meth:`stream` aggregates.
        ``advance=False`` records a summary figure (e.g. ``thread_total``)
        without moving the lane's timeline cursor."""
        if not cycles:
            return
        lane = self.current_lane()
        tot = self._lane_tot(lane)
        tot[kind] = tot.get(kind, 0) + cycles * self._repeat
        if advance:
            cur = self._cursor.get(lane, 0)
            self._cursor[lane] = cur + int(cycles * self._repeat)

    def block_record(self, **fields) -> None:
        """One ``copift_block_timing``/``baseline_timing``-level record
        (kind, block, provenance, int/fp/total cycles)."""
        fields.setdefault("lane", self.current_lane())
        self.block_records.append(fields)

    def summary(self, record: dict) -> None:
        """An exact end-of-run accounting record (e.g. ``api.evaluate``'s
        per-core cycle totals) — what ``export.reconcile`` checks against
        ``Report``."""
        self.summaries.append(record)

    # -- span plumbing (used by obs.spans) ----------------------------------

    def span_begin(self) -> int:
        self._span_depth += 1
        return self._span_depth

    def span_end(self, record: dict) -> None:
        self._span_depth -= 1
        self.spans.append(record)
