"""Profiling spans — nested wall-time scopes with memo provenance.

A self-standing copy of the JAX package's ``repro.obs.spans``.

``span("api.evaluate", kernel="expf")`` wraps a stack-level operation; the
record lands in the active :class:`~repro_torch.obs.record.TraceRecorder` (and
exports into the same Perfetto trace as the cycle-level lanes) and its
duration feeds a ``span.<name>.seconds`` histogram in the metrics registry.

Every span also snapshots the ``repro_torch.perf`` memo counters on entry/exit
and tags itself with the hit/miss delta plus a derived provenance:

* ``"hit"``   — the memo served everything (warm pricing),
* ``"cold"``  — every lookup missed (fresh simulation),
* ``"mixed"`` — some of each,
* ``"none"``  — the span touched the memo not at all.

That is the per-span half of the memo-parity story: a traced run can show
*where* its numbers came from without ever bypassing the tables.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import record as _record


def _memo_counts() -> tuple[int, int]:
    from repro_torch.perf import memo
    hits = misses = 0
    for s in memo.stats():
        hits += s["hits"]
        misses += s["misses"]
    return hits, misses


def _provenance(hits: int, misses: int) -> str:
    if hits and misses:
        return "mixed"
    if hits:
        return "hit"
    if misses:
        return "cold"
    return "none"


@contextmanager
def span(name: str, **attrs):
    """Profile a scope.  Yields the (mutable) span record, or ``None`` when
    observability is fully disabled — the no-op path costs two ContextVar
    reads."""
    rec = _record.active_recorder()
    metrics_on = _metrics.enabled()
    if rec is None and not metrics_on:
        yield None
        return
    h0, m0 = _memo_counts()
    t0 = time.perf_counter()
    sp = {"name": name, "attrs": dict(attrs),
          "depth": rec.span_begin() if rec is not None else 1,
          "start_s": (t0 - rec.created_s) if rec is not None else t0}
    try:
        yield sp
    finally:
        dur = time.perf_counter() - t0
        h1, m1 = _memo_counts()
        sp["dur_s"] = dur
        sp["memo_hits"] = h1 - h0
        sp["memo_misses"] = m1 - m0
        sp["memo_provenance"] = _provenance(h1 - h0, m1 - m0)
        if rec is not None:
            rec.span_end(sp)
        if metrics_on:
            _metrics.REGISTRY.histogram(f"span.{name}.seconds").observe(dur)
