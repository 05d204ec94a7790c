"""``obs.session()`` — the one front door over tracing, metrics and spans;
a self-standing copy of the JAX package's ``repro.obs.session``.

    from repro_torch import api, obs

    with obs.session() as sess:
        report = api.evaluate("expf", api.Target.homogeneous(n_cores=4))
    sess.save("trace.perfetto.json")          # open at ui.perfetto.dev
    print(sess.timeline())                    # terminal lanes + spans
    assert sess.reconcile(report)["ok"]       # lane sums == Report cycles

Closing a session with metrics on snapshots the ``repro_torch.perf`` memo
counters into ``perf.memo.<table>.{entries,hits,misses,hit_rate}`` gauges,
so the registry view includes cache warmth without the caller touching
``perf.memo.stats()`` directly.
"""

from __future__ import annotations

import json
from contextlib import contextmanager

from repro_torch.obs import export as _export
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import record as _record


class Session:
    """Handle yielded by :func:`session`; usable during and after the
    ``with`` block (the recorder's data outlives the scope)."""

    def __init__(self, recorder: "_record.TraceRecorder | None",
                 metrics_on: bool):
        self.recorder = recorder
        self.metrics_on = metrics_on
        self._final_metrics: dict | None = None

    def metrics(self) -> dict:
        """Snapshot of the registry (``{}`` if metrics off).  Live while
        the session is open; frozen at close, so the figures survive a
        later session resetting the process-wide registry."""
        if not self.metrics_on:
            return {}
        if self._final_metrics is not None:
            return self._final_metrics
        return _metrics.REGISTRY.snapshot()

    def trace_dict(self) -> dict:
        if self.recorder is None:
            raise ValueError("session was opened with trace=False")
        return _export.chrome_trace(
            self.recorder, self.metrics() if self.metrics_on else None)

    def save(self, path) -> str:
        path = str(path)
        with open(path, "w") as f:
            json.dump(self.trace_dict(), f)
        return path

    def timeline(self, width: int = 80) -> str:
        if self.recorder is None:
            raise ValueError("session was opened with trace=False")
        return _export.render_timeline(self.recorder, width)

    def reconcile(self, report=None) -> dict:
        if self.recorder is None:
            raise ValueError("session was opened with trace=False")
        return _export.reconcile(self.recorder, report)


def _memo_gauges() -> None:
    from repro_torch.perf import memo
    for s in memo.stats():
        base = f"perf.memo.{s['name']}"
        for k in ("entries", "hits", "misses", "hit_rate"):
            _metrics.REGISTRY.gauge(f"{base}.{k}").set(s[k])


@contextmanager
def session(trace: bool = True, metrics: bool = True, *,
            reset_metrics: bool = True, max_events: int = 200_000,
            max_events_per_stream: int = 2048):
    """Scope with observability on.  ``trace`` installs a
    :class:`~repro_torch.obs.record.TraceRecorder`; ``metrics`` enables the
    registry (resetting it first unless ``reset_metrics=False`` — the
    registry is process-wide, so back-to-back sessions would otherwise
    accumulate)."""
    rec = _record.TraceRecorder(
        max_events=max_events,
        max_events_per_stream=max_events_per_stream) if trace else None
    if metrics and reset_metrics:
        _metrics.REGISTRY.reset()
    tok_m = _metrics._ENABLED.set(bool(metrics))
    tok_r = _record._RECORDER.set(rec)
    sess = Session(rec, bool(metrics))
    try:
        yield sess
    finally:
        try:
            if metrics:
                _memo_gauges()
                sess._final_metrics = _metrics.REGISTRY.snapshot()
        finally:
            _record._RECORDER.reset(tok_r)
            _metrics._ENABLED.reset(tok_m)
