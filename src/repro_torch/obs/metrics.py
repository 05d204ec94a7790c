"""Process-wide metrics registry — counters, gauges, histograms.

A self-standing copy of the JAX package's ``repro.obs.metrics``.  The
registry (:data:`REGISTRY`) is a module singleton so that instrumented code
feeds one place; *recording* is gated by a ContextVar that
:func:`set_enabled` flips, so an instrumentation site costs one
short-circuiting :func:`enabled` call while recording is off (the default).

Metric names are dotted strings.  The port's training path publishes
``train.straggler.step_seconds.<host>`` and ``train.straggler.last_z.<host>``
gauges and the ``train.straggler.detected`` counter
(``train.fault.StragglerMonitor``).

Like ``record``, this module imports nothing but the standard library and
``record``.
"""

from __future__ import annotations

from contextvars import ContextVar

from repro_torch.obs import record as _record

_ENABLED: ContextVar[bool] = ContextVar("repro_torch_obs_metrics",
                                        default=False)


def enabled() -> bool:
    """Whether metric recording is on in the current context."""
    if not _record._HOOKS_ENABLED:
        return False
    return _ENABLED.get()


def set_enabled(flag: bool) -> None:
    """Flip recording for the current context (run a scope in
    ``contextvars.copy_context().run`` to keep it there)."""
    _ENABLED.set(bool(flag))


class Counter:
    """Monotonic accumulator (floats allowed: fractional contention
    stalls accumulate exactly as the simulator charges them)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Streaming summary (count/total/min/max/last) — enough for the
    oracle-throughput and span-latency questions without binning policy."""

    __slots__ = ("count", "total", "vmin", "vmax", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self.last = None

    def observe(self, v) -> None:
        self.count += 1
        self.total += v
        self.last = v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    @property
    def mean(self):
        return self.total / self.count if self.count else None

    def snapshot(self) -> dict:
        return {"type": "histogram", "count": self.count, "total": self.total,
                "mean": self.mean, "min": self.vmin, "max": self.vmax,
                "last": self.last}


class Registry:
    """Name -> metric.  Types are fixed on first use; asking for the same
    name with a different type is a programming error and raises."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str):
        """The metric object, or ``None`` if never recorded."""
        return self._metrics.get(name)

    def value(self, name: str, default=None):
        """Convenience: the counter/gauge value (histograms: the mean)."""
        m = self._metrics.get(name)
        if m is None:
            return default
        return m.mean if isinstance(m, Histogram) else m.value

    def snapshot(self) -> dict[str, dict]:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        self._metrics.clear()


#: The process-wide registry all instrumentation sites feed.
REGISTRY = Registry()


# -- guarded module-level helpers (the instrumentation API) -----------------

def inc(name: str, n=1) -> None:
    if enabled():
        REGISTRY.counter(name).inc(n)


def set_gauge(name: str, v) -> None:
    if enabled():
        REGISTRY.gauge(name).set(v)


def observe(name: str, v) -> None:
    if enabled():
        REGISTRY.histogram(name).observe(v)
