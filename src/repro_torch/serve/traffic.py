"""Request-arrival traces for the serving simulator
(``repro_torch.serve.sim``); a copy of the JAX package's
``repro.serve.traffic``: the same spec, duration and seed give the same
requests as there.

A trace is a *frozen* sequence of timestamped kernel requests, generated
once from a compact spec string and a seed, so every simulator run and
every policy comparison replays the identical workload — determinism is
what makes the percentile tables bit-reproducible and the policy
comparison of the JAX package's ``benchmarks/serve_bench.py`` scenario
(``chip_smoke.py`` phase 11 runs it through the port) a fair fight.

Spec grammar (``make_trace``)::

    poisson:rate=200
    bursty:rate=120,burst=6,period_ms=200,duty=0.15
    diurnal:low=40,high=400,period_ms=400

plus the request-shape keys accepted by every family::

    kernel=softmax        which priced workload each request runs
    elems=16384           problem elements per request

Rates are in requests/second; ``duration_ms`` bounds the arrival window
(in-flight work drains after it).  The non-homogeneous families are drawn
by Lewis-Shedler thinning against the family's peak rate, so a family's
arrival process is exact, not a per-epoch approximation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Request", "Trace", "make_trace", "TRACE_FAMILIES"]

TRACE_FAMILIES = ("poisson", "bursty", "diurnal")

_SHAPE_KEYS = ("kernel", "elems")


@dataclass(frozen=True)
class Request:
    """One unit of serving work: ``elems`` elements of ``kernel``."""
    rid: int
    t_arrival_ms: float
    kernel: str
    elems: int


@dataclass(frozen=True)
class Trace:
    """A replayable arrival sequence (requests sorted by arrival time)."""
    spec: str
    seed: int
    duration_ms: float
    requests: tuple[Request, ...]

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def mean_rate_rps(self) -> float:
        """Realized mean arrival rate over the trace window (req/s)."""
        if not self.duration_ms:
            return 0.0
        return len(self.requests) / (self.duration_ms * 1e-3)

    def rate_profile(self, epoch_ms: float) -> list[tuple[float, float]]:
        """Realized ``(epoch_start_ms, rate_rps)`` per epoch — what the
        reactive/predictive policies would observe with a perfect
        counter."""
        out = []
        t = 0.0
        i = 0
        while t < self.duration_ms:
            hi = t + epoch_ms
            n = 0
            while i + n < len(self.requests) \
                    and self.requests[i + n].t_arrival_ms < hi:
                n += 1
            out.append((t, n / (epoch_ms * 1e-3)))
            i += n
            t = hi
        return out


def _parse_spec(spec: str) -> tuple[str, dict[str, str]]:
    family, sep, rest = spec.partition(":")
    if family not in TRACE_FAMILIES:
        raise ValueError(f"unknown trace family {family!r}; expected one of "
                         f"{TRACE_FAMILIES} (spec grammar: "
                         f"'<family>:k1=v1,k2=v2,...')")
    kv: dict[str, str] = {}
    if sep and rest:
        for part in rest.split(","):
            key, eq, val = part.partition("=")
            if not eq or not key or not val:
                raise ValueError(f"bad trace-spec token {part!r} in {spec!r}; "
                                 f"expected 'key=value'")
            kv[key] = val
    return family, kv


def _pop_float(kv: dict[str, str], key: str, default: float | None,
               spec: str) -> float:
    if key in kv:
        return float(kv.pop(key))
    if default is None:
        raise ValueError(f"trace spec {spec!r} is missing required "
                         f"key {key!r}")
    return default


def _thinned(rng: np.random.Generator, duration_ms: float, peak_rps: float,
             rate_at):
    """Lewis-Shedler thinning: exact non-homogeneous Poisson arrivals with
    instantaneous rate ``rate_at(t_ms)`` bounded by ``peak_rps``."""
    times = []
    t = 0.0
    peak_per_ms = peak_rps * 1e-3
    while True:
        t += rng.exponential(1.0 / peak_per_ms)
        if t >= duration_ms:
            return times
        if rng.random() * peak_rps <= rate_at(t):
            times.append(t)


def make_trace(spec: str, duration_ms: float = 1000.0,
               seed: int = 0) -> Trace:
    """Generate a :class:`Trace` from a spec string (grammar above).

    Same ``(spec, duration_ms, seed)`` → the identical trace, always
    (PCG64-seeded; no global RNG state touched).
    """
    family, kv = _parse_spec(spec)
    kern = kv.pop("kernel", "softmax")
    elems = int(kv.pop("elems", 1 << 14))
    if duration_ms <= 0:
        raise ValueError(f"duration_ms must be positive, got {duration_ms}")
    if elems <= 0:
        raise ValueError(f"elems must be positive, got {elems}")
    rng = np.random.Generator(np.random.PCG64(seed))

    if family == "poisson":
        rate = _pop_float(kv, "rate", None, spec)
        times = _thinned(rng, duration_ms, rate, lambda t: rate)
    elif family == "bursty":
        # Baseline ``rate`` with ``burst``x surges for the first ``duty``
        # fraction of every ``period_ms`` window.
        rate = _pop_float(kv, "rate", None, spec)
        burst = _pop_float(kv, "burst", 4.0, spec)
        period = _pop_float(kv, "period_ms", 200.0, spec)
        duty = _pop_float(kv, "duty", 0.2, spec)
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")

        def rate_at(t, _r=rate, _b=burst, _p=period, _d=duty):
            return _r * _b if (t % _p) < _d * _p else _r

        times = _thinned(rng, duration_ms, rate * max(burst, 1.0), rate_at)
    else:  # diurnal
        # Sinusoidal swing between ``low`` and ``high`` req/s — the
        # long-trough/short-peak shape autoscalers live for.
        low = _pop_float(kv, "low", None, spec)
        high = _pop_float(kv, "high", None, spec)
        period = _pop_float(kv, "period_ms", duration_ms, spec)
        if low > high:
            raise ValueError(f"diurnal trace needs low <= high, got "
                             f"low={low} high={high}")

        def rate_at(t, _lo=low, _hi=high, _p=period):
            phase = (1.0 - np.cos(2.0 * np.pi * t / _p)) / 2.0
            return _lo + (_hi - _lo) * phase

        times = _thinned(rng, duration_ms, high, rate_at)
    if kv:
        raise ValueError(f"unknown trace-spec keys {sorted(kv)} for family "
                         f"{family!r} in {spec!r}")

    reqs = tuple(Request(rid=i, t_arrival_ms=float(t), kernel=kern,
                         elems=elems)
                 for i, t in enumerate(times))
    return Trace(spec=spec, seed=seed, duration_ms=float(duration_ms),
                 requests=reqs)
