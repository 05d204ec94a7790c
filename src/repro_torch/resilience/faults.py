"""Deterministic fault traces for the manycore model
(``repro_torch.resilience``); a copy of the JAX package's
``repro.resilience.faults``: the same spec, seed and shape give the same
events as there (numpy ``PCG64``, drawn in the same order).

A :class:`FaultTrace` is a *frozen* sequence of timestamped fault events,
generated once from a compact spec string and a seed — the exact
discipline ``serve.traffic`` applies to request arrivals, applied to
component failures: every degraded evaluation and every failover
comparison replays the identical fault schedule, which is what makes the
resilience benchmarks a fair fight and the no-fault case a pinnable
bit-for-bit reduction.

Spec grammar (``make_faults``; comma-separated event tokens)::

    corefail@2:c0.3            core 3 of cluster 0 fail-stops at t=2 ms
    clusterfail@4:c1           cluster 1 fail-stops at t=4 ms
    throttle@5-20:isl1>0.6GHz  cluster 1's DVFS island is capped at
                               0.6 GHz over [5, 20) ms (thermal window;
                               points downgrade to the fastest ladder
                               rung at or below the cap)
    hbm@10-15:0.5x             HBM bandwidth x0.5 over [10, 15) ms (a
                               degraded link; the multiplier feeds
                               ``noc.fair_shares``)
    mttf=40ms                  exponential random fail-stop core deaths
                               with the given mean time to failure,
                               PCG64-sampled over the trace window

Fail-stop events are permanent (a dead core never returns); throttle and
HBM windows end.  Same ``(spec, seed, shape)`` → the identical event
tuple, always — no global RNG state is touched.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["FaultEvent", "FaultState", "FaultTrace", "make_faults",
           "FAULT_KINDS", "AllCoresDeadError"]

#: Event kinds a trace may carry (the spec grammar's token heads).
FAULT_KINDS = ("corefail", "clusterfail", "throttle", "hbm")


class AllCoresDeadError(RuntimeError):
    """Raised when a fault state leaves no core alive to price work on —
    the evaluation is not degraded, it is impossible."""


@dataclass(frozen=True)
class FaultEvent:
    """One fault: what broke, when, and (for windows) until when.

    ``t_end_ms`` is ``inf`` for fail-stop events (permanent), the window
    close for throttle/HBM degradation.  ``value`` carries the throttle
    frequency cap (GHz) or the HBM width multiplier; it is 0.0 for the
    fail-stop kinds.
    """
    kind: str
    t_ms: float
    t_end_ms: float
    cluster: int = 0
    core: int | None = None
    value: float = 0.0

    def active_at(self, t_ms: float) -> bool:
        return self.t_ms <= t_ms < self.t_end_ms


@dataclass(frozen=True)
class FaultState:
    """The machine's health at one instant — what the evaluation path
    consumes (``api.evaluate(..., faults=...)`` samples a trace into one
    of these).

    ``dead_cores``     sorted ``(cluster, core)`` pairs that fail-stopped;
    ``dead_clusters``  sorted cluster indices that fail-stopped whole;
    ``freq_caps``      sorted ``(cluster, cap_ghz)`` — active thermal
                       throttle windows (the *minimum* cap per cluster
                       when windows overlap);
    ``hbm_scale``      product of the active HBM width multipliers
                       (1.0 = full bandwidth).
    """
    dead_cores: tuple = ()
    dead_clusters: tuple = ()
    freq_caps: tuple = ()
    hbm_scale: float = 1.0

    @property
    def is_trivial(self) -> bool:
        """True iff this state degrades nothing — the evaluation must
        then take the historical path verbatim (the bit-for-bit rule)."""
        return (not self.dead_cores and not self.dead_clusters
                and not self.freq_caps and self.hbm_scale == 1.0)

    def cluster_dead(self, cluster: int) -> bool:
        return cluster in self.dead_clusters

    def core_dead(self, cluster: int, core: int) -> bool:
        return (cluster in self.dead_clusters
                or (cluster, core) in self.dead_cores)

    def freq_cap(self, cluster: int) -> float | None:
        for c, cap in self.freq_caps:
            if c == cluster:
                return cap
        return None


@dataclass(frozen=True)
class FaultTrace:
    """A replayable fault schedule (events sorted by onset time).

    ``n_clusters``/``cores_per_cluster`` record the machine shape the
    trace was generated against (MTTF sampling needs it; consumers use it
    to map ``(cluster, core)`` onto flat core indices).
    """
    spec: str
    seed: int
    duration_ms: float
    n_clusters: int
    cores_per_cluster: int
    events: tuple = field(default=())

    @classmethod
    def empty(cls) -> "FaultTrace":
        """The no-fault trace — ``evaluate``/``simulate`` with this is
        pinned bit-for-bit equal to the fault-free run."""
        return cls(spec="", seed=0, duration_ms=0.0, n_clusters=0,
                   cores_per_cluster=0, events=())

    @property
    def n_events(self) -> int:
        return len(self.events)

    def state_at(self, t_ms: float) -> FaultState:
        """The accumulated fault state at ``t_ms``: every fail-stop with
        onset <= t, plus the throttle/HBM windows containing t."""
        dead_cores: set = set()
        dead_clusters: set = set()
        caps: dict[int, float] = {}
        hbm = 1.0
        for ev in self.events:
            if ev.kind == "corefail" and ev.t_ms <= t_ms:
                dead_cores.add((ev.cluster, ev.core))
            elif ev.kind == "clusterfail" and ev.t_ms <= t_ms:
                dead_clusters.add(ev.cluster)
            elif ev.kind == "throttle" and ev.active_at(t_ms):
                prev = caps.get(ev.cluster)
                caps[ev.cluster] = ev.value if prev is None \
                    else min(prev, ev.value)
            elif ev.kind == "hbm" and ev.active_at(t_ms):
                hbm *= ev.value
        dead_cores -= {(c, k) for c, k in dead_cores
                       if c in dead_clusters}
        return FaultState(dead_cores=tuple(sorted(dead_cores)),
                          dead_clusters=tuple(sorted(dead_clusters)),
                          freq_caps=tuple(sorted(caps.items())),
                          hbm_scale=hbm)

    def failstop_events(self) -> tuple:
        """The fail-stop (core/cluster death) events, onset-ordered —
        what the serving failover loop injects into its event heap."""
        return tuple(ev for ev in self.events
                     if ev.kind in ("corefail", "clusterfail"))


def _parse_window(tok: str, where: str) -> tuple[float, float]:
    """``"5-20"`` → (5.0, 20.0); a bare ``"5"`` is a permanent onset."""
    lo, sep, hi = tok.partition("-")
    try:
        t0 = float(lo)
        t1 = float(hi) if sep else math.inf
    except ValueError:
        raise ValueError(f"bad time token {tok!r} in {where}; expected "
                         f"'<t_ms>' or '<t0_ms>-<t1_ms>'") from None
    if t0 < 0 or t1 <= t0:
        raise ValueError(f"bad time window {tok!r} in {where}; need "
                         f"0 <= t0 < t1")
    return t0, t1


def _parse_core_ref(tok: str, where: str) -> tuple[int, int | None]:
    """``"c0.3"`` → (0, 3); ``"c1"`` → (1, None)."""
    if not tok.startswith("c"):
        raise ValueError(f"bad target {tok!r} in {where}; expected "
                         f"'c<cluster>[.<core>]'")
    cl, sep, co = tok[1:].partition(".")
    try:
        cluster = int(cl)
        core = int(co) if sep else None
    except ValueError:
        raise ValueError(f"bad target {tok!r} in {where}; expected "
                         f"'c<cluster>[.<core>]'") from None
    if cluster < 0 or (core is not None and core < 0):
        raise ValueError(f"bad target {tok!r} in {where}; indices must "
                         f"be >= 0")
    return cluster, core


def _parse_event_token(part: str, spec: str) -> FaultEvent | float:
    """One comma-separated token → a FaultEvent, or the MTTF in ms."""
    where = f"token {part!r} of {spec!r}"
    if part.startswith("mttf="):
        val = part[len("mttf="):]
        if not val.endswith("ms"):
            raise ValueError(f"bad MTTF {val!r} in {where}; expected "
                             f"'mttf=<ms>ms'")
        try:
            mttf = float(val[:-2])
        except ValueError:
            raise ValueError(f"bad MTTF {val!r} in {where}; expected "
                             f"'mttf=<ms>ms'") from None
        if mttf <= 0:
            raise ValueError(f"MTTF must be positive, got {mttf} in {where}")
        return mttf
    head, sep, rest = part.partition("@")
    if not sep or head not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {head!r} in {where}; "
                         f"expected one of {FAULT_KINDS} (grammar: "
                         f"'<kind>@<when>:<what>') or 'mttf=<ms>ms'")
    when, sep, what = rest.partition(":")
    if not sep or not what:
        raise ValueError(f"missing ':<what>' in {where}; grammar: "
                         f"'<kind>@<when>:<what>'")
    if head == "corefail":
        t0, _ = _parse_window(when, where)
        cluster, core = _parse_core_ref(what, where)
        if core is None:
            raise ValueError(f"corefail needs 'c<cluster>.<core>' in "
                             f"{where} (whole-cluster deaths are "
                             f"'clusterfail@t:c<cluster>')")
        return FaultEvent("corefail", t0, math.inf, cluster, core)
    if head == "clusterfail":
        t0, _ = _parse_window(when, where)
        cluster, core = _parse_core_ref(what, where)
        if core is not None:
            raise ValueError(f"clusterfail takes 'c<cluster>' in {where} "
                             f"(single-core deaths are "
                             f"'corefail@t:c<cluster>.<core>')")
        return FaultEvent("clusterfail", t0, math.inf, cluster)
    if head == "throttle":
        t0, t1 = _parse_window(when, where)
        tgt, sep, cap = what.partition(">")
        if not sep or not tgt.startswith("isl") or not cap.endswith("GHz"):
            raise ValueError(f"bad throttle target {what!r} in {where}; "
                             f"expected 'isl<cluster>><cap>GHz'")
        try:
            cluster = int(tgt[3:])
            cap_ghz = float(cap[:-3])
        except ValueError:
            raise ValueError(f"bad throttle target {what!r} in {where}; "
                             f"expected 'isl<cluster>><cap>GHz'") from None
        if cap_ghz <= 0:
            raise ValueError(f"throttle cap must be positive, got "
                             f"{cap_ghz} in {where}")
        return FaultEvent("throttle", t0, t1, cluster, value=cap_ghz)
    # hbm
    t0, t1 = _parse_window(when, where)
    if not what.endswith("x"):
        raise ValueError(f"bad HBM multiplier {what!r} in {where}; "
                         f"expected '<mult>x' (e.g. '0.5x')")
    try:
        mult = float(what[:-1])
    except ValueError:
        raise ValueError(f"bad HBM multiplier {what!r} in {where}; "
                         f"expected '<mult>x'") from None
    if not 0.0 < mult <= 1.0:
        raise ValueError(f"HBM multiplier must be in (0, 1], got {mult} "
                         f"in {where}")
    return FaultEvent("hbm", t0, t1, 0, value=mult)


def _sample_mttf(mttf_ms: float, duration_ms: float, seed: int,
                 n_clusters: int, cores_per_cluster: int,
                 already_dead: set) -> list[FaultEvent]:
    """Exponential fail-stop sampling: inter-fault gaps ~ Exp(mttf), each
    fault killing a uniformly random still-alive core.  PCG64-seeded, so
    the sampled deaths are a pure function of (spec, seed, shape)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    alive = [(c, k) for c in range(n_clusters)
             for k in range(cores_per_cluster)
             if (c, k) not in already_dead]
    out: list[FaultEvent] = []
    t = 0.0
    while alive:
        t += float(rng.exponential(mttf_ms))
        if t >= duration_ms:
            break
        victim = alive.pop(int(rng.integers(len(alive))))
        out.append(FaultEvent("corefail", t, math.inf, victim[0], victim[1]))
    return out


def make_faults(spec: str, duration_ms: float = 1000.0, seed: int = 0,
                n_clusters: int = 1,
                cores_per_cluster: int = 8) -> FaultTrace:
    """Generate a :class:`FaultTrace` from a spec string (grammar above).

    Same ``(spec, duration_ms, seed, shape)`` → the identical trace,
    always.  An empty spec is :meth:`FaultTrace.empty` with the shape
    attached (no events).  Events referencing clusters/cores outside the
    shape are rejected — a typo'd index must not silently no-op.
    """
    if duration_ms <= 0:
        raise ValueError(f"duration_ms must be positive, got {duration_ms}")
    if n_clusters < 1 or cores_per_cluster < 1:
        raise ValueError(f"need n_clusters >= 1 and cores_per_cluster >= 1, "
                         f"got {n_clusters}x{cores_per_cluster}")
    events: list[FaultEvent] = []
    mttf: float | None = None
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        parsed = _parse_event_token(part, spec)
        if isinstance(parsed, float):
            if mttf is not None:
                raise ValueError(f"duplicate mttf= token in {spec!r}")
            mttf = parsed
            continue
        if parsed.cluster >= n_clusters:
            raise ValueError(f"token {part!r} of {spec!r} references "
                             f"cluster {parsed.cluster}, but the shape has "
                             f"{n_clusters} cluster(s)")
        if parsed.core is not None and parsed.core >= cores_per_cluster:
            raise ValueError(f"token {part!r} of {spec!r} references core "
                             f"{parsed.core}, but clusters have "
                             f"{cores_per_cluster} core(s)")
        events.append(parsed)
    if mttf is not None:
        dead = {(ev.cluster, ev.core) for ev in events
                if ev.kind == "corefail"}
        events.extend(_sample_mttf(mttf, duration_ms, seed, n_clusters,
                                   cores_per_cluster, dead))
    events.sort(key=lambda ev: (ev.t_ms, ev.kind, ev.cluster,
                                -1 if ev.core is None else ev.core))
    return FaultTrace(spec=spec, seed=seed, duration_ms=float(duration_ms),
                      n_clusters=n_clusters,
                      cores_per_cluster=cores_per_cluster,
                      events=tuple(events))
