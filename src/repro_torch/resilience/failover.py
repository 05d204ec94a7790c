"""Serving failover — the fault-mode event loop behind ``serve.simulate``;
a copy of the JAX package's ``repro.resilience.failover``, whose reports
equal the JAX package's with ``==``.

``serve.sim.simulate`` owns the healthy-machine loop (and stays
bit-for-bit untouched without faults); this module owns the generalized
loop that runs when a :class:`~repro_torch.resilience.faults.FaultTrace`
carries fail-stop events.  The extensions, in event order:

* **Fault events** land between slot completions and the control
  decision: the newly dead cores leave the free pool, and every in-flight
  batch touching one is *killed* — its unfinished energy is refunded, its
  surviving cores return to the pool, and its requests go to the retry
  path.
* **Retry** is bounded, deadline-aware, exponential-backoff
  (:class:`RetryPolicy`): a killed request re-enters the admission queue
  after ``base_delay_ms * backoff**(attempt-1)`` unless its attempt
  budget or its deadline (measured from the *original* arrival) is
  exhausted — then it is **lost**, which every SLO counts as a violation.
  ``retry=None`` is the naive mode: killed requests are lost outright
  (the baseline the failover bench compares against).
* **Failover remap** happens at the next control epoch, never mid-epoch
  (a real control plane reacts at its control period): the policy's
  :class:`~repro_torch.serve.sim.SlotPlan` is re-partitioned over the
  survivors — ``n_slots_eff = min(n_slots, alive)`` slots of
  ``alive // n_slots_eff`` cores — and each such remap counts as one
  ``failover`` in the report.
* **Over-provisioning**: :class:`FailoverPolicy` wraps any policy and
  bumps its decided slot count by ``headroom_slots`` (rounded to a valid
  core divisor), so spare capacity exists *before* the fault lands.

Throttle/HBM-window events are evaluate-path degradations
(``api.evaluate(faults=...)``); the serving loop consumes the fail-stop
events only.

Determinism: the fault trace is frozen, core IDs are allocated in sorted
order, tied timestamps break on a fixed (priority, sequence) order —
same trace, policy, faults and retry policy replay the identical report.
"""

from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import record as _obs_record
from repro_torch.obs.spans import span as _obs_span
from repro_torch.resilience.faults import FaultTrace

# NOTE: repro_torch.serve imports are function-local throughout —
# repro_torch.serve re-exports RetryPolicy/FailoverPolicy from this
# module, so the module boundary must stay lazy in one direction (same
# rule as system.analytics vs api.evaluate).

__all__ = ["RetryPolicy", "FailoverPolicy", "simulate_failover",
           "FAULT_LANE"]

#: The Perfetto timeline lane fault events are recorded on.
FAULT_LANE = "resilience.faults"

# Event-heap priorities at equal timestamps — the healthy loop's order
# with faults slotted between completions and the control decision:
# capacity frees first, then the machine breaks, then the control plane
# reacts, then new arrivals (and retries) see the result.
_PRIO_FREE, _PRIO_FAULT, _PRIO_CONTROL, _PRIO_ARRIVAL = 0, 1, 2, 3


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with deadline timeout and exponential backoff.

    ``max_attempts``   total dispatch attempts a request may consume
                       (1 = the initial dispatch only, i.e. no retry);
    ``timeout_ms``     deadline from the request's *original* arrival —
                       a retry that would start past it is abandoned
                       (``None`` = no deadline);
    ``backoff``        multiplier between successive retry delays;
    ``base_delay_ms``  delay before the first retry.
    """
    max_attempts: int = 3
    timeout_ms: float | None = None
    backoff: float = 2.0
    base_delay_ms: float = 0.5

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if self.timeout_ms is not None and self.timeout_ms <= 0:
            raise ValueError(f"timeout_ms must be positive (or None), got "
                             f"{self.timeout_ms}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if self.base_delay_ms < 0:
            raise ValueError(f"base_delay_ms must be >= 0, got "
                             f"{self.base_delay_ms}")

    def delay_ms(self, attempt: int) -> float:
        """Backoff delay before retry number ``attempt`` (1-based)."""
        return self.base_delay_ms * self.backoff ** (attempt - 1)


def _slot_divisor(n_cores: int, want: int) -> int:
    """The smallest divisor of ``n_cores`` that is >= ``want`` (clamped
    to ``n_cores``) — slot counts must divide the cores evenly."""
    want = min(max(1, want), n_cores)
    for n in range(want, n_cores + 1):
        if n_cores % n == 0:
            return n
    return n_cores


class FailoverPolicy:
    """Wrap any serving policy with ``headroom_slots`` of over-provision.

    The inner policy decides as usual; the wrapper raises the slot count
    by ``headroom_slots`` (to the nearest valid divisor of the core
    count), so when a fault kills a slot's cores the remap still has
    spare partitions — capacity bought *before* the failure, which is
    what lets retried work complete inside the SLO.
    """

    def __init__(self, inner, headroom_slots: int = 1):
        if headroom_slots < 0:
            raise ValueError(f"headroom_slots must be >= 0, got "
                             f"{headroom_slots}")
        self.inner = inner
        self.headroom_slots = headroom_slots
        self.name = f"failover({getattr(inner, 'name', type(inner).__name__)}" \
                    f"+{headroom_slots})"

    def bind(self, ctx) -> None:
        self.ctx = ctx
        self.inner.bind(ctx)

    def decide(self, obs: dict):
        plan = self.inner.decide(obs)
        if not self.headroom_slots:
            return plan
        from dataclasses import replace
        n = _slot_divisor(self.ctx.n_cores,
                          plan.n_slots + self.headroom_slots)
        return plan if n == plan.n_slots else replace(plan, n_slots=n)


@dataclass
class _Job:
    """One admitted request plus its retry bookkeeping (``attempts`` =
    dispatch attempts consumed so far)."""
    req: object
    attempts: int = 0


def _flat_dead(ev, n_clusters: int, cores_per_cluster: int) -> list[int]:
    """A fail-stop event's flat core indices (cluster-major), restricted
    to the pricer's machine shape — an event aimed past the machine (a
    trace generated for a different shape) is a no-op, not a crash."""
    if ev.cluster >= n_clusters:
        return []
    base = ev.cluster * cores_per_cluster
    if ev.kind == "clusterfail":
        return list(range(base, base + cores_per_cluster))
    if ev.core is None or ev.core >= cores_per_cluster:
        return []
    return [base + ev.core]


def simulate_failover(trace, policy, *, slo, epoch_ms: float,
                      queue_cap: int, pricer, power_cap_mw: float | None,
                      admission: str, faults: FaultTrace,
                      retry: "RetryPolicy | None"):
    """The fault-mode serving loop (see the module docstring).  Called by
    ``serve.simulate`` whenever ``faults`` carries fail-stop events —
    arguments mirror ``simulate`` exactly; returns a
    ``serve.sim.SimReport``."""
    from repro_torch.serve.sim import (PERCENTILES, PolicyContext,
                                       SimReport, _nearest_rank)
    pname = getattr(policy, "name", type(policy).__name__)
    n_cores = pricer.n_cores
    cores_per_cluster = pricer.cluster.n_cores
    n_clusters = (pricer.system.n_clusters if pricer.system is not None
                  else 1)
    ctx = PolicyContext(pricer=pricer, kernel=trace.requests[0].kernel,
                        elems=trace.requests[0].elems, n_cores=n_cores,
                        epoch_ms=epoch_ms, slo=slo,
                        power_cap_mw=power_cap_mw)
    policy.bind(ctx)
    kern = trace.requests[0].kernel
    metrics_on = _obs_metrics.enabled()
    rec = _obs_record.active_recorder()

    events: list = []
    seq = 0
    for r in trace.requests:
        heapq.heappush(events, (r.t_arrival_ms, _PRIO_ARRIVAL, seq,
                                "arrival", _Job(r)))
        seq += 1
    for ev in faults.failstop_events():
        heapq.heappush(events, (ev.t_ms, _PRIO_FAULT, seq, "fault", ev))
        seq += 1
    heapq.heappush(events, (0.0, _PRIO_CONTROL, seq, "control", None))
    seq += 1

    alive = [True] * n_cores
    free: set[int] = set(range(n_cores))
    queue: deque = deque()
    # sid -> (power_mw, jobs, core-tuple, t_start, t_free, energy_pj)
    busy: dict[int, tuple] = {}
    killed: set[int] = set()
    plan = None
    n_slots_eff = cps = 0
    pending_remap = False
    latencies: list[float] = []
    active_pj = idle_pj = 0.0
    peak_power = 0.0
    n_dropped = n_shed = n_batches = batch_sum = plan_switches = 0
    n_failed = n_retried = n_lost = failovers = 0
    arrived_epoch = completed_epoch = 0
    prev_rate = 0.0
    makespan = 0.0
    t_prev = 0.0
    sid_counter = 0

    def n_alive() -> int:
        return sum(alive)

    def busy_cores() -> int:
        return sum(len(b[2]) for b in busy.values())

    def predicted_latency_ms(r) -> float:
        # The healthy loop's forecast, over the *effective* partition.
        if not queue and len(busy) < n_slots_eff and len(free) >= cps:
            return pricer.price(r.kernel, r.elems, cps,
                                plan.point).time_ns * 1e-6
        wave_ms = pricer.price(r.kernel, r.elems * plan.batch_max, cps,
                               plan.point).time_ns * 1e-6
        waves_ahead = 1 + len(queue) // max(1, n_slots_eff * plan.batch_max)
        return (waves_ahead + 1) * wave_ms

    def dispatch(t: float) -> None:
        nonlocal active_pj, peak_power, n_batches, batch_sum, seq, \
            sid_counter
        if plan is None or not cps:
            return
        while queue and len(busy) < n_slots_eff and len(free) >= cps:
            k = min(plan.batch_max, len(queue))
            jobs = [queue.popleft() for _ in range(k)]
            for j in jobs:
                j.attempts += 1
            cores = tuple(sorted(free)[:cps])
            free.difference_update(cores)
            est = pricer.price(jobs[0].req.kernel,
                               sum(j.req.elems for j in jobs),
                               cps, plan.point)
            free_t = t + est.time_ns * 1e-6
            sid = sid_counter
            sid_counter += 1
            busy[sid] = (est.power_mw, jobs, cores, t, free_t,
                         est.energy_pj)
            heapq.heappush(events, (free_t, _PRIO_FREE, seq,
                                    "slot_free", sid))
            seq += 1
            active_pj += est.energy_pj
            peak_power = max(peak_power,
                             sum(b[0] for b in busy.values()))
            n_batches += 1
            batch_sum += k

    def lose(n: int) -> None:
        nonlocal n_lost
        n_lost += n
        if metrics_on:
            _obs_metrics.inc("resilience.requests_lost", n)

    def reschedule(job: _Job, t: float) -> None:
        """Route one killed request: retry if the policy's budget and the
        deadline allow, else lose it."""
        nonlocal n_retried, seq
        if retry is None or job.attempts >= retry.max_attempts:
            lose(1)
            return
        t_retry = t + retry.delay_ms(job.attempts)
        if retry.timeout_ms is not None \
                and t_retry - job.req.t_arrival_ms > retry.timeout_ms:
            lose(1)
            return
        n_retried += 1
        if metrics_on:
            _obs_metrics.inc("resilience.requests_retried")
        heapq.heappush(events, (t_retry, _PRIO_ARRIVAL, seq, "retry", job))
        seq += 1

    def apply_fault(ev, t: float) -> None:
        nonlocal active_pj, n_failed, pending_remap
        dead = [i for i in _flat_dead(ev, n_clusters, cores_per_cluster)
                if alive[i]]
        if not dead:
            return
        for i in dead:
            alive[i] = False
            free.discard(i)
        pending_remap = True
        if metrics_on:
            _obs_metrics.inc("resilience.faults.injected")
        if rec is not None:
            what = (f"c{ev.cluster}" if ev.kind == "clusterfail"
                    else f"c{ev.cluster}.{ev.core}")
            rec.events.append((FAULT_LANE, t * 1e3, 1.0,
                               f"{ev.kind}:{what}", "fault"))
            rec._cursor[FAULT_LANE] = max(rec._cursor.get(FAULT_LANE, 0),
                                          int(t * 1e3) + 1)
        dead_set = set(dead)
        for sid in sorted(busy):
            power, jobs, cores, t0, t1, energy = busy[sid]
            if not dead_set.intersection(cores):
                continue
            # Kill the batch: refund the unfinished energy fraction,
            # return its surviving cores, reroute its requests.
            del busy[sid]
            killed.add(sid)
            n_failed += 1
            if metrics_on:
                _obs_metrics.inc("resilience.batches_killed")
            frac_done = (t - t0) / (t1 - t0) if t1 > t0 else 1.0
            active_pj -= energy * (1.0 - frac_done)
            free.update(c for c in cores if alive[c])
            for job in jobs:
                reschedule(job, t)
        if not n_alive():
            # Nothing can ever complete: drain the queue as lost so the
            # heap empties instead of waiting on capacity forever.
            lose(len(queue))
            queue.clear()
        elif queue:
            # Killed batches freed cores — stay work-conserving under the
            # current (pre-remap) partition.
            dispatch(t)

    with _obs_span("serve.sim.failover", policy=pname, trace=trace.spec,
                   faults=faults.spec, requests=trace.n_requests):
        while events:
            t, _prio, _seq, kind, payload = heapq.heappop(events)
            if t > t_prev:
                if plan is not None:
                    n_idle = len(free)
                    if n_idle > 0:
                        idle_pj += (pricer.idle_power_mw(kern, plan.point)
                                    * n_idle * (t - t_prev) * 1e6)
                t_prev = t
            if kind == "slot_free":
                if payload in killed:
                    killed.discard(payload)
                    continue
                power, jobs, cores, t0, t1, energy = busy.pop(payload)
                completed_epoch += len(jobs)
                makespan = max(makespan, t)
                free.update(c for c in cores if alive[c])
                for job in jobs:
                    lat = t - job.req.t_arrival_ms
                    latencies.append(lat)
                    if metrics_on:
                        _obs_metrics.observe("serve.sim.latency_ms", lat)
                if queue:
                    dispatch(t)
            elif kind == "fault":
                apply_fault(payload, t)
            elif kind == "control":
                rate = arrived_epoch / (epoch_ms * 1e-3)
                decision = policy.decide(dict(
                    t_ms=t, queue_len=len(queue), busy_slots=len(busy),
                    arrived_epoch=arrived_epoch,
                    completed_epoch=completed_epoch,
                    rate_rps=rate, prev_rate_rps=prev_rate,
                    plan=plan)).validate(n_cores)
                if plan is not None and decision != plan:
                    plan_switches += 1
                plan = decision
                na = n_alive()
                if na:
                    n_slots_eff = min(plan.n_slots, na)
                    cps = na // n_slots_eff
                else:
                    n_slots_eff = cps = 0
                if pending_remap:
                    failovers += 1
                    pending_remap = False
                    if metrics_on:
                        _obs_metrics.inc("resilience.failovers")
                prev_rate = rate
                arrived_epoch = completed_epoch = 0
                if queue:
                    dispatch(t)
                if (t < trace.duration_ms or queue or busy) and na:
                    heapq.heappush(events, (t + epoch_ms, _PRIO_CONTROL,
                                            seq, "control", None))
                    seq += 1
            elif kind == "retry":
                # Already admitted once; only capacity can turn it away.
                if not n_alive():
                    lose(1)
                elif len(queue) >= queue_cap:
                    lose(1)
                else:
                    queue.append(payload)
                    dispatch(t)
            else:  # arrival
                arrived_epoch += 1
                if not n_alive():
                    lose(1)
                elif len(queue) >= queue_cap:
                    n_dropped += 1
                    if metrics_on:
                        _obs_metrics.inc("serve.sim.dropped")
                elif admission == "slo_aware" and plan is not None \
                        and predicted_latency_ms(payload.req) \
                        > slo.latency_ms:
                    n_shed += 1
                    if metrics_on:
                        _obs_metrics.inc("serve.sim.shed")
                else:
                    queue.append(payload)
                    dispatch(t)

    lat_sorted = tuple(sorted(latencies))
    report = SimReport(
        policy=pname, trace_spec=trace.spec, trace_seed=trace.seed,
        n_requests=trace.n_requests, n_completed=len(latencies),
        n_dropped=n_dropped,
        latency_ms={f"p{q:g}": _nearest_rank(lat_sorted, q)
                    for q in PERCENTILES},
        max_latency_ms=lat_sorted[-1] if lat_sorted else math.nan,
        makespan_ms=makespan, energy_uj=(active_pj + idle_pj) * 1e-6,
        active_energy_uj=active_pj * 1e-6, idle_energy_uj=idle_pj * 1e-6,
        peak_power_mw=peak_power,
        mean_batch=batch_sum / n_batches if n_batches else 0.0,
        n_batches=n_batches, slo=slo, plan_switches=plan_switches,
        n_shed=n_shed, n_failed=n_failed, n_retried=n_retried,
        n_lost=n_lost, failovers=failovers, latencies_ms=lat_sorted)
    if metrics_on:
        _obs_metrics.inc("serve.sim.requests", trace.n_requests)
        _obs_metrics.set_gauge(f"resilience.{pname}.completed_frac",
                               report.completed_frac)
        _obs_metrics.set_gauge(f"resilience.{pname}.lost", float(n_lost))
        _obs_metrics.set_gauge(f"serve.sim.{pname}.p99_ms",
                               report.latency_ms["p99"])
        _obs_metrics.set_gauge(f"serve.sim.{pname}.energy_uj",
                               report.energy_uj)
    return report
