"""Autoscaling policies for the serving simulator; a copy of the JAX
package's ``repro.serve.policies``.

A policy turns the simulator's epoch observation into a
:class:`~repro_torch.serve.sim.SlotPlan` (slot count x DVFS point x batch cap).
Three families, in increasing awareness:

* :class:`StaticPolicy`    — one plan forever, chosen offline for an
  assumed arrival rate (what a fixed deployment does);
* :class:`ReactivePolicy`  — a capacity ladder stepped up/down on queue
  depth (threshold autoscaling, always one epoch late);
* :class:`ModelPredictivePolicy` — forecasts the next epoch's rate
  (linear extrapolation plus backlog drain) and re-plans from the cost
  oracle each epoch.

All three choose plans with the same planner, :func:`plan_for_rate`: the
whole plan grid is priced through the tuner's cost oracle
(``ServicePricer.price_many`` → ``tune.cost.evaluate_batch``) and ranked
by the tuner's latency-constrained objective
(``constrain_latency("energy", slo_budget)``) — *minimum energy per
request among the plans that sustain the rate within the latency budget
and the power cap* — so the serving layer re-tunes online with exactly
the machinery ``repro_torch.tune`` ranks kernels with.  The policies differ
only in WHICH rate they hand the planner and WHEN.
"""

from __future__ import annotations

from repro_torch.serve.sim import PolicyContext, SlotPlan
from repro_torch.tune.cost import constrain_latency, meets_latency

__all__ = ["Policy", "StaticPolicy", "ReactivePolicy",
           "ModelPredictivePolicy", "plan_grid", "plan_for_rate",
           "POLICIES"]

#: Fraction of the SLO latency budget a single batch may consume — the
#: rest is headroom for queueing delay the batch-level oracle cannot see.
SERVICE_BUDGET_FRACTION = 0.5

#: Capacity safety factor: a plan must sustain ``headroom x`` the target
#: rate before it is considered throughput-feasible.
DEFAULT_HEADROOM = 1.25

_BATCH_SIZES = (1, 2, 4, 8)


def plan_grid(ctx: PolicyContext,
              batch_sizes: tuple = _BATCH_SIZES) -> list[SlotPlan]:
    """Every valid plan for the context's cluster: slot counts dividing
    the core count x the full DVFS ladder x batch caps."""
    slots = [s for s in range(1, ctx.n_cores + 1) if ctx.n_cores % s == 0]
    points = [p.name for p in ctx.pricer.cluster.operating_points]
    return [SlotPlan(n_slots=s, point=p, batch_max=b)
            for s in slots for p in points for b in batch_sizes]


def _plan_sort_key(plan: SlotPlan) -> tuple:
    return (plan.n_slots, plan.point, plan.batch_max)


def plan_for_rate(ctx: PolicyContext, rate_rps: float,
                  grid: list[SlotPlan] | None = None,
                  headroom: float = DEFAULT_HEADROOM) -> SlotPlan:
    """Min-energy-per-request plan that sustains ``rate_rps``.

    Ranking (deterministic; ties broken by the plan tuple):

    1. throughput-feasible (slot capacity >= ``headroom * rate_rps``) and
       within the power cap and the per-batch latency budget
       (``SERVICE_BUDGET_FRACTION`` of the SLO, via the tuner's
       ``energy@time<=...`` objective) → ranked by energy per request;
    2. otherwise → ranked by batch service time (miss as narrowly as
       possible), mirroring the cost oracle's over-constrained
       degradation.
    """
    grid = grid if grid is not None else plan_grid(ctx)
    if not grid:
        raise ValueError("empty plan grid")
    objective = "energy"
    if ctx.slo is not None:
        objective = constrain_latency(
            "energy", ctx.slo.budget_ns * SERVICE_BUDGET_FRACTION)
    shapes = [(ctx.elems * p.batch_max, p.cores_per_slot(ctx.n_cores),
               p.point) for p in grid]
    ests = ctx.pricer.price_many(ctx.kernel, shapes)
    best = None
    for plan, est in zip(grid, ests):
        s_sec = est.time_ns * 1e-9
        capacity_rps = plan.n_slots * plan.batch_max / s_sec
        ok = (capacity_rps >= headroom * rate_rps
              and meets_latency(est, objective)
              and (ctx.power_cap_mw is None
                   or plan.n_slots * est.power_mw <= ctx.power_cap_mw))
        key = ((0, est.energy_pj / plan.batch_max) if ok
               else (1, est.time_ns)) + _plan_sort_key(plan)
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


class Policy:
    """Base: ``bind`` once per simulation, ``decide`` once per epoch."""

    name = "policy"

    def bind(self, ctx: PolicyContext) -> None:
        self.ctx = ctx

    def decide(self, obs: dict) -> SlotPlan:
        raise NotImplementedError


class StaticPolicy(Policy):
    """One fixed plan for the whole run.

    Pass a :class:`SlotPlan` directly, or ``rate_rps`` to have the shared
    planner choose it offline at bind time — "provision for the mean
    rate" is ``StaticPolicy(rate_rps=trace.mean_rate_rps)``.
    """

    name = "static"

    def __init__(self, plan: SlotPlan | None = None,
                 rate_rps: float | None = None):
        if (plan is None) == (rate_rps is None):
            raise ValueError("pass exactly one of plan= or rate_rps=")
        self._plan = plan
        self._rate = rate_rps

    def bind(self, ctx: PolicyContext) -> None:
        super().bind(ctx)
        if self._plan is None:
            self._plan = plan_for_rate(ctx, self._rate)

    def decide(self, obs: dict) -> SlotPlan:
        return self._plan


class ReactivePolicy(Policy):
    """Queue-threshold autoscaling over a capacity ladder.

    At bind time the plan grid is collapsed to its energy/capacity Pareto
    frontier (strictly more capacity costs strictly more energy per
    request); each epoch steps one rung up when the queue exceeds
    ``hi_queue``, one rung down when it has drained to ``lo_queue``.
    Reacts only to what already queued — one epoch behind any surge.
    """

    name = "reactive"

    def __init__(self, hi_queue: int = 8, lo_queue: int = 0):
        if lo_queue >= hi_queue:
            raise ValueError(f"need lo_queue < hi_queue, got "
                             f"{lo_queue} >= {hi_queue}")
        self.hi_queue = hi_queue
        self.lo_queue = lo_queue

    def bind(self, ctx: PolicyContext) -> None:
        super().bind(ctx)
        grid = plan_grid(ctx)
        shapes = [(ctx.elems * p.batch_max, p.cores_per_slot(ctx.n_cores),
                   p.point) for p in grid]
        ests = ctx.pricer.price_many(ctx.kernel, shapes)
        scored = []
        for plan, est in zip(grid, ests):
            if ctx.power_cap_mw is not None \
                    and plan.n_slots * est.power_mw > ctx.power_cap_mw:
                continue
            capacity = plan.n_slots * plan.batch_max / (est.time_ns * 1e-9)
            scored.append((est.energy_pj / plan.batch_max, capacity, plan))
        scored.sort(key=lambda s: (s[0], -s[1], _plan_sort_key(s[2])))
        ladder, max_cap = [], 0.0
        for energy, capacity, plan in scored:
            if capacity > max_cap:   # Pareto: more capacity, else cheaper
                ladder.append(plan)
                max_cap = capacity
        self._ladder = ladder
        self._idx = 0

    def decide(self, obs: dict) -> SlotPlan:
        if obs["queue_len"] >= self.hi_queue:
            self._idx = min(self._idx + 1, len(self._ladder) - 1)
        elif obs["queue_len"] <= self.lo_queue:
            self._idx = max(self._idx - 1, 0)
        return self._ladder[self._idx]


class ModelPredictivePolicy(Policy):
    """Forecast-then-replan: each epoch smooths the observed arrival
    rate (EWMA, ``alpha``), adds drain capacity for any *excess* backlog
    (queue beyond ``burst_tolerance``, to be cleared within one epoch),
    and asks the shared planner for the min-energy plan sustaining that
    rate.  The smoothing keeps per-epoch counting noise from thrashing
    across DVFS tiers in steady state; the backlog term is what reacts
    to a surge the very epoch it queues.
    """

    name = "mpc"

    def __init__(self, headroom: float = DEFAULT_HEADROOM,
                 alpha: float = 0.3, burst_tolerance: int = 4):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.headroom = headroom
        self.alpha = alpha
        self.burst_tolerance = burst_tolerance

    def bind(self, ctx: PolicyContext) -> None:
        super().bind(ctx)
        self._grid = plan_grid(ctx)
        self._rate_ewma: float | None = None

    def decide(self, obs: dict) -> SlotPlan:
        rate = obs["rate_rps"]
        if self._rate_ewma is None:
            self._rate_ewma = rate
        else:
            self._rate_ewma += self.alpha * (rate - self._rate_ewma)
        excess = max(0, obs["queue_len"] - self.burst_tolerance)
        backlog_rps = excess / (self.ctx.epoch_ms * 1e-3)
        return plan_for_rate(self.ctx, self._rate_ewma + backlog_rps,
                             self._grid, headroom=self.headroom)


#: name -> zero-config constructor (the benchmark's policy table).
POLICIES = {
    "static": lambda rate_rps: StaticPolicy(rate_rps=rate_rps),
    "reactive": lambda rate_rps: ReactivePolicy(),
    "mpc": lambda rate_rps: ModelPredictivePolicy(),
}
