"""``Tuner`` — one object over the three tuner front doors; the port's copy
of the JAX package's ``repro.api.tuner``.

``repro_torch.tune`` has three parallel entry points — ``tune`` (joint plan
search), ``select_block`` (block-only, for consumers that can only act on
the tiling) and ``select_operating_point`` (cores x DVFS under a power
cap).  A ``Tuner`` binds their context once (a
:class:`~repro_torch.api.Target` and one cache object) and exposes the
searches as methods sharing the same persistent cache and the same memoized
cost oracle (``tune.cost.evaluate``):

    tuner = Tuner(Target.homogeneous(power_cap_mw=250.0))
    tuner.plan("softmax")                       # joint plan knobs
    tuner.block("expf")                         # tiling-only
    tuner.operating_point("expf", heterogeneous=True,
                          per_island_blocks=True)

``per_island_blocks=True`` refines the winning island layout with
per-island block sizes after the joint islands x strategy search.  The
shared-block winner stays in the comparison pool — and a uniform per-island
assignment canonicalizes onto it in the cost oracle — so the refined pick
never scores worse than the shared-block plan under the same power cap.

``operating_point(n_clusters=...)`` lifts the search to the manycore part
(``system.select_system_point``), and :meth:`Tuner.attribute` explains a
tuned plan's speedup as an exact stall-category waterfall
(``obs.attrib``).  Every result equals the JAX package's with ``==``.
"""

from __future__ import annotations

import itertools
from dataclasses import replace as _dc_replace

from repro_torch.api.registry import KernelSpec, kernel
from repro_torch.api.target import Target
from repro_torch.obs.spans import span as _obs_span
from repro_torch.tune import cache as _tune_cache
from repro_torch.tune.cost import constrain_latency
from repro_torch.tune.cost import evaluate_batch as _cost_evaluate_batch
from repro_torch.tune.cost import objective_value
from repro_torch.tune.search import (TuneResult, select_block,
                                     select_operating_point, tune)
from repro_torch.tune.space import block_ladder
from repro_torch.tune.workloads import Workload, get_workload


class Tuner:
    """Model-guided search bound to one target and one cache.

    ``objective=None`` (default) keeps each method's historical default —
    ``cycles`` for the plan/block searches, ``energy`` for operating-point
    selection (cycles are frequency-independent, so they cannot rank DVFS
    points); an explicit objective binds all three methods alike.
    ``cache=None`` (default) shares the persistent process-wide cache;
    ``cache=False`` disables persistence; a ``TuneCache`` instance targets
    a specific file.  Every method funnels through the same cache object
    and the same in-process cost-oracle memo table.
    """

    def __init__(self, target: Target | None = None,
                 objective: str | None = None,
                 cache: "_tune_cache.TuneCache | None | bool" = None):
        self.target = target or Target()
        self.objective = objective
        self._cache = cache

    @property
    def cache(self) -> "_tune_cache.TuneCache | bool":
        """The bound store; the shared default resolves lazily so a
        changed ``$REPRO_TORCH_TUNE_CACHE`` is honored per call."""
        if self._cache is None or self._cache is True:
            return _tune_cache.default_cache()
        return self._cache

    def __repr__(self):
        return (f"Tuner(n_cores={self.target.n_cores}, "
                f"objective={self.objective!r}, "
                f"power_cap_mw={self.target.power_cap_mw})")

    # -- spec resolution ----------------------------------------------------

    @staticmethod
    def _workload(spec: "KernelSpec | Workload | str") -> Workload:
        if isinstance(spec, Workload):
            return spec
        if isinstance(spec, str):
            try:
                spec = kernel(spec)
            except KeyError:
                # Not a registry kernel — fall through to the raw workload
                # registry so pre-facade call sites keep working.
                return get_workload(spec)
        return spec.get_workload()

    # -- searches -----------------------------------------------------------

    def plan(self, spec: "KernelSpec | Workload | str",
             problem: int | None = None, objective: str | None = None,
             cluster: bool = False, space=None,
             measure_top_k: int = 0,
             latency_ns: float | None = None) -> TuneResult:
        """Joint plan-knob search (block, fusion, movers, pipelining; plus
        cores x DVFS when ``cluster=True``) — the old ``tune()``.

        ``latency_ns`` bounds the search: the winner is the best plan by
        the objective *among those finishing within the bound* (the
        ``"energy@time<=..."`` objective grammar, composed for you)."""
        w = self._workload(spec)
        objective = objective or self.objective or "cycles"
        if latency_ns is not None:
            objective = constrain_latency(objective, latency_ns)
        with _obs_span("tuner.plan", workload=w.name, cluster=cluster):
            return tune(w, problem=problem, objective=objective,
                        cfg=self.target.cluster, cluster=cluster,
                        power_cap_mw=self.target.power_cap_mw,
                        space=space, cache=self.cache,
                        measure_top_k=measure_top_k)

    def block(self, spec: "KernelSpec | Workload | str",
              objective: str | None = None,
              problem: int | None = None) -> TuneResult:
        """Block-size-only search, every other knob at its static default —
        what tiling-only consumers (``kernels.ops`` defaults,
        ``copift.make_plan(tune=True)``) must use."""
        w = self._workload(spec)
        with _obs_span("tuner.block", workload=w.name):
            return select_block(w,
                                objective=objective or self.objective
                                or "cycles",
                                problem=problem, cfg=self.target.cluster,
                                cache=self.cache)

    def operating_point(self, spec: "KernelSpec | Workload | str",
                        n_cores: int | None = None,
                        objective: str | None = None,
                        heterogeneous: bool = False,
                        max_islands: int = 2,
                        per_island_blocks: bool = False,
                        latency_ns: float | None = None,
                        n_clusters: "int | tuple[int, ...] | None" = None):
        """Cluster operating-point selection under the target's power cap.

        ``heterogeneous=True`` searches DVFS-island layouts and weighted
        scheduling strategies (a strict superset of the homogeneous
        ladder); ``per_island_blocks=True`` additionally refines the
        winning multi-island layout with per-island block sizes.
        ``latency_ns`` turns the selection into the serving question —
        *minimum energy among the operating points finishing within the
        bound* ("p99 <= X ms at minimum energy", with the bound applied
        to the priced problem's service time) — via the
        ``"energy@time<=..."`` objective grammar; with no point fast
        enough the selection degrades to the fastest feasible one.

        ``n_clusters`` lifts the search one level: candidate *cluster
        counts* (an int ``k`` searches ``1..k``; a tuple searches exactly
        those) x the DVFS ladder, priced on the whole manycore part with
        the target's ``power_cap_mw`` as the **system** budget — returns
        a :class:`repro_torch.system.SystemPoint` (its ``best_cost``
        mirrors ``TuneResult.best_cost``).  The target's ``system_config``
        (if any) supplies the cluster template and HBM/NoC parameters;
        without ``n_clusters`` a system target takes the cluster search on
        its first cluster, as in the JAX package.
        """
        objective = objective or self.objective or "energy"
        if latency_ns is not None:
            objective = constrain_latency(objective, latency_ns)
        if n_clusters is not None:
            from repro_torch.system.analytics import select_system_point
            sys_cfg = self.target.system_config
            return select_system_point(
                spec if isinstance(spec, str) else self._workload(spec).name,
                n_clusters, cluster=self.target.cluster,
                hbm_bytes_per_cycle=(sys_cfg.hbm_bytes_per_cycle
                                     if sys_cfg is not None else None),
                noc_latency_cycles=(sys_cfg.noc_latency_cycles
                                    if sys_cfg is not None else 0),
                power_cap_mw=self.target.power_cap_mw,
                objective=objective)
        w = self._workload(spec)
        with _obs_span("tuner.operating_point", workload=w.name,
                       heterogeneous=heterogeneous,
                       per_island_blocks=per_island_blocks):
            res = select_operating_point(
                w, cfg=self.target.cluster,
                n_cores=n_cores if n_cores is not None
                else self.target.n_cores,
                power_cap_mw=self.target.power_cap_mw, objective=objective,
                cache=self.cache, heterogeneous=heterogeneous,
                max_islands=max_islands)
            if per_island_blocks and len(res.best.islands) > 1:
                res = self._refine_island_blocks(spec, res, objective)
        return res

    def attribute(self, spec: "KernelSpec | Workload | str",
                  result: TuneResult | None = None, *,
                  problem: int | None = None, which: str = "copift"):
        """Where did the tuned plan's speedup come from?

        Returns an :class:`repro_torch.obs.attrib.Attribution` — the exact
        stall-category waterfall between ``result.default`` and
        ``result.best`` (``result=None`` runs :meth:`plan` first).
        Simulatable registry kernels are priced through the full traced
        ``api.evaluate`` path on this tuner's target, so the step deltas
        sum bit-for-bit to the ``Report`` cycle delta; tuner-only
        workloads (``softmax``, ``prng``) get the per-block decomposition
        (``obs.attrib.attribute_plans``).
        """
        from repro_torch.obs.attrib import attribute_evaluate, attribute_plans
        w = self._workload(spec)
        if result is None:
            result = self.plan(spec, problem=problem)
        sp = None
        if isinstance(sp_in := spec, KernelSpec):
            sp = sp_in
        elif isinstance(spec, str):
            try:
                sp = kernel(spec)
            except KeyError:
                sp = None
        with _obs_span("tuner.attribute", workload=w.name,
                       evaluate_path=bool(sp is not None and sp.simulatable)):
            if sp is not None and sp.simulatable:
                att = attribute_evaluate(
                    sp, self.target, self.target,
                    plan_a=result.default, plan_b=result.best,
                    which=which, label_a="default", label_b="tuned")
            else:
                att = attribute_plans(w, result.default, result.best)
        att.meta.setdefault("predicted_speedup", result.predicted_speedup)
        att.meta.setdefault("method", result.method)
        return att

    def _refine_island_blocks(self, spec, res: TuneResult,
                              objective: str) -> TuneResult:
        """Per-island block refinement of a heterogeneous winner.

        Enumerates the block ladder independently per island of the
        winning layout and keeps the best *feasible* candidate; the
        shared-block winner is in the pool (uniform tuples canonicalize
        onto it), so the result never scores worse under the same cap.
        The whole ladder^islands cross product is priced in one
        ``evaluate_batch`` call (shared sub-simulations via the
        ``repro_torch.perf`` memo), so refinement stays cheap and runs after
        the (persistent-cached) layout search rather than widening its
        keyed space.
        """
        w = self._workload(spec)
        cap = self.target.power_cap_mw
        ladder = block_ladder(w.max_block)
        cands = []
        for combo in itertools.product(ladder,
                                       repeat=len(res.best.islands)):
            # Store uniform combos in canonical shared-block form (the
            # same rule the cost oracle applies), so a winner's .block
            # field never contradicts its island_blocks — consumers that
            # only read .block (the kernels' tiling defaults) stay honest.
            if len(set(combo)) == 1:
                cands.append(_dc_replace(res.best, block=combo[0],
                                         island_blocks=()))
            else:
                cands.append(_dc_replace(res.best, island_blocks=combo))
        costs = _cost_evaluate_batch(w, cands, res.problem,
                                     self.target.cluster, cap)
        best_cand, best_cost = res.best, res.best_cost
        n_extra = len(cands)
        for cand, cost in zip(cands, costs):
            # Feasible beats infeasible; within a class, the objective
            # decides (sort_key breaks ties toward the shared plan).
            if ((not cost.feasible, objective_value(cost, objective),
                 cand.sort_key())
                    < (not best_cost.feasible,
                       objective_value(best_cost, objective),
                       best_cand.sort_key())):
                best_cand, best_cost = cand, cost
        if best_cand == res.best:
            return res
        return _dc_replace(res, best=best_cand, best_cost=best_cost,
                           method=res.method + "+island_blocks",
                           n_evaluated=res.n_evaluated + n_extra,
                           from_cache=False)
