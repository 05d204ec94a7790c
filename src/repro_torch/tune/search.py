"""Search strategies over a ``SearchSpace`` + the ``tune()`` front door; the
port's copy of the JAX package's ``repro.tune.search``.

* ``exhaustive_search``   — price every candidate; exact argmin.  The
  default for small spaces (analytic evaluations are milliseconds).
* ``successive_halving``  — for large spaces: evaluate everything at a
  cheap fidelity (a fraction of the problem size), keep the top 1/eta,
  re-evaluate at the next fidelity, until the survivors are priced at the
  full problem.
* ``local_search``        — hill climbing over single-knob neighbor moves;
  used to polish the halving winner (and available standalone).
* ``measure_candidates``  — optional measured-refinement pass: time the
  top-K candidates as the port's kernels (``repro_torch.kernels.ops``) at
  each candidate's tiling, on the card with CUDA events, and re-rank by
  what the hardware actually did.

Every strategy prices its candidate sets through the batched oracle
(``cost.evaluate_batch``): candidates are grouped by shared
sub-simulations and the cluster math is composed vectorized over the
candidate axis — identical estimates to per-candidate ``evaluate``,
orders of magnitude faster.

Determinism: every strategy breaks objective ties with
``Candidate.sort_key`` (prefer the static plan's neighborhood), so a
search result is a pure function of (workload, space, problem, config) —
which is also what makes the persistent cache sound.

The best candidate is always compared against the space's default before
returning: ``tune()`` can return the default, but never anything worse.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.cluster.topology import SNITCH_CLUSTER, ClusterConfig
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.spans import span as _obs_span
from repro_torch.tune import cache as _cache
from repro_torch.tune.cost import (OBJECTIVES, CostEstimate, evaluate,
                                   evaluate_batch, objective_value,
                                   parse_objective)
from repro_torch.tune.space import Candidate, SearchSpace, default_space
from repro_torch.tune.workloads import Workload, get_workload


@dataclass(frozen=True)
class Evaluated:
    """One priced candidate."""
    candidate: Candidate
    cost: CostEstimate


def _best(evaluated: list[Evaluated], objective: str) -> Evaluated:
    """Deterministic argmin: feasible candidates only (falling back to the
    lowest-power one if the cap excludes everything — the cluster must
    throttle there anyway, as in ``dvfs.optimal_point``)."""
    if not evaluated:
        raise ValueError("nothing evaluated")
    pool = [e for e in evaluated if e.cost.feasible]
    if not pool:
        pool = [min(evaluated, key=lambda e: (e.cost.power_mw,
                                              e.candidate.sort_key()))]
    return min(pool, key=lambda e: (objective_value(e.cost, objective),
                                    e.candidate.sort_key()))


@dataclass
class TuneResult:
    """What ``tune()`` returns (and what the cache persists)."""
    workload: str
    problem: int
    objective: str
    best: Candidate
    best_cost: CostEstimate
    default: Candidate
    default_cost: CostEstimate
    method: str
    n_evaluated: int
    from_cache: bool = False
    measured_us: dict = field(default_factory=dict)   # candidate repr -> µs

    @property
    def predicted_speedup(self) -> float:
        """Default plan cycles over tuned plan cycles (>= 1 by search
        construction when the objective is cycles/time)."""
        return self.default_cost.cycles / self.best_cost.cycles

    @property
    def predicted_energy_saving(self) -> float:
        return self.default_cost.energy_pj / self.best_cost.energy_pj

    def to_dict(self) -> dict:
        return dict(
            workload=self.workload, problem=self.problem,
            objective=self.objective, best=self.best.to_dict(),
            best_cost=vars(self.best_cost).copy(),
            default=self.default.to_dict(),
            default_cost=vars(self.default_cost).copy(),
            method=self.method, n_evaluated=self.n_evaluated,
            measured_us=dict(self.measured_us))

    @classmethod
    def from_dict(cls, d: dict, from_cache: bool = False) -> "TuneResult":
        return cls(
            workload=d["workload"], problem=d["problem"],
            objective=d["objective"],
            best=Candidate.from_dict(d["best"]),
            best_cost=CostEstimate(**d["best_cost"]),
            default=Candidate.from_dict(d["default"]),
            default_cost=CostEstimate(**d["default_cost"]),
            method=d["method"], n_evaluated=d["n_evaluated"],
            from_cache=from_cache, measured_us=dict(d.get("measured_us", {})))


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

def exhaustive_search(workload: Workload, space: SearchSpace, problem: int,
                      cfg: ClusterConfig = SNITCH_CLUSTER,
                      objective: str = "cycles",
                      power_cap_mw: float | None = None
                      ) -> tuple[Evaluated, list[Evaluated]]:
    """Price every candidate; exact argmin under the deterministic order.
    Returns (best, everything evaluated at full fidelity).  Pricing goes
    through the batched oracle (one schedule rewrite per plan group,
    shared sub-simulations) — same estimates, far higher throughput."""
    cands = list(space.candidates())
    costs = evaluate_batch(workload, cands, problem, cfg, power_cap_mw)
    evaluated = [Evaluated(c, e) for c, e in zip(cands, costs)]
    return _best(evaluated, objective), evaluated


def local_search(workload: Workload, space: SearchSpace, problem: int,
                 cfg: ClusterConfig = SNITCH_CLUSTER,
                 objective: str = "cycles",
                 power_cap_mw: float | None = None,
                 start: Candidate | None = None,
                 max_steps: int = 64) -> tuple[Evaluated, list[Evaluated]]:
    """Hill climbing over single-knob neighbor moves from ``start``
    (default: the space's default candidate) to a local optimum."""
    cur = Evaluated(start or space.default,
                    evaluate(workload, start or space.default, problem, cfg,
                             power_cap_mw))
    seen = [cur]
    for _ in range(max_steps):
        moves_c = list(space.neighbors(cur.candidate))
        costs = evaluate_batch(workload, moves_c, problem, cfg, power_cap_mw)
        moves = [Evaluated(c, e) for c, e in zip(moves_c, costs)]
        seen += moves
        nxt = _best(moves + [cur], objective)
        if nxt.candidate == cur.candidate:
            break
        cur = nxt
    return cur, seen


def successive_halving(workload: Workload, space: SearchSpace, problem: int,
                       cfg: ClusterConfig = SNITCH_CLUSTER,
                       objective: str = "cycles",
                       power_cap_mw: float | None = None,
                       eta: int = 4) -> tuple[Evaluated, list[Evaluated]]:
    """Fidelity ladder: evaluate all candidates on a scaled-down problem,
    keep the top ``1/eta`` per rung, finish the survivors at full size.
    The fidelity floor is a few blocks of the largest block size, so even
    the cheapest rung exercises the per-block overheads being tuned.
    The returned list holds only the final rung (full-fidelity costs)."""
    cands = list(space.candidates())
    floor = 4 * max(space.knob("block").values)
    rungs = 0
    while eta ** (rungs + 1) < len(cands) and problem // eta ** (rungs + 1) >= floor:
        rungs += 1
    for r in range(rungs, -1, -1):
        fidelity = max(floor, problem // eta ** r) if r else problem
        with _obs_span("tune.search.rung", workload=workload.name, rung=r,
                       fidelity=fidelity, candidates=len(cands)):
            costs = evaluate_batch(workload, cands, fidelity, cfg,
                                   power_cap_mw)
        evals = [Evaluated(c, e) for c, e in zip(cands, costs)]
        _obs_metrics.inc("tune.search.rungs")
        if r == 0:
            _obs_metrics.observe("tune.search.rung_survivors", len(evals))
            return _best(evals, objective), evals
        evals.sort(key=lambda e: (not e.cost.feasible,
                                  objective_value(e.cost, objective),
                                  e.candidate.sort_key()))
        cands = [e.candidate for e in evals[:max(1, len(evals) // eta)]]
        _obs_metrics.observe("tune.search.rung_survivors", len(cands))
    raise AssertionError("unreachable")


# ---------------------------------------------------------------------------
# Measured refinement
# ---------------------------------------------------------------------------

#: The lanes of the JAX package's (rows, 1024) tiles: the softmax runner's
#: row width and the floor of every runner's problem.
_LANES = 1024


def candidate_runner(workload: Workload | str, cand: Candidate,
                     problem: int | None = None, device: str = "cuda"):
    """A function that runs ``workload``'s kernel entry point
    (``kernels.ops``) once at ``cand``'s tiling on inputs made on
    ``device``, and returns its output.  The analytic block choice is
    transferred onto the tiling by scaling the kernel's default
    ``block_rows`` with ``cand.block / max_block`` (the rule ``kernels.ops``
    applies): 64 rows for exp, logf and uniform, 8 for softmax, and
    ``n_blocks = 8 x share`` for Monte Carlo."""
    import torch

    from repro_torch.kernels import ops as kops

    w = get_workload(workload) if isinstance(workload, str) else workload
    n = max(problem or w.default_problem, 2 * _LANES)
    device = torch.device(device)
    # Every runner must consume the candidate's block knob — otherwise
    # identical launches get re-timed and the "winner" is jitter.
    share = cand.block / w.max_block
    rows = max(1, round(64 * share))
    if w.name == "expf":
        x = torch.linspace(-3.0, 3.0, n, dtype=torch.float32, device=device)
        return lambda: kops.exp(x, block_rows=rows)
    if w.name == "logf":
        x = torch.linspace(0.5, 4.0, n, dtype=torch.float32, device=device)
        return lambda: kops.log(x, block_rows=rows)
    if w.name == "softmax":
        x = torch.linspace(-1.0, 1.0, n, dtype=torch.float32,
                           device=device).reshape(-1, _LANES)
        return lambda: kops.softmax(x, block_rows=max(1, round(8 * share)))
    if w.name == "prng":
        return lambda: kops.uniform(0, (n,), block_rows=rows, device=device)
    if w.name == "montecarlo":
        return lambda: kops.mc_pi(0, n_samples=n,
                                  n_blocks=max(1, round(8 * share)),
                                  device=device)
    raise KeyError(w.name)


def measure_candidates(workload: Workload | str, cands: list[Candidate],
                       problem: int | None = None, repeats: int = 3,
                       device: str = "cuda") -> dict[Candidate, float]:
    """Time candidates as the port's kernels (µs per call, best of
    ``repeats`` after one warm-up call) at each candidate's tiling
    (``candidate_runner``), on ``device``.

    On the card each call is timed between two CUDA events; on the CPU
    (``device="cpu"``, the plain versions) by ``time.perf_counter``.  Unlike
    the JAX package's version, nothing is caught: a kernel that fails to
    build or launch raises, so an empty or partial result cannot hide a
    broken kernel."""
    import time

    import torch

    on_card = torch.device(device).type == "cuda"

    def time_us(fn) -> float:
        if not on_card:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e6
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3

    out: dict[Candidate, float] = {}
    for cand in cands:
        fn = candidate_runner(workload, cand, problem, device)
        fn()                                   # warm-up (and the build)
        out[cand] = min(time_us(fn) for _ in range(repeats))
    return out


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

#: Spaces at most this big are searched exhaustively.
EXHAUSTIVE_THRESHOLD = 1024


def tune(workload: Workload | str, problem: int | None = None,
         objective: str = "cycles", cfg: ClusterConfig = SNITCH_CLUSTER,
         cluster: bool = False, power_cap_mw: float | None = None,
         space: SearchSpace | None = None,
         cache: "_cache.TuneCache | None | bool" = None,
         measure_top_k: int = 0) -> TuneResult:
    """Find the best plan for ``workload`` under ``objective``.

    ``cache=None`` uses the shared persistent cache (``tune.cache``);
    ``cache=False`` disables caching; a ``TuneCache`` instance targets a
    specific file.  ``measure_top_k > 0`` times the analytic top-K as the
    port's kernels on the card (``measure_candidates``) and re-ranks by
    measured time.
    """
    w = get_workload(workload) if isinstance(workload, str) else workload
    space = space or default_space(w, cfg, cluster=cluster)
    problem = problem or w.default_problem
    # Validates both plain objectives and the latency-bounded grammar
    # ("energy@time<=2.5ms") — the error names the offending token.
    parse_objective(objective)

    store = None if cache is False else (
        _cache.default_cache() if cache in (None, True) else cache)
    key = _cache.cache_key(w.name, problem, cfg, objective, power_cap_mw,
                           space, measure_top_k=measure_top_k) \
        if store is not None else None
    if store is not None:
        hit = store.get(key)
        if hit is not None:
            _obs_metrics.inc("tune.cache.hits")
            return TuneResult.from_dict(hit, from_cache=True)
    _obs_metrics.inc("tune.cache.misses")

    with _obs_span("tune.search", workload=w.name, objective=objective,
                   space_size=space.size):
        default_ev = Evaluated(space.default,
                               evaluate(w, space.default, problem, cfg,
                                        power_cap_mw))
        if space.size <= EXHAUSTIVE_THRESHOLD:
            method = "exhaustive"
            best, evaluated = exhaustive_search(w, space, problem, cfg,
                                                objective, power_cap_mw)
        else:
            method = "halving+local"
            best, evaluated = successive_halving(w, space, problem, cfg,
                                                 objective, power_cap_mw)
            best, seen = local_search(w, space, problem, cfg, objective,
                                      power_cap_mw, start=best.candidate)
            evaluated += seen
    # Tuned may equal, but never lose to, the static plan.
    best = _best([best, default_ev], objective)

    measured: dict[str, float] = {}
    if measure_top_k > 0:
        # Re-rank only what the search already priced at full fidelity —
        # measurement refines the search, it must not reopen the space.
        ranked = sorted({e.candidate: e for e in evaluated}.values(),
                        key=lambda e: (objective_value(e.cost, objective),
                                       e.candidate.sort_key()))
        timed = measure_candidates(w, [e.candidate
                                       for e in ranked[:measure_top_k]],
                                   problem)
        measured = {repr(c): us for c, us in timed.items()}
        if timed and max(timed.values()) > 1.05 * min(timed.values()):
            # Trust the hardware only when it actually distinguishes the
            # candidates; within-noise spreads keep the analytic winner.
            winner = min(timed, key=lambda c: (timed[c], c.sort_key()))
            best = Evaluated(winner, evaluate(w, winner, problem, cfg,
                                              power_cap_mw))

    res = TuneResult(
        workload=w.name, problem=problem, objective=objective,
        best=best.candidate, best_cost=best.cost,
        default=default_ev.candidate, default_cost=default_ev.cost,
        method=method, n_evaluated=len(evaluated), measured_us=measured)
    if store is not None:
        store.put(key, res.to_dict())
    return res


def select_block(workload: Workload | str, objective: str = "cycles",
                 problem: int | None = None,
                 cfg: ClusterConfig = SNITCH_CLUSTER,
                 cache: "_cache.TuneCache | None | bool" = None
                 ) -> TuneResult:
    """Block-size-only search: every other plan knob held at its static
    default.  This is what consumers that can only act on the block
    dimension (``copift.make_plan(tune=True)``, the ``repro_torch.kernels``
    tiling defaults) must use — a block lifted out of a *joint* argmin is
    only optimal together with the fusion/pipelining choices it was found
    with."""
    w = get_workload(workload) if isinstance(workload, str) else workload
    space = default_space(w, cfg)
    for name in ("fuse_fp", "movers", "pipelined"):
        space = space.with_values(name, (getattr(space.default, name),))
    return tune(w, problem=problem, objective=objective, cfg=cfg,
                space=space, cache=cache)


def select_operating_point(workload: Workload | str,
                           cfg: ClusterConfig = SNITCH_CLUSTER,
                           n_cores: int | None = None,
                           power_cap_mw: float | None = None,
                           objective: str = "energy",
                           cache: "_cache.TuneCache | None | bool" = None,
                           heterogeneous: bool = False,
                           max_islands: int = 2) -> TuneResult:
    """Cluster operating-point selection: hold the plan knobs at their
    static defaults and search cores x DVFS ladder only — the tuner-backed
    replacement for ``dvfs.optimal_point`` used by the sweeps.

    ``heterogeneous=True`` widens the search to DVFS-island layouts and
    the weighted scheduling strategies.  That space strictly contains the
    homogeneous one (every ladder point appears as a single-island layout
    pricing bit-for-bit like its homogeneous candidate), and the selection
    stays exhaustive at this size — so the heterogeneous pick never scores
    worse than the homogeneous pick under the same power cap.
    """
    w = get_workload(workload) if isinstance(workload, str) else workload
    n_cores = cfg.n_cores if n_cores is None else n_cores
    space = default_space(w, cfg, cluster=True, cores=(n_cores,),
                          heterogeneous=heterogeneous,
                          max_islands=max_islands)
    for name in ("block", "fuse_fp", "movers", "pipelined"):
        space = space.with_values(name, (getattr(space.default, name),))
    return tune(w, objective=objective, cfg=cfg,
                power_cap_mw=power_cap_mw, space=space, cache=cache)
