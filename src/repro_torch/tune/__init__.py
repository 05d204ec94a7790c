"""Model-guided autotuning of COPIFT plans and cluster operating points: the
port's copy of the JAX package's ``repro.tune``, plain Python and numpy in
the same order, so that every result equals the JAX package's with ``==``.

The paper's Steps 4-7 choices — block size via the Table-I "Max Block"
rule, phase fusion, stream-to-mover assignment — are fixed heuristics, yet
Fig. 3 shows IPC varies strongly across problem x block sizes.  This
subsystem closes the loop between the calibrated cost models and those
choices: it declares the searchable knobs, prices every candidate through
one unified analytic oracle (the single-PE discrete-event model composed
with the ``repro_torch.cluster`` contention/DMA/DVFS machinery), searches the
space, and remembers the winners.

Layer map (mirrors ``repro_torch.core``'s and ``repro_torch.cluster``'s):

* ``space``     — ``Knob`` / ``SearchSpace`` / ``Candidate``: the searchable
  plan parameters (block size, FP-phase fusion, SSR/mover assignment,
  pipelining on/off; at cluster scope cores x DVFS point under a power
  cap; at heterogeneous scope DVFS-island layouts and the weighted
  scheduling strategy)
* ``workloads`` — the tunable built-in kernels (``expf``, ``logf``,
  ``montecarlo``, ``prng``, ``softmax``) bound to their ISA-level schedules
* ``cost``      — ``evaluate(workload, candidate) -> CostEstimate``: the
  unified oracle wrapping ``core.timing`` and the cluster composition into
  ``{cycles, time, energy, ipc, power}``
* ``search``    — exhaustive search for small spaces, successive halving +
  local search for large ones, optional measured refinement of the top-K
  candidates as the port's CUDA kernels on the card; ``tune()`` is the
  front door
* ``cache``     — persistent JSON cache keyed by (kernel, problem, dtype,
  arch config, objective, space) so repeat calls are free; the port's own
  file (``$REPRO_TORCH_TUNE_CACHE``), never the JAX package's

The facade object ``repro_torch.api.Tuner`` binds these front doors to one
``Target`` and one cache (``.plan()`` / ``.block()`` /
``.operating_point()``), and adds per-island block-size refinement on
top of the heterogeneous search; prefer it in new code.

Invariant (pinned in ``tests/test_torch_tune.py``): with fusion off, the
default mover assignment, pipelining on, one core and the nominal DVFS
point, the tuned block size reproduces the Table-I "Max Block" choice — the
tuner strictly generalizes the paper's static rule.
"""

from repro_torch.tune.cache import TuneCache, cache_key, default_cache
from repro_torch.tune.cost import (CostEstimate, constrain_latency, evaluate,
                                   meets_latency, objective_value,
                                   parse_objective)
from repro_torch.tune.search import (Evaluated, TuneResult, candidate_runner,
                                     exhaustive_search, local_search,
                                     measure_candidates, select_block,
                                     select_operating_point,
                                     successive_halving, tune)
from repro_torch.tune.space import (Candidate, Knob, SearchSpace, block_ladder,
                                    default_space, island_ladder)
from repro_torch.tune.workloads import (BUILTIN_KERNELS, WORKLOADS, Workload,
                                        get_workload)

__all__ = [
    "TuneCache", "cache_key", "default_cache",
    "CostEstimate", "constrain_latency", "evaluate", "meets_latency",
    "objective_value", "parse_objective",
    "Evaluated", "TuneResult", "candidate_runner", "exhaustive_search",
    "local_search",
    "measure_candidates", "select_block", "select_operating_point",
    "successive_halving", "tune",
    "Candidate", "Knob", "SearchSpace", "block_ladder", "default_space",
    "island_ladder",
    "BUILTIN_KERNELS", "WORKLOADS", "Workload", "get_workload",
]
