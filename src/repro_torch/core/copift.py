"""The user-facing COPIFT transform and analyzer.

The port's copy of the JAX package's ``repro.core.copift``.

``analyze(fn, *args)`` applies Steps 1–2 of the methodology to any PyTorch
function: trace (``dfg.fx_dfg``, an aten graph) → DFG → domain
classification → acyclic min-cut phase partition → Eq. 1–3 predictions.
This is the framework's "COPIFT analyzer".

``make_plan(...)`` carries the remaining steps (3–7) for block-parallel
elementwise computations: given ordered phase functions it derives the spill
buffers, picks a block size that fits the scratch budget (Table I "Max
Block" logic), fuses the streams onto the available movers, and returns an
executable plan.  :func:`execute` runs a plan with PyTorch on the inputs'
device, serial or software-pipelined; ``csrc/expf.cu`` is the same three
phases fused into one CUDA kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import dfg as _dfg
from repro_torch.core import partition as _partition
from repro_torch.core import schedule as _schedule
from repro_torch.core import streams as _streams
from repro_torch.core.isa import Domain, L1_BUDGET_DWORDS


@dataclass
class Analysis:
    """Steps 1–2 applied to a function, with Eq. 1–3 predictions."""
    n_int: int
    n_fp: int
    n_mem: int
    n_phases: int
    phase_domains: list[Domain]
    n_cut_edges: int
    cut_types: dict[str, int]

    @property
    def thread_imbalance(self) -> float:
        if max(self.n_int, self.n_fp) == 0:
            return 0.0
        return min(self.n_int, self.n_fp) / max(self.n_int, self.n_fp)

    @property
    def predicted_speedup(self) -> float:
        """Eq. 3: S'' = 1 + TI — the dual-issue speedup if this computation
        were COPIFT-scheduled across the int/fp execution resources."""
        return 1.0 + self.thread_imbalance

    @property
    def predicted_ipc_gain(self) -> float:
        tot = self.n_int + self.n_fp
        if max(self.n_int, self.n_fp) == 0:
            return 1.0
        return tot / max(self.n_int, self.n_fp)


def analyze(fn: Callable, *example_args: Any, **kw) -> Analysis:
    g = _dfg.fx_dfg(fn, *example_args, **kw)
    part = _partition.partition(g)
    counts = _dfg.domain_counts(g)
    cut_types: dict[str, int] = {}
    for _, _, dep in part.cut_edges:
        cut_types[dep.name] = cut_types.get(dep.name, 0) + 1
    return Analysis(
        n_int=counts[Domain.INT], n_fp=counts[Domain.FP],
        n_mem=counts[Domain.MEM],
        n_phases=len(part.phases),
        phase_domains=[p.domain for p in part.phases],
        n_cut_edges=part.n_cuts, cut_types=cut_types)


# ---------------------------------------------------------------------------
# Executable plans for block-parallel elementwise kernels (Steps 3–7)
# ---------------------------------------------------------------------------

@dataclass
class PhaseDef:
    """One phase of a COPIFT plan.

    ``fn(**inputs) -> dict`` maps named block arrays to named block arrays.
    ``domain`` tags which execution resource the phase occupies; ``reads``
    name inter-phase buffers consumed, ``writes`` buffers produced;
    ``extern_reads``/``extern_writes`` are slices of the kernel's global
    inputs/outputs (the SSR-streamed arrays).
    """
    fn: Callable[..., dict]
    domain: Domain
    reads: tuple[str, ...] = ()
    writes: tuple[str, ...] = ()
    extern_reads: tuple[str, ...] = ()
    extern_writes: tuple[str, ...] = ()


@dataclass
class CopiftPlan:
    name: str
    phases: list[PhaseDef]
    block: int
    buffers: dict[str, int]            # name → replica count
    pipeline: _schedule.PipelinePlan | None = None

    @property
    def depth(self) -> int:
        return len(self.phases)


def choose_block(n_buffers_after_pipelining: int, requested: int | None = None,
                 budget_dwords: int = L1_BUDGET_DWORDS) -> int:
    """Table-I 'Max Block' logic: the largest block whose replica set fits
    the scratch budget, optionally clamped to a requested size."""
    cap = _schedule.max_block(n_buffers_after_pipelining, budget_dwords)
    if requested is None:
        return cap
    if requested < 1:
        raise ValueError(f"requested block must be >= 1, got {requested}")
    return min(requested, cap)


def make_plan(name: str, phases: Sequence[PhaseDef], n_elements: int,
              block: int | None = None,
              tune: bool = False, tune_objective: str = "cycles") -> CopiftPlan:
    """Steps 3–7 for an explicitly phase-decomposed computation.

    ``tune=True`` asks the autotuner (``repro_torch.tune``) for the block
    size when ``name`` matches a tunable built-in workload and no explicit
    ``block`` was given; the tuned choice is still clamped to this plan's
    own scratch budget.  Unknown names keep the static Table-I rule.
    """
    if tune and block is None:
        # Deferred import (the facade builds on core); block-only search —
        # a block from the joint argmin is only valid with the fusion and
        # pipelining choices it was found with, which this plan keeps.
        # The shared default tuner means this hits the same cache as the
        # kernels' tiling defaults and the serve engine.
        from repro_torch.api import default_tuner
        try:
            block = default_tuner().block(
                name, objective=tune_objective).best.block
        except KeyError:
            block = None  # not a tunable workload -> static Max Block rule
    # Buffer replicas: producer→consumer distance + 1 (Step 5).
    producers: dict[str, int] = {}
    replicas: dict[str, int] = {}
    for i, ph in enumerate(phases):
        for b in ph.writes:
            producers[b] = i
    for i, ph in enumerate(phases):
        for b in ph.reads:
            if b not in producers:
                raise ValueError(f"phase {i} reads unproduced buffer {b}")
            dist = i - producers[b]
            if dist < 1:
                raise ValueError(f"buffer {b} not produced before phase {i}")
            replicas[b] = max(replicas.get(b, 0), dist + 1)
    n_slots = sum(replicas.values()) or 1
    blk = choose_block(n_slots, block)
    n_blocks = max(1, -(-n_elements // blk))
    plan = CopiftPlan(name=name, phases=list(phases), block=blk,
                      buffers=replicas)
    spec = [
        _schedule.BufferSpec(name=b, producer_phase=producers[b],
                             consumer_phase=producers[b] + replicas[b] - 1)
        for b in sorted(replicas)
    ]
    plan.pipeline = _schedule.PipelinePlan(
        n_phases=len(phases),
        phase_domains=[p.domain for p in phases],
        buffers=spec, block=blk, n_blocks=n_blocks)
    return plan


def execute(plan: CopiftPlan, extern: dict[str, torch.Tensor],
            pipelined: bool = True) -> dict[str, torch.Tensor]:
    """Execute a plan with PyTorch on the inputs' device (serial or
    software-pipelined with rotating replicas — bit-identical results,
    property-tested)."""
    prog = _schedule.PhaseProgram(
        phases=[p.fn for p in plan.phases],
        reads=[p.reads for p in plan.phases],
        writes=[p.writes for p in plan.phases],
        extern_reads=[p.extern_reads for p in plan.phases],
        extern_writes=[p.extern_writes for p in plan.phases])
    runner = _schedule.run_pipelined if pipelined else _schedule.run_serial
    return runner(prog, plan.pipeline, extern)
