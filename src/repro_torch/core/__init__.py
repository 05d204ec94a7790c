"""COPIFT — the paper's primary contribution, as executable machinery; the
port's copy of the JAX package's ``repro.core``.

Layer map (paper §II-A steps → modules):

* Step 1    ``dfg``        — DFG construction + int/fp/mem classification
  (front-ends: RISC-V traces for the paper's kernels, aten graphs traced by
  ``make_fx`` for any PyTorch function)
* Steps 2–3 ``partition``  — acyclic min-cut phase partitioning + reorder
* Steps 4–5 ``schedule``   — loop tiling, fission, software pipelining,
  multi-buffering (replicas = phase distance + 1)
* Steps 6–7 ``streams``    — SSR affine streams, stream fusion, ISSR
* §II-B     ``isa``        — RV32G/FREP/SSR model + COPIFT custom-1 opcodes
* Eq. 1–3   ``analytics``  — TI, S′, S″, I′ + Table I
* §III      ``timing``     — dual-issue discrete-event model (Fig. 2a, 3)
* §III-B    ``energy``     — component power model (Fig. 2b/2c)
* API       ``copift``     — ``analyze()`` + executable block plans

Everything but the traced front-end, the streams' addresses and the
executors is plain Python and numpy, copied so that every count and timing
equals the JAX package's bit for bit.
"""

from repro_torch.core.analytics import (PAPER_HEADLINE, TABLE_I,
                                        TABLE_I_PRINTED, KernelCounts,
                                        geomean, table_rows)
from repro_torch.core.copift import (Analysis, CopiftPlan, PhaseDef, analyze,
                                     choose_block, execute, make_plan)
from repro_torch.core.dfg import (DiGraph, build_dfg, cross_edges,
                                  domain_counts, fx_dfg)
from repro_torch.core.isa import DepType, Domain, Instr, KernelTrace
from repro_torch.core.partition import Partition, Phase, partition, reorder
from repro_torch.core.schedule import (BufferSpec, PhaseProgram,
                                       PipelinePlan, max_block,
                                       plan_from_partition, run_pipelined,
                                       run_serial)
from repro_torch.core.streams import (AffineStream, IndirectStream,
                                      allocate_ssrs, fuse,
                                      stage_type1_to_type2)
from repro_torch.core.timing import (BlockTiming, CopiftSchedule,
                                     KernelResult, copift_block_timing,
                                     copift_problem_timing, evaluate_kernel,
                                     ipc_surface)

__all__ = [
    "PAPER_HEADLINE", "TABLE_I", "TABLE_I_PRINTED", "KernelCounts",
    "geomean", "table_rows",
    "Analysis", "CopiftPlan", "PhaseDef", "analyze", "choose_block",
    "execute", "make_plan", "DiGraph", "build_dfg", "cross_edges",
    "domain_counts", "fx_dfg", "DepType", "Domain", "Instr", "KernelTrace",
    "Partition", "Phase", "partition", "reorder", "BufferSpec",
    "PhaseProgram", "PipelinePlan", "max_block", "plan_from_partition",
    "run_pipelined", "run_serial", "AffineStream", "IndirectStream",
    "allocate_ssrs", "fuse", "stage_type1_to_type2", "BlockTiming",
    "CopiftSchedule", "KernelResult", "copift_block_timing",
    "copift_problem_timing", "evaluate_kernel", "ipc_surface",
]
