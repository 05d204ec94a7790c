"""COPIFT Steps 4–5 — loop tiling, fission, software pipelining and
multi-buffering.

Step 4 turns ``for i in range(N): phase0(i); phase1(i); ...`` into a blocked
schedule where each phase consumes/produces whole blocks, spilling every
cut-edge value into a block-sized buffer (Fig. 1e).

Step 5 software-pipelines the blocked schedule (Fig. 1f → 1g): in pipeline
iteration ``j'``, phase ``p`` processes block ``j' - p``.  Each cut-edge
buffer connecting phase ``a`` to phase ``b`` needs ``(b - a) + 1`` replicas
(paper: "the distance between the subgraphs ... plus one"); replica
``j mod replicas`` holds block ``j``'s value.

The port's copy of the JAX package's ``repro.core.schedule``.  This module
provides both the *plan* (what a COPIFT kernel implements with on-chip
scratch) and the PyTorch *executors*, which run the phase functions on the
inputs' device and write into outputs allocated there; the property tests
prove with them that the pipelined schedule computes exactly the same result
as the serial schedule for arbitrary phase functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.isa import Domain, L1_BUDGET_DWORDS
from repro_torch.core.partition import Partition


@dataclass(frozen=True)
class BufferSpec:
    """A block-sized spill buffer materializing one cut edge."""
    name: str
    producer_phase: int
    consumer_phase: int
    dtype: Any = torch.float64

    @property
    def distance(self) -> int:
        return self.consumer_phase - self.producer_phase

    @property
    def replicas(self) -> int:
        # Paper §II-A Step 5: distance in the total phase order, plus one.
        return self.distance + 1


@dataclass
class PipelinePlan:
    """The blocked, software-pipelined schedule for one kernel."""
    n_phases: int
    phase_domains: list[Domain]
    buffers: list[BufferSpec]
    block: int
    n_blocks: int

    @property
    def depth(self) -> int:
        return self.n_phases

    @property
    def n_pipeline_iters(self) -> int:
        # j' ranges over [0, n_blocks + depth - 1): phase p handles block
        # j' - p when 0 <= j' - p < n_blocks.
        return self.n_blocks + self.depth - 1

    def active_phases(self, jp: int) -> list[tuple[int, int]]:
        """(phase, block) pairs live in pipeline iteration ``jp``.

        Step 7 ordering: FP phases precede INT phases within an iteration so
        FREP-issued FP work overlaps the integer thread.
        """
        live = [(p, jp - p) for p in range(self.n_phases)
                if 0 <= jp - p < self.n_blocks]
        return sorted(live, key=lambda pb: (self.phase_domains[pb[0]] is not Domain.FP, pb[0]))

    def buffer_replicas(self) -> dict[str, int]:
        return {b.name: b.replicas for b in self.buffers}

    def l1_dwords(self) -> int:
        """Total L1 buffer footprint in double words (8 B)."""
        return sum(b.replicas for b in self.buffers) * self.block

    def validate(self) -> None:
        for b in self.buffers:
            if b.distance < 1:
                raise AssertionError(f"buffer {b.name} is not forward: {b}")
        if self.l1_dwords() > L1_BUDGET_DWORDS * max(1, 1):
            # Informational only at plan level; max_block() enforces the cap.
            pass


def max_block(n_buffer_slots: int, budget_dwords: int = L1_BUDGET_DWORDS) -> int:
    """Largest block size whose spill buffers fit the L1 budget.

    ``n_buffer_slots`` is the total number of buffer *replicas* (Table I's
    "#Buff." column after Step 5–6).  Table I's "Max Block" column follows
    from the per-kernel replica counts and the TCDM budget.
    """
    return budget_dwords // max(1, n_buffer_slots)


def plan_from_partition(part: Partition, block: int, n_blocks: int,
                        dtype=torch.float64) -> PipelinePlan:
    """Derive the pipeline plan straight from a Step-2 partition: one buffer
    per distinct (producer_phase, consumer_phase, producer_node) cut value."""
    seen: dict[tuple[int, int, int], BufferSpec] = {}
    for (u, v, _dep) in part.cut_edges:
        pu, pv = part.node_phase[u], part.node_phase[v]
        key = (pu, pv, u)
        if key not in seen:
            seen[key] = BufferSpec(name=f"e{u}_{pu}to{pv}", producer_phase=pu,
                                   consumer_phase=pv, dtype=dtype)
    plan = PipelinePlan(
        n_phases=len(part.phases),
        phase_domains=[ph.domain for ph in part.phases],
        buffers=sorted(seen.values(), key=lambda b: b.name),
        block=block, n_blocks=n_blocks)
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# Executors (the property tests and ``copift.execute``), on any device
# ---------------------------------------------------------------------------

PhaseFn = Callable[..., dict[str, torch.Tensor]]


@dataclass
class PhaseProgram:
    """Executable phase set: ``phases[p]`` maps named block inputs (from
    earlier phases or external arrays) to named block outputs.

    ``reads[p]`` / ``writes[p]`` list buffer names; external arrays are read
    via ``extern_reads[p]`` (sliced per block) and final outputs via
    ``extern_writes[p]``.
    """
    phases: Sequence[PhaseFn]
    reads: Sequence[Sequence[str]]
    writes: Sequence[Sequence[str]]
    extern_reads: Sequence[Sequence[str]]
    extern_writes: Sequence[Sequence[str]]


def run_serial(prog: PhaseProgram, plan: PipelinePlan,
               extern: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fig. 1f — blocked but unpipelined: all phases on block j, then j+1.
    The outputs are new tensors on the inputs' device; ``extern`` is not
    written."""
    outs = {k: torch.zeros_like(v) for k, v in extern.items()
            if any(k in w for w in prog.extern_writes)}
    buffers: dict[str, torch.Tensor] = {}
    B = plan.block
    for j in range(plan.n_blocks):
        sl = slice(j * B, (j + 1) * B)
        for p in range(plan.n_phases):
            ins = {k: buffers[k] for k in prog.reads[p]}
            ins.update({k: extern[k][sl] for k in prog.extern_reads[p]})
            res = prog.phases[p](**ins)
            for k in prog.writes[p]:
                buffers[k] = res[k]
            for k in prog.extern_writes[p]:
                outs[k][sl] = res[k]
    return outs


def run_pipelined(prog: PhaseProgram, plan: PipelinePlan,
                  extern: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fig. 1g — software-pipelined with rotating multi-buffers.

    Buffer ``name`` has ``replicas`` copies; block ``j``'s value lives in
    replica ``j % replicas``.  Correctness of the replica count (= phase
    distance + 1) is exactly what the property tests exercise: with fewer
    replicas, an in-flight value would be overwritten before consumption.
    """
    outs = {k: torch.zeros_like(v) for k, v in extern.items()
            if any(k in w for w in prog.extern_writes)}
    reps = plan.buffer_replicas()
    name_by_writer: dict[str, list[str]] = {}
    buffers: dict[str, list[Any]] = {b.name: [None] * b.replicas for b in plan.buffers}
    # Map plan buffer names to program buffer names 1:1 when they match;
    # otherwise the program's names are authoritative and replica counts are
    # looked up by name with a default of depth (safe upper bound).
    def replicas_of(name: str) -> int:
        return reps.get(name, plan.depth)

    store: dict[str, list[Any]] = {}
    B = plan.block
    for jp in range(plan.n_pipeline_iters):
        for p, j in plan.active_phases(jp):
            sl = slice(j * B, (j + 1) * B)
            ins = {}
            for k in prog.reads[p]:
                ins[k] = store[k][j % replicas_of(k)]
            ins.update({k: extern[k][sl] for k in prog.extern_reads[p]})
            res = prog.phases[p](**ins)
            for k in prog.writes[p]:
                store.setdefault(k, [None] * replicas_of(k))
                store[k][j % replicas_of(k)] = res[k]
            for k in prog.extern_writes[p]:
                outs[k][sl] = res[k]
    return outs
