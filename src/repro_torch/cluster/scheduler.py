"""Static work partitioning — distributing a kernel's blocks across the
cluster's cores, homogeneous or heterogeneous.

The port's copy of the JAX package's ``repro.cluster.scheduler``, plain
Python, so that its numbers equal the JAX package's bit for bit.

COPIFT tiles a kernel into ``n_blocks`` independent blocks (Step 4); across
a homogeneous cluster the natural static schedule hands block ``j`` to core
``j mod n_cores`` (``block_cyclic``).  Blocks are homogeneous (same size,
same instruction mix), so on equal cores the only load imbalance is the
remainder: some cores run ``ceil(n_blocks / n_cores)`` rounds while others
run ``floor``.  The cluster finishes with the slowest core — ``imbalance``
quantifies the idle fraction this costs, which the strong-scaling sweeps
surface (e.g. 36 blocks on 16 cores: 3 rounds on 4 cores, 2 on the rest →
2.25 mean vs 3 max).

With DVFS islands the cores *differ in speed*, and block-cyclic is no
longer the right static schedule: a 0.5 GHz core handed as many blocks as
a 1.45 GHz one stretches the tail by ~3x.  ``assign`` generalizes the
partitioner to weighted cores with three strategies:

* ``block_cyclic``          — speed-blind round robin (the paper's rule);
* ``static_proportional``   — shares ∝ core speed, largest-remainder
  apportionment (deterministic, exact conservation);
* ``lpt``                   — longest-processing-time greedy: each block
  goes to the core that would finish it earliest (the classic 4/3-optimal
  makespan heuristic, exact here because blocks are identical).

Reduction invariant (pinned by the scheduler property tests): with uniform
``core_speeds`` every strategy produces exactly ``block_cyclic``'s
per-core counts, so the heterogeneous machinery is a strict superset of
the homogeneous one.
"""

from __future__ import annotations

from dataclasses import dataclass

#: The weighted-assignment strategies ``assign`` accepts.
STRATEGIES = ("block_cyclic", "static_proportional", "lpt")


@dataclass(frozen=True)
class WorkAssignment:
    """Assignment of ``n_blocks`` blocks to ``n_cores`` cores.

    ``core_speeds`` (relative rates, e.g. island frequencies) is ``None``
    for the homogeneous block-cyclic case — every derived quantity then
    treats the cores as equal.
    """
    n_blocks: int
    n_cores: int
    blocks_per_core: tuple[int, ...]
    core_speeds: tuple[float, ...] | None = None

    @property
    def max_blocks(self) -> int:
        """Rounds the fullest core runs — sets cluster latency on equal
        cores."""
        return max(self.blocks_per_core)

    @property
    def mean_blocks(self) -> float:
        return self.n_blocks / self.n_cores

    @property
    def imbalance(self) -> float:
        """max/mean load ratio: 1.0 = perfectly balanced (unweighted)."""
        return self.max_blocks / self.mean_blocks if self.n_blocks else 1.0

    @property
    def finish_times(self) -> tuple[float, ...]:
        """Per-core finish time in block-rounds of a unit-speed core:
        ``blocks_i / speed_i`` (``blocks_i`` when speeds are uniform)."""
        if self.core_speeds is None:
            return tuple(float(b) for b in self.blocks_per_core)
        # Zero-speed (dead) cores hold zero blocks by construction, so
        # they finish at 0 rather than 0/0.
        return tuple(b / s if s > 0 else 0.0
                     for b, s in zip(self.blocks_per_core,
                                     self.core_speeds))

    @property
    def makespan(self) -> float:
        """The slowest core's finish time (weighted rounds)."""
        return max(self.finish_times)

    @property
    def weighted_imbalance(self) -> float:
        """makespan over the ideal fluid makespan ``n_blocks / Σspeed``:
        1.0 = the heterogeneous cluster is perfectly speed-balanced."""
        if not self.n_blocks:
            return 1.0
        speeds = self.core_speeds or (1.0,) * self.n_cores
        return self.makespan / (self.n_blocks / sum(speeds))

    @property
    def idle_core_cycles_frac(self) -> float:
        """Fraction of cluster core-cycles wasted idle at the tail."""
        total = self.max_blocks * self.n_cores
        return (total - self.n_blocks) / total if total else 0.0

    def cores_active(self, round_idx: int) -> int:
        """Cores still computing in round ``round_idx`` (0-based) — the
        contention model uses round-0 occupancy (the steady state)."""
        return sum(1 for b in self.blocks_per_core if b > round_idx)


def block_cyclic(n_blocks: int, n_cores: int) -> WorkAssignment:
    """Core ``i`` gets blocks ``i, i+n_cores, i+2·n_cores, ...``."""
    if n_blocks < 0 or n_cores < 1:
        raise ValueError(f"bad assignment: {n_blocks} blocks, {n_cores} cores")
    per_core = tuple(
        n_blocks // n_cores + (1 if i < n_blocks % n_cores else 0)
        for i in range(n_cores))
    return WorkAssignment(n_blocks=n_blocks, n_cores=n_cores,
                          blocks_per_core=per_core)


def _static_proportional(n_blocks: int, speeds: tuple[float, ...]
                         ) -> tuple[int, ...]:
    """Largest-remainder apportionment of ``n_blocks`` over ``speeds``."""
    total_speed = sum(speeds)
    quotas = [n_blocks * s / total_speed for s in speeds]
    base = [int(q) for q in quotas]
    rema = [q - b for q, b in zip(quotas, base)]
    # Conservation under float drift: hand out (or claw back) one block at
    # a time by fractional remainder, lowest core index winning ties.
    while sum(base) < n_blocks:
        i = max(range(len(base)), key=lambda i: (rema[i], -i))
        base[i] += 1
        rema[i] -= 1.0
    while sum(base) > n_blocks:
        i = min(range(len(base)), key=lambda i: (rema[i], -i))
        if base[i] == 0:
            rema[i] += 1.0       # can't go negative; retry elsewhere
            continue
        base[i] -= 1
        rema[i] += 1.0
    return tuple(base)


def _lpt(n_blocks: int, speeds: tuple[float, ...]) -> tuple[int, ...]:
    """Greedy earliest-finish-time: identical blocks, so LPT degenerates to
    repeatedly loading the core that would complete its next block first."""
    counts = [0] * len(speeds)
    for _ in range(n_blocks):
        i = min(range(len(speeds)),
                key=lambda i: ((counts[i] + 1) / speeds[i], i))
        counts[i] += 1
    return tuple(counts)


def assign(n_blocks: int, core_speeds: tuple[float, ...] | list[float],
           strategy: str = "block_cyclic") -> WorkAssignment:
    """Distribute ``n_blocks`` identical blocks over cores of the given
    relative ``core_speeds`` (island frequencies, typically).

    ``block_cyclic`` ignores the speeds (the homogeneous rule, kept for
    comparison); the weighted strategies match shares to speeds.  With
    uniform speeds every strategy reduces exactly to ``block_cyclic``.
    """
    speeds = tuple(float(s) for s in core_speeds)
    if n_blocks < 0 or not speeds:
        raise ValueError(f"bad assignment: {n_blocks} blocks, "
                         f"{len(speeds)} cores")
    if any(s < 0 for s in speeds):
        raise ValueError(f"core speeds must be >= 0, got {speeds}")
    if any(s == 0 for s in speeds):
        # Survival masks (repro_torch.resilience): speed 0 marks a dead core.
        # Work routes over the surviving subset by the same strategy —
        # including block_cyclic, which is speed-blind among survivors
        # but must never hand a block to a failed core — and zeros are
        # scattered back so per-core counts stay index-aligned.
        alive = tuple(i for i, s in enumerate(speeds) if s > 0)
        if not alive:
            if n_blocks:
                raise ValueError(f"no core with positive speed to take "
                                 f"{n_blocks} blocks; speeds={speeds}")
            return WorkAssignment(n_blocks=0, n_cores=len(speeds),
                                  blocks_per_core=(0,) * len(speeds),
                                  core_speeds=speeds)
        sub = assign(n_blocks, tuple(speeds[i] for i in alive), strategy)
        per_core = [0] * len(speeds)
        for i, b in zip(alive, sub.blocks_per_core):
            per_core[i] = b
        return WorkAssignment(n_blocks=n_blocks, n_cores=len(speeds),
                              blocks_per_core=tuple(per_core),
                              core_speeds=speeds)
    if strategy == "block_cyclic":
        per_core = block_cyclic(n_blocks, len(speeds)).blocks_per_core
    elif strategy == "static_proportional":
        per_core = _static_proportional(n_blocks, speeds)
    elif strategy == "lpt":
        per_core = _lpt(n_blocks, speeds)
    else:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    return WorkAssignment(n_blocks=n_blocks, n_cores=len(speeds),
                          blocks_per_core=per_core, core_speeds=speeds)


def cluster_compute_cycles(per_block_cycles: int,
                           assignment: WorkAssignment) -> int:
    """Cluster compute latency: the slowest core's serial block rounds.
    (Blocks are independent — no inter-core synchronization inside a
    kernel; one barrier at the end, folded into the prologue constant.)"""
    return per_block_cycles * assignment.max_blocks
