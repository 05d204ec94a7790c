"""Hierarchical scheduling: work blocks → clusters → cores; a self-standing
copy of the JAX package's ``repro.system.scheduler``.

Both levels reuse :func:`repro_torch.cluster.scheduler.assign` — the system just
runs it twice.  Level 1 splits the blocks across clusters weighted by each
cluster's *aggregate* core speed (the fluid-model throughput of the
cluster); level 2 splits each cluster's share across its cores with the
per-core strategy the ``Target`` carries.

Invariants (property-tested against the JAX package's):

* conservation — the per-core counts sum to ``n_blocks`` across the whole
  part, at both levels;
* uniform reduction — on identical clusters of identical cores, the
  flattened per-core counts are the same *multiset* as a single-level
  ``assign`` over all cores (hierarchical block-cyclic = flat block-cyclic
  up to core naming);
* 1-cluster degenerate case — the inner assignment IS the single-cluster
  assignment, verbatim (the top level hands the lone cluster everything).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.cluster.scheduler import WorkAssignment, assign


@dataclass(frozen=True)
class SystemAssignment:
    """Blocks → clusters → cores, with the flattened per-core view."""

    n_blocks: int
    cluster_assignment: WorkAssignment
    core_assignments: tuple[WorkAssignment, ...]

    @property
    def cluster_blocks(self) -> tuple[int, ...]:
        return self.cluster_assignment.blocks_per_core

    @property
    def flat(self) -> WorkAssignment:
        """One ``WorkAssignment`` over every core of every cluster — the
        view the system ``Report`` prices imbalance on, so the metric is
        the same expression the single-cluster path uses."""
        blocks = tuple(b for a in self.core_assignments
                       for b in a.blocks_per_core)
        speeds = tuple(s for a in self.core_assignments
                       for s in (a.core_speeds or ()))
        return WorkAssignment(n_blocks=self.n_blocks, n_cores=len(blocks),
                              blocks_per_core=blocks,
                              core_speeds=speeds or None)


def assign_system(n_blocks: int,
                  cluster_core_speeds: tuple[tuple[float, ...], ...],
                  cluster_strategy: str = "block_cyclic",
                  core_strategy: str = "block_cyclic") -> SystemAssignment:
    """Two-level assignment over ``cluster_core_speeds[i][j]`` (cluster
    *i*, core *j*).  Each level is a plain ``cluster.scheduler.assign``."""
    if not cluster_core_speeds:
        raise ValueError("need at least one cluster")
    agg = tuple(float(sum(speeds)) for speeds in cluster_core_speeds)
    top = assign(n_blocks, agg, cluster_strategy)
    inner = tuple(assign(share, speeds, core_strategy)
                  for share, speeds in zip(top.blocks_per_core,
                                           cluster_core_speeds))
    return SystemAssignment(n_blocks=n_blocks, cluster_assignment=top,
                            core_assignments=inner)
