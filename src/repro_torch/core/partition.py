"""COPIFT Steps 2–3 — acyclic min-cut phase partitioning and reordering.

The port's copy of the JAX package's ``repro.core.partition``, over the
port's ordered :class:`~repro_torch.core.dfg.DiGraph`.

Given the typed DFG from :mod:`repro_torch.core.dfg`, produce an ordered list of
domain-pure *phases* (paper: "subgraphs, each defining a phase of the
computation with clear ordering requirements w.r.t. the others") such that

* every phase contains only INT-domain or only FP-domain nodes,
* the quotient graph of phases is acyclic and compatible with the phase
  order (all edges go from earlier to later phases),
* the number of int↔fp cut edges — which become block-sized memory buffers
  in Step 4 — is minimized (heuristically: affinity-driven list scheduling
  followed by a local-improvement pass).

The expf walk-through in the paper (Fig. 1c→1d) yields FP Phase 0 →
INT Phase 1 → FP Phase 2 with 4 cut edges; ``tests/test_core_partition.py``
asserts we reproduce exactly that structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.dfg import DiGraph
from repro_torch.core.isa import DepType, Domain


@dataclass
class Phase:
    index: int
    domain: Domain
    nodes: list[int] = field(default_factory=list)

    @property
    def weight(self) -> int:
        return len(self.nodes)


@dataclass
class Partition:
    phases: list[Phase]
    cut_edges: list[tuple[int, int, DepType]]
    node_phase: dict[int, int]

    @property
    def n_cuts(self) -> int:
        return len(self.cut_edges)

    @property
    def cross_cuts(self) -> list[tuple[int, int, DepType]]:
        """Cut edges that cross the int/fp domain boundary — the ones that
        become block-sized spill buffers in Step 4 (paper's count)."""
        return [(u, v, d) for (u, v, d) in self.cut_edges
                if d is not DepType.INTRA]

    @property
    def n_cross_cuts(self) -> int:
        return len(self.cross_cuts)

    def phase_of(self, node: int) -> int:
        return self.node_phase[node]

    def validate(self, g: DiGraph) -> None:
        """Raise if the partition violates COPIFT's invariants."""
        for u, v in g.edges():
            pu, pv = self.node_phase[u], self.node_phase[v]
            if pu > pv:
                raise AssertionError(
                    f"edge {u}->{v} goes backwards across phases {pu}->{pv}")
        for ph in self.phases:
            doms = {g.nodes[n]["domain"] for n in ph.nodes}
            # MEM/CTRL nodes are absorbed by whichever thread issues them;
            # purity is about the int/fp execution domains only.
            core = doms & {Domain.INT, Domain.FP}
            if len(core) > 1:
                raise AssertionError(f"phase {ph.index} mixes domains {core}")


def _effective_domain(g: DiGraph, n: int) -> Domain:
    """MEM/CTRL nodes are absorbed into the thread that issues them: FP loads/
    stores ride the FPSS (→ FP), everything else the integer core (→ INT)."""
    d = g.nodes[n]["domain"]
    if d in (Domain.INT, Domain.FP):
        return d
    if d is Domain.MEM:
        # FP-typed memory ops were already reassigned by the trace front-end;
        # aten-graph MEM nodes follow the majority domain of their neighbours.
        doms = [g.nodes[m]["domain"] for m in list(g.predecessors(n)) + list(g.successors(n))
                if g.nodes[m]["domain"] in (Domain.INT, Domain.FP)]
        if doms:
            return max(set(doms), key=doms.count)
    return Domain.INT


def partition(g: DiGraph, max_phases: int | None = None) -> Partition:
    """Affinity-driven list scheduling: sweep a topological order, keeping the
    current phase open while same-domain nodes are ready; switch domains (and
    open a new phase) only when forced.  Ties are broken to prefer nodes whose
    predecessors are all in closed phases, which minimizes cut edges.
    """
    eff = {n: _effective_domain(g, n) for n in g.nodes}
    indeg = {n: g.in_degree(n) for n in g.nodes}
    ready = [n for n, d in indeg.items() if d == 0]

    phases: list[Phase] = []
    node_phase: dict[int, int] = {}

    def start_phase(domain: Domain) -> Phase:
        ph = Phase(index=len(phases), domain=domain)
        phases.append(ph)
        return ph

    current: Phase | None = None
    remaining = set(g.nodes)
    while remaining:
        # Candidates in the current domain first.
        ready.sort()
        pick = None
        if current is not None:
            for n in ready:
                if eff[n] == current.domain:
                    pick = n
                    break
        if pick is None:
            # Forced domain switch: choose the domain with the most ready
            # work to keep phases large (fewer phases → fewer buffers).
            if not ready:
                raise AssertionError("graph has a cycle")
            by_dom: dict[Domain, int] = {}
            for n in ready:
                by_dom[eff[n]] = by_dom.get(eff[n], 0) + 1
            dom = max(by_dom, key=lambda d: by_dom[d])
            current = start_phase(dom)
            pick = next(n for n in ready if eff[n] == dom)
        ready.remove(pick)
        remaining.discard(pick)
        current.nodes.append(pick)
        node_phase[pick] = current.index
        for s in g.successors(pick):
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)

    part = Partition(phases=phases, cut_edges=[], node_phase=node_phase)
    _improve(g, part, eff)
    _coalesce(g, part)
    if max_phases is not None and len(part.phases) > max_phases:
        raise ValueError(
            f"partition needs {len(part.phases)} phases > max {max_phases}")
    part.cut_edges = _collect_cuts(g, part)
    part.validate(g)
    return part


def _collect_cuts(g: DiGraph, part: Partition) -> list[tuple[int, int, DepType]]:
    cuts = []
    for u, v, data in g.edges(data=True):
        if part.node_phase[u] != part.node_phase[v]:
            cuts.append((u, v, data.get("dep", DepType.INTRA)))
    return cuts


def _improve(g: DiGraph, part: Partition, eff: dict[int, Domain]) -> None:
    """Local improvement: move a node to an adjacent same-domain phase when
    that strictly reduces the number of cut edges and keeps all edges forward.
    A few sweeps suffice on kernel-sized graphs."""
    for _ in range(4):
        moved = False
        for n in list(g.nodes):
            p = part.node_phase[n]
            for cand in (p - 2, p + 2):  # same-domain phases alternate
                if cand < 0 or cand >= len(part.phases):
                    continue
                if part.phases[cand].domain != eff[n]:
                    continue
                lo = min(part.node_phase[m] for m in g.successors(n)) \
                    if g.out_degree(n) else len(part.phases)
                hi = max(part.node_phase[m] for m in g.predecessors(n)) \
                    if g.in_degree(n) else -1
                if not (hi <= cand <= lo):
                    continue
                before = _node_cut_count(g, part, n)
                part.phases[p].nodes.remove(n)
                part.phases[cand].nodes.append(n)
                part.node_phase[n] = cand
                after = _node_cut_count(g, part, n)
                if after < before:
                    moved = True
                else:  # revert
                    part.phases[cand].nodes.remove(n)
                    part.phases[p].nodes.append(n)
                    part.node_phase[n] = p
        # Drop empty phases and reindex.
        if any(not ph.nodes for ph in part.phases):
            part.phases = [ph for ph in part.phases if ph.nodes]
            for i, ph in enumerate(part.phases):
                ph.index = i
                for n in ph.nodes:
                    part.node_phase[n] = i
        if not moved:
            break


def _coalesce(g: DiGraph, part: Partition) -> None:
    """Merge an entire phase into the next same-domain phase when legal
    (every member's successors lie at or beyond the target).  Collapses the
    free-floating bookkeeping mini-phases the list sweep tends to open first,
    yielding the paper's canonical FP→INT→FP shape for expf."""
    changed = True
    while changed:
        changed = False
        for i, ph in enumerate(part.phases):
            target = i + 2
            if target >= len(part.phases):
                continue
            if part.phases[target].domain != ph.domain:
                continue
            ok = all(
                all(part.node_phase[s] >= target or part.node_phase[s] == i
                    for s in g.successors(n))
                for n in ph.nodes)
            if not ok:
                continue
            part.phases[target].nodes.extend(ph.nodes)
            for n in ph.nodes:
                part.node_phase[n] = target
            ph.nodes = []
            part.phases = [p for p in part.phases if p.nodes]
            for j, p in enumerate(part.phases):
                p.index = j
                for n in p.nodes:
                    part.node_phase[n] = j
            changed = True
            break


def _node_cut_count(g: DiGraph, part: Partition, n: int) -> int:
    c = 0
    for m in g.predecessors(n):
        if part.node_phase[m] != part.node_phase[n]:
            c += 1
    for m in g.successors(n):
        if part.node_phase[m] != part.node_phase[n]:
            c += 1
    return c


def reorder(trace_len: int, part: Partition) -> list[int]:
    """Step 3 — the reordered instruction sequence: phases concatenated in
    order, original program order preserved within each phase."""
    order: list[int] = []
    for ph in part.phases:
        order.extend(sorted(ph.nodes))
    assert len(order) == trace_len
    return order
