"""Searchable knobs — what the tuner is allowed to change about a plan; the
port's copy of the JAX package's ``repro.tune.space``.

A ``Candidate`` is one complete assignment of every knob; a ``SearchSpace``
is the cross product of per-knob value lists plus a distinguished *default*
candidate (the paper's static Steps 4-7 choices), which is always a member
of the space — that containment is what makes "tuned never worse than
default" a theorem rather than a hope.

Knobs (field-for-field the ``Candidate`` dataclass):

* ``block``      — elements per block (Step 4).  The ladder tops out at the
  workload's Table-I "Max Block" cap; the default *is* the cap.
* ``fuse_fp``    — fuse all FP phases into one FREP loop (fewer FREP setups
  and a shallower pipeline, at the price of coarser overlap).
* ``movers``     — SSR data movers used (Step 6).  Demoting a stream below
  the kernel's natural count turns it into explicit integer-LSU accesses.
* ``pipelined``  — Step-5 software pipelining on/off.  Off shrinks the
  replica set to the Step-4 distinct buffers but serializes the phases.
* ``n_cores``    — cluster scope: active cores (block-cyclic split).
* ``point``      — cluster scope: DVFS operating point (by name).
* ``islands``    — heterogeneous scope: per-island DVFS point names; the
  cores split as evenly as possible over the islands.  ``()`` means
  homogeneous (every core at ``point``); ``("a", "b")`` is a two-island
  big.LITTLE layout.  The tuple length *is* the island-count knob.
* ``strategy``   — heterogeneous scope: how blocks are shared across
  unequal cores (``cluster.scheduler.assign`` strategies).  Irrelevant —
  and ignored — when the islands are uniform, where every strategy
  reduces to block-cyclic.
* ``island_blocks`` — heterogeneous refinement: per-island block sizes,
  parallel to ``islands``.  ``()`` means every island shares the
  ``block`` knob; a uniform tuple canonicalizes onto it, so the
  per-island space strictly contains the shared-block one.  Searched by
  ``repro_torch.api.Tuner.operating_point(per_island_blocks=True)`` as a
  refinement stage rather than a cross-product knob (its valid values
  depend on the island layout).

Adding a knob: add the field to ``Candidate`` (with its static default),
give it a value list in ``default_space``, and teach ``cost.evaluate`` its
price.  Nothing else changes — search, cache keys, and the benchmarks all
iterate the knob set generically.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, fields, replace

from repro_torch.cluster.scheduler import STRATEGIES
from repro_torch.cluster.topology import (NOMINAL_POINT, SNITCH_CLUSTER,
                                          ClusterConfig)
from repro_torch.tune.workloads import Workload


@dataclass(frozen=True)
class Candidate:
    """One complete knob assignment (a point in the search space)."""
    block: int
    fuse_fp: bool = False
    movers: int = 3
    pipelined: bool = True
    n_cores: int = 1
    point: str = NOMINAL_POINT.name
    islands: tuple[str, ...] = ()
    strategy: str = "block_cyclic"
    #: Per-island block sizes, parallel to ``islands``.  ``()`` means every
    #: island shares the ``block`` knob (the pre-refinement plan); a
    #: uniform tuple canonicalizes to the shared knob in ``cost.evaluate``,
    #: so the per-island space strictly contains the shared-block one.
    island_blocks: tuple[int, ...] = ()

    def sort_key(self):
        """Deterministic tie-break order: prefer the larger block, no
        fusion, the natural mover count, pipelining on, fewer cores,
        fewer islands, the simpler schedule, shared block sizes — i.e.
        prefer the candidate closest to the paper's static plan."""
        return (-self.block, self.fuse_fp, -self.movers, not self.pipelined,
                self.n_cores, self.point, len(self.islands), self.islands,
                self.strategy != "block_cyclic", self.strategy,
                len(self.island_blocks), self.island_blocks)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        # Tolerate payloads from older schema revisions (missing fields
        # keep their defaults); JSON round-trips tuples as lists, so
        # restore hashability.
        vals = {f.name: d[f.name] for f in fields(cls) if f.name in d}
        for name in ("islands", "island_blocks"):
            if name in vals:
                vals[name] = tuple(vals[name])
        return cls(**vals)


@dataclass(frozen=True)
class Knob:
    """One searchable parameter: a ``Candidate`` field name + value list."""
    name: str
    values: tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"knob {self.name!r} has no values")
        if self.name not in {f.name for f in fields(Candidate)}:
            raise ValueError(f"knob {self.name!r} is not a Candidate field")


@dataclass(frozen=True)
class SearchSpace:
    """Cross product of knob values, with the static plan as its default."""
    knobs: tuple[Knob, ...]
    default: Candidate

    def __post_init__(self):
        if self.default not in self:
            raise ValueError("default candidate must be a member of the space")

    @property
    def size(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.values)
        return n

    def knob(self, name: str) -> Knob:
        for k in self.knobs:
            if k.name == name:
                return k
        raise KeyError(f"no knob {name!r}; have {[k.name for k in self.knobs]}")

    def candidates(self):
        """Deterministic enumeration of every candidate."""
        names = [k.name for k in self.knobs]
        for combo in itertools.product(*(k.values for k in self.knobs)):
            yield replace(self.default, **dict(zip(names, combo)))

    def __contains__(self, cand: Candidate) -> bool:
        return all(getattr(cand, k.name) in k.values for k in self.knobs)

    def neighbors(self, cand: Candidate):
        """Single-knob moves to adjacent values (local-search moves)."""
        for k in self.knobs:
            vals = list(k.values)
            i = vals.index(getattr(cand, k.name))
            for j in (i - 1, i + 1):
                if 0 <= j < len(vals):
                    yield replace(cand, **{k.name: vals[j]})

    def with_values(self, name: str, values) -> "SearchSpace":
        """Same space with one knob's value list replaced (restricting a
        space for a pinned comparison, or widening it for a new sweep).
        If the default's value falls outside the new list it snaps to the
        list's first entry."""
        values = tuple(values)
        self.knob(name)  # raise KeyError on unknown knobs
        knobs = tuple(Knob(k.name, values) if k.name == name else k
                      for k in self.knobs)
        default = self.default
        if getattr(default, name) not in values:
            default = replace(default, **{name: values[0]})
        return SearchSpace(knobs, default)


def block_ladder(cap: int, rungs: int = 5) -> tuple[int, ...]:
    """Halving ladder topped by the Table-I cap: cap, cap//2, ... (>= 8)."""
    out = [cap]
    b = cap // 2
    while b >= 8 and len(out) < rungs:
        out.append(b)
        b //= 2
    return tuple(sorted(out))


#: Backward-compatible private alias (pre-facade name).
_block_ladder = block_ladder


def island_ladder(cfg: ClusterConfig, max_islands: int = 2,
                  points: tuple[str, ...] | None = None
                  ) -> tuple[tuple[str, ...], ...]:
    """The island-layout knob values for a cluster's DVFS ladder:
    ``()`` (homogeneous at the ``point`` knob), every single-island layout
    (homogeneous at that point — the heterogeneous space strictly contains
    the homogeneous one), and every frequency-descending multi-island
    combination up to ``max_islands`` islands.  ``points`` restricts the
    layouts to a subset of the ladder (by name)."""
    allowed = cfg.operating_points if points is None else \
        tuple(p for p in cfg.operating_points if p.name in points)
    names = [p.name for p in sorted(allowed, key=lambda p: -p.freq_ghz)]
    out: list[tuple[str, ...]] = [()]
    for k in range(1, max_islands + 1):
        out.extend(itertools.combinations(names, k))
    return tuple(out)


def default_space(workload: Workload, cfg: ClusterConfig = SNITCH_CLUSTER,
                  cluster: bool = False,
                  cores: tuple[int, ...] | None = None,
                  points: tuple[str, ...] | None = None,
                  heterogeneous: bool = False,
                  max_islands: int = 2) -> SearchSpace:
    """The standard knob set for a workload.

    Single-PE by default (one core, nominal point — the paper's setting);
    ``cluster=True`` adds the cores x DVFS-point scope;
    ``heterogeneous=True`` (implies cluster) additionally opens the
    DVFS-island layout and the weighted scheduling strategy.  The island
    knob subsumes the point sweep (single-island layouts are the
    homogeneous points), so the ``point`` knob is pinned to its default
    there to avoid a redundant cross product.
    """
    sched = workload.schedule()
    if cluster or heterogeneous:
        cores = cores or tuple(c for c in (1, 2, 4, 8, 16)
                               if c <= cfg.n_cores) or (cfg.n_cores,)
        points = points or tuple(p.name for p in cfg.operating_points)
    else:
        cores = cores or (1,)
        points = points or (cfg.nominal.name,)
    default_point = (cfg.nominal.name if cfg.nominal.name in points
                     else points[0])
    if heterogeneous:
        # The island knob subsumes the point sweep, but must respect the
        # caller's point restriction; the point knob pins to its default.
        island_values = island_ladder(cfg, max_islands, points)
        points = (default_point,)
    knobs = (
        Knob("block", _block_ladder(workload.max_block)),
        Knob("fuse_fp", (False, True) if len(sched.fp_bodies) > 1
             else (False,)),
        Knob("movers", tuple(range(1, sched.n_ssrs + 1))),
        Knob("pipelined", (True, False)),
        Knob("n_cores", tuple(sorted(cores))),
        Knob("point", tuple(points)),
    )
    if heterogeneous:
        knobs += (
            Knob("islands", island_values),
            Knob("strategy", STRATEGIES),
        )
    default = Candidate(
        block=workload.max_block, fuse_fp=False, movers=sched.n_ssrs,
        pipelined=True, n_cores=max(cores), point=default_point)
    return SearchSpace(knobs, default)
