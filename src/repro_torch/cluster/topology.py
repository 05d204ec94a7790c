"""Cluster topology — the shared-memory context the paper's PEs live in.

The port's copy of the JAX package's ``repro.cluster.topology``, plain
Python, so that its numbers equal the JAX package's bit for bit.

The paper evaluates COPIFT on one Snitch PE, but states its target as
accelerators that "integrate an ever-increasing number of extremely area-
and energy-efficient PEs".  Snitch-class cores ship as *clusters*: N cores
sharing a word-interleaved multi-banked TCDM through a single-cycle
interconnect, fed by one cluster DMA engine (Zaruba et al., arXiv:2002.10143
— 8 cores, 32 banks, 512-bit DMA).  This module is the static description of
that context; the sibling modules derive contention, transfer, scheduling
and DVFS behavior from it.

Operating points follow the lumos-style (freq, vdd) pair convention: each
point names a frequency/voltage pair, and power scales from the nominal
calibration point (1 GHz / 0.8 V — the condition ``core/energy.py``'s
coefficients are calibrated at) as dynamic ∝ f·V² and static ∝ V².
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class OperatingPoint:
    """One DVFS (frequency, voltage) pair."""
    name: str
    freq_ghz: float
    vdd: float

    def dynamic_scale(self, nominal: "OperatingPoint") -> float:
        """Dynamic power multiplier vs the nominal point: P_dyn ∝ f·V²."""
        return (self.freq_ghz / nominal.freq_ghz) * (self.vdd / nominal.vdd) ** 2

    def static_scale(self, nominal: "OperatingPoint") -> float:
        """Leakage multiplier vs nominal: ∝ V² (first-order, fixed temp)."""
        return (self.vdd / nominal.vdd) ** 2


#: The calibration point of ``core/energy.py`` (GF12LP+, 1 GHz, 0.8 V).
NOMINAL_POINT = OperatingPoint("1.00GHz@0.80V", 1.00, 0.80)


@dataclass(frozen=True)
class DvfsIsland:
    """A group of cores sharing one frequency/voltage domain.

    Snitch-class clusters place cores in *islands*: all cores of an island
    see the same (f, V) pair, and islands can differ (big.LITTLE-style).
    A homogeneous cluster is the one-island special case.
    """
    n_cores: int
    point: OperatingPoint

    def __post_init__(self):
        if self.n_cores < 1:
            raise ValueError(f"island needs >= 1 core, got {self.n_cores}")

#: Snitch-cluster DVFS ladder (GF12LP+ style signoff corners around the
#: calibration point; low-voltage points trade frequency for energy).
OPERATING_POINTS: tuple[OperatingPoint, ...] = (
    OperatingPoint("0.50GHz@0.60V", 0.50, 0.60),
    OperatingPoint("0.75GHz@0.70V", 0.75, 0.70),
    NOMINAL_POINT,
    OperatingPoint("1.25GHz@0.90V", 1.25, 0.90),
    OperatingPoint("1.45GHz@1.00V", 1.45, 1.00),
)


@dataclass(frozen=True)
class ClusterConfig:
    """Static cluster parameters (defaults: the published Snitch cluster).

    ``tcdm_banks``            word-interleaved SRAM banks behind the
                              single-cycle crossbar (conflicts serialize);
    ``dma_bytes_per_cycle``   cluster DMA engine width (512-bit = 64 B);
    ``operating_points``      the DVFS ladder available to ``dvfs.py``;
    ``islands``               optional per-island DVFS domains; ``None``
                              means homogeneous (every core at the point
                              the evaluation is asked for);
    ``power_cap_mw``          cluster-level power budget for the
                              energy-optimal-point search (None = uncapped).
    """
    n_cores: int = 8
    tcdm_banks: int = 32
    dma_bytes_per_cycle: float = 64.0
    operating_points: tuple[OperatingPoint, ...] = OPERATING_POINTS
    nominal: OperatingPoint = NOMINAL_POINT
    islands: tuple[DvfsIsland, ...] | None = None
    power_cap_mw: float | None = None

    def __post_init__(self):
        if self.n_cores < 1:
            raise ValueError(f"n_cores must be >= 1, got {self.n_cores}")
        if self.tcdm_banks < 1:
            raise ValueError(f"tcdm_banks must be >= 1, got {self.tcdm_banks}")
        if self.dma_bytes_per_cycle <= 0:
            raise ValueError("dma_bytes_per_cycle must be positive")
        if self.nominal not in self.operating_points:
            raise ValueError("nominal operating point must be in the ladder")
        if self.islands is not None:
            total = sum(i.n_cores for i in self.islands)
            if total != self.n_cores:
                raise ValueError(f"islands cover {total} cores, cluster has "
                                 f"{self.n_cores}")

    def with_cores(self, n_cores: int) -> "ClusterConfig":
        """Same cluster, different core count (banks/DMA held fixed — the
        resource-sharing effect the scaling sweeps measure).  Any island
        layout is dropped: it was sized for the old core count."""
        return replace(self, n_cores=n_cores, islands=None)

    def with_islands(self, *islands: DvfsIsland) -> "ClusterConfig":
        """Same shared resources, cores regrouped into DVFS islands (the
        core count follows the island sizes)."""
        return replace(self, n_cores=sum(i.n_cores for i in islands),
                       islands=tuple(islands))

    def point(self, name: str) -> OperatingPoint:
        """Ladder point by name (the ``Candidate.point`` string)."""
        for p in self.operating_points:
            if p.name == name:
                return p
        raise ValueError(f"operating point {name!r} not in the ladder: "
                         f"{[p.name for p in self.operating_points]}")

    def core_points(self, default: OperatingPoint | None = None
                    ) -> tuple[OperatingPoint, ...]:
        """One operating point per core: the island layout expanded, or
        ``default`` (nominal if unset) replicated when homogeneous."""
        if self.islands is None:
            return (default or self.nominal,) * self.n_cores
        out: list[OperatingPoint] = []
        for isl in self.islands:
            out.extend([isl.point] * isl.n_cores)
        return tuple(out)

    @property
    def is_heterogeneous(self) -> bool:
        """True iff the island layout mixes distinct operating points."""
        return (self.islands is not None
                and len({i.point for i in self.islands}) > 1)


#: The grammar ``parse_islands`` accepts, quoted verbatim in its errors.
_ISLAND_GRAMMAR = ("'<count>@<point-name>[,<count>@<point-name>...]', e.g. "
                   "'2@1.45GHz@1.00V,6@0.50GHz@0.60V'")


def parse_islands(spec: str, cfg: "ClusterConfig") -> tuple[DvfsIsland, ...]:
    """Parse a CLI island spec ``"<count>@<point>,<count>@<point>,..."``
    (e.g. ``"2@1.45GHz@1.00V,6@0.50GHz@0.60V"``) against ``cfg``'s ladder.

    Errors name the offending token (by position) and the expected
    grammar, so a malformed sweep flag fails with an actionable message
    rather than an opaque int() traceback."""
    if not spec or not spec.strip():
        raise ValueError(f"empty island spec; expected {_ISLAND_GRAMMAR}")
    islands = []
    for i, part in enumerate(spec.split(",")):
        part = part.strip()
        where = f"island {i + 1} of {spec!r}"
        if not part:
            raise ValueError(f"empty token at {where}; expected "
                             f"{_ISLAND_GRAMMAR}")
        count, sep, point_name = part.partition("@")
        if not sep or not point_name:
            raise ValueError(f"token {part!r} at {where} has no "
                             f"'@<point-name>' part; expected "
                             f"{_ISLAND_GRAMMAR}")
        try:
            n = int(count)
        except ValueError:
            raise ValueError(f"token {part!r} at {where}: core count "
                             f"{count!r} is not an integer; expected "
                             f"{_ISLAND_GRAMMAR}") from None
        if n < 1:
            raise ValueError(f"token {part!r} at {where}: core count must "
                             f"be >= 1, got {n}; expected {_ISLAND_GRAMMAR}")
        try:
            point = cfg.point(point_name)
        except ValueError:
            raise ValueError(
                f"token {part!r} at {where}: operating point "
                f"{point_name!r} is not in the ladder "
                f"{[p.name for p in cfg.operating_points]}; expected "
                f"{_ISLAND_GRAMMAR}") from None
        islands.append(DvfsIsland(n, point))
    return tuple(islands)


#: The reference 8-core Snitch cluster.
SNITCH_CLUSTER = ClusterConfig()
