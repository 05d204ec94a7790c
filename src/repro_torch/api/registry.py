"""``KernelSpec`` — kernels as registry objects, as in ``repro.api``.

A ``KernelSpec`` binds every view of one kernel: its ISA schedule in the
analytic model (``isa_name``), its tunable workload (``workload``), its
runnable entry point (``op``) and its plain oracle (``reference``), plus
its default problem size.  The registry resolves any of the historical
names (``"montecarlo"`` → ``pi_xoshiro128p``) to the same spec.  Names,
aliases and documentation equal the JAX package's; ``op`` and
``reference`` point into ``repro_torch.kernels``.

``schedule``, ``baseline_trace`` and ``get_workload`` answer from the
port's analytic model (``core.kernels_isa``, ``tune.workloads``).  The
spec's callables are dotted references resolved at first use, so importing
this module imports no kernel.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

from repro_torch.core.analytics import TABLE_I
from repro_torch.core.kernels_isa import KERNELS as ISA_KERNELS


def _resolve_ref(ref: str):
    """``"pkg.mod:attr"`` -> the attribute, imported on first use."""
    mod, _, attr = ref.partition(":")
    if not mod or not attr:
        raise ValueError(f"bad callable reference {ref!r}: expected "
                         f"'package.module:attribute'")
    return getattr(importlib.import_module(mod), attr)


@dataclass(frozen=True)
class KernelSpec:
    """One kernel, every view of it.

    ``isa_name``   name in the analytic model's ISA registry (``None`` for
                   tuner-only kernels like ``prng``);
    ``workload``   name in the tuner's workload registry (``None`` for
                   kernels without a tunable schedule);
    ``op``         dotted reference to the entry point
                   (``"repro_torch.kernels.ops:exp"``), resolved lazily;
    ``reference``  dotted reference to the plain oracle.
    """
    name: str
    isa_name: str | None = None
    workload: str | None = None
    op: str | None = None
    reference: str | None = None
    default_problem: int = 1 << 14
    doc: str = ""
    aliases: tuple[str, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.isa_name is not None and self.isa_name not in ISA_KERNELS:
            raise ValueError(f"isa_name {self.isa_name!r} is not in the ISA "
                             f"registry; known: {sorted(ISA_KERNELS)}")

    # -- capability probes --------------------------------------------------

    @property
    def simulatable(self) -> bool:
        """Does the analytic model have an ISA schedule for this spec?"""
        return self.isa_name is not None

    @property
    def tunable(self) -> bool:
        """Does the tuner have a workload for this spec?"""
        return self.workload is not None

    @property
    def max_block(self) -> int:
        """Step-4 block-size cap: Table I for ISA kernels, the workload's
        L1-budget derivation otherwise."""
        if self.isa_name is not None:
            return TABLE_I[self.isa_name].max_block
        return self.get_workload().max_block

    # -- bound machinery ----------------------------------------------------

    @property
    def table_i(self):
        """The paper's Table-I row (``core.analytics.TABLE_I``) for
        simulatable kernels."""
        if self.isa_name is None:
            raise ValueError(f"kernel {self.name!r} has no ISA view and "
                             f"hence no Table-I row")
        return TABLE_I[self.isa_name]

    def schedule(self):
        """The COPIFT ``CopiftSchedule`` (ISA view when available, else the
        workload's synthetic schedule)."""
        if self.isa_name is not None:
            from repro_torch.core.kernels_isa import copift_schedule
            return copift_schedule(self.isa_name)
        return self.get_workload().schedule()

    def baseline_trace(self):
        """The RV32G baseline ``KernelTrace`` (ISA view) — what the
        single-issue simulator and the Table-I analytics consume."""
        if self.isa_name is None:
            raise ValueError(f"kernel {self.name!r} has no ISA view; "
                             f"simulatable kernels: "
                             f"{[s.name for s in specs() if s.simulatable]}")
        from repro_torch.core.kernels_isa import baseline_trace
        return baseline_trace(self.isa_name)

    def get_workload(self):
        """The bound ``tune.workloads.Workload``.  Raises ``KeyError`` for
        untunable kernels — the same failure class as an unknown workload
        name, so tune-optional consumers catch one exception."""
        if self.workload is None:
            raise KeyError(
                f"kernel {self.name!r} has no tunable workload; tunable "
                f"kernels: {[s.name for s in specs() if s.tunable]}")
        from repro_torch.tune.workloads import get_workload
        return get_workload(self.workload)

    def run(self, *args, **kwargs):
        """Call the entry point (the CUDA kernel on the card, the plain
        version on the CPU, per the active ``repro_torch.api.config``)."""
        if self.op is None:
            raise ValueError(f"kernel {self.name!r} has no runnable entry "
                             f"point (model-only kernel)")
        return _resolve_ref(self.op)(*args, **kwargs)

    def ref(self, *args, **kwargs):
        """Call the plain oracle."""
        if self.reference is None:
            raise ValueError(f"kernel {self.name!r} has no reference "
                             f"implementation")
        return _resolve_ref(self.reference)(*args, **kwargs)


_OPS = "repro_torch.kernels.ops"
_REF = "repro_torch.kernels.ref"

#: The built-in registry: the paper's six evaluated kernels plus the two
#: serving-path kernels (``prng``, ``softmax``) the tuner knows.
_BUILTINS = (
    KernelSpec("expf", isa_name="expf", workload="expf",
               op=f"{_OPS}:exp", reference=f"{_REF}:exp_ref",
               doc="glibc-expf-style exponential (streaming)"),
    KernelSpec("logf", isa_name="logf", workload="logf",
               op=f"{_OPS}:log", reference=f"{_REF}:log_ref",
               doc="glibc-logf-style logarithm (ISSR table gather)"),
    KernelSpec("poly_lcg", isa_name="poly_lcg",
               doc="polynomial-integral MC, LCG PRNG (in-core)"),
    KernelSpec("pi_lcg", isa_name="pi_lcg",
               doc="pi hit-and-miss MC, LCG PRNG (in-core)"),
    KernelSpec("poly_xoshiro128p", isa_name="poly_xoshiro128p",
               op=f"{_OPS}:mc_poly",
               doc="polynomial-integral MC, xoshiro128+ PRNG"),
    KernelSpec("pi_xoshiro128p", isa_name="pi_xoshiro128p",
               workload="montecarlo", op=f"{_OPS}:mc_pi",
               aliases=("montecarlo",),
               doc="pi hit-and-miss MC, xoshiro128+ PRNG (Table-I hardest)"),
    KernelSpec("prng", workload="prng", op=f"{_OPS}:uniform",
               reference=f"{_REF}:prng_uniform",
               doc="counter-based uniforms (serving-path sampling)"),
    KernelSpec("softmax", workload="softmax", op=f"{_OPS}:softmax",
               reference=f"{_REF}:softmax_ref",
               doc="attention softmax (expf phases + normalization)"),
)

_REGISTRY: dict[str, KernelSpec] = {}
_ALIASES: dict[str, str] = {}


def register_kernel(spec: KernelSpec, overwrite: bool = False) -> KernelSpec:
    """Add a user kernel to the registry (the extension hook).

    The spec's ``name`` and every entry of ``aliases`` become resolvable
    through :func:`kernel`.  Re-registering an existing name requires
    ``overwrite=True`` — a silent clobber would let two subsystems disagree
    about what a name means, which is the failure mode this registry
    replaces.
    """
    taken = ({spec.name, *spec.aliases}
             & (set(_REGISTRY) | set(_ALIASES)))
    if taken and not overwrite:
        raise ValueError(f"kernel name(s) {sorted(taken)} already "
                         f"registered; pass overwrite=True to replace")
    # Purge every stale mapping the new spec shadows: the name/aliases it
    # claims, and the replaced spec's own old aliases — otherwise a stale
    # alias could silently resolve past the new registration (the exact
    # two-subsystems-disagree failure this registry exists to prevent).
    for name in (spec.name, *spec.aliases):
        _ALIASES.pop(name, None)
        _REGISTRY.pop(name, None)
    for alias in [a for a, target in _ALIASES.items()
                  if target == spec.name]:
        del _ALIASES[alias]
    _REGISTRY[spec.name] = spec
    for a in spec.aliases:
        _ALIASES[a] = spec.name
    return spec


for _s in _BUILTINS:
    register_kernel(_s)
del _s


def kernel(name: "str | KernelSpec") -> KernelSpec:
    """Resolve a kernel by any of its names (pass-through for specs)."""
    if isinstance(name, KernelSpec):
        return name
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        known = sorted(set(_REGISTRY) | set(_ALIASES))
        raise KeyError(f"no kernel {name!r} in the registry; "
                       f"known: {known}") from None


def kernels() -> tuple[str, ...]:
    """Registered kernel names (canonical, no aliases)."""
    return tuple(_REGISTRY)


def specs() -> tuple[KernelSpec, ...]:
    return tuple(_REGISTRY.values())
