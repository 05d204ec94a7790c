"""Banked-TCDM conflict model — how sharing the L1 degrades each PE.

The port's copy of the JAX package's ``repro.cluster.contention``, plain
Python, so that its numbers equal the JAX package's bit for bit.

The Snitch TCDM is word-interleaved across ``tcdm_banks`` single-ported SRAM
banks behind a single-cycle crossbar: two requests to the same bank in the
same cycle serialize.  The single-PE timing model already charges the
*intra*-core conflict rate (SSR movers vs the integer LSU — the calibrated
0.25 stalls/access in ``core/timing.py``); this module derives the
*inter*-core surcharge as a function of how many cores are active and how
they access memory, and feeds it back through the ``extra_contention`` hook
of ``copift_block_timing`` / ``baseline_timing``.

Model (first-order banked-memory analysis): a core presents ``r`` memory
requests per cycle (integer-LSU accesses plus SSR stream beats).  Under
uniform bank mapping, the expected number of *other-core* requests landing
on the bank a given access targets is ``(n-1)·r/banks``; each such collision
serializes one cycle and on average an access waits behind half of them:

    extra_stalls_per_access(n) = ½ · (n-1) · r · pattern / banks

``pattern`` reflects the access pattern: COPIFT's affine SSR streams sweep
banks in order (cores offset by whole blocks rarely align → 0.5), while ISSR
gather streams (logf's table lookups) are data-dependent and behave like
uniform random traffic (1.0).  The surcharge is exactly zero at n=1, which
is what keeps the cluster model's single-core reduction bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from repro_torch.cluster.topology import ClusterConfig
from repro_torch.core.analytics import TABLE_I
from repro_torch.core.isa import count_mem_accesses
from repro_torch.core.kernels_isa import baseline_trace, copift_schedule
from repro_torch.core.timing import baseline_timing, copift_block_timing
from repro_torch.obs import metrics as _metrics

#: Pattern factors: affine SSR streams conflict less than random gathers.
PATTERN_AFFINE = 0.5
PATTERN_RANDOM = 1.0

#: Upper bound on stalls/access — past this the crossbar round-robins and
#: the model's linearity assumption is void anyway.
MAX_EXTRA_STALLS = 4.0


@dataclass(frozen=True)
class AccessProfile:
    """One core's steady-state TCDM traffic for a kernel variant."""
    name: str
    requests_per_cycle: float     # LSU + SSR beats, per core-cycle
    pattern: float                # PATTERN_AFFINE | PATTERN_RANDOM mix

    def extra_stalls(self, cfg: ClusterConfig, n_active: int) -> float:
        """Inter-core stall surcharge per access; zero when alone."""
        if n_active <= 1:
            return 0.0
        extra = 0.5 * (n_active - 1) * self.requests_per_cycle \
            * self.pattern / cfg.tcdm_banks
        extra = min(extra, MAX_EXTRA_STALLS)
        _metrics.observe("cluster.contention.stalls_per_access", extra)
        return extra

    def extra_stalls_het(self, cfg: ClusterConfig,
                         core_speeds: tuple[float, ...],
                         core_idx: int) -> float:
        """Inter-core stall surcharge per access *seen by core ``core_idx``*
        when the active cores run at different clock rates.

        A faster neighbor lands proportionally more requests per victim-core
        cycle, so the homogeneous ``(n-1)`` other-core count generalizes to
        ``Σ_{j≠i} f_j / f_i`` (the pressure in units of the victim's own
        cycles).  With uniform speeds every ratio is exactly 1.0 and the
        pressure sum is exactly ``n-1`` — same float expression, bit-for-bit
        the homogeneous surcharge (the reduction invariant).
        """
        if len(core_speeds) <= 1:
            return 0.0
        f_i = core_speeds[core_idx]
        pressure = sum(f_j / f_i
                       for j, f_j in enumerate(core_speeds) if j != core_idx)
        extra = 0.5 * pressure * self.requests_per_cycle \
            * self.pattern / cfg.tcdm_banks
        extra = min(extra, MAX_EXTRA_STALLS)
        _metrics.observe("cluster.contention.stalls_per_access", extra)
        return extra


@lru_cache(maxsize=None)
def copift_profile(name: str) -> AccessProfile:
    """TCDM request rate of one COPIFT PE running kernel ``name`` at its
    Table-I max block, from the calibrated single-PE timing."""
    sched = copift_schedule(name)
    block = TABLE_I[name].max_block
    bt = copift_block_timing(sched, block)
    int_mem = count_mem_accesses(sched.int_body) * block
    stream_beats = 2 * sched.n_ssrs * block      # as in energy.py
    pattern = PATTERN_RANDOM if TABLE_I[name].uses_issr else PATTERN_AFFINE
    return AccessProfile(name=name,
                         requests_per_cycle=(int_mem + stream_beats) / bt.cycles,
                         pattern=pattern)


@lru_cache(maxsize=None)
def baseline_profile(name: str) -> AccessProfile:
    """TCDM request rate of one RV32G baseline PE (LSU only, no SSRs)."""
    trace = baseline_trace(name)
    block = TABLE_I[name].max_block
    bt = baseline_timing(trace, block)
    accesses = count_mem_accesses(trace.instrs) * block
    return AccessProfile(name=name,
                         requests_per_cycle=accesses / bt.cycles,
                         pattern=PATTERN_RANDOM)


# The profiles cache simulator-derived request rates; register them so
# repro_torch.perf.clear_all() resets the whole pricing stack.
from repro_torch.perf.memo import register_cache as _register_cache  # noqa: E402

_register_cache(copift_profile.cache_clear)
_register_cache(baseline_profile.cache_clear)


def copift_extra_contention(cfg: ClusterConfig, name: str,
                            n_active: int) -> float:
    """Stalls/access to add to ``copift_block_timing`` for ``n_active``
    concurrent COPIFT PEs (0.0 at one core — the reduction invariant)."""
    return copift_profile(name).extra_stalls(cfg, n_active)


def baseline_extra_contention(cfg: ClusterConfig, name: str,
                              n_active: int) -> float:
    """Stalls/access for ``n_active`` concurrent baseline PEs."""
    return baseline_profile(name).extra_stalls(cfg, n_active)


def copift_extra_contention_het(cfg: ClusterConfig, name: str,
                                core_speeds: tuple[float, ...]
                                ) -> tuple[float, ...]:
    """Per-core stalls/access for active COPIFT PEs at (possibly) different
    clock rates — ``core_speeds`` lists only the *active* cores' relative
    frequencies.  Uniform speeds reproduce the homogeneous surcharge
    bit-for-bit for every core."""
    prof = copift_profile(name)
    return tuple(prof.extra_stalls_het(cfg, core_speeds, i)
                 for i in range(len(core_speeds)))


def baseline_extra_contention_het(cfg: ClusterConfig, name: str,
                                  core_speeds: tuple[float, ...]
                                  ) -> tuple[float, ...]:
    """Per-core stalls/access for active baseline PEs at different rates."""
    prof = baseline_profile(name)
    return tuple(prof.extra_stalls_het(cfg, core_speeds, i)
                 for i in range(len(core_speeds)))
