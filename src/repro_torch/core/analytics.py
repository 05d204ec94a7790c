"""Paper Eq. 1–3 and Table I — the COPIFT analytical performance model.

A self-standing copy of the JAX package's ``repro.core.analytics``, which
imports nothing of JAX; the port keeps its own so that it imports nothing of
``repro``.  These four quantities drive the whole evaluation:

* thread imbalance   ``TI  = min(ni, nf) / max(ni, nf)``                (base counts)
* expected speedup   ``S'  = (ni_b + nf_b) / max(ni_c, nf_c)``          (Eq. 1)
* expected IPC gain  ``I'  = (ni_c + nf_c) / max(ni_c, nf_c)``          (Eq. 2)
* count-free approx  ``S'' = 1 + TI``                                   (Eq. 3)

`TABLE_I` transcribes the paper's measured per-kernel instruction counts and
buffer/bookkeeping characteristics; ``tests/test_torch_api.py`` holds every
row and derived column against the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KernelCounts:
    """Static per-loop-iteration instruction counts for one kernel."""
    name: str
    n_int_base: int
    n_fp_base: int
    n_int_copift: int
    n_fp_copift: int
    # Step 4 / Steps 5–6 bookkeeping (Table I middle columns):
    int_ldst_delta: int = 0        # integer load-stores added by Step 4
    n_buffers_step4: int = 0       # distinct spill buffers after Step 4
    fp_ldst_delta: int = 0         # FP load-stores removed by Step 6
    n_buffers_step6: int = 0       # buffer replicas after Steps 5–6
    max_block: int = 0             # largest block fitting L1 (Table I)
    needs_fcvt_d_w: bool = False   # requires COPIFT cft.fcvt.d.w
    needs_flt_d: bool = False      # requires COPIFT cft.flt.d
    uses_issr: bool = False        # maps Type-1 deps to ISSRs

    # ---- derived columns (Eq. 1–3) ----
    @property
    def thread_imbalance(self) -> float:
        return min(self.n_int_base, self.n_fp_base) / max(self.n_int_base,
                                                          self.n_fp_base)

    @property
    def s_prime(self) -> float:
        """Eq. 1 — expected speedup from instruction counts."""
        return (self.n_int_base + self.n_fp_base) / max(self.n_int_copift,
                                                        self.n_fp_copift)

    @property
    def i_prime(self) -> float:
        """Eq. 2 — expected IPC improvement."""
        return (self.n_int_copift + self.n_fp_copift) / max(self.n_int_copift,
                                                            self.n_fp_copift)

    @property
    def s_double_prime(self) -> float:
        """Eq. 3 — speedup approximation from baseline counts alone."""
        return 1.0 + self.thread_imbalance


#: Paper Table I, transcribed.  Columns: baseline #Int/#FP, TI; Step 4
#: int-ld/st delta + #buffers; Steps 5–6 FP-ld/st delta + #buffer replicas;
#: max block; COPIFT #Int/#FP; derived I', S'', S' (checked, not stored).
TABLE_I: dict[str, KernelCounts] = {
    "expf": KernelCounts("expf", 43, 52, 43, 36,
                         int_ldst_delta=0, n_buffers_step4=5,
                         fp_ldst_delta=-4, n_buffers_step6=13, max_block=157),
    "logf": KernelCounts("logf", 39, 52, 57, 36,
                         int_ldst_delta=+4, n_buffers_step4=6,
                         fp_ldst_delta=-4, n_buffers_step6=12, max_block=273,
                         needs_fcvt_d_w=True, uses_issr=True),
    "poly_lcg": KernelCounts("poly_lcg", 44, 80, 72, 80,
                             int_ldst_delta=+3, n_buffers_step4=3,
                             fp_ldst_delta=0, n_buffers_step6=6, max_block=341,
                             needs_fcvt_d_w=True, needs_flt_d=True),
    "pi_lcg": KernelCounts("pi_lcg", 44, 56, 72, 56,
                           int_ldst_delta=+3, n_buffers_step4=3,
                           fp_ldst_delta=0, n_buffers_step6=6, max_block=341,
                           needs_fcvt_d_w=True, needs_flt_d=True),
    "poly_xoshiro128p": KernelCounts("poly_xoshiro128p", 172, 80, 200, 80,
                                     int_ldst_delta=+3, n_buffers_step4=3,
                                     fp_ldst_delta=0, n_buffers_step6=6,
                                     max_block=341,
                                     needs_fcvt_d_w=True, needs_flt_d=True),
    "pi_xoshiro128p": KernelCounts("pi_xoshiro128p", 172, 56, 200, 56,
                                   int_ldst_delta=+3, n_buffers_step4=3,
                                   fp_ldst_delta=0, n_buffers_step6=6,
                                   max_block=341,
                                   needs_fcvt_d_w=True, needs_flt_d=True),
}

#: The derived columns as printed in the paper (for regression-testing our
#: formulas against the publication, rounded as the paper rounds them).
TABLE_I_PRINTED: dict[str, dict[str, float]] = {
    "expf":             dict(ti=0.83, i_prime=1.84, s_pp=1.83, s_prime=2.21),
    "logf":             dict(ti=0.75, i_prime=1.63, s_pp=1.75, s_prime=1.60),
    "poly_lcg":         dict(ti=0.55, i_prime=1.90, s_pp=1.55, s_prime=1.55),
    "pi_lcg":           dict(ti=0.79, i_prime=1.78, s_pp=1.79, s_prime=1.39),
    "poly_xoshiro128p": dict(ti=0.47, i_prime=1.40, s_pp=1.47, s_prime=1.26),
    "pi_xoshiro128p":   dict(ti=0.33, i_prime=1.28, s_pp=1.33, s_prime=1.14),
}

#: Headline aggregates the paper reports (abstract / §III) — the calibration
#: and validation targets for timing.py and energy.py.
PAPER_HEADLINE = dict(
    geomean_speedup=1.47,
    peak_speedup=2.05,           # expf
    peak_ipc=1.75,
    geomean_ipc_gain=1.62,
    geomean_power_ratio=1.07,
    max_power_ratio=1.17,
    geomean_energy_saving=1.37,
    peak_energy_saving=1.93,     # expf
)


def geomean(xs) -> float:
    import math
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def table_rows(counts: dict[str, KernelCounts] | None = None) -> list[dict]:
    """Materialize Table I (all columns, derived included), ordered by the
    expected speedup S', largest first, as the paper orders it."""
    counts = counts or TABLE_I
    rows = []
    for k in counts.values():
        rows.append(dict(
            kernel=k.name, n_int=k.n_int_base, n_fp=k.n_fp_base,
            ti=k.thread_imbalance,
            int_ldst=k.int_ldst_delta, buff4=k.n_buffers_step4,
            fp_ldst=k.fp_ldst_delta, buff6=k.n_buffers_step6,
            max_block=k.max_block,
            n_int_cft=k.n_int_copift, n_fp_cft=k.n_fp_copift,
            i_prime=k.i_prime, s_pp=k.s_double_prime, s_prime=k.s_prime,
        ))
    rows.sort(key=lambda r: -r["s_prime"])
    return rows
