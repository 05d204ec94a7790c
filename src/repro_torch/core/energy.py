"""Power/energy model of the Snitch cluster, reproducing Fig. 2b/2c.

The port's copy of the JAX package's ``repro.core.energy``, plain Python, so
that its numbers equal the JAX package's bit for bit.

Without RTL + PrimeTime we model power as a sum of activity-weighted
components, with coefficients calibrated once against the aggregates the
paper publishes (geomean power ratio 1.07×, max 1.17×, geomean energy saving
1.37×, peak 1.93× on expf) — see ``tests/test_energy.py`` for the asserted
bands.  The component structure encodes the paper's qualitative findings:

* a dominant constant term (clock network etc.) — why the power increase
  stays small despite near-2× IPC;
* instruction-fetch power split by where fetches hit: Snitch's 64-entry L0
  I$ vs thrashing to L1 — the exp/log COPIFT integer loop bodies (43/57
  instrs) fit L0 while every baseline body (>90 instrs) thrashes, which is
  the paper's explanation for those kernels' power *decrease* component;
  FP instructions replayed from the FREP buffer cost near-zero fetch power;
* DMA engine + L1 activity: active for the streaming kernels (exp/log),
  idle for the Monte-Carlo kernels — why MC baselines sit at lower power.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.analytics import TABLE_I
from repro_torch.core.isa import count_mem_accesses as _mem_accesses
from repro_torch.core.kernels_isa import baseline_trace, copift_schedule
from repro_torch.core.timing import (CopiftSchedule, KernelResult,
                                     copift_block_timing, evaluate_kernel)

#: L0 I-cache capacity in instructions (Snitch: 64-entry L0 I$, paper §III-B).
L0_CAPACITY = 64

#: Power coefficients, mW at 1 GHz / 0.8 V / 25 °C (GF12LP+), calibrated on
#: the paper's published aggregates (procedure: tests/test_energy.py bands).
P_CONST = 22.0        # clock tree, PLL share, idle cluster overheads
P_INT = 2.0           # integer datapath, per issued int-instr/cycle
P_FPU = 4.2           # FP64 datapath, per issued fp-instr/cycle
P_LSU = 2.0           # TCDM access, per memory access/cycle
P_FETCH_L0 = 0.7      # per fetched instr/cycle when loop fits L0
P_FETCH_L1 = 2.1      # per fetched instr/cycle when thrashing to L1
P_FETCH_FREP = 0.15   # FP instrs replayed from the FREP buffer
P_DMA = 1.8           # DMA engine active (streaming kernels)
P_SSR = 0.6           # per active SSR data mover lane group


@dataclass
class PowerBreakdown:
    const: float
    int_dp: float
    fpu: float
    lsu: float
    fetch: float
    dma: float
    ssr: float

    @property
    def total(self) -> float:
        return (self.const + self.int_dp + self.fpu + self.lsu + self.fetch
                + self.dma + self.ssr)


def baseline_power(name: str) -> PowerBreakdown:
    trace = baseline_trace(name)
    row = TABLE_I[name]
    res = evaluate_kernel(name, trace, copift_schedule(name), row.max_block)
    cycles_per_iter = res.instrs_base / res.ipc_base / 1.0 / (res.instrs_base / len(trace.instrs))
    n = len(trace.instrs)
    u_int = trace.n_int / cycles_per_iter
    u_fp = trace.n_fp / cycles_per_iter
    u_mem = _mem_accesses(trace.instrs) / cycles_per_iter
    issue = n / cycles_per_iter
    streaming = name in ("expf", "logf")
    fetch_coeff = P_FETCH_L1 if n > L0_CAPACITY else P_FETCH_L0
    return PowerBreakdown(
        const=P_CONST, int_dp=P_INT * u_int, fpu=P_FPU * u_fp,
        lsu=P_LSU * u_mem, fetch=fetch_coeff * issue,
        dma=P_DMA if streaming else 0.0, ssr=0.0)


def copift_power(name: str) -> PowerBreakdown:
    sched = copift_schedule(name)
    row = TABLE_I[name]
    bt = copift_block_timing(sched, row.max_block)
    cyc = bt.cycles
    B = row.max_block
    u_int = (sched.n_int * B + sched.block_overhead_instrs()) / cyc
    u_fp = sched.n_fp * B / cyc
    int_mem = _mem_accesses(sched.int_body) * B
    # SSR stream beats: every eliminated FP load/store became a stream beat;
    # approximate as one TCDM beat per fp-phase operand read/write per elem.
    stream_beats = 2 * sched.n_ssrs * B
    u_mem = (int_mem + stream_beats) / cyc
    streaming = name in ("expf", "logf")
    int_fetch = (P_FETCH_L0 if len(sched.int_body) <= L0_CAPACITY
                 else P_FETCH_L1) * u_int
    fp_fetch = P_FETCH_FREP * u_fp
    return PowerBreakdown(
        const=P_CONST, int_dp=P_INT * u_int, fpu=P_FPU * u_fp,
        lsu=P_LSU * u_mem, fetch=int_fetch + fp_fetch,
        dma=P_DMA if streaming else 0.0, ssr=P_SSR * sched.n_ssrs)


@dataclass
class EnergyResult:
    name: str
    power_base_mw: float
    power_copift_mw: float
    speedup: float

    @property
    def power_ratio(self) -> float:
        return self.power_copift_mw / self.power_base_mw

    @property
    def energy_saving(self) -> float:
        """E_base / E_copift = speedup / power_ratio."""
        return self.speedup / self.power_ratio


def evaluate_energy(name: str) -> EnergyResult:
    row = TABLE_I[name]
    res = evaluate_kernel(name, baseline_trace(name), copift_schedule(name),
                          row.max_block)
    return EnergyResult(
        name=name,
        power_base_mw=baseline_power(name).total,
        power_copift_mw=copift_power(name).total,
        speedup=res.speedup)
