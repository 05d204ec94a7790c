"""Tunable workload registry — the tuner's bridge to the calibrated ISA
machinery; the port's copy of the JAX package's ``repro.tune.workloads``.

A ``Workload`` binds a tuner kernel name to the ISA-level
``CopiftSchedule`` the cost oracle prices, plus the static facts the
oracle needs that live outside the schedule: the Table-I block-size cap,
the Step-4 distinct-buffer count (the replica set when pipelining is
tuned *off*), the steady-state DMA traffic, and the access pattern class
(affine SSR sweeps vs data-dependent ISSR gathers).

The built-in set matches the ``repro_torch.kernels`` entry points:

* ``expf`` / ``logf``  — the paper's streaming kernels, straight from
  ``kernels_isa`` (Table-I counts asserted at import time);
* ``montecarlo``       — the hardest MC variant (``pi_xoshiro128p``),
  representative of ``mc_pi``/``mc_poly``;
* ``prng``             — counter-based uniforms alone (``kernels.uniform``):
  two xoshiro128+ draws spilled to block buffers, FP conversion phase;
* ``softmax``          — the attention softmax: expf's phases plus a
  normalization FP phase (running row sum, reciprocal scale).

``prng``/``softmax`` have no Table-I row, so their block caps derive from
the replica count and the L1 budget exactly as ``schedule.max_block``
derives the printed column for the paper kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.core.analytics import TABLE_I
from repro_torch.core.isa import Instr, L1_BUDGET_DWORDS
from repro_torch.core.kernels_isa import (_xoshiro_draw, copift_schedule,
                                          expf_copift)
from repro_torch.core.timing import CopiftSchedule


@dataclass(frozen=True)
class Workload:
    """One tunable kernel: schedule factory + oracle-side static facts."""
    name: str
    make_schedule: Callable[[], CopiftSchedule]
    max_block: int                # Table-I "Max Block" cap (pipelined plan)
    n_buffers_serial: int         # Step-4 distinct buffers (unpipelined)
    bytes_per_elem: float         # steady-state DMA traffic (L2 <-> TCDM)
    uses_issr: bool = False       # gather streams -> random bank pattern
    default_problem: int = 1 << 14

    def schedule(self) -> CopiftSchedule:
        return self.make_schedule()


def _prng_schedule() -> CopiftSchedule:
    """kernels.uniform as a COPIFT schedule: the integer thread runs two
    xoshiro128+ draws per element and spills them to block buffers; the FP
    phase converts and scales into [0, 1) via the cft.* duplicates."""
    ints: list[Instr] = []
    for k in range(2):
        d = _xoshiro_draw(k)
        ints += d
        ints += [
            Instr("sw", f"mem:buf_u{k}", (d[-1].dst,), tag="spill"),
            Instr("addi", f"pu{k}", (f"pu{k}",)),
        ]
    ints += [
        Instr("addi", "loop:cnt", ("loop:cnt",)),
        Instr("bne", None, ("loop:cnt",)),
    ]
    fp: list[Instr] = []
    for k in range(2):
        fp += [
            Instr("cft.fcvt.d.wu", f"fu{k}", ("loop:ssr0",)),
            Instr("fmadd.d", f"fu{k}s", (f"fu{k}", "const:scale",
                                         "const:half")),
            Instr("fcvt.s.d", "loop:ssr1", (f"fu{k}s",)),
        ]
    return CopiftSchedule("prng", int_body=ints, fp_bodies=[fp],
                          n_ssrs=2, n_buffer_replicas=4, pipeline_depth=2)


#: prng buffer replicas (2 draw buffers x distance-2 pipeline).
_PRNG_REPLICAS = 4
#: softmax replicas: expf's 13 plus the running-sum spill pair.
_SOFTMAX_REPLICAS = 15


def _softmax_schedule() -> CopiftSchedule:
    """The attention softmax: expf's FP/INT phases plus a normalization FP
    phase (running row sum, then scale by the reciprocal)."""
    e = expf_copift()
    norm = [
        Instr("fadd.d", "loop:srow", ("loop:srow", "loop:ssr2")),
        Instr("fmul.d", "fn0", ("loop:ssr2", "loop:sinv")),
        Instr("fmax.d", "fn1", ("fn0", "const:zero")),
        Instr("fcvt.s.d", "loop:ssr1", ("fn1",)),
    ]
    return CopiftSchedule(
        "softmax", int_body=list(e.int_body),
        fp_bodies=[list(b) for b in e.fp_bodies] + [norm],
        n_ssrs=3, n_buffer_replicas=_SOFTMAX_REPLICAS,
        phase_order=(("fp", 0), ("int", 0), ("fp", 1), ("fp", 2)))


WORKLOADS: dict[str, Workload] = {
    "expf": Workload(
        "expf", lambda: copift_schedule("expf"),
        max_block=TABLE_I["expf"].max_block,
        n_buffers_serial=TABLE_I["expf"].n_buffers_step4,
        bytes_per_elem=16.0),
    "logf": Workload(
        "logf", lambda: copift_schedule("logf"),
        max_block=TABLE_I["logf"].max_block,
        n_buffers_serial=TABLE_I["logf"].n_buffers_step4,
        bytes_per_elem=16.0, uses_issr=True),
    "montecarlo": Workload(
        "montecarlo", lambda: copift_schedule("pi_xoshiro128p"),
        max_block=TABLE_I["pi_xoshiro128p"].max_block,
        n_buffers_serial=TABLE_I["pi_xoshiro128p"].n_buffers_step4,
        bytes_per_elem=0.0),
    "prng": Workload(
        "prng", _prng_schedule,
        max_block=L1_BUDGET_DWORDS // _PRNG_REPLICAS,
        n_buffers_serial=2,
        bytes_per_elem=4.0),      # fp32 out stream only; draws are in-core
    "softmax": Workload(
        "softmax", _softmax_schedule,
        max_block=L1_BUDGET_DWORDS // _SOFTMAX_REPLICAS,
        n_buffers_serial=6,
        bytes_per_elem=16.0),
}

#: The tunable kernels behind the ``repro_torch.kernels`` entry points.
BUILTIN_KERNELS: tuple[str, ...] = tuple(WORKLOADS)


def get_workload(name: str) -> Workload:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise KeyError(f"no tunable workload {name!r}; known: "
                       f"{sorted(WORKLOADS)}") from None
