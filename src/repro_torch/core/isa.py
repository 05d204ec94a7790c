"""Instruction-level model of the Snitch core, its FREP/SSR extensions, and
the COPIFT ISA extensions (paper §II-B).

The port's copy of the JAX package's ``repro.core.isa``, plain Python, so
that its numbers equal the JAX package's bit for bit.

This module is the vocabulary shared by the DFG builder (``dfg.py``), the
partitioner (``partition.py``), the timing model (``timing.py``) and the
Table-I analytics (``analytics.py``).  It models the RV32G subset the paper's
kernels use, plus:

* ``frep``    — the FPSS loop buffer (pseudo dual-issue sequencer),
* ``ssr``     — stream semantic registers (3 per core, ≤4-D affine streams),
* ``issr``    — indirection SSRs (arbitrary gather/scatter streams),
* COPIFT custom-1 opcode-space duplicates of the FP conversion / comparison
  instructions whose semantics under FREP operate entirely on the FP register
  file: ``cft.fcvt.w.d``, ``cft.fcvt.wu.d``, ``cft.fcvt.d.w``,
  ``cft.fcvt.d.wu``, ``cft.feq.d``, ``cft.flt.d``, ``cft.fle.d``,
  ``cft.fclass.d`` (paper lists fcvt.w[u].d, fcvt.d.w[u], feq/flt/fle/fclass).

Domain taxonomy
---------------
``Domain.INT``   — executes on the integer core (RV32I/M/B arithmetic).
``Domain.FP``    — executes on the FPSS (D-extension arithmetic).
``Domain.MEM``   — load/store (port: integer LSU or SSR streamer).
``Domain.CTRL``  — branches / loop bookkeeping.

Cross-domain dependency types (paper §II-A):
``DepType.DYN_MEM``  (Type 1)  FP load/store whose address is computed.
``DepType.STA_MEM``  (Type 2)  FP load/store with statically known address.
``DepType.REG``      (Type 3)  register traffic via fcvt / fmv / fcmp.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Domain(enum.Enum):
    INT = "int"
    FP = "fp"
    MEM = "mem"
    CTRL = "ctrl"


class DepType(enum.Enum):
    DYN_MEM = 1   # Type 1: dynamic memory dependency
    STA_MEM = 2   # Type 2: static memory dependency
    REG = 3       # Type 3: register dependency (fcvt/fmv/fcmp)
    INTRA = 0     # same-domain dependency (not a cut candidate)


# ---------------------------------------------------------------------------
# Opcode tables
# ---------------------------------------------------------------------------

#: RV32IMB integer-side opcodes used by the paper's kernels.  Latency is the
#: result latency in cycles on Snitch's single-issue integer pipeline; the
#: writeback ("wb") flag marks multi-cycle producers that occupy the register
#: file write port when they retire (the structural hazard called out for the
#: LCG kernels in paper §III-A).
INT_OPS: dict[str, dict] = {
    "add": dict(lat=1, wb=False), "addi": dict(lat=1, wb=False),
    "sub": dict(lat=1, wb=False), "and": dict(lat=1, wb=False),
    "andi": dict(lat=1, wb=False), "or": dict(lat=1, wb=False),
    "ori": dict(lat=1, wb=False), "xor": dict(lat=1, wb=False),
    "xori": dict(lat=1, wb=False), "sll": dict(lat=1, wb=False),
    "slli": dict(lat=1, wb=False), "srl": dict(lat=1, wb=False),
    "srli": dict(lat=1, wb=False), "sra": dict(lat=1, wb=False),
    "srai": dict(lat=1, wb=False), "slt": dict(lat=1, wb=False),
    "sltu": dict(lat=1, wb=False), "lui": dict(lat=1, wb=False),
    "auipc": dict(lat=1, wb=False),
    # M extension — the multi-cycle producers behind the LCG writeback hazard.
    "mul": dict(lat=3, wb=True), "mulh": dict(lat=3, wb=True),
    "mulhu": dict(lat=3, wb=True), "div": dict(lat=20, wb=True),
    "divu": dict(lat=20, wb=True), "rem": dict(lat=20, wb=True),
    # B-extension style ops (Snitch toolchain emits these for bit twiddling).
    "rol": dict(lat=1, wb=False), "ror": dict(lat=1, wb=False),
    "pack": dict(lat=1, wb=False),
}

#: D-extension FP opcodes (FPSS side).  Latencies per the Snitch FPU.
FP_OPS: dict[str, dict] = {
    "fadd.d": dict(lat=3), "fsub.d": dict(lat=3), "fmul.d": dict(lat=3),
    "fmadd.d": dict(lat=3), "fmsub.d": dict(lat=3), "fnmadd.d": dict(lat=3),
    "fnmsub.d": dict(lat=3), "fdiv.d": dict(lat=21), "fsqrt.d": dict(lat=21),
    "fsgnj.d": dict(lat=1), "fsgnjx.d": dict(lat=1), "fabs.d": dict(lat=1),
    "fmin.d": dict(lat=1), "fmax.d": dict(lat=1),
    "fadd.s": dict(lat=2), "fmul.s": dict(lat=2), "fmadd.s": dict(lat=2),
    "fcvt.s.d": dict(lat=2), "fcvt.d.s": dict(lat=2),
}

#: FP instructions that read or write the INTEGER register file — the Type-3
#: dependency producers (paper §II-A).  ``to_fp`` is the direction.
#: FPSS→integer results travel back through Snitch's accelerator interface
#: (a multi-cycle round trip, lat=4) and retire through the integer RF write
#: port — precisely the cost the COPIFT custom-1 duplicates eliminate by
#: keeping these semantics inside the FP RF (paper §II-B).
XRF_FP_OPS: dict[str, dict] = {
    "fcvt.w.d": dict(lat=4, to_fp=False), "fcvt.wu.d": dict(lat=4, to_fp=False),
    "fcvt.d.w": dict(lat=2, to_fp=True), "fcvt.d.wu": dict(lat=2, to_fp=True),
    "feq.d": dict(lat=4, to_fp=False), "flt.d": dict(lat=4, to_fp=False),
    "fle.d": dict(lat=4, to_fp=False), "fclass.d": dict(lat=4, to_fp=False),
    "fmv.x.d": dict(lat=4, to_fp=False), "fmv.d.x": dict(lat=2, to_fp=True),
    "fmv.x.w": dict(lat=4, to_fp=False), "fmv.w.x": dict(lat=2, to_fp=True),
}

#: COPIFT ISA extensions (paper §II-B): custom-1 opcode-space duplicates whose
#: semantics under FREP operate entirely on the FP RF.  Operands that used to
#: cross register files are spilled through memory (and typically folded into
#: SSRs), so these are plain Domain.FP instructions with no Type-3 edge.
COPIFT_EXT_OPS: dict[str, dict] = {
    # FP-RF-local semantics: no accelerator-interface round trip → the plain
    # FPU pipeline latency (2), regardless of the original direction.
    "cft." + name: dict(lat=2, base=name)
    for name, spec in XRF_FP_OPS.items()
    if name.startswith(("fcvt", "feq", "flt", "fle", "fclass"))
}

MEM_OPS: dict[str, dict] = {
    "lw": dict(lat=2, fp=False), "sw": dict(lat=1, fp=False),
    "lbu": dict(lat=2, fp=False), "sb": dict(lat=1, fp=False),
    "fld": dict(lat=3, fp=True), "fsd": dict(lat=1, fp=True),
    "flw": dict(lat=3, fp=True), "fsw": dict(lat=1, fp=True),
}

CTRL_OPS: dict[str, dict] = {
    "beq": dict(lat=1), "bne": dict(lat=1), "blt": dict(lat=1),
    "bge": dict(lat=1), "bltu": dict(lat=1), "bgeu": dict(lat=1),
    "jal": dict(lat=1), "jalr": dict(lat=1),
    # Snitch extensions (sequencer / streamer bookkeeping).
    "frep.o": dict(lat=1), "frep.i": dict(lat=1),
    "scfgwi": dict(lat=1),  # SSR config write
    "csrrsi": dict(lat=1), "csrrci": dict(lat=1),  # SSR enable/disable
}

#: Cycles the integer core spends programming one SSR data mover for a new
#: block (bounds/strides/base writes via ``scfgwi``).  Used by timing.py for
#: the per-block overhead the paper observes on the exp kernel.
SSR_SETUP_CYCLES_PER_STREAM = 5
#: Cycles to swap double-buffer base pointers + loop bookkeeping per block.
BUFFER_SWITCH_CYCLES = 8
#: Number of SSR data movers per Snitch core (paper §II-A: "the 3 SSRs").
NUM_SSRS = 3
#: L1 TCDM budget per core for COPIFT buffers, in double words (Table I "Max
#: Block" column is derived from this: block * n_buffers * 8B <= budget).
L1_BUDGET_DWORDS = 2048


def classify(opcode: str) -> Domain:
    """Map an opcode to the execution domain it occupies."""
    if opcode in INT_OPS:
        return Domain.INT
    if opcode in FP_OPS or opcode in COPIFT_EXT_OPS:
        return Domain.FP
    if opcode in XRF_FP_OPS:
        # Cross-RF FP instructions execute on the FPSS but synchronise with
        # the integer pipeline; for partitioning they are FP-domain nodes with
        # a Type-3 edge attached by dfg.py.
        return Domain.FP
    if opcode in MEM_OPS:
        return Domain.MEM
    if opcode in CTRL_OPS:
        return Domain.CTRL
    raise KeyError(f"unknown opcode: {opcode}")


def latency(opcode: str) -> int:
    for table in (INT_OPS, FP_OPS, XRF_FP_OPS, COPIFT_EXT_OPS, MEM_OPS, CTRL_OPS):
        if opcode in table:
            return table[opcode]["lat"]
    raise KeyError(f"unknown opcode: {opcode}")


def count_mem_accesses(instrs) -> int:
    """TCDM accesses (loads + stores) in an instruction sequence — the one
    counter shared by the energy model's LSU utilization and the cluster
    contention model's request rate, so they can never diverge."""
    return sum(1 for i in instrs if i.opcode in MEM_OPS)


def is_copift_ext(opcode: str) -> bool:
    return opcode in COPIFT_EXT_OPS


def copift_encode(opcode: str) -> str:
    """Return the COPIFT custom-1 duplicate for a cross-RF FP opcode.

    Raises if the opcode has no COPIFT duplicate (fmv.* are handled by SSR
    spilling instead, as in the paper).
    """
    ext = "cft." + opcode
    if ext not in COPIFT_EXT_OPS:
        raise KeyError(f"{opcode} has no COPIFT custom-1 duplicate")
    return ext


@dataclass(frozen=True)
class Instr:
    """One instruction in a kernel trace.

    ``dst``/``srcs`` are abstract register names; the integer/FP RF split is
    implied by the usual RISC-V naming convention used here: names starting
    with ``f`` live in the FP RF, anything else in the integer RF. Memory
    operands are encoded as ``srcs`` entries of the form ``mem:<name>`` with
    ``dyn`` flagging a dynamically computed address (Type 1 vs Type 2).
    """

    opcode: str
    dst: str | None = None
    srcs: tuple[str, ...] = ()
    dyn_addr: bool = False          # for MEM ops: address computed at runtime
    tag: str = ""                   # free-form label (phase hints, provenance)

    @property
    def domain(self) -> Domain:
        return classify(self.opcode)

    @property
    def lat(self) -> int:
        return latency(self.opcode)

    @property
    def is_fp_mem(self) -> bool:
        return self.opcode in MEM_OPS and MEM_OPS[self.opcode]["fp"]

    @property
    def writes_int_rf(self) -> bool:
        if self.dst is None:
            return False
        name = self.dst.removeprefix("loop:")
        return not name.startswith("f") and not self.dst.startswith("mem:")

    @property
    def wb_port_hazard(self) -> bool:
        """Multi-cycle producer competing for the integer RF write port:
        integer mul/div, and cross-RF FP instructions whose destination is an
        integer register (flt.d / fcvt.w.d / fmv.x.*) — the collision behind
        the LCG kernels' stalls (paper §III-A)."""
        spec = INT_OPS.get(self.opcode)
        if spec and spec.get("wb"):
            return True
        xspec = XRF_FP_OPS.get(self.opcode)
        return bool(xspec and not xspec["to_fp"] and self.writes_int_rf)


@dataclass
class KernelTrace:
    """A straight-line (loop-body) instruction trace for one kernel variant."""

    name: str
    instrs: list[Instr] = field(default_factory=list)

    def count(self, domain: Domain) -> int:
        return sum(1 for i in self.instrs if i.domain is domain)

    @property
    def n_int(self) -> int:
        """Integer-thread instruction count, the paper's ``#Int`` column:
        everything issued by the integer core (INT + int-side MEM + CTRL)."""
        n = 0
        for i in self.instrs:
            if i.domain is Domain.INT or i.domain is Domain.CTRL:
                n += 1
            elif i.domain is Domain.MEM and not i.is_fp_mem:
                n += 1
        return n

    @property
    def n_fp(self) -> int:
        """FP-thread instruction count, the paper's ``#FP`` column:
        FPSS-issued instructions (FP arith + FP load/store)."""
        n = 0
        for i in self.instrs:
            if i.domain is Domain.FP:
                n += 1
            elif i.domain is Domain.MEM and i.is_fp_mem:
                n += 1
        return n
