"""Snitch dual-issue timing model (discrete-event), reproducing Fig. 2a/2c
and Fig. 3 of the paper.

The port's copy of the JAX package's ``repro.core.timing``, plain Python, so
that its numbers equal the JAX package's bit for bit.

Two simulators share one micro-architectural vocabulary (``isa.py``):

* :func:`simulate_single_issue` — the RV32G baseline: one instruction per
  cycle, in-order, with a register scoreboard (RAW stalls from result
  latencies) and a single integer-RF writeback port (multi-cycle producers
  like ``mul`` collide with 1-cycle ops — the structural hazard the paper
  blames for the LCG kernels' stalls, §III-A).

* :func:`simulate_copift` — the COPIFT schedule: the integer core and the
  FPSS each issue from their own phase streams with their own scoreboards;
  per paper §II-A Step 7, the *first* FREP iteration of each FP phase is
  issued by the integer core (occupying its issue slot), after which the
  FREP sequencer streams the remaining ``B-1`` iterations concurrently with
  the integer thread.  Per-block overheads — SSR reprogramming (base
  pointers change every block because of multi-buffering), buffer-pointer
  switching, FREP setup — are executed as integer-thread instructions, so
  they raise the dynamic instruction count *and* the cycle count, exactly
  the effect the paper observes on the exp kernel ("instruction overhead
  required to program the SSRs and switch buffers in every block
  iteration").

Block-level composition (Fig. 3): ``problem_cycles`` sums pipeline
iterations j' = 0 .. n_blocks+depth-2, where iteration cycles are
max(integer-thread cycles, FP-thread cycles) over the phases active in that
iteration, plus a fixed program prologue (initial SSR/buffer setup).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.isa import (BUFFER_SWITCH_CYCLES, Instr, KernelTrace,
                                  SSR_SETUP_CYCLES_PER_STREAM, Domain)
from repro_torch.obs.metrics import enabled as _metrics_enabled
from repro_torch.obs.metrics import inc as _metric_inc
from repro_torch.obs.record import active_recorder as _active_recorder
from repro_torch.perf.memo import STREAM_MEMO, TIMING_MEMO


# ---------------------------------------------------------------------------
# Scoreboarded in-order issue
# ---------------------------------------------------------------------------

def _ssa_unroll(instrs: list[Instr], iters: int) -> list[Instr]:
    """Unroll ``iters`` copies of the body with SSA renaming.

    Plain registers get an ``@iter`` suffix (independent iterations can
    overlap); loop-carried names (``loop:*`` — PRNG state, pointers,
    accumulators) and memory cells get *version* numbers on every write, so
    true recurrences remain serial chains through the versions — exactly why
    the LCG kernels' stalls "could not be eliminated by unrolling"
    (paper §III-A).
    """
    version: dict[str, int] = {}
    out: list[Instr] = []
    for it in range(iters):
        for ins in instrs:
            def rn_src(name: str) -> str:
                if name.startswith("const:"):
                    return name
                if name.startswith(("loop:", "mem:")):
                    return f"{name}#{version.get(name, 0)}"
                return f"{name}@{it}"
            srcs = tuple(rn_src(s) for s in ins.srcs)
            dst = ins.dst
            if dst is not None:
                if dst.startswith(("loop:", "mem:")):
                    version[dst] = version.get(dst, 0) + 1
                    dst = f"{dst}#{version[dst]}"
                else:
                    dst = f"{dst}@{it}"
            out.append(Instr(ins.opcode, dst, srcs, ins.dyn_addr, ins.tag))
    return out


def _list_schedule(instrs: list[Instr]) -> list[Instr]:
    """Latency-aware greedy list scheduling (models -O3 + hand scheduling):
    dependency graph over the SSA-renamed stream, priority = longest
    remaining latency path, output = a static program order the in-order
    core then executes.  Only true (RAW) dependencies constrain order —
    SSA renaming removed WAR/WAW."""
    n = len(instrs)
    succs: list[list[int]] = [[] for _ in range(n)]
    preds: list[int] = [0] * n
    writer: dict[str, int] = {}
    for i, ins in enumerate(instrs):
        for s in ins.srcs:
            if s in writer:
                succs[writer[s]].append(i)
                preds[i] += 1
        if ins.dst is not None:
            writer[ins.dst] = i
    # Longest-path priority (critical path in latency terms).
    prio = [0] * n
    for i in range(n - 1, -1, -1):
        lat = instrs[i].lat
        prio[i] = lat + max((prio[s] for s in succs[i]), default=0)
    import heapq
    ready = [(-prio[i], i) for i in range(n) if preds[i] == 0]
    heapq.heapify(ready)
    order: list[Instr] = []
    indeg = preds[:]
    while ready:
        _, i = heapq.heappop(ready)
        order.append(instrs[i])
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, (-prio[s], s))
    assert len(order) == n
    return order


def _simulate_inorder_counts(instrs: list[Instr]) -> tuple[int, int]:
    """In-order single-issue execution of a statically scheduled stream:
    RAW stalls from result latencies + the single integer-RF write port
    (multi-cycle producers — mul, and cross-RF FP ops targeting the int RF —
    reserve their retire slot; colliding 1-cycle writers stall).

    Returns the contention-free ``(cycles, mem_accesses)`` pair: TCDM
    contention only ever enters the total as ``_simulate_stream``'s final
    ``t + mem · stalls_per_access`` term, so this pair is what the
    content-addressed memo stores — one simulation prices every
    contention value bit-for-bit."""
    ready: dict[str, int] = {}
    wb_busy: set[int] = set()
    t = 0
    mem_accesses = 0
    for ins in instrs:
        t += 1  # issue slot
        for s in ins.srcs:
            if s in ready and ready[s] > t:
                t = ready[s]
        if ins.domain is Domain.MEM:
            mem_accesses += 1
        if ins.dst is not None:
            wb = t + ins.lat - 1
            if ins.wb_port_hazard:
                while wb in wb_busy:  # port taken → retire one later
                    wb += 1
                wb_busy.add(wb)
            elif ins.writes_int_rf and wb in wb_busy:
                # 1-cycle op collides with an earlier producer's retire slot.
                while wb in wb_busy:
                    t += 1
                    wb = t + ins.lat - 1
            ready[ins.dst] = wb + 1
    return t, mem_accesses


def _simulate_inorder_observed(instrs: list[Instr], want_events: bool):
    """Instrumented twin of :func:`_simulate_inorder_counts`: the identical
    state machine (same ``t``/``ready``/``wb_busy`` transitions — parity
    pinned by the hypothesis tests in ``tests/test_obs.py``), additionally
    splitting lost issue slots into stall classes and, when
    ``want_events``, emitting ``(issue_cycle, opcode, stall, kind)`` per
    instruction for the trace recorder.  Kept separate so the disabled-mode
    hot loop above stays branch-free."""
    ready: dict[str, int] = {}
    wb_busy: set[int] = set()
    t = 0
    mem_accesses = 0
    raw_stalls = 0
    wb_stalls = 0
    events: list[tuple] | None = [] if want_events else None
    for ins in instrs:
        t += 1  # issue slot
        t_entry = t
        for s in ins.srcs:
            if s in ready and ready[s] > t:
                t = ready[s]
        stall = t - t_entry
        kind = "raw" if stall else ""
        raw_stalls += stall
        if ins.domain is Domain.MEM:
            mem_accesses += 1
        if ins.dst is not None:
            wb = t + ins.lat - 1
            if ins.wb_port_hazard:
                while wb in wb_busy:  # port taken → retire one later
                    wb += 1
                wb_busy.add(wb)
            elif ins.writes_int_rf and wb in wb_busy:
                # 1-cycle op collides with an earlier producer's retire slot.
                while wb in wb_busy:
                    t += 1
                    wb = t + ins.lat - 1
                extra = t - t_entry - stall
                wb_stalls += extra
                stall += extra
                kind = "wb_port" if not kind else "raw+wb_port"
            ready[ins.dst] = wb + 1
        if events is not None:
            events.append((t, ins.opcode, stall, kind))
    return t, mem_accesses, {"raw": raw_stalls, "wb_port": wb_stalls}, events


def _record_stall_metrics(n_instrs: int, cycles: int, mem: int,
                          stalls: dict[str, int]) -> None:
    _metric_inc("timing.issue.instructions", n_instrs)
    _metric_inc("timing.issue.cycles", cycles)
    _metric_inc("timing.mem.accesses", mem)
    _metric_inc("timing.stall.raw_cycles", stalls["raw"])
    _metric_inc("timing.stall.wb_port_cycles", stalls["wb_port"])


def _stream_counts(instrs: list[Instr], iters: int,
                   schedule: bool = True) -> tuple[int, int]:
    """Memoized unroll → schedule → simulate, returning the contention-free
    ``(cycles, mem_accesses)`` pair.  Content-addressed on the body itself
    (the instruction tuple), so independently built identical bodies —
    e.g. a schedule registry rebuilding per call — share one entry.

    With observability on (``repro_torch.obs``), the observed twin below runs
    instead; the fast path here pays exactly two short-circuiting reads."""
    rec = _active_recorder()
    if rec is None and not _metrics_enabled():
        key = (tuple(instrs), iters, schedule)
        hit = STREAM_MEMO.lookup(key)
        if hit is not None:
            return hit
        stream = _ssa_unroll(instrs, iters)
        if schedule:
            stream = _list_schedule(stream)
        return STREAM_MEMO.store(key, _simulate_inorder_counts(stream))
    return _stream_counts_observed(instrs, iters, schedule, rec)


def _stream_counts_observed(instrs: list[Instr], iters: int, schedule: bool,
                            rec) -> tuple[int, int]:
    """The observed path.  Memo parity rules: the tables are never bypassed
    or poisoned — a traced run *re-simulates* (the stored pair is a pure
    function of the key, so the recomputed counts are bit-identical) and
    consults the memo only to tag provenance; a metrics-only run serves
    hits straight from the table (stall-class counters then accumulate on
    cold simulations only — memo warmth is tracked separately)."""
    key = (tuple(instrs), iters, schedule)
    hit = STREAM_MEMO.lookup(key)
    if rec is None:
        if hit is not None:
            _metric_inc("timing.stream.memo_hits")
            return hit
        _metric_inc("timing.stream.cold_sims")
        stream = _ssa_unroll(instrs, iters)
        if schedule:
            stream = _list_schedule(stream)
        t, mem, stalls, _ = _simulate_inorder_observed(stream, False)
        _record_stall_metrics(len(stream), t, mem, stalls)
        return STREAM_MEMO.store(key, (t, mem))
    stream = _ssa_unroll(instrs, iters)
    if schedule:
        stream = _list_schedule(stream)
    t, mem, stalls, events = _simulate_inorder_observed(stream, True)
    if _metrics_enabled():
        _metric_inc("timing.stream.memo_hits" if hit is not None
                    else "timing.stream.cold_sims")
        _record_stall_metrics(len(stream), t, mem, stalls)
    rec.stream(cycles=t, n_instrs=len(stream), stalls=stalls, events=events,
               provenance="hit" if hit is not None else "cold")
    if hit is not None:
        return hit
    return STREAM_MEMO.store(key, (t, mem))


def _simulate_stream(instrs: list[Instr], iters: int, schedule: bool = True,
                     tcdm_contention: float = 0.0) -> float:
    """SSA-unroll → list-schedule (unless ``schedule=False``) → simulate.

    ``tcdm_contention`` adds fractional stall cycles per memory access,
    modeling SSR-stream/LSU bank conflicts on the shared TCDM when data
    movers are active.  Returns a *float* so callers that window the
    simulation (``thread_cycles``) can accumulate fractional stalls across
    windows before truncating once — per-window truncation would floor
    small surcharges (e.g. the cluster's inter-core contention) to zero."""
    t, mem_accesses = _stream_counts(instrs, iters, schedule)
    if tcdm_contention:
        contention_cycles = mem_accesses * tcdm_contention
        rec = _active_recorder()
        if rec is not None:
            rec.annotate("tcdm_contention", contention_cycles)
        _metric_inc("timing.stall.tcdm_contention_cycles", contention_cycles)
        return t + contention_cycles
    return t + mem_accesses * tcdm_contention


def simulate_single_issue(instrs: list[Instr], iters: int = 1,
                          schedule: bool = True,
                          tcdm_contention: float = 0.0) -> int:
    """Cycles for ``iters`` repetitions of ``instrs`` on the in-order core."""
    rec = _active_recorder()
    if rec is not None:
        with rec.lane("rv32g"):
            total = _simulate_stream(instrs, iters, schedule, tcdm_contention)
            rec.annotate("thread_total", total, advance=False)
            return int(total)
    return int(_simulate_stream(instrs, iters, schedule, tcdm_contention))


def thread_cycles(instrs: list[Instr], iters: int = 1,
                  tcdm_contention: float = 0.0) -> int:
    """Cycles for one thread of a dual-issue pair (same issue rules).
    Unrolling/scheduling is windowed (groups of 8 iterations) to bound the
    scheduler's scope to a realistic FREP/loop-buffer horizon.  Fractional
    contention stalls accumulate across windows and truncate once at the
    end, so small per-access surcharges survive into the total."""
    if iters <= 0:
        return 0
    WINDOW = 8
    full, rem = divmod(iters, WINDOW)
    cycles = 0.0
    rec = _active_recorder()
    if rec is None:
        if full:
            cycles += _simulate_stream(instrs, WINDOW,
                                       tcdm_contention=tcdm_contention) * full
        if rem:
            cycles += _simulate_stream(instrs, rem,
                                       tcdm_contention=tcdm_contention)
        return int(cycles)
    # Traced: the full windows are simulated once and repeat-scaled (the
    # recorder scales aggregates; micro events stay one representative
    # window), and the exact pre-truncation total is annotated so the
    # exported lane reconciles bit-for-bit (obs.export.reconcile).
    if full:
        with rec.repeat(full):
            cycles += _simulate_stream(instrs, WINDOW,
                                       tcdm_contention=tcdm_contention) * full
    if rem:
        cycles += _simulate_stream(instrs, rem,
                                   tcdm_contention=tcdm_contention)
    rec.annotate("thread_total", cycles, advance=False)
    return int(cycles)


# ---------------------------------------------------------------------------
# COPIFT block schedule
# ---------------------------------------------------------------------------

@dataclass
class CopiftSchedule:
    """Static description of one COPIFT-transformed kernel's inner loop.

    ``int_body`` / ``fp_bodies`` are per-element instruction sequences; the
    FP bodies are indexed by FP phase (the paper fuses them into one FREP
    loop in steady state, which we model by concatenation).
    ``phase_order`` positions the phases in the software pipeline (Step 5):
    entries are ("int", 0) or ("fp", k); default INT→FP (the MC kernels).
    """
    name: str
    int_body: list[Instr]
    fp_bodies: list[list[Instr]]
    n_ssrs: int = 3                      # streams after fusion (≤3)
    n_buffer_replicas: int = 6           # Table I "#Buff." after Steps 5–6
    pipeline_depth: int = 3              # number of phases
    phase_order: tuple = ()              # e.g. (("fp",0),("int",0),("fp",1))

    def __post_init__(self):
        if not self.phase_order:
            self.phase_order = tuple(
                [("fp", k) for k in range(len(self.fp_bodies) - 1)]
                + [("int", 0)]
                + [("fp", len(self.fp_bodies) - 1)]) \
                if len(self.fp_bodies) > 1 else (("int", 0), ("fp", 0))
        self.pipeline_depth = len(self.phase_order)

    def fingerprint(self) -> tuple:
        """Content fingerprint for the timing memo: two schedules with the
        same bodies and static parameters share cached timings, however
        they were built.  Cached on the instance — schedules are treated
        as immutable after construction (every producer builds fresh
        objects; mutate one and the cache goes stale)."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            fp = (self.name, tuple(self.int_body),
                  tuple(tuple(b) for b in self.fp_bodies), self.n_ssrs,
                  self.n_buffer_replicas, tuple(self.phase_order))
            self.__dict__["_fingerprint"] = fp
        return fp

    @property
    def n_int(self) -> int:
        return len(self.int_body)

    @property
    def n_fp(self) -> int:
        return sum(len(b) for b in self.fp_bodies)

    def block_overhead_instrs(self) -> int:
        """Integer-thread bookkeeping instructions per block iteration:
        SSR base/bound reprogramming (multi-buffering moves the bases every
        block), buffer-pointer rotation, FREP setup, loop bookkeeping."""
        ssr_cfg = self.n_ssrs * SSR_SETUP_CYCLES_PER_STREAM
        buf_switch = 2 * self.n_buffer_replicas
        frep_setup = 2 * len(self.fp_bodies)
        loop = BUFFER_SWITCH_CYCLES
        return ssr_cfg + buf_switch + frep_setup + loop


@dataclass
class BlockTiming:
    cycles: int
    int_cycles: int
    fp_cycles: int
    instrs: int

    @property
    def ipc(self) -> float:
        return self.instrs / self.cycles


def copift_block_timing(sched: CopiftSchedule, block: int,
                        extra_contention: float = 0.0) -> BlockTiming:
    """Steady-state cycles for one block iteration (paper Fig. 2a regime).

    ``extra_contention`` adds stall cycles per memory access on top of the
    calibrated intra-core SSR/LSU conflict rate — the hook the cluster model
    (``repro_torch.cluster.contention``) uses to charge inter-core TCDM bank
    conflicts.  The default of 0 keeps the paper-calibrated single-PE
    numbers bit-for-bit.
    """
    key = (sched.fingerprint(), "block", block, extra_contention)
    rec = _active_recorder()
    hit = TIMING_MEMO.lookup(key)
    if hit is not None and rec is None:
        return hit
    oh = sched.block_overhead_instrs()
    fp_first = sum(len(b) for b in sched.fp_bodies)      # FREP 1st iteration
    # Integer thread: its own body for the whole block + bookkeeping + the
    # first FREP iteration of each FP phase (issued through the int core).
    # SSR data movers are active during the block → TCDM bank contention on
    # the integer thread's own loads/stores.
    contention = (0.25 if sched.n_ssrs else 0.0) + extra_contention
    if rec is None:
        int_cycles = thread_cycles(sched.int_body, block,
                                   tcdm_contention=contention) + oh + fp_first
        # FP thread: remaining block-1 iterations stream from the FREP
        # buffer.
        fp_cycles = fp_first + sum(thread_cycles(b, block - 1)
                                   for b in sched.fp_bodies)
    else:
        # Traced: same arithmetic, with the two threads scoped onto their
        # lanes.  A memo hit is recomputed rather than served (values are
        # pure functions of the key → bit-identical; the hit is recorded
        # as provenance) so the trace always has events.
        with rec.lane("int"):
            int_cycles = thread_cycles(
                sched.int_body, block,
                tcdm_contention=contention) + oh + fp_first
            rec.annotate("block_overhead", oh)
            rec.annotate("frep_launch", fp_first)
        with rec.lane("fpss"):
            fp_cycles = fp_first + sum(thread_cycles(b, block - 1)
                                       for b in sched.fp_bodies)
            rec.annotate("frep_first_iter", fp_first)
    cycles = max(int_cycles, fp_cycles)
    instrs = (sched.n_int + sched.n_fp) * block + oh
    if rec is not None:
        rec.block_record(name=sched.name, kind="block", block=block,
                         extra_contention=extra_contention,
                         provenance="hit" if hit is not None else "cold",
                         int_cycles=int_cycles, fp_cycles=fp_cycles,
                         cycles=cycles)
        if hit is not None:
            return hit
    return TIMING_MEMO.store(key, BlockTiming(
        cycles=cycles, int_cycles=int_cycles,
        fp_cycles=fp_cycles, instrs=instrs))


def copift_serial_block_timing(sched: CopiftSchedule, block: int,
                               extra_contention: float = 0.0) -> BlockTiming:
    """Per-block cost with Step-5 pipelining *off* (paper Fig. 1f): every
    phase runs to completion on each block, so there is no int/FP overlap
    and no first-FREP-iteration handoff — the FP phases pay all ``block``
    iterations themselves and the block total is the **sum** of the two
    threads plus the per-block bookkeeping.

    This is the serial branch of the cost oracle's per-core pricing
    (``tune.cost._per_core_cycles``), promoted into the timing model so
    unpipelined candidates share the content-addressed timing memo and
    trace onto the same ``int``/``fpss`` lanes as
    :func:`copift_block_timing` (the serialized summaries carry
    ``combine="sum"``, which ``obs.export.reconcile`` and the attribution
    waterfall understand).
    """
    key = (sched.fingerprint(), "serial", block, extra_contention)
    rec = _active_recorder()
    hit = TIMING_MEMO.lookup(key)
    if hit is not None and rec is None:
        return hit
    oh = sched.block_overhead_instrs()
    contention = (0.25 if sched.n_ssrs else 0.0) + extra_contention
    if rec is None:
        int_blk = thread_cycles(sched.int_body, block,
                                tcdm_contention=contention)
        fp_blk = sum(thread_cycles(b, block) for b in sched.fp_bodies)
    else:
        with rec.lane("int"):
            int_blk = thread_cycles(sched.int_body, block,
                                    tcdm_contention=contention)
            rec.annotate("block_overhead", oh)
        with rec.lane("fpss"):
            fp_blk = sum(thread_cycles(b, block) for b in sched.fp_bodies)
    cycles = int_blk + oh + fp_blk
    instrs = (sched.n_int + sched.n_fp) * block + oh
    if rec is not None:
        rec.block_record(name=sched.name, kind="serial", block=block,
                         extra_contention=extra_contention,
                         provenance="hit" if hit is not None else "cold",
                         int_cycles=int_blk + oh, fp_cycles=fp_blk,
                         cycles=cycles)
        if hit is not None:
            return hit
    return TIMING_MEMO.store(key, BlockTiming(
        cycles=cycles, int_cycles=int_blk + oh, fp_cycles=fp_blk,
        instrs=instrs))


def baseline_timing(trace: KernelTrace, n: int = 1,
                    extra_contention: float = 0.0) -> BlockTiming:
    cycles = simulate_single_issue(trace.instrs, n,
                                   tcdm_contention=extra_contention)
    instrs = len(trace.instrs) * n
    return BlockTiming(cycles=cycles, int_cycles=cycles, fp_cycles=0,
                       instrs=instrs)


#: Fixed program prologue: initial SSR stream configuration, buffer
#: allocation, loop setup (cycles).  Affects Fig. 3 small-problem IPC only.
PROGRAM_PROLOGUE_CYCLES = 120


def copift_problem_timing(sched: CopiftSchedule, problem: int,
                          block: int,
                          extra_contention: float = 0.0) -> BlockTiming:
    """Full-problem cycles with software-pipeline fill/drain (Fig. 3).

    Pipeline iteration j' runs phase p on block j'-p (when in range); its
    cost is max(integer-thread work, FP-thread work) over the phases active
    in that iteration plus the per-block integer bookkeeping.  All interior
    iterations are identical, so we evaluate fill (d-1), one steady
    iteration, and drain (d-1) exactly and scale.
    """
    key = (sched.fingerprint(), "problem", problem, block, extra_contention)
    rec = _active_recorder()
    hit = TIMING_MEMO.lookup(key)
    if hit is not None and rec is None:
        return hit
    n_blocks = max(1, math.ceil(problem / block))
    d = sched.pipeline_depth
    oh = sched.block_overhead_instrs()
    fp_first = sum(len(b) for b in sched.fp_bodies)
    contention = (0.25 if sched.n_ssrs else 0.0) + extra_contention
    if rec is None:
        int_blk = thread_cycles(sched.int_body, block,
                                tcdm_contention=contention)
        fp_blk = [thread_cycles(b, max(0, block - 1)) + len(b)
                  for b in sched.fp_bodies]
    else:
        with rec.lane("int"):
            int_blk = thread_cycles(sched.int_body, block,
                                    tcdm_contention=contention)
        with rec.lane("fpss"):
            fp_blk = [thread_cycles(b, max(0, block - 1)) + len(b)
                      for b in sched.fp_bodies]

    def iter_cost(jp: int) -> int:
        active = [(p, jp - p) for p in range(d) if 0 <= jp - p < n_blocks]
        if not active:
            return 0
        ic = fc = 0
        for p, _ in active:
            kind, idx = sched.phase_order[p]
            if kind == "int":
                ic += int_blk + oh + fp_first
            else:
                fc += fp_blk[idx]
        return max(ic, fc)

    total_iters = n_blocks + d - 1
    cycles = PROGRAM_PROLOGUE_CYCLES
    # fill: j' in [0, d-1); drain: j' in [n_blocks, n_blocks+d-1)
    for jp in range(min(d - 1, total_iters)):
        cycles += iter_cost(jp)
    steady_iters = max(0, n_blocks - (d - 1))
    if steady_iters:
        cycles += steady_iters * iter_cost(d - 1 if n_blocks >= d else 0)
    for jp in range(max(d - 1, n_blocks), total_iters):
        cycles += iter_cost(jp)
    instrs = (sched.n_int + sched.n_fp) * problem + oh * n_blocks
    if rec is not None:
        rec.block_record(name=sched.name, kind="problem", problem=problem,
                         block=block, extra_contention=extra_contention,
                         provenance="hit" if hit is not None else "cold",
                         cycles=cycles)
        if hit is not None:
            return hit
    return TIMING_MEMO.store(key, BlockTiming(
        cycles=cycles, int_cycles=0, fp_cycles=0, instrs=instrs))


def ipc_surface(sched: CopiftSchedule, problems: list[int],
                blocks: list[int]) -> dict[tuple[int, int], float]:
    """IPC over a (problem size × block size) grid — Fig. 3.

    Each cell resolves through the per-schedule timing memo, and the
    per-block thread costs underneath (``thread_cycles`` windows,
    content-addressed) are simulated once per block *however* the grid
    is ordered — the full pipeline model used to be rebuilt from scratch
    per cell.  Cell values are identical to the cold path (regression-
    pinned in ``tests/test_timing_energy.py``)."""
    out = {}
    for n in problems:
        for b in blocks:
            if b > n:
                continue
            out[(n, b)] = copift_problem_timing(sched, n, b).ipc
    return out


@dataclass
class KernelResult:
    name: str
    ipc_base: float
    ipc_copift: float
    speedup: float
    cycles_base: int
    cycles_copift: int
    instrs_base: int
    instrs_copift: int

    @property
    def ipc_gain(self) -> float:
        return self.ipc_copift / self.ipc_base


def evaluate_kernel(name: str, base: KernelTrace, sched: CopiftSchedule,
                    block: int, steady_elems: int | None = None) -> KernelResult:
    """Steady-state comparison of baseline vs COPIFT (Fig. 2a / 2c).

    Compatibility entry point: registry kernels should be evaluated through
    ``repro_torch.api.evaluate(name, Target.single_pe())``, which reduces to
    these numbers bit-for-bit (pinned in ``tests/test_api.py``) and adds
    the cluster/DVFS axes.  This function remains the primitive for
    *custom* traces/schedules outside the registry — and what the
    ``core.energy`` calibration uses (``core`` cannot depend on ``api``).
    """
    n = steady_elems or block
    bt = baseline_timing(base, n)
    ct = copift_block_timing(sched, block)
    blocks_needed = n / block
    c_cycles = int(ct.cycles * blocks_needed)
    c_instrs = int(ct.instrs * blocks_needed)
    return KernelResult(
        name=name,
        ipc_base=bt.instrs / bt.cycles,
        ipc_copift=ct.ipc,
        speedup=bt.cycles / c_cycles,
        cycles_base=bt.cycles, cycles_copift=c_cycles,
        instrs_base=bt.instrs, instrs_copift=c_instrs)
