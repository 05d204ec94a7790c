"""Differential cycle attribution — *why* plan B beats plan A, exactly; a
self-standing copy of the JAX package's ``repro.obs.attrib``, with the
same ``Fraction`` arithmetic in the same order.

``export.reconcile`` proves a single traced ``api.evaluate`` run's cycle
accounting internally consistent; this module takes **two** traced runs
(default vs tuned plan, Target A vs Target B, …) and decomposes the cycle
delta into a waterfall over the stall taxonomy the recorder already
carries — issue slots, RAW stalls, write-port conflicts, TCDM contention,
FREP launch, per-block bookkeeping, scheduling/DVFS, DMA — plus the
dual-issue overlap gain, such that the step deltas sum **bit-for-bit** to
the ``Report`` cycle delta (the same standard as the traced == untraced
parity of ``obs.record``).

How exactness survives floats
-----------------------------
Every quantity in a trace summary is either an integer or a float the
simulator itself produced; both embed exactly into ``fractions.Fraction``.
The waterfall is a *hybrid walk*: starting from run A's per-core category
state, each step overwrites one category group with run B's values and
re-replays the full cluster reduction (the identical arithmetic
``api.evaluate._compute_cycles`` used — integer max over reference-clock
cores, IEEE-double scaling for the rest, DMA floor).  Consecutive replays
telescope, so the step deltas sum to ``cycles_B − cycles_A`` by
construction, and the two endpoints are checked against the recorded
Report figures bit-for-bit.

The dual-issue overlap gain needs one extra trick: ``max(int, fp)`` is not
additive over categories.  The walk therefore runs inside a *serialized
sandwich* — the first step switches every core's phase combinator from its
native ``max`` to ``sum`` (pricing the hypothetical unpipelined machine,
paper Fig. 1f), the category steps walk in that additive space, and the
last step restores run B's native combinator.  The two switch deltas
together are exactly the overlap cycles the pipelining recovered
(``dual_issue_overlap``).

Float dust from fractional TCDM stalls (the only non-integral category) is
absorbed into an exact per-lane ``residual`` term folded into the
``tcdm_contention`` step, so nothing is ever rounded away.
"""

from __future__ import annotations

from copy import deepcopy
from dataclasses import dataclass, field
from fractions import Fraction

from repro_torch.obs.export import _summaries

#: Additive per-lane cycle categories (``residual`` absorbs the exact gap
#: between the float ``thread_total`` and the recorded category sum).
_TT_CATS = ("busy", "raw", "wb_port", "tcdm_contention", "residual")

#: Walk order for the COPIFT path: category steps run inside the
#: serialized sandwich; each entry lists the (group, key) state fields the
#: step moves from A's values to B's.
_COPIFT_STEPS = (
    ("issue_slots", (("int", "busy"), ("fp", "busy"))),
    ("raw", (("int", "raw"), ("fp", "raw"))),
    ("wb_port", (("int", "wb_port"), ("fp", "wb_port"))),
    ("tcdm_contention", (("int", "tcdm_contention"), ("fp", "tcdm_contention"),
                         ("int", "residual"), ("fp", "residual"))),
    ("frep_launch", ((None, "launch"), (None, "first"))),
    ("block_overhead", ((None, "oh"),)),
)

_BASE_STEPS = (
    ("issue_slots", (("base", "busy"),)),
    ("raw", (("base", "raw"),)),
    ("wb_port", (("base", "wb_port"),)),
    ("tcdm_contention", (("base", "tcdm_contention"),
                         ("base", "residual"))),
)


@dataclass
class Step:
    """One waterfall bar: the exact cycle delta this category explains."""
    name: str
    delta: Fraction
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "delta": float(self.delta),
                "delta_exact": str(self.delta), "detail": dict(self.detail)}


@dataclass
class Attribution:
    """An exact A→B cycle-delta decomposition (see module docstring)."""
    kind: str                 # "evaluate" (cluster Reports) | "plan" (block)
    which: str                # "copift" | "base"
    kernel: str
    label_a: str
    label_b: str
    cycles_a: float           # as recorded (int for the homogeneous path)
    cycles_b: float
    steps: list = field(default_factory=list)
    checks: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    @property
    def delta(self) -> float:
        return self.cycles_b - self.cycles_a

    @property
    def speedup(self) -> float:
        """>1 when B is faster."""
        return self.cycles_a / self.cycles_b if self.cycles_b else float("inf")

    @property
    def exact(self) -> bool:
        """Do the step deltas sum bit-for-bit to the recorded cycle delta,
        with every endpoint/consistency check green?"""
        total = sum((s.delta for s in self.steps), Fraction(0))
        return (total == Fraction(self.cycles_b) - Fraction(self.cycles_a)
                and all(c["ok"] for c in self.checks))

    def to_dict(self) -> dict:
        def _j(v):
            return str(v) if isinstance(v, Fraction) else v
        return {
            "kind": self.kind, "which": self.which, "kernel": self.kernel,
            "label_a": self.label_a, "label_b": self.label_b,
            "cycles_a": self.cycles_a, "cycles_b": self.cycles_b,
            "delta": self.delta, "speedup": self.speedup,
            "exact": self.exact,
            "steps": [s.to_dict() for s in self.steps],
            "checks": [{k: _j(v) for k, v in c.items()} for c in self.checks],
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Attribution":
        """Rebuild from :meth:`to_dict` output (JSON round-trip).  Step
        deltas are restored from their exact-Fraction string so the
        :attr:`exact` verdict survives serialization bit-for-bit."""
        steps = [Step(name=s["name"],
                      delta=Fraction(s.get("delta_exact", s["delta"])),
                      detail=dict(s.get("detail", {})))
                 for s in doc.get("steps", ())]
        return cls(kind=doc["kind"], which=doc["which"],
                   kernel=doc["kernel"], label_a=doc["label_a"],
                   label_b=doc["label_b"], cycles_a=doc["cycles_a"],
                   cycles_b=doc["cycles_b"], steps=steps,
                   checks=[dict(c) for c in doc.get("checks", ())],
                   meta=dict(doc.get("meta", {})))

    @classmethod
    def render_dict(cls, doc: dict, width: int = 40) -> str:
        """Render a :meth:`to_dict` document without rebuilding it first
        at the call site."""
        return cls.from_dict(doc).render(width=width)

    def render(self, width: int = 40) -> str:
        """ASCII waterfall: one signed bar per category, scaled to the
        largest |delta| (``-`` bars are cycles saved going A→B)."""
        lines = [f"attribution [{self.which}] {self.kernel}: "
                 f"{self.label_a} -> {self.label_b}   "
                 f"{self.cycles_a:g} -> {self.cycles_b:g} cycles "
                 f"({self.speedup:.3f}x)"]
        top = max((abs(float(s.delta)) for s in self.steps), default=0.0)
        name_w = max((len(s.name) for s in self.steps), default=4)
        for s in self.steps:
            d = float(s.delta)
            n = int(round(abs(d) / top * width)) if top else 0
            bar = ("-" if d < 0 else "+") * n
            lines.append(f"  {s.name.ljust(name_w)} {d:+14.3f}  {bar}")
        lines.append(f"  {'total'.ljust(name_w)} {self.delta:+14.3f}"
                     f"  (exact={self.exact})")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Per-core category state
# ---------------------------------------------------------------------------

def _lane_cats(lane: dict) -> dict:
    """The lane's additive cycle categories as exact Fractions; the
    residual closes the gap to the simulator's ``thread_total`` so the
    category sum IS the thread total, not approximately."""
    cats = {k: Fraction(lane.get(k, 0)) for k in _TT_CATS[:-1]}
    cats["residual"] = Fraction(lane.get("thread_total", 0)) \
        - sum(cats.values())
    return cats


def _zero_cats() -> dict:
    return {k: Fraction(0) for k in _TT_CATS}


def _core_state(core: dict, which: str) -> dict:
    lanes = core.get("lanes", {})
    st = {"freq": core["freq_ghz"], "blocks": core["blocks"]}
    if which == "base":
        st["base"] = _lane_cats(lanes["rv32g"]) if "rv32g" in lanes \
            else _zero_cats()
        return st
    li = lanes.get("int", {})
    lf = lanes.get("fpss", {})
    st.update(combine=core.get("combine", "max"),
              int=_lane_cats(li), fp=_lane_cats(lf),
              oh=li.get("block_overhead", 0),
              launch=li.get("frep_launch", 0),
              first=lf.get("frep_first_iter", 0))
    return st


def _stub_state(freq: float, which: str) -> dict:
    """Zero-work stand-in for a core present on only one side: zero blocks
    contribute zero finish cycles at any clock, so it never perturbs the
    reduction."""
    st = {"freq": freq, "blocks": 0}
    if which == "base":
        st["base"] = _zero_cats()
    else:
        st.update(combine="max", int=_zero_cats(), fp=_zero_cats(),
                  oh=0, launch=0, first=0)
    return st


def _block_cycles(st: dict, which: str) -> int:
    """Replays the recorded per-core identity: lane-category sums truncate
    exactly as the simulator's ``int(thread_total)`` did, then combine by
    the core's phase combinator (``max`` pipelined / ``sum`` serialized)."""
    if which == "base":
        return int(sum(st["base"].values()))
    ic = int(sum(st["int"].values())) + st["oh"] + st["launch"]
    fc = int(sum(st["fp"].values())) + st["first"]
    return ic + fc if st["combine"] == "sum" else max(ic, fc)


def _replay(states: dict, f_ref: float, transfer, which: str) -> Fraction:
    """The cluster reduction, bit-for-bit as ``api.evaluate`` computed it:
    exact integer max over reference-clock cores, IEEE-double ``f_ref/f``
    scaling for the rest (winning only on strict ``>``), DMA floor."""
    at_ref: list[int] = []
    rest: list[tuple] = []
    for st in states.values():
        fin = _block_cycles(st, which) * st["blocks"]
        if st["freq"] == f_ref:
            at_ref.append(fin)
        else:
            rest.append((fin, st["freq"]))
    latest = max(at_ref) if at_ref else 0
    total = Fraction(latest)
    if rest:
        top = max(float(f) * (f_ref / fr) for f, fr in rest)
        if top > latest:
            total = Fraction(top)
    tr = Fraction(transfer)
    return total if total >= tr else tr


# ---------------------------------------------------------------------------
# The hybrid walk
# ---------------------------------------------------------------------------

def _field_total(states: dict, group, key) -> Fraction:
    tot = Fraction(0)
    for st in states.values():
        v = st[key] if group is None else st[group][key]
        tot += Fraction(v)
    return tot


def _walk(sum_a: dict, sum_b: dict, which: str,
          label_a: str, label_b: str, kind: str) -> Attribution:
    checks: list[dict] = []

    def check(name, got, want):
        ok = got == want
        checks.append({"name": name, "ok": ok, "got": got, "want": want})

    cyc_key = "cycles_copift" if which == "copift" else "cycles_base"
    per_core = "block_cycles" if which == "copift" else "base_cycles"

    sides = {}
    for tag, s in (("a", sum_a), ("b", sum_b)):
        states = {c["core"]: _core_state(c, which) for c in s["cores"]}
        # Side consistency: the category state reproduces the recorded
        # per-core and cluster figures before any walking starts.
        for c in s["cores"]:
            check(f"{tag}:core{c['core']}_cycles",
                  _block_cycles(states[c["core"]], which), c[per_core])
        check(f"{tag}:{cyc_key}",
              _replay(states, s["ref_freq_ghz"], s["transfer_cycles"], which),
              Fraction(s[cyc_key]))
        sides[tag] = states

    ids = sorted(set(sides["a"]) | set(sides["b"]))
    for cid in ids:
        if cid not in sides["a"]:
            sides["a"][cid] = _stub_state(sides["b"][cid]["freq"], which)
        if cid not in sides["b"]:
            sides["b"][cid] = _stub_state(sides["a"][cid]["freq"], which)

    a, b = sides["a"], sides["b"]
    cur = deepcopy(a)
    f_ref, transfer = sum_a["ref_freq_ghz"], sum_a["transfer_cycles"]
    t = _replay(cur, f_ref, transfer, which)
    check("endpoint_a", t, Fraction(sum_a[cyc_key]))

    steps: list[Step] = []
    overlap_detail = {}
    if which == "copift":
        # Enter the serialized sandwich: price A on the unpipelined
        # machine.  This delta is (minus) A's dual-issue overlap.
        for st in cur.values():
            st["combine"] = "sum"
        t1 = _replay(cur, f_ref, transfer, which)
        overlap_detail["serialize_a"] = float(t1 - t)
        overlap_entry = t1 - t
        t = t1
    else:
        overlap_entry = Fraction(0)

    cat_steps = _COPIFT_STEPS if which == "copift" else _BASE_STEPS
    for name, fields_ in cat_steps:
        det = {"a": float(sum(_field_total(a, g, k) for g, k in fields_)),
               "b": float(sum(_field_total(b, g, k) for g, k in fields_))}
        for cid in ids:
            for g, k in fields_:
                v = b[cid][k] if g is None else b[cid][g][k]
                if g is None:
                    cur[cid][k] = v
                else:
                    cur[cid][g][k] = v
        t2 = _replay(cur, f_ref, transfer, which)
        steps.append(Step(name, t2 - t, det))
        t = t2

    # Scheduling / DVFS: block assignment, per-core clocks, reference clock.
    for cid in ids:
        cur[cid]["blocks"] = b[cid]["blocks"]
        cur[cid]["freq"] = b[cid]["freq"]
    f_ref = sum_b["ref_freq_ghz"]
    t2 = _replay(cur, f_ref, transfer, which)
    steps.append(Step("schedule", t2 - t,
                      {"f_ref_a": sum_a["ref_freq_ghz"],
                       "f_ref_b": sum_b["ref_freq_ghz"],
                       "total_blocks_a": sum_a["total_blocks"],
                       "total_blocks_b": sum_b["total_blocks"]}))
    t = t2

    transfer = sum_b["transfer_cycles"]
    t2 = _replay(cur, f_ref, transfer, which)
    steps.append(Step("dma", t2 - t,
                      {"transfer_a": sum_a["transfer_cycles"],
                       "transfer_b": sum_b["transfer_cycles"]}))
    t = t2

    if which == "copift":
        # Leave the sandwich: restore B's native combinators.  This delta
        # is B's dual-issue overlap; entry+exit together are the net
        # overlap change the pipelining bought between the two plans.
        for cid in ids:
            cur[cid]["combine"] = b[cid]["combine"]
        t2 = _replay(cur, f_ref, transfer, which)
        overlap_detail["restore_b"] = float(t2 - t)
        steps.append(Step("dual_issue_overlap", overlap_entry + (t2 - t),
                          overlap_detail))
        t = t2

    check("endpoint_b", t, Fraction(sum_b[cyc_key]))
    check("telescoped_sum",
          sum((s.delta for s in steps), Fraction(0)),
          Fraction(sum_b[cyc_key]) - Fraction(sum_a[cyc_key]))

    return Attribution(kind=kind, which=which, kernel=sum_b["name"],
                       label_a=label_a, label_b=label_b,
                       cycles_a=sum_a[cyc_key], cycles_b=sum_b[cyc_key],
                       steps=steps, checks=checks)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _pick_summary(trace, report=None) -> dict:
    sums = [s for s in _summaries(trace) if s.get("kind") == "evaluate"]
    if report is not None:
        sums = [s for s in sums if s["name"] == report.name
                and s["total_blocks"] == report.total_blocks
                and s.get("block", report.block) == report.block]
    if not sums:
        raise ValueError("trace carries no matching 'evaluate' summary — "
                         "run api.evaluate under obs.session(trace=True)")
    return sums[-1]


def attribute(trace_a, trace_b, report_a=None, report_b=None, *,
              which: str = "copift", label_a: str = "A",
              label_b: str = "B") -> Attribution:
    """Attribute the cycle delta between two traced ``api.evaluate`` runs.

    ``trace_a``/``trace_b`` are recorders, obs Sessions, or exported
    chrome-trace dicts; pass the matching ``Report``\\ s to select the right
    summary when a trace holds several.  ``which`` picks the COPIFT or the
    RV32G-baseline cycle path.
    """
    if which not in ("copift", "base"):
        raise ValueError(f"which must be 'copift' or 'base', got {which!r}")
    return _walk(_pick_summary(trace_a, report_a),
                 _pick_summary(trace_b, report_b),
                 which, label_a, label_b, kind="evaluate")


def attribute_evaluate(spec, target_a=None, target_b=None, *,
                       plan_a=None, plan_b=None, blocks_per_core: int = 1,
                       total_blocks: int | None = None,
                       which: str = "copift", label_a: str | None = None,
                       label_b: str | None = None) -> Attribution:
    """Trace-and-attribute in one call: evaluates ``spec`` twice (Target
    A/B and/or plan A/B), each in its own trace session, and returns the
    exact waterfall.  The two ``Report``\\ s ride along as
    ``attribution.report_a`` / ``report_b``."""
    from repro_torch.api.evaluate import evaluate
    from repro_torch.obs.session import session

    reports = []
    sums = []
    for tgt, plan in ((target_a, plan_a), (target_b, plan_b)):
        with session(trace=True, metrics=False) as sess:
            rep = evaluate(spec, tgt, blocks_per_core=blocks_per_core,
                           total_blocks=total_blocks, plan=plan)
        reports.append(rep)
        sums.append(_pick_summary(sess.recorder, rep))
    if label_a is None:
        label_a = "default" if plan_a is None else "plan_a"
    if label_b is None:
        label_b = "default" if plan_b is None else "plan_b"
    out = _walk(sums[0], sums[1], which, label_a, label_b, kind="evaluate")
    out.report_a, out.report_b = reports
    return out


def _plan_summary(w, cand) -> tuple:
    """Trace one tuner candidate's per-block timing and dress it as a
    single-core evaluate summary, so the same walk machinery prices it."""
    from repro_torch.core.timing import (copift_block_timing,
                                         copift_serial_block_timing)
    from repro_torch.obs.record import TraceRecorder, recording
    from repro_torch.tune.cost import _canonicalize, tuned_schedule

    cand = _canonicalize(w, cand)
    sched = tuned_schedule(w, cand)
    timing = (copift_block_timing if cand.pipelined
              else copift_serial_block_timing)
    rec = TraceRecorder()
    with recording(rec):
        bt = timing(sched, cand.block)
    lanes = {ln: dict(tot) for ln, tot in rec.lane_micro.items()}
    summary = dict(
        kind="evaluate", name=w.name, block=cand.block, total_blocks=1,
        ref_freq_ghz=1.0, transfer_cycles=0,
        cycles_copift=bt.cycles, cycles_base=0,
        cores=[dict(core=0, freq_ghz=1.0, blocks=1,
                    block_cycles=bt.cycles, int_cycles=bt.int_cycles,
                    fp_cycles=bt.fp_cycles, base_cycles=0,
                    combine="max" if cand.pipelined else "sum",
                    lanes=lanes)])
    return summary, cand, bt


def attribute_plans(workload, cand_a, cand_b, *, label_a: str = "default",
                    label_b: str = "tuned") -> Attribution:
    """Per-block attribution between two tuner candidates — works for
    *every* tunable workload, including the tuner-only ones (``softmax``,
    ``prng``) that have no RV32G baseline and so cannot go through
    ``api.evaluate``.  The waterfall decomposes the steady-state per-block
    cycle delta at the nominal point (contention-free single PE); for
    per-island block plans the shared ``block`` knob is what's priced.

    ``workload`` is a ``tune.workloads.Workload``, a registry
    ``KernelSpec``, or a kernel name.
    """
    if not (hasattr(workload, "make_schedule")
            and hasattr(workload, "max_block")):
        from repro_torch.api.registry import kernel
        workload = kernel(workload).get_workload()
    sum_a, cand_a, bt_a = _plan_summary(workload, cand_a)
    sum_b, cand_b, bt_b = _plan_summary(workload, cand_b)
    out = _walk(sum_a, sum_b, "copift", label_a, label_b, kind="plan")
    out.meta.update(plan_a=cand_a.to_dict(), plan_b=cand_b.to_dict(),
                    block_a=cand_a.block, block_b=cand_b.block)
    return out
