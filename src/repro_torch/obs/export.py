"""Trace export + reconciliation; a self-standing copy of the JAX
package's ``repro.obs.export``.

* :func:`chrome_trace` — serialize a :class:`~repro_torch.obs.record.TraceRecorder`
  into Chrome-trace / Perfetto JSON (open at https://ui.perfetto.dev or
  ``chrome://tracing``).  The simulated cycle domain lands on one "process"
  (one thread per lane, 1 µs ↔ 1 cycle), wall-clock spans on another.
* :func:`render_timeline` — a terminal view of the same lanes.
* :func:`reconcile` — check the exported accounting against a ``Report``:
  per-lane busy+stall sums → per-core thread cycles → the cluster's
  reference-clock reduction → ``Report.cycles_copift`` / ``cycles_base``,
  every step exact (the float steps replicate ``api.evaluate``'s own
  arithmetic bit-for-bit).
"""

from __future__ import annotations

import json
import math

_SIM_PID = 1
_HOST_PID = 2


def _recorder_of(obj):
    """Accept a TraceRecorder, an obs Session, or a chrome-trace dict."""
    if hasattr(obj, "events") and hasattr(obj, "summaries"):
        return obj
    rec = getattr(obj, "recorder", None)
    if rec is not None:
        return rec
    return None


def chrome_trace(rec, metrics_snapshot: dict | None = None) -> dict:
    """The recorder's contents as a Chrome-trace JSON object."""
    events: list[dict] = []
    events.append({"ph": "M", "pid": _SIM_PID, "name": "process_name",
                   "args": {"name": "snitch-sim (1us = 1 cycle)"}})
    events.append({"ph": "M", "pid": _HOST_PID, "name": "process_name",
                   "args": {"name": "host (wall clock)"}})
    lanes = sorted(set(rec.lane_micro) | set(rec._cursor))
    tid_of = {lane: i + 1 for i, lane in enumerate(lanes)}
    for lane, tid in tid_of.items():
        events.append({"ph": "M", "pid": _SIM_PID, "tid": tid,
                       "name": "thread_name", "args": {"name": lane}})
    # Per-lane envelope slice: the exact aggregate accounting as args, the
    # instruction/stall slices nested visually inside it.
    for lane, tid in tid_of.items():
        end = rec._cursor.get(lane, 0)
        micro = rec.lane_micro.get(lane, {})
        events.append({"name": f"lane:{lane}", "cat": "lane_summary",
                       "ph": "X", "pid": _SIM_PID, "tid": tid,
                       "ts": 0, "dur": max(end, 1),
                       "args": {k: v for k, v in sorted(micro.items())}})
    for lane, ts, dur, name, cat in rec.events:
        events.append({"name": name, "cat": cat, "ph": "X",
                       "pid": _SIM_PID, "tid": tid_of[lane],
                       "ts": ts, "dur": dur, "args": {}})
    events.append({"ph": "M", "pid": _HOST_PID, "tid": 1,
                   "name": "thread_name", "args": {"name": "spans"}})
    for sp in rec.spans:
        args = dict(sp["attrs"])
        args.update(memo_hits=sp["memo_hits"], memo_misses=sp["memo_misses"],
                    memo_provenance=sp["memo_provenance"], depth=sp["depth"])
        events.append({"name": sp["name"], "cat": "span", "ph": "X",
                       "pid": _HOST_PID, "tid": 1,
                       "ts": sp["start_s"] * 1e6, "dur": sp["dur_s"] * 1e6,
                       "args": args})
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ns",
        "otherData": {
            "memo_provenance": dict(rec.memo_provenance),
            "dropped_events": rec.dropped_events,
            "lane_micro": {k: dict(v) for k, v in rec.lane_micro.items()},
            "block_records": list(rec.block_records),
            "summaries": list(rec.summaries),
        },
    }
    if metrics_snapshot is not None:
        doc["otherData"]["metrics"] = metrics_snapshot
    return doc


def save_chrome_trace(rec, path, metrics_snapshot: dict | None = None) -> str:
    path = str(path)
    with open(path, "w") as f:
        json.dump(chrome_trace(rec, metrics_snapshot), f)
    return path


# ---------------------------------------------------------------------------
# Terminal timeline
# ---------------------------------------------------------------------------

def render_timeline(rec, width: int = 80) -> str:
    """ASCII lanes: ``#`` = issue slot, ``.`` = stall, blank = idle/untraced.
    Micro events are representative windows (see record.py), so the bars
    illustrate *shape*; the numbers on the right are the exact aggregates."""
    lanes = sorted(set(rec.lane_micro) | set(rec._cursor))
    if not lanes:
        return "(no lanes recorded)"
    horizon = max([rec._cursor.get(ln, 0) for ln in lanes] + [1])
    scale = horizon / width
    name_w = max([len(ln) for ln in lanes] + [4])
    header = "issue timeline (#=issue .=stall)".ljust(width)[:width]
    lines = [f"{'lane'.ljust(name_w)} |{header}|"]
    by_lane: dict[str, list] = {ln: [] for ln in lanes}
    for lane, ts, dur, name, cat in rec.events:
        by_lane[lane].append((ts, dur, cat))
    for lane in lanes:
        chars = [" "] * width
        for ts, dur, cat in by_lane[lane]:
            lo = min(width - 1, int(ts / scale))
            hi = min(width - 1, int((ts + max(dur, 1) - 1) / scale))
            for i in range(lo, hi + 1):
                if cat == "instr":
                    chars[i] = "#"
                elif chars[i] == " ":
                    chars[i] = "."
        micro = rec.lane_micro.get(lane, {})
        busy = micro.get("busy", 0)
        stalls = sum(v for k, v in micro.items()
                     if k not in ("busy", "thread_total"))
        lines.append(f"{lane.ljust(name_w)} |{''.join(chars)}| "
                     f"busy={busy:g} stalls={stalls:g}")
    if rec.spans:
        lines.append("")
        lines.append("spans:")
        for sp in sorted(rec.spans, key=lambda s: s["start_s"]):
            indent = "  " * sp["depth"]
            lines.append(f"{indent}{sp['name']}  {sp['dur_s'] * 1e3:.2f} ms"
                         f"  memo={sp['memo_provenance']}")
    if rec.dropped_events:
        lines.append(f"({rec.dropped_events} micro events dropped; "
                     f"aggregates remain exact)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Exact reconciliation against Report
# ---------------------------------------------------------------------------

def _summaries(trace) -> list[dict]:
    rec = _recorder_of(trace)
    if rec is not None:
        return list(rec.summaries)
    if isinstance(trace, dict):
        return list(trace.get("otherData", {}).get("summaries", []))
    raise TypeError(f"cannot extract summaries from {type(trace).__name__}")


def _lane_thread_cycles(lane: dict) -> float:
    """The lane's exact simulated thread total.  ``thread_total`` is the
    pre-truncation float the simulator itself produced; the busy+stall
    decomposition must agree with it (checked separately)."""
    return lane["thread_total"]


def _lane_decomposition(lane: dict) -> float:
    return (lane.get("busy", 0) + lane.get("raw", 0)
            + lane.get("wb_port", 0) + lane.get("tcdm_contention", 0))


def reconcile(trace, report=None) -> dict:
    """Check a traced ``api.evaluate`` run's cycle accounting.

    Verifies, per evaluate summary (optionally filtered to ``report``):

    1. per-lane: busy + stall-class cycles equal the simulator's thread
       total (float-exact);
    2. per-core: ``int(int-lane total) + overhead + FREP launch`` equals
       the recorded integer-thread cycles, the FP lane total the FP-thread
       cycles, and ``max(int, fp)`` the block cycles (and likewise the
       rv32g lane vs baseline cycles);
    3. cluster: the reference-clock reduction over per-core finish times
       (replicating ``api.evaluate._compute_cycles``) and the DMA floor
       reproduce ``cycles_copift`` / ``cycles_base`` exactly — compared
       against the ``Report`` when one is given.

    Returns ``{"ok": bool, "checks": [...], "summaries": n}``.
    """
    checks: list[dict] = []

    def check(name, got, want, exact=True):
        ok = (got == want) if exact else math.isclose(
            got, want, rel_tol=0, abs_tol=1e-6)
        checks.append({"name": name, "ok": ok, "got": got, "want": want})
        return ok

    sums = [s for s in _summaries(trace) if s.get("kind") == "evaluate"]
    if report is not None:
        sums = [s for s in sums if s["name"] == report.name
                and s["total_blocks"] == report.total_blocks
                and s.get("block", report.block) == report.block]
        sums = sums[-1:]
    if not sums:
        return {"ok": False, "checks": [
            {"name": "summary_present", "ok": False,
             "got": 0, "want": ">=1"}], "summaries": 0}

    for s in sums:
        finish_c, finish_b = [], []
        f_ref = s["ref_freq_ghz"]
        for core in s["cores"]:
            cid = core["core"]
            lanes = core.get("lanes", {})
            for lname, lane in lanes.items():
                if "thread_total" in lane:
                    check(f"lane_decomposition[{cid}/{lname}]",
                          _lane_decomposition(lane),
                          _lane_thread_cycles(lane), exact=False)
            if "int" in lanes:
                li = lanes["int"]
                check(f"int_lane_cycles[{cid}]",
                      int(_lane_thread_cycles(li))
                      + li.get("block_overhead", 0)
                      + li.get("frep_launch", 0),
                      core["int_cycles"])
            if "fpss" in lanes:
                lf = lanes["fpss"]
                check(f"fp_lane_cycles[{cid}]",
                      int(_lane_thread_cycles(lf))
                      + lf.get("frep_first_iter", 0),
                      core["fp_cycles"])
            if "rv32g" in lanes:
                check(f"baseline_lane_cycles[{cid}]",
                      int(_lane_thread_cycles(lanes["rv32g"])),
                      core["base_cycles"])
            if core.get("combine", "max") == "sum":
                # Step-5 pipelining off (paper Fig. 1f): the int and FP
                # phases serialize instead of overlapping.
                check(f"serial_phase_sum[{cid}]",
                      core["int_cycles"] + core["fp_cycles"],
                      core["block_cycles"])
            else:
                check(f"dual_issue_max[{cid}]",
                      max(core["int_cycles"], core["fp_cycles"]),
                      core["block_cycles"])
            finish_c.append((core["block_cycles"] * core["blocks"],
                             core["freq_ghz"]))
            finish_b.append((core["base_cycles"] * core["blocks"],
                             core["freq_ghz"]))

        def reduce_ref(finish):
            # Replicates api.evaluate._compute_cycles: exact int64 max over
            # reference-clock cores; float64 f_ref/f scaling for the rest;
            # the scaled max only wins on strict '>'.
            at_ref = [f for f, fr in finish if fr == f_ref]
            latest = max(at_ref) if at_ref else 0
            rest = [f * (f_ref / fr) for f, fr in finish if fr != f_ref]
            if rest:
                top = max(rest)
                if top > latest:
                    latest = top
            return latest

        transfer = s["transfer_cycles"]
        check("cycles_copift", max(reduce_ref(finish_c), transfer),
              s["cycles_copift"])
        check("cycles_base", max(reduce_ref(finish_b), transfer),
              s["cycles_base"])
        if report is not None:
            check("report_cycles_copift", s["cycles_copift"],
                  report.cycles_copift)
            check("report_cycles_base", s["cycles_base"],
                  report.cycles_base)

    return {"ok": all(c["ok"] for c in checks), "checks": checks,
            "summaries": len(sums)}
