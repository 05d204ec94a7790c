"""Self-contained HTML observability report (plus a terminal summary); a
self-standing copy of the JAX package's ``repro.obs.report``: given the same
recorder, attribution, history and ``title``, the HTML is byte-equal to the
JAX package's.

One static file, no external assets (open it from an artifact zip in any
browser), built from the three layers this subsystem carries:

* the **per-lane issue timeline** and exact **stall-class breakdown** of a
  traced run (:mod:`repro_torch.obs.record` / :mod:`~repro_torch.obs.export`);
* the differential **attribution waterfall** between two plans
  (:mod:`repro_torch.obs.attrib`) — where the tuned plan's speedup came from;
* **metric trend sparklines** over the append-only history store
  (:mod:`repro_torch.obs.history`), with soft/hard regressions vs the rolling
  baseline highlighted inline.

Everything here runs on the host over the analytic model; no kernel is
launched.  CLI:

    PYTHONPATH=src python -m repro_torch.obs.report softmax \\
        --history BENCH_history_torch.jsonl --out obs_report.html
"""

from __future__ import annotations

import argparse
import html
import json
import sys

from repro_torch.obs.export import _recorder_of, render_timeline

_CAT_COLORS = {
    "busy": "#43a047", "raw": "#e53935", "wb_port": "#fb8c00",
    "tcdm_contention": "#8e24aa", "block_overhead": "#1e88e5",
    "frep_launch": "#00897b", "frep_first_iter": "#00acc1",
}
_FALLBACK_COLOR = "#9e9e9e"

_CSS = """
body{font:14px/1.5 system-ui,sans-serif;margin:2em auto;max-width:70em;
     color:#222}
h1{font-size:1.4em;border-bottom:2px solid #ddd;padding-bottom:.3em}
h2{font-size:1.1em;margin-top:2em}
table{border-collapse:collapse;font-size:.85em}
td,th{border:1px solid #ddd;padding:.25em .6em;text-align:right}
th{background:#f5f5f5}
td:first-child,th:first-child{text-align:left}
.lane-label{font:11px monospace}
.legend span{display:inline-block;margin-right:1em;font-size:.8em}
.legend i{display:inline-block;width:.8em;height:.8em;margin-right:.3em;
          border-radius:2px}
.ok{color:#2e7d32}.bad{color:#c62828}.soft{color:#ef6c00}
.meta{color:#777;font-size:.85em}
svg{background:#fafafa;border:1px solid #eee}
"""


def _e(x) -> str:
    return html.escape(str(x))


def _color(name: str) -> str:
    return _CAT_COLORS.get(name, _FALLBACK_COLOR)


def _legend(keys) -> str:
    items = "".join(
        f'<span><i style="background:{_color(k)}"></i>{_e(k)}</span>'
        for k in keys)
    return f'<div class="legend">{items}</div>'


# ---------------------------------------------------------------------------
# Trace sections
# ---------------------------------------------------------------------------

def _timeline_svg(rec, width: int = 960, row_h: int = 14,
                  max_events: int = 4000) -> str:
    lanes = sorted(set(rec.lane_micro) | set(rec._cursor))
    if not lanes:
        return "<p class='meta'>(no lanes recorded)</p>"
    horizon = max([rec._cursor.get(ln, 0) for ln in lanes] + [1])
    label_w = 220
    h = row_h * len(lanes) + 20
    parts = [f'<svg width="{width + label_w}" height="{h}" '
             f'viewBox="0 0 {width + label_w} {h}">']
    scale = width / horizon
    for i, ln in enumerate(lanes):
        y = i * row_h + 4
        parts.append(f'<text x="2" y="{y + row_h - 5}" class="lane-label" '
                     f'font-size="10" font-family="monospace">'
                     f'{_e(ln)}</text>')
        parts.append(f'<rect x="{label_w}" y="{y}" width="{width}" '
                     f'height="{row_h - 3}" fill="#eee"/>')
    row_of = {ln: i for i, ln in enumerate(lanes)}
    n = 0
    for lane, ts, dur, name, cat in rec.events:
        if n >= max_events:
            break
        n += 1
        i = row_of[lane]
        y = i * row_h + 4
        x = label_w + ts * scale
        w = max(dur * scale, 0.5)
        color = "#43a047" if cat == "instr" else _color(name)
        parts.append(f'<rect x="{x:.2f}" y="{y}" width="{w:.2f}" '
                     f'height="{row_h - 3}" fill="{color}">'
                     f'<title>{_e(name)} @{ts} (+{dur})</title></rect>')
    parts.append("</svg>")
    note = ("<p class='meta'>micro events are representative windows; "
            "exact aggregates below"
            + (f" ({rec.dropped_events} events dropped)"
               if rec.dropped_events else "") + "</p>")
    return "".join(parts) + note


def _stall_breakdown(rec, width: int = 700, row_h: int = 22) -> str:
    lanes = {ln: {k: v for k, v in tot.items() if k != "thread_total"}
             for ln, tot in sorted(rec.lane_micro.items())}
    lanes = {ln: tot for ln, tot in lanes.items() if tot}
    if not lanes:
        return "<p class='meta'>(no lane aggregates)</p>"
    top = max(sum(tot.values()) for tot in lanes.values())
    cats = sorted({k for tot in lanes.values() for k in tot})
    label_w = 220
    h = row_h * len(lanes) + 4
    parts = [f'<svg width="{width + label_w}" height="{h}">']
    rows = []
    for i, (ln, tot) in enumerate(lanes.items()):
        y = i * row_h + 2
        parts.append(f'<text x="2" y="{y + row_h - 8}" font-size="10" '
                     f'font-family="monospace">{_e(ln)}</text>')
        x = float(label_w)
        for k in cats:
            v = tot.get(k, 0)
            if not v:
                continue
            w = v / top * width
            parts.append(f'<rect x="{x:.2f}" y="{y}" width="{w:.2f}" '
                         f'height="{row_h - 6}" fill="{_color(k)}">'
                         f'<title>{_e(k)}: {v:g}</title></rect>')
            x += w
        rows.append((ln, tot))
    parts.append("</svg>")
    head = "".join(f"<th>{_e(c)}</th>" for c in cats)
    body = "".join(
        "<tr><td>" + _e(ln) + "</td>"
        + "".join(f"<td>{tot.get(c, 0):g}</td>" for c in cats) + "</tr>"
        for ln, tot in rows)
    table = (f"<table><tr><th>lane</th>{head}</tr>{body}</table>")
    return _legend(cats) + "".join(parts) + table


# ---------------------------------------------------------------------------
# Attribution waterfall
# ---------------------------------------------------------------------------

def _waterfall_svg(att: dict, width: int = 760, row_h: int = 26) -> str:
    """Floating-bar waterfall from ``Attribution.to_dict()`` (or the
    object itself)."""
    if hasattr(att, "to_dict"):
        att = att.to_dict()
    steps = att["steps"]
    runs = [att["cycles_a"]]
    for s in steps:
        runs.append(runs[-1] + s["delta"])
    lo = min(runs + [att["cycles_b"]])
    hi = max(runs + [att["cycles_a"]])
    span = (hi - lo) or 1.0
    label_w = 200
    n_rows = len(steps) + 2
    h = n_rows * row_h + 8

    def x(v):
        return label_w + (v - lo) / span * width

    parts = [f'<svg width="{width + label_w + 120}" height="{h}">']

    def bar(i, name, x0, x1, color, text):
        y = i * row_h + 4
        parts.append(f'<text x="2" y="{y + row_h - 12}" font-size="11" '
                     f'font-family="monospace">{_e(name)}</text>')
        parts.append(f'<rect x="{min(x0, x1):.2f}" y="{y}" '
                     f'width="{max(abs(x1 - x0), 1):.2f}" '
                     f'height="{row_h - 8}" fill="{color}"/>')
        parts.append(f'<text x="{max(x0, x1) + 6:.2f}" '
                     f'y="{y + row_h - 12}" font-size="11">{_e(text)}</text>')

    bar(0, att["label_a"], x(0) if lo <= 0 else x(lo), x(att["cycles_a"]),
        "#607d8b", f"{att['cycles_a']:g}")
    run = att["cycles_a"]
    for i, s in enumerate(steps):
        nxt = run + s["delta"]
        color = "#43a047" if s["delta"] < 0 else (
            "#e53935" if s["delta"] > 0 else "#bdbdbd")
        bar(i + 1, s["name"], x(run), x(nxt), color, f"{s['delta']:+g}")
        run = nxt
    bar(len(steps) + 1, att["label_b"], x(0) if lo <= 0 else x(lo),
        x(att["cycles_b"]), "#607d8b", f"{att['cycles_b']:g}")
    parts.append("</svg>")
    exact = ("<span class='ok'>exact ✓ (steps sum bit-for-bit to the "
             "cycle delta)</span>" if att["exact"]
             else "<span class='bad'>INEXACT</span>")
    meta = (f"<p>{_e(att['kernel'])}: {_e(att['label_a'])} → "
            f"{_e(att['label_b'])}, {att['cycles_a']:g} → "
            f"{att['cycles_b']:g} cycles ({att['speedup']:.3f}x) — "
            f"{exact}</p>")
    return meta + "".join(parts)


# ---------------------------------------------------------------------------
# History sparklines
# ---------------------------------------------------------------------------

def _sparklines(records: list, *, max_metrics: int = 60, width: int = 160,
                height: int = 28, window: int = 8) -> str:
    from repro_torch.obs import history as H
    if not records:
        return "<p class='meta'>(no history records)</p>"
    verdicts = {}
    doc = H.detect_regressions(records, window=window)
    for r in doc["regressions"]:
        verdicts[(r["source"], r["metric"])] = r["severity"]
    by_source: dict = {}
    for rec in records:
        by_source.setdefault(rec.get("source", "?"), []).append(rec)
    out = [f"<p class='meta'>{len(records)} records, "
           f"{doc['checked']} metrics checked vs rolling median "
           f"(window {window}); "
           f"{sum(1 for r in doc['regressions'] if r['severity'] == 'hard')}"
           f" hard / "
           f"{sum(1 for r in doc['regressions'] if r['severity'] == 'soft')}"
           f" soft regressions</p>"]
    shown = 0
    rows = []
    for source, recs in sorted(by_source.items()):
        names = sorted({m for r in recs for m in r.get("metrics", {})})
        for name in names:
            if shown >= max_metrics:
                break
            series = [r["metrics"][name] for r in recs
                      if name in r.get("metrics", {})][-40:]
            if len(series) < 2:
                continue
            shown += 1
            lo, hi = min(series), max(series)
            span = (hi - lo) or 1.0
            pts = " ".join(
                f"{i / (len(series) - 1) * (width - 4) + 2:.1f},"
                f"{height - 4 - (v - lo) / span * (height - 8):.1f}"
                for i, v in enumerate(series))
            sev = verdicts.get((source, name))
            klass = {"hard": "bad", "soft": "soft"}.get(sev, "")
            mark = f" <b class='{klass}'>[{sev}]</b>" if sev else ""
            line_color = {"hard": "#c62828", "soft": "#ef6c00"}.get(
                sev, "#1e88e5")
            rows.append(
                f"<tr><td style='text-align:left'>"
                f"<code>{_e(source)}/{_e(name)}</code>{mark}</td>"
                f"<td><svg width='{width}' height='{height}'>"
                f"<polyline points='{pts}' fill='none' "
                f"stroke='{line_color}' stroke-width='1.5'/></svg></td>"
                f"<td>{series[0]:g}</td><td>{series[-1]:g}</td></tr>")
    out.append("<table><tr><th>metric</th><th>trend</th><th>first</th>"
               "<th>last</th></tr>" + "".join(rows) + "</table>")
    if shown >= max_metrics:
        out.append(f"<p class='meta'>(showing first {max_metrics} metrics)"
                   f"</p>")
    return "".join(out)


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def html_report(*, trace=None, attribution=None, history=None,
                title: str = "repro_torch observability report",
                window: int = 8) -> str:
    """Build the standalone HTML document.

    ``trace`` — recorder / obs ``Session`` (timeline + stall breakdown);
    ``attribution`` — one :class:`~repro_torch.obs.attrib.Attribution` (or its
    ``to_dict()``, or a list of either); ``history`` — a records list or a
    store path for :func:`repro_torch.obs.history.read_history`.
    """
    body = [f"<h1>{_e(title)}</h1>"]
    rec = _recorder_of(trace) if trace is not None else None
    if rec is not None:
        body.append("<h2>Per-lane issue timeline</h2>")
        body.append(_timeline_svg(rec))
        body.append("<h2>Stall breakdown (exact aggregates)</h2>")
        body.append(_stall_breakdown(rec))
    if attribution is not None:
        atts = attribution if isinstance(attribution, (list, tuple)) \
            else [attribution]
        body.append("<h2>Attribution waterfall</h2>")
        for att in atts:
            body.append(_waterfall_svg(att))
    if history is not None:
        if isinstance(history, (str, bytes)) or hasattr(history, "__fspath__"):
            from repro_torch.obs.history import read_history
            history = read_history(history)
        body.append("<h2>Metric trends (history store)</h2>")
        body.append(_sparklines(list(history), window=window))
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_e(title)}</title><style>{_CSS}</style></head>"
            f"<body>{''.join(body)}</body></html>")


def save_report(path, **kwargs) -> str:
    path = str(path)
    with open(path, "w") as f:
        f.write(html_report(**kwargs))
    return path


def terminal_summary(*, trace=None, attribution=None, history=None,
                     width: int = 100, window: int = 8) -> str:
    """The same three sections as text — what the CLI prints."""
    parts = []
    rec = _recorder_of(trace) if trace is not None else None
    if rec is not None:
        parts.append(render_timeline(rec, width))
    if attribution is not None:
        atts = attribution if isinstance(attribution, (list, tuple)) \
            else [attribution]
        for att in atts:
            parts.append(att.render() if hasattr(att, "render")
                         else json.dumps(att, indent=1))
    if history is not None:
        from repro_torch.obs import history as H
        if isinstance(history, (str, bytes)) \
                or hasattr(history, "__fspath__"):
            history = H.read_history(history)
        doc = H.detect_regressions(list(history), window=window)
        parts.append("\n".join(H.format_regressions(doc)))
    return "\n\n".join(parts) if parts else "(nothing to report)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.splitlines()[0])
    ap.add_argument("kernel", nargs="?", default="softmax",
                    help="registry kernel to trace (default softmax)")
    ap.add_argument("--cores", type=int, default=8,
                    help="homogeneous core count (default 8)")
    ap.add_argument("--history", default=None, metavar="PATH",
                    help="metric history store to render sparklines from")
    ap.add_argument("--window", type=int, default=8,
                    help="rolling-baseline window for the regression "
                         "highlights (default 8)")
    ap.add_argument("--no-attrib", action="store_true",
                    help="skip the tuned-vs-default attribution waterfall")
    ap.add_argument("--out", default="obs_report.html", metavar="PATH",
                    help="output HTML path (default obs_report.html)")
    ap.add_argument("--width", type=int, default=100,
                    help="terminal timeline width (default 100)")
    args = ap.parse_args(argv)

    from repro_torch.obs.trace import trace_kernel
    try:
        sess, result, checks = trace_kernel(args.kernel, n_cores=args.cores)
    except KeyError:
        from repro_torch.api.registry import specs
        ap.error(f"unknown kernel {args.kernel!r}; known: "
                 f"{', '.join(s.name for s in specs())}")

    attribution = None
    if not args.no_attrib:
        try:
            from repro_torch.api.tuner import Tuner
            attribution = Tuner().attribute(args.kernel)
        except (KeyError, ValueError) as e:
            print(f"report.attribution_skipped,{e}")

    print(terminal_summary(trace=sess, attribution=attribution,
                           history=args.history, width=args.width,
                           window=args.window))
    path = save_report(args.out, trace=sess, attribution=attribution,
                       history=args.history,
                       title=f"repro_torch observability — {args.kernel}",
                       window=args.window)
    print(f"\nreport.written,{path}")
    if checks is not None and not checks["ok"]:
        print("report.reconcile_failed")
        return 1
    if attribution is not None and not attribution.exact:
        print("report.attribution_inexact")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
