"""Persistent metric history — the perf trajectory across commits; a
self-standing copy of the JAX package's ``repro.obs.history``.

One snapshot compares one run; a diff compares exactly two.  This module
gives the numbers a *memory*: an append-only JSONL store (one flat
``{metric: value}`` record per run, stamped with commit SHA + timestamp +
source) and rolling-baseline regression detection over it, so a slow drift
that never trips a single-step diff still trips the gate.

Store location: the ``path`` argument, else ``$REPRO_TORCH_METRIC_HISTORY``,
else ``./BENCH_history_torch.jsonl`` — the port's own store, never the JAX
package's ``$REPRO_METRIC_HISTORY`` / ``BENCH_history.jsonl``, so the two
packages never append to one file (records and rules are the same).
Records are self-describing and the reader is tolerant — a
truncated/corrupt line (an interrupted upload) is skipped and counted,
never fatal.  An unwritable location (read-only checkout, the variable
pointing into a dead mount) degrades to an in-process memory store with
one ``RuntimeWarning`` — same contract as ``repro_torch.tune.cache``:
history *observes*, it never gates, so a benchmark run must not die on the
append.  ``read_history`` merges the memory records back in, so
same-process regression checks still see them.

Regression semantics (``detect_regressions``):

* the **baseline** for each metric is the *median* of its values over the
  last ``window`` prior records from the same source (median, so one bad
  historical run cannot poison the baseline);
* each metric name is classified by first-match ``fnmatch`` rules into a
  direction: ``higher_worse`` (cycles, energy, overheads...),
  ``lower_worse`` (speedups, IPC, savings...), or ``advisory``
  (wall-clock timings — noisy on shared CI runners, reported but never
  gating);
* a directional move beyond ``soft`` (default 2 %) is a soft regression,
  beyond ``hard`` (default 10 %) a hard one.  The CI gate fails only on
  hard regressions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from fnmatch import fnmatch

SCHEMA = 1
ENV_VAR = "REPRO_TORCH_METRIC_HISTORY"
DEFAULT_FILENAME = "BENCH_history_torch.jsonl"

#: In-process fallback store, keyed by resolved path: records that could
#: not be appended because the location is unwritable.  One warning per
#: path per process (``_WARNED``); nothing persists, but same-process
#: readers still see the records.
_MEMORY: dict = {}
_WARNED: set = set()

#: First-match metric-name classification.  Wall-clock figures (host
#: seconds, throughput, measured overheads) are advisory: CI runners are
#: shared and noisy, and the hard wall-clock gates live in the benches
#: themselves (e.g. obs_bench's 5 % exit).  Model outputs — cycles,
#: energy, speedups, IPC — are deterministic, so any drift is a real
#: model change.
DIRECTION_RULES: tuple = (
    ("*seconds*", "advisory"),
    ("*per_sec*", "advisory"),
    ("*_us*", "advisory"),
    ("*overhead*", "advisory"),
    ("*speedup*", "lower_worse"),
    ("*ipc*", "lower_worse"),
    ("*saving*", "lower_worse"),
    ("*cycles*", "higher_worse"),
    # Serving-simulator quality figures (benchmarks/serve_bench.py):
    # latency percentiles and drops are deterministic model outputs, so
    # any upward drift is a real serving regression; ``slo_met`` is a
    # 0/1 flag that must not fall.  These sit before the generic energy/
    # power rules only for documentation — the directions agree.
    ("*p99*", "higher_worse"),
    ("*latency*", "higher_worse"),
    ("*dropped*", "higher_worse"),
    ("*slo_met*", "lower_worse"),
    ("*shed*", "higher_worse"),
    ("*slo_violations*", "higher_worse"),
    # Manycore scaling figures (benchmarks/system_bench.py): scaling
    # efficiency must not fall, and the saturated-HBM transfer floor
    # must not rise.  ``*eff*`` sits before the generic catch-all so
    # ``system.eff.compute.*`` rows read as quality metrics.
    ("*eff*", "lower_worse"),
    ("*saturated*", "higher_worse"),
    # Resilience figures (benchmarks/resilience_bench.py): lost requests,
    # retries, killed batches and failover remaps must not creep up on
    # the calibrated chaos scenario, and the completed fraction must not
    # fall.  ``*completed_frac*`` sits before the catch-all; the rest
    # are deterministic fault-loop outputs like the serve rows above.
    ("*completed_frac*", "lower_worse"),
    ("*lost*", "higher_worse"),
    ("*retried*", "higher_worse"),
    ("*killed*", "higher_worse"),
    ("*failovers*", "higher_worse"),
    ("*energy*", "higher_worse"),
    ("*power*", "higher_worse"),
    ("*", "advisory"),
)


def history_path(path: "str | os.PathLike | None" = None) -> str:
    return str(path or os.environ.get(ENV_VAR) or DEFAULT_FILENAME)


def _git_sha() -> "str | None":
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


# ---------------------------------------------------------------------------
# Flattening + appending
# ---------------------------------------------------------------------------

def flatten_snapshot(snapshot: dict) -> dict:
    """Every numeric CSV field of a ``BENCH_*.json`` snapshot as one flat
    ``{metric_name: value}`` dict.

    Keys mirror ``benchmarks.run``'s diff identity — the section, the
    line's non-numeric columns, and an occurrence counter for repeated
    keys (``@occ`` only when a key repeats).  The last path component
    names the numeric column: a pure CSV header line (no numeric
    fields, as ``table1``/``fig2``/``tune``/``obs`` emit) names the
    columns of the data lines that follow it —
    ``fig2/fig2.expf/speedup``-style — which is what gives the
    ``DIRECTION_RULES`` their teeth.  A section may switch headers
    mid-stream (``perf``/``serve`` emit several row shapes); each
    header governs until the next one.  Headerless data falls back to
    the column index (``fig2/expf,ipc@1/c2``-style).
    """
    out: dict = {}
    seen: dict = {}
    for section, entry in snapshot.get("sections", {}).items():
        header: list = []
        for line in entry.get("lines") or []:
            key_cols: list = []
            values: list = []
            toks = line.split(",")
            for i, tok in enumerate(toks):
                try:
                    # "+29.5%"-style tokens are data, not identity — left
                    # in the key they would churn the metric name per run.
                    values.append((i, float(tok[:-1] if tok.endswith("%")
                                            else tok)))
                except ValueError:
                    key_cols.append(tok)
            if not values:
                header = toks  # a new header line; carries no data itself
                continue
            key = (section, tuple(key_cols))
            occ = seen.get(key, 0)
            seen[key] = occ + 1
            tag = f"@{occ}" if occ else ""
            base = f"{section}/{','.join(key_cols)}{tag}"
            for col, v in values:
                if math.isfinite(v):
                    name = header[col] if col < len(header) else f"c{col}"
                    out[f"{base}/{name}"] = v
    return out


def append_record(metrics: dict, *, source: str,
                  path: "str | os.PathLike | None" = None,
                  meta: dict | None = None, sha: "str | None" = None,
                  ts: "float | None" = None) -> dict:
    """Append one flat metrics record to the JSONL store; returns it."""
    record = {
        "schema": SCHEMA,
        "ts": time.time() if ts is None else ts,
        "sha": _git_sha() if sha is None else sha,
        "source": source,
        "metrics": {k: float(v) for k, v in sorted(metrics.items())},
        "meta": dict(meta or {}),
    }
    p = history_path(path)
    line = json.dumps(record, sort_keys=True)
    try:
        with open(p, "a") as f:
            f.write(line + "\n")
    except OSError as e:
        _MEMORY.setdefault(p, []).append(record)
        if p not in _WARNED:
            _WARNED.add(p)
            warnings.warn(f"metric history at {p!r} is not writable "
                          f"({e}); falling back to in-memory records",
                          RuntimeWarning, stacklevel=2)
    return record


def append_snapshot(snapshot: dict, *,
                    path: "str | os.PathLike | None" = None,
                    source: str = "benchmarks.run",
                    meta: dict | None = None) -> dict:
    """Flatten a ``BENCH_*.json`` snapshot and append it as one record."""
    meta = dict(meta or {})
    meta.setdefault("sections", sorted(snapshot.get("sections", {})))
    return append_record(flatten_snapshot(snapshot), source=source,
                         path=path, meta=meta)


def read_history(path: "str | os.PathLike | None" = None,
                 source: "str | None" = None) -> list[dict]:
    """All parseable records, oldest first.  Corrupt/truncated lines are
    skipped (counted in the module-level return via ``read_history.skipped``
    — rebound per call) rather than failing the gate.  Records held in the
    in-memory fallback (unwritable path) are appended after the on-disk
    ones — they are by construction the newest for that path."""
    p = history_path(path)
    records: list[dict] = []
    skipped = 0
    try:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if not isinstance(rec, dict) or "metrics" not in rec:
                    skipped += 1
                    continue
                if source is not None and rec.get("source") != source:
                    continue
                records.append(rec)
    except OSError:
        # Missing or unreadable store reads as empty — the in-memory
        # fallback below still surfaces same-process records.
        pass
    for rec in _MEMORY.get(p, []):
        if source is None or rec.get("source") == source:
            records.append(rec)
    read_history.skipped = skipped
    return records


read_history.skipped = 0


# ---------------------------------------------------------------------------
# Rolling-baseline regression detection
# ---------------------------------------------------------------------------

def metric_direction(name: str) -> str:
    for pat, direction in DIRECTION_RULES:
        if fnmatch(name, pat):
            return direction
    return "advisory"


def detect_regressions(records: "list[dict] | None" = None, *,
                       path: "str | os.PathLike | None" = None,
                       window: int = 8, soft: float = 0.02,
                       hard: float = 0.10) -> dict:
    """Compare each source's newest record against its rolling baseline.

    For every metric in the latest record of each source, the baseline is
    the median over (up to) the ``window`` immediately preceding records
    of that source carrying the metric; with no prior value the metric is
    new and skipped.  Returns ``{"ok": no hard regressions,
    "regressions": [...], "improvements": n, "checked": n, ...}`` where
    each regression row carries the metric, direction, baseline, current
    value, signed relative move, and severity (``hard``/``soft``/
    ``info`` — ``info`` rows are advisory-direction moves beyond ``soft``,
    reported for the record but never gating).
    """
    if not 0 <= soft <= hard:
        raise ValueError(f"need 0 <= soft <= hard, got soft={soft} "
                         f"hard={hard}")
    if records is None:
        records = read_history(path)
    by_source: dict = {}
    for rec in records:
        by_source.setdefault(rec.get("source", "?"), []).append(rec)

    regressions: list[dict] = []
    checked = 0
    improvements = 0
    for source, recs in sorted(by_source.items()):
        if len(recs) < 2:
            continue
        latest = recs[-1]
        prior = recs[:-1][-window:] if window > 0 else []
        for name, cur in sorted(latest.get("metrics", {}).items()):
            hist = [r["metrics"][name] for r in prior
                    if name in r.get("metrics", {})]
            if not hist:
                continue
            checked += 1
            base = statistics.median(hist)
            direction = metric_direction(name)
            if cur == base:
                continue
            if base == 0:
                rel = math.inf if cur > 0 else -math.inf
            else:
                rel = (cur - base) / abs(base)
            worse = rel if direction != "lower_worse" else -rel
            if worse < 0:
                improvements += 1
                continue
            if worse < soft:
                continue
            if direction == "advisory":
                severity = "info"
            else:
                severity = "hard" if worse >= hard else "soft"
            regressions.append(dict(
                source=source, metric=name, direction=direction,
                baseline=base, current=cur, rel_delta=rel,
                severity=severity, sha=latest.get("sha"),
                n_baseline=len(hist)))
    regressions.sort(key=lambda r: ({"hard": 0, "soft": 1, "info": 2}
                                    [r["severity"]], r["metric"]))
    return dict(ok=not any(r["severity"] == "hard" for r in regressions),
                regressions=regressions, checked=checked,
                improvements=improvements, window=window,
                soft=soft, hard=hard,
                sources={s: len(r) for s, r in sorted(by_source.items())})


def format_regressions(doc: dict) -> list[str]:
    lines = [f"history.checked,{doc['checked']},window={doc['window']},"
             f"soft={doc['soft']},hard={doc['hard']}"]
    for r in doc["regressions"]:
        rel = ("inf" if math.isinf(r["rel_delta"])
               else f"{r['rel_delta'] * 100:+.2f}%")
        lines.append(f"history.{r['severity']},{r['source']},{r['metric']},"
                     f"{r['baseline']:g},{r['current']:g},{rel}")
    if not doc["regressions"]:
        lines.append("history.clean,no regressions vs rolling baseline")
    return lines


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.obs.history [--check]
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="inspect the metric history store / run the "
                    "rolling-baseline regression gate")
    ap.add_argument("--path", default=None,
                    help=f"store path (default ${ENV_VAR} or "
                         f"./{DEFAULT_FILENAME})")
    ap.add_argument("--source", default=None,
                    help="restrict to one record source")
    ap.add_argument("--check", action="store_true",
                    help="run detect_regressions; exit 1 on any HARD "
                         "regression vs the rolling baseline")
    ap.add_argument("--window", type=int, default=8,
                    help="rolling-baseline window (default 8)")
    ap.add_argument("--soft", type=float, default=0.02,
                    help="soft-regression threshold (default 0.02)")
    ap.add_argument("--hard", type=float, default=0.10,
                    help="hard-regression threshold (default 0.10)")
    args = ap.parse_args(argv)

    records = read_history(args.path, source=args.source)
    skipped = read_history.skipped
    print(f"history.store,{history_path(args.path)},{len(records)}_records,"
          f"{skipped}_corrupt_skipped")
    if args.check:
        doc = detect_regressions(records, window=args.window,
                                 soft=args.soft, hard=args.hard)
        for line in format_regressions(doc):
            print(line)
        if not doc["ok"]:
            print("history.fail,hard regression vs rolling baseline")
            sys.exit(1)
        return
    by_source: dict = {}
    for rec in records:
        by_source.setdefault(rec.get("source", "?"), []).append(rec)
    for source, recs in sorted(by_source.items()):
        last = recs[-1]
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.gmtime(last.get("ts", 0)))
        print(f"history.source,{source},{len(recs)}_records,"
              f"last={when},sha={(last.get('sha') or 'none')[:12]},"
              f"{len(last.get('metrics', {}))}_metrics")


if __name__ == "__main__":
    main()
