"""Run one cell of the benchmark once, on the card, and print its result.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``src/repro_torch``).
Set-up (imports, the program's kernels, the seeded weights on the card,
the warm-up of the cell's shapes) runs from the start of the process to
the window; the window runs whole units of the cell's traffic for
``--seconds``; then the program's state is freed and the reference checks
what the window produced.  ``--trace 1`` runs the same window, then the
traffic's ``trace_units`` units under ``torch.profiler``, and prints the
per-layer metrics instead of the end-to-end ones (a host-clock metric
reads the untraced window, a device-trace metric the traced units).  The last line on standard output is the result, one
JSON object; the numbers the check compared, each with its limit, are the
last lines on standard error and the result's last key.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    benchmark = harness.load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in benchmark["workloads"]}.get(args.workload)
    if entry is None:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    cell, config, traffic = harness.cell_files(args.workload)
    phases = {"imports": time.perf_counter() - T0}
    harness.require_card(entry["chips"])
    torch.cuda.reset_peak_memory_stats()
    phases["card"] = time.perf_counter() - T0 - phases["imports"]
    ctx = harness.Context(cell, config, traffic, args.seed)
    run = harness.driver(traffic["kind"]).Run(ctx)
    run.setup()
    ctx.setup_s = time.perf_counter() - T0 - getattr(run, "check_s", 0.0)
    phases.update(run.phases)
    print("set-up " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()),
          file=sys.stderr)

    result, lines = harness.measure(benchmark, ctx, run, args.seconds,
                                    bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"the run holds {found} after its window", file=sys.stderr)
        return 3
    result["device"]["count"] = entry["chips"]
    check = result.pop("check")
    result["card"] = {"name_power_limit": f"{result['device']['kind']}, "
                                          f"{harness.smi('power.limit')}"}
    result["check"] = check
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except harness.NoCard as e:
        print(e, file=sys.stderr)
        sys.exit(2)
