"""Read the numbers the check compares, on the card, to set its limits.

  python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--units N]
      [--control fp8 --control-seeds 4,5,6] [--fault half_batch
      --fault-seeds 7,8,9]

For each seed, one run of the cell at its own sizes without a timed
window (serving: ``--units`` calls, at least enough to draw as many
requests as a run compares), then the check's numbers.  With
``--control`` the reference computed in that precision takes the
program's place on ``--control-seeds``; with ``--fault`` the program runs
with that fault planted (``drivers/train.py``) on ``--fault-seeds``.  One
JSON line a reading on standard output, and in
``chiprun_out/calibrate_<cell>.jsonl``.  All seeds run in one process.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402


def ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def reading(cell, config, traffic, seed, units, control=None, fault=None):
    ctx = harness.Context(cell, config, traffic, seed)
    run = harness.driver(traffic["kind"]).Run(ctx)
    t0 = time.perf_counter()
    if fault:
        run.setup(fault=fault)
    else:
        run.setup()
    t1 = time.perf_counter()
    if traffic["kind"] == "serve":
        need = math.ceil(cell["check"]["requests"] / traffic["batch"])
        for _ in range(max(units, need)):
            ctx.units.append(run.unit())
    peak = torch.cuda.max_memory_allocated()
    if hasattr(run, "after_window"):
        run.after_window()
    run.free()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    numbers = run.check(control)
    t3 = time.perf_counter()
    out = {"cell": cell["name"], "seed": seed, "control": control,
           "fault": fault, "numbers": numbers, "setup_s": t1 - t0,
           "units": [u["seconds"] for u in ctx.units],
           "reference_s": t3 - t2, "memory_peak_bytes": peak}
    del run, ctx
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=ints, default=[])
    args = ap.parse_args(argv)
    harness.require_card(1)
    cell, config, traffic = harness.cell_files(args.workload)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = out_dir / f"calibrate_{args.workload}.jsonl"
    plan = [(s, None, None) for s in args.seeds]
    plan += [(s, args.control, None) for s in args.control_seeds]
    plan += [(s, None, args.fault) for s in args.fault_seeds]
    card = f"{torch.cuda.get_device_name(0)}, {harness.smi('power.limit')}"
    for seed, control, fault in plan:
        r = reading(cell, config, traffic, seed, args.units, control, fault)
        r["card"] = card
        line = json.dumps(r)
        print(line, flush=True)
        with open(log, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
