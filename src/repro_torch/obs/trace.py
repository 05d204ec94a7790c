"""``python -m repro_torch.obs.trace <kernel>`` — trace one kernel end to
end; a self-standing copy of the JAX package's ``repro.obs.trace``.

Runs one traced evaluation inside :func:`repro_torch.obs.session`, prints the
terminal timeline plus the reconciliation verdict, and (with ``--out``)
writes the Perfetto/Chrome-trace JSON — load it at https://ui.perfetto.dev
or ``chrome://tracing``.

Two paths, matching the facade's split:

* **simulatable kernels** (``expf``, ``logf``, the MC kernels) go through
  the cluster front door — a traced ``api.evaluate`` on a homogeneous
  target — and the trace's per-lane cycle accounting is *reconciled
  exactly* against the returned ``Report``;
* **tuner-only kernels** (``softmax``, ``prng`` — no ISA baseline trace)
  go through the cost oracle (``tune.cost.evaluate``) on their default
  candidate, which traces the COPIFT block timing lanes the oracle
  prices (no cluster ``Report`` to reconcile against).

Both paths run the analytic Snitch model on the host: no kernel is
launched and no device is touched, so this entry point takes no device
argument.

CLI:
    PYTHONPATH=src python -m repro_torch.obs.trace expf --out trace.json
    PYTHONPATH=src python -m repro_torch.obs.trace softmax --cores 8
    PYTHONPATH=src python -m repro_torch.obs.trace expf --json   # machine-readable
"""

from __future__ import annotations

import argparse
import json
import sys


def _kernel_names() -> list[str]:
    from repro_torch.api.registry import specs
    return [s.name for s in specs()]


def trace_kernel(name: str, n_cores: int = 8, blocks_per_core: int = 1):
    """Trace one kernel; returns ``(session, report_or_cost, checks)``."""
    import repro_torch.obs as obs
    from repro_torch import api
    from repro_torch.api.registry import kernel

    spec = kernel(name)
    with obs.session(trace=True, metrics=True) as sess:
        if spec.simulatable:
            report = api.evaluate(
                spec, api.Target.homogeneous(n_cores=n_cores),
                blocks_per_core=blocks_per_core)
            checks = sess.reconcile(report)
            return sess, report, checks
        # Tuner-only: price the default candidate through the cost oracle.
        from repro_torch.tune.cost import evaluate as cost_evaluate
        from repro_torch.tune.space import Candidate

        w = spec.get_workload()
        cost = cost_evaluate(w, Candidate(block=w.max_block, n_cores=n_cores))
        return sess, cost, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description=__doc__.splitlines()[0])
    ap.add_argument("kernel", help="registry kernel name "
                                   f"(one of {', '.join(_kernel_names())})")
    ap.add_argument("--cores", type=int, default=8,
                    help="homogeneous core count (default 8)")
    ap.add_argument("--blocks-per-core", type=int, default=1,
                    help="weak-scaling blocks per core (default 1)")
    ap.add_argument("--out", type=str, default=None, metavar="PATH",
                    help="write the Perfetto/Chrome-trace JSON here")
    ap.add_argument("--json", action="store_true",
                    help="print a machine-readable JSON document (lane "
                         "aggregates, reconcile verdict, result figures) "
                         "to stdout instead of the terminal timeline")
    ap.add_argument("--width", type=int, default=100,
                    help="terminal timeline width (default 100)")
    args = ap.parse_args(argv)

    try:
        sess, result, checks = trace_kernel(
            args.kernel, n_cores=args.cores,
            blocks_per_core=args.blocks_per_core)
    except KeyError:
        ap.error(f"unknown kernel {args.kernel!r}; "
                 f"known: {', '.join(_kernel_names())}")

    if args.json:
        rec = sess.recorder
        doc = {
            "schema": 1,
            "kernel": args.kernel,
            "cores": args.cores,
            "blocks_per_core": args.blocks_per_core,
            "simulatable": checks is not None,
            "lane_micro": {k: dict(v) for k, v in rec.lane_micro.items()},
            "memo_provenance": dict(rec.memo_provenance),
            "dropped_events": rec.dropped_events,
            "n_events": len(rec.events),
            "n_summaries": len(rec.summaries),
            "reconcile": None if checks is None else {
                "ok": checks["ok"], "n_checks": len(checks["checks"])},
            "result": ({"cycles_copift": result.cycles_copift,
                        "cycles_base": result.cycles_base,
                        "speedup": result.speedup}
                       if checks is not None else
                       {"cycles": result.cycles,
                        "energy_uj": getattr(result, "energy_uj", None),
                        "feasible": getattr(result, "feasible", None)}),
        }
        print(json.dumps(doc, indent=1, default=float))
        if args.out:
            sess.save(args.out)
        return 0 if checks is None or checks["ok"] else 1

    print(sess.timeline(width=args.width))
    print()
    print(f"result: {result}")
    if checks is None:
        print("reconcile: n/a (tuner-only kernel — no cluster Report; the "
              "trace carries the cost oracle's block-timing lanes)")
    else:
        print(f"reconcile: ok={checks['ok']} "
              f"({len(checks['checks'])} per-lane cycle checks against "
              f"the report)")
    if args.out:
        sess.save(args.out)
        print(f"wrote {args.out} (load at https://ui.perfetto.dev)")
    return 0 if checks is None or checks["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
