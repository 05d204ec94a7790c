"""``repro_torch.obs`` — issue-slot tracing, stall-breakdown metrics and
profiling spans over the analytic model; the port's copy of the JAX
package's ``repro.obs``, with the same ``__all__``.

Three opt-in layers behind one front door (:func:`session`):

* **event tracing** (``obs.record``) — per-instruction issue events on
  named lanes (int core / FPSS / rv32g baseline) with stall classes (RAW,
  write-port, TCDM contention, FREP launch), recorded by the discrete-event
  simulator in ``core.timing``;
* **metrics** (``obs.metrics``) — a process-wide counter/gauge/histogram
  registry fed by ``core.timing`` (stall split), ``cluster.contention`` /
  ``cluster.dma``, ``system.noc``, ``tune.cost`` / ``tune.search``,
  ``perf.memo`` (warmth), ``serve.engine`` (autotune and the system plan)
  and ``train.fault`` (stragglers);
* **spans** (``obs.spans``) — nested wall-time scopes with per-span memo
  provenance, wrapping ``api.evaluate``/``api.sweep``, tuner searches and
  the serve engine's autotune.

Everything is off by default: disabled, the hooks reduce to a couple of
ContextVar reads per *call* (never per instruction).  Traced runs never
bypass or poison the ``repro_torch.perf`` memo — they re-simulate
(bit-identical by construction) and record hit/cold provenance.

Exports go to Perfetto/Chrome-trace JSON (:meth:`Session.save`) or a
terminal timeline; ``python -m repro_torch.obs.trace <kernel>`` does both
from the command line.

On top of the single-run layers sit the *differential* ones:

* **attribution** (``obs.attrib``) — exact stall-category waterfalls
  between two traced runs (plan A vs plan B, Target A vs B), step deltas
  summing bit-for-bit to the ``Report`` cycle delta;
* **history** (``obs.history``) — an append-only JSONL metric store with
  rolling-baseline regression detection (the port's own store:
  ``$REPRO_TORCH_METRIC_HISTORY``, else ``BENCH_history_torch.jsonl``);
* **report** (``obs.report``) — a self-contained HTML report (timeline,
  stall bars, waterfall, trend sparklines) plus a terminal summary.

The analytic model, and so every layer above, runs on the host; the CUDA
kernels' launches are counted by their wrappers.  The port's own card
path is traced by one more module, outside the JAX package's ``__all__``:

* **card spans** (``obs.card``) — spans and counters at the port's layer
  boundaries (training step, attention, MoE, optimizer, serving engine),
  recorded while ``torch.profiler`` records, as host ranges in its trace
  and CUDA-event device times read after it (:func:`card.read`).
"""

from repro_torch.obs import record as record  # noqa: F401
from repro_torch.obs import metrics as metrics  # noqa: F401
from repro_torch.obs import spans as spans  # noqa: F401
from repro_torch.obs import export as export  # noqa: F401
from repro_torch.obs import attrib as attrib  # noqa: F401
from repro_torch.obs import history as history  # noqa: F401
from repro_torch.obs import card as card  # noqa: F401
from repro_torch.obs.record import (TraceRecorder,  # noqa: F401
                                    active_recorder, hooks_bypassed,
                                    recording)
from repro_torch.obs.metrics import REGISTRY  # noqa: F401
from repro_torch.obs.spans import span  # noqa: F401
from repro_torch.obs.export import (chrome_trace, reconcile,  # noqa: F401
                                    render_timeline, save_chrome_trace)
from repro_torch.obs.attrib import (Attribution, attribute,  # noqa: F401
                                    attribute_evaluate, attribute_plans)
from repro_torch.obs.history import (append_snapshot,  # noqa: F401
                                     detect_regressions, read_history)
from repro_torch.obs.session import Session, session  # noqa: F401

__all__ = [
    "session", "Session", "span",
    "TraceRecorder", "active_recorder", "recording", "hooks_bypassed",
    "REGISTRY", "chrome_trace", "save_chrome_trace", "render_timeline",
    "reconcile", "record", "metrics", "spans", "export",
    "Attribution", "attribute", "attribute_evaluate", "attribute_plans",
    "attrib", "history", "append_snapshot", "detect_regressions",
    "read_history",
]
