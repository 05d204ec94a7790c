"""Observability: the metrics registry (``obs.metrics``), the trace recorder
beneath it (``obs.record``) that ``core.timing`` feeds, and the profiling
spans (``obs.spans``) around ``api.evaluate`` and ``api.sweep`` —
self-standing copies of the JAX package's.  The rest of ``repro.obs``
(attribution, export, history, report, session, trace) waits for ROADMAP.md
§1 item 3."""
