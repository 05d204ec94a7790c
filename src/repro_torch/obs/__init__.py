"""Observability: the metrics registry (``obs.metrics``) and the trace
recorder beneath it (``obs.record``), self-standing copies of the JAX
package's; the rest of ``repro.obs`` waits for ROADMAP.md §1 item 3."""
