"""``repro_torch.perf`` — the timing-engine performance layer, a
self-standing copy of the JAX package's ``repro.perf``.

The analytic evaluation pipeline (``api.evaluate``, ``api.sweep``) bottoms
out in the pure-Python discrete-event simulator in ``core.timing``.  This
package makes it fast without changing a single cycle:

* :mod:`repro_torch.perf.memo` — the content-addressed simulation memo that
  ``core.timing`` consults (``STREAM_MEMO`` / ``TIMING_MEMO``), with the
  process-wide on/off switch (``$REPRO_TIMING_MEMO``, the JAX package's own
  name; :func:`set_enabled`, :func:`memo_disabled`) and :func:`stats`.
* :func:`sweep` — the batched target evaluator (``repro_torch.api.sweep``),
  re-exported lazily so importing this package from ``core.timing`` never
  creates an import cycle.

The batched cost oracle (``evaluate_batch``) comes with the tuner
(ROADMAP.md §1 item 3d).  Parity is the contract: every memoized path
returns bit for bit the numbers of the cold path.
"""

from repro_torch.perf.memo import (STREAM_MEMO, TIMING_MEMO, SimMemo,
                                   clear_all, enabled, memo_disabled,
                                   register_cache, set_enabled, stats)

__all__ = [
    "STREAM_MEMO", "TIMING_MEMO", "SimMemo", "enabled", "set_enabled",
    "memo_disabled", "clear_all", "register_cache", "stats", "sweep",
]


def __getattr__(name: str):
    """The lazy re-export of ``api.sweep``."""
    if name != "sweep":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from repro_torch.api.evaluate import sweep
    return sweep
