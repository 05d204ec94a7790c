"""``repro_torch.perf`` — the timing-engine performance layer, a
self-standing copy of the JAX package's ``repro.perf``.

The analytic evaluation pipeline (``api.evaluate``, ``api.sweep``) bottoms
out in the pure-Python discrete-event simulator in ``core.timing``.  This
package makes it fast without changing a single cycle:

* :mod:`repro_torch.perf.memo` — the content-addressed simulation memo that
  ``core.timing`` consults (``STREAM_MEMO`` / ``TIMING_MEMO``), with the
  process-wide on/off switch (``$REPRO_TIMING_MEMO``, the JAX package's own
  name; :func:`set_enabled`, :func:`memo_disabled`) and :func:`stats`.
* :func:`evaluate_batch` — the batched cost oracle
  (``repro_torch.tune.cost.evaluate_batch``): many candidates priced in one
  pass, grouped by shared sub-simulations, the cluster math composed with
  numpy over the candidate axis.
* :func:`sweep` — the batched target evaluator (``repro_torch.api.sweep``).

The batch entry points live with their subsystems (``tune`` / ``api``) and
are re-exported here lazily, so importing this package from
``core.timing`` never creates an import cycle.  Parity is the contract:
every memoized or batched path returns bit for bit the numbers of the cold
scalar path.
"""

from repro_torch.perf.memo import (STREAM_MEMO, TIMING_MEMO, SimMemo,
                                   clear_all, enabled, memo_disabled,
                                   register_cache, set_enabled, stats)

__all__ = [
    "STREAM_MEMO", "TIMING_MEMO", "SimMemo", "enabled", "set_enabled",
    "memo_disabled", "clear_all", "register_cache", "stats",
    "evaluate_batch", "sweep",
]

_LAZY = {
    "evaluate_batch": ("repro_torch.tune.cost", "evaluate_batch"),
    "sweep": ("repro_torch.api.evaluate", "sweep"),
}


def __getattr__(name: str):
    """Lazy re-exports of the subsystem-hosted batch entry points."""
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)
