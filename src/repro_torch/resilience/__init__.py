"""``repro_torch.resilience`` — deterministic fault injection, graceful
degradation, and serving failover over the analytic stack; the port's
copy of the JAX package's ``repro.resilience``, plain Python and numpy,
so every ``FaultTrace``, degraded ``Report`` and failover ``SimReport``
equals the JAX package's with ``==``.

Three layers, mirroring the question "how much margin buys how many
nines" at manycore scale:

* :mod:`~repro_torch.resilience.faults`   — the frozen, PCG64-seeded
  :class:`FaultTrace` (fail-stop deaths, thermal-throttle windows, HBM
  degradation, exponential MTTF sampling) built from a compact spec
  grammar;
* :mod:`~repro_torch.resilience.degrade`  — mapping a :class:`FaultState`
  onto survival masks, downgraded DVFS points and a narrowed HBM port, all
  consumed by the *existing* evaluation path
  (``api.evaluate(faults=...)``);
* :mod:`~repro_torch.resilience.failover` — the serving-side fault loop
  behind ``serve.simulate(faults=...)``: killed batches, bounded
  retry/timeout/backoff (:class:`RetryPolicy`), partition remap onto
  survivors, and :class:`FailoverPolicy` over-provisioning.

The empty trace is the identity everywhere — pinned bit-for-bit by
``tests/test_torch_resilience.py`` / ``tests/test_torch_failover.py``.
"""

from repro_torch.resilience.degrade import (degrade_cluster,
                                            degrade_system_hbm,
                                            masked_speeds, resolve_state,
                                            throttled_point)
from repro_torch.resilience.failover import (FAULT_LANE, FailoverPolicy,
                                             RetryPolicy, simulate_failover)
from repro_torch.resilience.faults import (FAULT_KINDS, AllCoresDeadError,
                                           FaultEvent, FaultState,
                                           FaultTrace, make_faults)

__all__ = [
    "FaultEvent", "FaultState", "FaultTrace", "make_faults", "FAULT_KINDS",
    "AllCoresDeadError",
    "throttled_point", "degrade_cluster", "masked_speeds",
    "degrade_system_hbm", "resolve_state",
    "RetryPolicy", "FailoverPolicy", "simulate_failover", "FAULT_LANE",
]
