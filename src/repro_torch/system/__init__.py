"""repro_torch.system — the manycore part: clusters x interconnect x HBM;
the port's copy of the JAX package's ``repro.system``.

Only ``topology`` is ported: :class:`SystemConfig` and the
``"4x8c,hbm=256"`` spec grammar (:func:`parse_system`), which
``api.Target.system`` builds on.  The interconnect model (``noc``), the
hierarchical scheduler and ``evaluate_system`` (``analytics``) wait for
ROADMAP.md §1 item 3c; until then ``api.evaluate`` on a system target
raises.
"""

from repro_torch.system.topology import (DEFAULT_SYSTEM, SystemConfig,
                                         parse_system)

__all__ = ["DEFAULT_SYSTEM", "SystemConfig", "parse_system"]
