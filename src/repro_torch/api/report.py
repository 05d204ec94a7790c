"""Public home of the unified evaluation result.

The implementation lives in ``repro_torch.cluster.report`` (an import-cycle-free
leaf both ``repro_torch.cluster`` and ``repro_torch.api`` can reach); this module is
the facade's canonical name for it — consumers should import ``Report`` /
``ReportMetrics`` from ``repro_torch.api``.
"""

from repro_torch.cluster.report import Report, ReportMetrics, headline

__all__ = ["Report", "ReportMetrics", "headline"]
