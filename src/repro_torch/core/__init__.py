"""The port's copy of the analytic COPIFT model (``repro.core``).

Only Eq. 1–3 and Table I (``analytics``) are ported so far; the timing and
energy model, the ISA traces and the COPIFT planner are ROADMAP §1 item 3.
"""

from repro_torch.core.analytics import (PAPER_HEADLINE, TABLE_I,
                                        TABLE_I_PRINTED, KernelCounts,
                                        geomean, table_rows)

__all__ = ["PAPER_HEADLINE", "TABLE_I", "TABLE_I_PRINTED", "KernelCounts",
           "geomean", "table_rows"]
