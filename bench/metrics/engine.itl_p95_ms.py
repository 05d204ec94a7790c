"""The 95th percentile of the inter-token time on the card: over the traced
calls' decode steps, the device time between the ends of consecutive
``serve.decode_step`` spans (each step's end is when its token's logits
exist on the card; the host sees the tokens only at the call's end), in
ms (``repro_torch.obs.card``).  None where the program has no card spans
or a call took fewer than two decode steps."""

import numpy as np


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "serve":
        return None
    try:
        from repro_torch.obs import card
    except ImportError:
        return None
    w = ctx.trace.window
    recs = card.read(w.start, w.end)
    gaps = []
    for u in card.units(recs, "serve.generate"):
        ends = sorted(r.device_end for r in recs
                      if r.unit == u.unit and r.name == "serve.decode_step"
                      and r.device_end is not None)
        gaps += [b - a for a, b in zip(ends, ends[1:])]
    return float(np.percentile(gaps, 95)) / 1e6 if gaps else None
