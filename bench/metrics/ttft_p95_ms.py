"""The 95th percentile, over every request in the window, of the time from
the start of its call to its first token on the host.  A call copies its
tokens to the host at its end, so a request's first token arrives when
its call returns."""

import numpy as np


def read(ctx):
    if ctx.traffic["kind"] != "serve" or not ctx.units:
        return None
    per_request = [u["seconds"] for u in ctx.units
                   for _ in range(u["requests"])]
    return float(np.percentile(per_request, 95)) * 1e3
