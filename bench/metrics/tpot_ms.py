"""All decode-loop time in the window (each call's ``decode_s``, which
ends in the copy of its tokens to the host) over all decode steps taken
(a call of n new tokens takes n − 1)."""


def read(ctx):
    if ctx.traffic["kind"] != "serve":
        return None
    steps = sum(u["decode_steps"] for u in ctx.units)
    if not steps:
        return None
    return sum(u["decode_s"] for u in ctx.units) / steps * 1e3
