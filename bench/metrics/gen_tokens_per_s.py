"""Tokens sampled by every call in the window over the calls' time, the
prefills included (each call timed whole on the host clock)."""


def read(ctx):
    if ctx.traffic["kind"] != "serve" or not ctx.units:
        return None
    return sum(u["tokens"] for u in ctx.units) / sum(
        u["seconds"] for u in ctx.units)
