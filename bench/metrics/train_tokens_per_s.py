"""Tokens of every training step in the window over the steps' time (each
step timed on the host clock up to a device synchronisation)."""


def read(ctx):
    if ctx.traffic["kind"] != "train" or not ctx.units:
        return None
    return sum(u["tokens"] for u in ctx.units) / sum(
        u["seconds"] for u in ctx.units)
