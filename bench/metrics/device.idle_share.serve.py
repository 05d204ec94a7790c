"""The share of the traced window in which no operation ran on the card,
in a serving cell."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.traffic["kind"] != "serve":
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
