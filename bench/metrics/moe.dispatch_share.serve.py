"""The MoE dispatch's share of the traced calls' device time: the exclusive
device time of the program's ``moe.dispatch`` and ``moe.combine`` spans
over the ``serve.generate`` units' device time (``repro_torch.obs.card``).
None where the program has no card spans or the model no mixture."""

NAMES = ("moe.dispatch", "moe.combine")


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "serve":
        return None
    try:
        from repro_torch.obs import card
    except ImportError:
        return None
    w = ctx.trace.window
    return card.share(card.read(w.start, w.end), NAMES, "serve.generate")
