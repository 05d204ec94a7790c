"""The MoE dispatch's share of the traced training steps' device time: the
exclusive device time of the program's ``moe.dispatch`` (the sort, the
slots, the buffer's ``index_put``) and ``moe.combine`` (the gathers back)
spans, forward, recompute and backward, over the ``train.step`` units'
device time (``repro_torch.obs.card``).  None where the program has no
card spans or the model no mixture."""

NAMES = ("moe.dispatch", "moe.combine")


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "train":
        return None
    try:
        from repro_torch.obs import card
    except ImportError:
        return None
    w = ctx.trace.window
    return card.share(card.read(w.start, w.end), NAMES, "train.step")
