"""Attention's share of the traced training steps' device time: the
exclusive device time of the program's ``attn`` and ``attn.core`` spans
(forward, recompute and backward) over the ``train.step`` units' device
time (``repro_torch.obs.card``).  None where the program has no card
spans."""

NAMES = ("attn", "attn.core")


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "train":
        return None
    try:
        from repro_torch.obs import card
    except ImportError:
        return None
    w = ctx.trace.window
    return card.share(card.read(w.start, w.end), NAMES, "train.step")
