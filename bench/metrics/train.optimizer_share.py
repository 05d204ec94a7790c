"""AdamW's share of the traced training steps' device time: the exclusive
device time of the program's ``train.optimizer`` span (the clipping, the
update and the cast of the masters into the working copy) over the
``train.step`` units' device time (``repro_torch.obs.card``).  None where
the program has no card spans."""


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "train":
        return None
    try:
        from repro_torch.obs import card
    except ImportError:
        return None
    w = ctx.trace.window
    return card.share(card.read(w.start, w.end), ("train.optimizer",),
                      "train.step")
