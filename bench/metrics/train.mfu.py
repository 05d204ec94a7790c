"""Model FLOPs of the window's training steps (``counts.train_step_flops``:
the layers and the readout three times over, causal attention, no
recompute) over the steps' time, as a share of the card's bf16 peak."""

from bench import counts


def read(ctx):
    if ctx.traffic["kind"] != "train" or not ctx.units:
        return None
    flops = sum(counts.train_step_flops(ctx.model, b, t)
                for u in ctx.units for _, b, t, _ in u["forwards"])
    seconds = sum(u["seconds"] for u in ctx.units)
    return 100.0 * flops / seconds / counts.PEAK_BF16_FLOPS
