"""The COPIFT exp's share of its roofline in a training cell: the least
bytes the exponentials of causal attention need (once per step, each
layer's B·H·T·(T + 1)/2 scores at or below the diagonal read and written,
in fp32), over the bandwidth, over the device time of the program's exp
kernels in the traced window."""

from bench import counts, trace


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "train":
        return None
    seconds = trace.kernel_seconds(ctx.trace, counts.is_exp_kernel)
    if not seconds:
        return None
    m = ctx.model
    nbytes = sum(m.n_layers * counts.causal_exp_bytes(b, m.n_heads, t)
                 for u in ctx.units for _, b, t, _ in u["forwards"])
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES_PER_S / seconds
