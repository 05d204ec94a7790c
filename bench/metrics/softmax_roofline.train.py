"""The COPIFT softmax's share of its roofline in a training cell: the
least bytes the softmax needs at the cell's shapes (once per step, each
layer's (B·H·T, T) scores read and its probabilities written, in fp32),
over the bandwidth, over the device time of the program's softmax kernels
in the traced window."""

from bench import counts, trace


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "train":
        return None
    seconds = trace.kernel_seconds(ctx.trace, counts.is_softmax_kernel)
    if not seconds:
        return None
    nbytes = sum(counts.forward_softmax_bytes(ctx.model, f)
                 for u in ctx.units for f in u["forwards"])
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES_PER_S / seconds
