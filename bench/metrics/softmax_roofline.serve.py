"""The COPIFT softmax's share of its roofline in a serving cell: the least
bytes the softmax needs at the cell's shapes (each forward pass's layers:
(B·H·T, S) scores over the cache's S positions read and probabilities
written, in fp32; T is 1 in a decode step), over the bandwidth, over the
device time of the program's softmax kernels in the traced window."""

from bench import counts, trace


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "serve":
        return None
    seconds = trace.kernel_seconds(ctx.trace, counts.is_softmax_kernel)
    if not seconds:
        return None
    nbytes = sum(counts.forward_softmax_bytes(ctx.model, f)
                 for u in ctx.units for f in u["forwards"])
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES_PER_S / seconds
