"""For each forward pass of the window's calls, the least time its work
takes on the card (``counts.least_seconds``: the larger of its FLOPs over
the bf16 peak and the bytes it must read over the HBM bandwidth, weights
and, in a decode step, the keys and values at or before the position);
their sum over the calls' time, as a share."""

from bench import counts


def read(ctx):
    if ctx.traffic["kind"] != "serve" or not ctx.units:
        return None
    m, dt = ctx.model, ctx.config["model"]["dtype"]
    weights = counts.weight_bytes(m, ctx.specs, dt)
    least = 0.0
    for u in ctx.units:
        for kind, b, t, _ in u["forwards"]:
            if kind == "prefill":
                least += counts.least_seconds(counts.prefill_flops(m, b, t),
                                              weights)
            else:
                least += counts.least_seconds(
                    counts.decode_step_flops(m, b, t),
                    weights + counts.kv_bytes(m, b, t, dt))
    return 100.0 * least / sum(u["seconds"] for u in ctx.units)
