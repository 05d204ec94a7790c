"""Device operations (kernels, copies, sets) of the traced calls' decode
loops over the decode steps they took: a count.  A call's decode loop
runs from the end of the device synchronisation that closes its prefill
(the call's first ``cudaDeviceSynchronize``; the prompts' copy to the card
before it ends in a stream synchronisation) to the call's end."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.traffic["kind"] != "serve":
        return None
    ops, steps = 0, 0
    for span, u in zip(t.units, ctx.units):
        syncs = t.syncs_in(span, ("cudaDeviceSynchronize",))
        if not syncs or not u["decode_steps"]:
            continue
        ops += len(t.device_in(syncs[0].end, span.end))
        steps += u["decode_steps"]
    return ops / steps if steps else None
