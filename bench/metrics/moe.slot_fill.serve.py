"""The share of the expert slots that the expert products run over which
hold a routed pair, in the traced calls: the (token, choice) pairs kept
over the slots computed (rows × experts × capacity), summed over the
program's ``moe.dispatch`` records of the ``serve.generate`` units
(``repro_torch.obs.card``).  None where the program has no card spans or
the model no mixture."""


def read(ctx):
    if ctx.trace is None or ctx.traffic["kind"] != "serve":
        return None
    try:
        from repro_torch.obs import card
    except ImportError:
        return None
    w = ctx.trace.window
    recs = card.read(w.start, w.end)
    ids = {r.unit for r in card.units(recs, "serve.generate")}
    routes = [r.counters for r in recs if r.name == "moe.dispatch"
              and r.unit in ids and "slots" in r.counters]
    slots = sum(c["slots"] for c in routes)
    return 100.0 * sum(c["kept"] for c in routes) / slots if slots else None
