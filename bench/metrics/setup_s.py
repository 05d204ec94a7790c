"""Seconds from the start of the process to the window's start: imports,
the program's kernels (built on a checkout's first run), the seeded
weights on the card, the warm-up, less the time the check's own readings
took during set-up."""


def read(ctx):
    return ctx.setup_s
