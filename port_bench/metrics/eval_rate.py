"""eval_rate: items completed in the window / the window (host clock)."""

from port_bench import readers


def read(ctx):
    return readers.rate(ctx)
