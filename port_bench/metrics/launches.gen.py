"""launches.gen: the port's dcf_gen launches a request (its counter)."""

from port_bench import readers


def read(ctx):
    return readers.launches(ctx, ("dcf_gen",))
