"""launches.eval: the port's dcf_eval launches a request (its counter)."""

from port_bench import readers


def read(ctx):
    return readers.launches(ctx, ("dcf_eval",))
