"""idle_share.pir: percent of the traced window with no device activity
(device trace)."""

from port_bench import readers


def read(ctx):
    return readers.idle_share(ctx)
