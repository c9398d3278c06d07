"""p95_ms.eval: 95th percentile of request latency, dispatch to completion,
in the closed loop (host clock; after the traced part)."""

from port_bench import readers


def read(ctx):
    return readers.p95_ms(ctx)
