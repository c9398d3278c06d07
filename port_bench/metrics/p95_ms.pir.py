"""p95_ms.pir: 95th percentile of a request's latency, 32 queries
dispatched to their answers, in the closed loop (host clock; after the
traced part)."""

from port_bench import readers


def read(ctx):
    return readers.p95_ms(ctx)
