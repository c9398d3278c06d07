"""dispatch_ms.eval: host ms inside the API call a request, which returns
before the device is done (host clock; after the traced part)."""

from port_bench import readers


def read(ctx):
    return readers.mean_ms(ctx.dispatch_s)
