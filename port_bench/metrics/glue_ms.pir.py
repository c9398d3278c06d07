"""glue_ms.pir: device ms a request of the device work that is none of the
port's kernels (the zeroing of the contraction's answers, copies, library
kernels), over the pir_contract launches in the traced window (device
trace)."""

from port_bench import trace

OURS = (*trace.PORT_KERNELS, "pir_contract_kernel")


def read(ctx):
    if ctx.summary is None:
        return None
    n, _ = ctx.summary.select("pir_contract_kernel")
    if not n:
        return None
    glue = sum(secs for name, (_, secs) in ctx.summary.kernels.items()
               if not any(k in name for k in OURS))
    return glue / n * 1e3
