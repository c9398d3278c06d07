"""glue_ms.eval: device ms a batch of the kernels that are not the port's
own (the finalize and group glue), over the dcf_eval launches in the
traced window (device trace)."""


def read(ctx):
    if ctx.summary is None:
        return None
    n, _ = ctx.summary.select("dcf_eval_kernel")
    if not n:
        return None
    _, glue = ctx.summary.select(port=False)
    return glue / n * 1e3
