"""dpf_eval_all_roofline: percent of the least time of one key's DPF
EvalAll (roofline.dpf_eval_all, both launches) over the traced device time
a key of the dpf_eval_all launches: two a key (the plan's top and body),
one at in_bits = 1."""

from port_bench import roofline


def read(ctx):
    if ctx.summary is None:
        return None
    n, secs = ctx.summary.select("dpf_eval_all_kernel")
    if not n or secs <= 0:
        return None
    bits = ctx.cfg["in_bits"]
    keys = n / (1 if bits == 1 else 2)
    least, _ = roofline.least_seconds(*roofline.dpf_eval_all(bits))
    return least / (secs / keys) * 100
