"""dcf_eval_roofline: percent of the least time of one dcf_eval launch
(roofline.dcf_eval) over its traced device time a launch."""

from port_bench import readers, roofline


def read(ctx):
    return readers.kernel_roofline(
        ctx, "dcf_eval_kernel",
        roofline.dcf_eval(ctx.items, ctx.cfg["in_bits"]))
