"""dcf_gen_roofline: percent of the least time of one dcf_gen launch
(roofline.dcf_gen) over its traced device time a launch."""

from port_bench import readers, roofline


def read(ctx):
    return readers.kernel_roofline(
        ctx, "dcf_gen_kernel",
        roofline.dcf_gen(ctx.items, ctx.cfg["in_bits"]))
