"""pir_contract_roofline: percent of the least time of one pir_contract
launch (roofline_pir.pir_contract, the bytes bound it) over its traced
device time a launch."""

from port_bench import readers, roofline_pir


def read(ctx):
    return readers.kernel_roofline(
        ctx, "pir_contract_kernel",
        roofline_pir.pir_contract(ctx.mix.batch, 1 << ctx.cfg["in_bits"],
                                  ctx.cfg["record_words"]))
