"""launches.pir: the port's dpf_eval_all and pir_contract launches a
request (its counters)."""

from port_bench import readers


def read(ctx):
    return readers.launches(ctx, ("dpf_eval_all", "pir_contract"))
