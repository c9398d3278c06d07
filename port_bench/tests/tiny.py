"""Each cell cut to a size the CPU runs in seconds: the overrides of its
configuration and mix."""

SEED = (1 << 31) + 977  # a large seed, as the checks draw them

CELLS = {
    "dcf20.eval": dict(cfg={"in_bits": 8},
                       mix={"batch_log2": 6, "sample": 2, "sample_from": 4}),
    "dcf20.gen": dict(cfg={"in_bits": 8},
                      mix={"batch_log2": 6, "sample": 2, "sample_from": 4}),
}
SECONDS = 0.5
