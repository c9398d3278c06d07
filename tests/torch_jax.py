"""JAX references for the port's CPU tests, at a small compile cost.

Both parties of a JAX function run in one jitted program, which XLA:CPU
compiles at its lowest optimisation level: a test's domains are at most a
few thousand leaves, so compiling, not running, is what a reference costs,
and each eagerly run JAX op or each party's own jit would compile anew.

    from torch_jax import both_parties
"""

import jax
import numpy as np

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def both_parties(fn, s0s, cws):
    """[fn(0, s0s[0], cws), fn(1, s0s[1], cws)] as numpy arrays, from one
    program compiled with FAST_COMPILE. ``fn(party, s0, cws)`` is traced
    once a party; s0s [2, 4] and cws are uint32 arrays."""
    f = jax.jit(lambda s, c: [fn(p, s[p], c) for p in (0, 1)])
    s0s, cws = np.asarray(s0s, np.uint32), np.asarray(cws, np.uint32)
    compiled = f.lower(s0s, cws).compile(FAST_COMPILE)
    return [np.asarray(y) for y in compiled(s0s, cws)]
