"""The yardstick's peaks and the work each measured kernel needs.

Counts are of the algorithm's work, whatever implements it, computed from
shapes alone. They are frozen copies of ``chip_smoke.py``'s kernel-table
arithmetic: the peaks of ``chip_smoke.py:172-181`` and ``:2218-2232``
(``bound``), the rows of ``:3132-3136`` (``dpf_eval_all``), ``:3143-3146``
(``dcf_eval``) and ``:3147-3151`` (``dcf_gen``).

Peaks are the published ones of an NVIDIA H100 SXM at its full power limit
(700 W): 132 SMs, a 1980 MHz maximum SM clock, HBM3 at 3.35 TB/s. A 32-bit
integer instruction issues on 128 lanes an SM a clock (IMAD on the FMA
pipe as wide), an upper bound, so a share can only read low. One ChaCha
block (the FSS PRG, 20 rounds) is 960 32-bit ALU instructions: 10 double
rounds x 8 quarter-rounds x 12.
"""

from __future__ import annotations

SMS = 132
MAX_SM_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
LANES_PER_SM_CLOCK = 128
INT_OPS_PER_S = SMS * LANES_PER_SM_CLOCK * MAX_SM_HZ
CHACHA_OPS = 960


def least_seconds(ops: float, nbytes: float):
    """(the least time in seconds for ``ops`` 32-bit ALU instructions and
    ``nbytes`` of device memory, what sets it: "operations" or "bytes")."""
    t_ops, t_bytes = ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def dcf_eval(keys: int, in_bits: int):
    """(ops, bytes) of one ``dcf_eval`` launch over ``keys`` keys, one
    point each, ChaCha mul=4 (one block a level). Seeds 16 B, cw rows 32 B
    a level, x 4 B in; the raw value 16 B, seed 16 B and t 4 B out."""
    return (keys * in_bits * CHACHA_OPS,
            keys * (16 + in_bits * 32 + 4 + 16 + 16 + 4))


def dcf_gen(keys: int, in_bits: int):
    """(ops, bytes) of one ``dcf_gen`` launch: two blocks a level (both
    parties). Seeds 32 B, alpha 4 B, beta 16 B in; n + 1 rows of 32 B
    out."""
    return (keys * in_bits * 2 * CHACHA_OPS,
            keys * (32 + 4 + 16 + (in_bits + 1) * 32))


def dpf_eval_all(in_bits: int):
    """(ops, bytes) of one DPF EvalAll (both launches): the 2^n - 1
    expansions of the tree, one ChaCha block each (mul=2). The root 16 B,
    20 B of cw a level and the output CW 16 B in; a 16 B share a leaf
    out."""
    leaves = 1 << in_bits
    return ((leaves - 1) * CHACHA_OPS, 16 + in_bits * 20 + 16 + leaves * 16)
