"""The work of one PIR contraction launch (``pir_contract``), for its
roofline share against ``roofline.py``'s peaks.

Counted from the shapes alone, as the algorithm needs it whatever
implements it: Q x N x D 32-bit multiply-adds (IMAD); the table read once
(N x D words), one selector word a row and query (Q x N words) and the
answers written (Q x D words), 4 bytes a word. An IMAD issues on 64 lanes
an SM a clock on the H100 (the CUDA C++ Programming Guide's throughput
table, compute capability 9.0), half the 128 of ``roofline.INT_OPS_PER_S``,
so each counts as two of its operations. At Q = 32 over 2^20 x 64 words
that is 0.128 ms against the bytes' 0.120: the IMADs bound it from Q = 29.
"""

from __future__ import annotations

IMAD_SLOTS = 2  # 128-lane operations an IMAD takes


def pir_contract(queries: int, rows: int, words: int):
    """(ops, bytes) of one ``pir_contract`` launch: ``queries`` answers
    over a table of ``rows`` records of ``words`` 32-bit words."""
    return (IMAD_SLOTS * queries * rows * words,
            4 * (rows * words + queries * rows + queries * words))
