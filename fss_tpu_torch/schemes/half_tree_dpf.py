"""Half-Tree DPF (Guo+'23): plain PyTorch version.

Counterpart of ``fss_tpu.schemes.half_tree_dpf``, batched over a leading
key axis with a Python loop over tree levels. Bit-exact with the
reference: keys generated from the same seeds give the same correction
words, and Eval and EvalAll the same output shares.

One CCR-hash call per node, H(hash_key ^ node) through the mul=1 PRG
(ChaCha or AES-MMO); the right child costs nothing (right = left ^ parent). Unlike the
DPF, a node carries its control bit t in the clamped bit throughout, and
the hash sees it. The correction words follow the reference's corrected
formulas (docs/design.md "Half-Tree correction words").

Key layout: ``cws`` is [..., in_bits, 8] int32; rows 0..n-2 hold the level
CW in lanes 0-3 (all 128 bits: its low bit is part of it); row n-1 holds
SetLsb(HCW, LCW_0) in lanes 0-3 and LCW_1 in lane 4. The output correction
word ``ocw`` is a separate [..., 4] block.

The level step (:func:`step`, :func:`children`) and the last-level
conversion (:func:`convert`) exist once: Gen, point Eval, EvalAll and the
kernels' plain versions (``ops/ht_cuda.py``, ``ops/eval_all_cuda.py``)
share them. The output CW and the group finalize are the DPF's
(``schemes/dpf.output_cw``, ``schemes/dpf.finalize_leaves``).
"""

from __future__ import annotations

import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.schemes import _tree
from fss_tpu_torch.schemes import dpf as _dpf


def ccr_hash(prg1, hash_key: torch.Tensor, node: torch.Tensor):
    """H(hash_key ^ node): the mul=1 PRG's one output."""
    return prg1(hash_key ^ node)[0]


def step(h: torch.Tensor, node: torch.Tensor, cw: torch.Tensor):
    """One level step from a node's hash h: (left, right) children with
    left = h ^ (t ? cw : 0) and right = left ^ node, t the node's clamped
    bit. The children's clamped bits are their control bits."""
    left = blk.masked_xor(blk.get_lsb(node), h, cw)
    return left, left ^ node


def children(prg1, hash_key, node, cw):
    """Both children of nodes [..., 4] under the level CW [..., 4]."""
    return step(ccr_hash(prg1, hash_key, node), node, cw)


def decode_last(row: torch.Tensor):
    """The last key row [..., >=5] -> (hcw, lcw_0, lcw_1)."""
    return (blk.clear_lsb(row[..., 0:4]), blk.get_lsb(row[..., 0:4]),
            row[..., 4] & 1)


def convert(prg1, hash_key, node, sigma, hcw, lcw):
    """The last-level conversion of level-(n-1) nodes [..., 4] toward leaf
    ``sigma`` (0/1, an int or per node) with ``lcw`` = LCW_sigma:
    (high [..., 4] with the clamped bit clear, low [...])."""
    t = blk.get_lsb(node)
    h = ccr_hash(prg1, hash_key, blk.set_lsb(node, sigma))
    return (blk.masked_xor(t, blk.clear_lsb(h), hcw),
            blk.get_lsb(h) ^ (t & lcw))


# ---------------------------------------------------------------------------
# Gen
# ---------------------------------------------------------------------------

def gen_keys(prg1, in_bits: int, hash_key, s0s: torch.Tensor,
             a_bits: torch.Tensor):
    """Both parties' walks down the path to alpha, and the last level's
    four sigma-hashes.

    s0s [B, 2, 4] seeds; a_bits [B, in_bits] alpha bits, MSB first.
    Returns (cws [B, in_bits, 8], leaf0 [B, 4], leaf1 [B, 4]): the key rows
    and both parties' leaves in the alpha direction, corrected.
    """
    B = s0s.shape[0]
    cws = torch.zeros((B, in_bits, 8), dtype=torch.int32, device=s0s.device)
    node0 = blk.set_lsb(s0s[:, 0], 0)
    node1 = blk.set_lsb(s0s[:, 1], 1)
    for i in range(in_bits - 1):
        a = a_bits[:, i]
        h0 = ccr_hash(prg1, hash_key, node0)
        h1 = ccr_hash(prg1, hash_key, node1)
        cw = blk.masked_xor(a ^ 1, h0 ^ h1, node0 ^ node1)
        node0 = _tree.choose(a, *step(h0, node0, cw))
        node1 = _tree.choose(a, *step(h1, node1, cw))
        cws[:, i, 0:4] = cw

    a_n = a_bits[:, in_bits - 1]
    h00, h01, h10, h11 = (ccr_hash(prg1, hash_key, blk.set_lsb(n, s))
                          for n in (node0, node1) for s in (0, 1))
    # HCW from the !a_n hashes; LCW_0 carries !a_n.
    hcw = blk.clear_lsb(_tree.choose(a_n, h01 ^ h11, h00 ^ h10))
    lcw_0 = blk.get_lsb(h00) ^ blk.get_lsb(h10) ^ a_n ^ 1
    lcw_1 = blk.get_lsb(h01) ^ blk.get_lsb(h11) ^ a_n
    cws[:, in_bits - 1, 0:4] = blk.set_lsb(hcw, lcw_0)
    cws[:, in_bits - 1, 4] = lcw_1
    leaf_cw = blk.set_lsb(hcw, _tree.choose_bit(a_n, lcw_0, lcw_1))
    leaf0 = blk.masked_xor(blk.get_lsb(node0), _tree.choose(a_n, h00, h01),
                           leaf_cw)
    leaf1 = blk.masked_xor(blk.get_lsb(node1), _tree.choose(a_n, h10, h11),
                           leaf_cw)
    return cws, leaf0, leaf1


def output_cw(group, leaf0: torch.Tensor, leaf1: torch.Tensor,
              betas: torch.Tensor) -> torch.Tensor:
    """The group-typed output CW from the alpha-direction leaves."""
    return _dpf.output_cw(group, blk.clear_lsb(leaf0), blk.clear_lsb(leaf1),
                          blk.get_lsb(leaf1), betas)


def gen(prg1, group, in_bits: int, hash_key, s0s: torch.Tensor,
        a_lanes: torch.Tensor, betas: torch.Tensor):
    """Generate a batch of Half-Tree keys.

    s0s [B, 2, 4] initial seeds, a_lanes [B, 4] alpha lanes, betas [B, 4];
    hash_key [4]. Returns (cws [B, in_bits, 8], ocw [B, 4]) int32.
    """
    cws, leaf0, leaf1 = gen_keys(prg1, in_bits, hash_key, s0s,
                                 blk.input_bits_msb_first(a_lanes, in_bits))
    return cws, output_cw(group, leaf0, leaf1, betas)


# ---------------------------------------------------------------------------
# Eval and EvalAll
# ---------------------------------------------------------------------------

def walk(prg1, in_bits: int, party: int, hash_key, s0: torch.Tensor,
         cw_level, x_bits: torch.Tensor) -> torch.Tensor:
    """The n-1 hash levels of point evaluation.

    s0 [B, 4] seeds; ``cw_level(i)`` gives level i's CW [B, 4]; x_bits
    [B, in_bits] MSB first. Returns the level-(n-1) nodes [B, 4].
    """
    node = blk.set_lsb(s0, party)
    for i in range(in_bits - 1):
        node = _tree.choose(x_bits[:, i],
                            *children(prg1, hash_key, node, cw_level(i)))
    return node


def convert_at(prg1, hash_key, node, x_n, last_row):
    """The conversion toward leaf x_n [B] under the last key rows [B, >=5]:
    (high [B, 4], low [B])."""
    hcw, lcw_0, lcw_1 = decode_last(last_row)
    return convert(prg1, hash_key, node, x_n, hcw,
                   _tree.choose_bit(x_n, lcw_0, lcw_1))


def eval_points(prg1, group, in_bits: int, party: int, hash_key,
                s0: torch.Tensor, cws: torch.Tensor, ocw: torch.Tensor,
                x_lanes: torch.Tensor) -> torch.Tensor:
    """Batched point evaluation.

    s0 [B, 4] or [4]; cws [B, in_bits, 8] or [in_bits, 8]; ocw [B, 4] or
    [4]; x_lanes [B, 4]. Returns [B, 4] shares.
    """
    x_bits = blk.input_bits_msb_first(x_lanes, in_bits)
    B = x_bits.shape[0]
    cws = cws.expand(B, in_bits, 8)
    node = walk(prg1, in_bits, party, hash_key, s0.expand(B, 4),
                lambda i: cws[:, i, 0:4], x_bits)
    high, low = convert_at(prg1, hash_key, node, x_bits[:, in_bits - 1],
                           cws[:, in_bits - 1])
    return _dpf.finalize_leaves(group, party, high, low, ocw)


def expand_level(prg1, hash_key, nodes: torch.Tensor,
                 cw: torch.Tensor) -> torch.Tensor:
    """One breadth-first doubling step: [M, 4] nodes -> [2M, 4], children
    interleaved (left, right) to keep x order."""
    left, right = children(prg1, hash_key, nodes, cw)
    return torch.stack([left, right], dim=1).reshape(-1, 4)


def convert_both(prg1, hash_key, nodes: torch.Tensor, last_row):
    """Both leaves of every level-(n-1) node [M, 4] under the last key row
    [>=5]: (high [2M, 4], low [2M]) in x order."""
    hcw, lcw_0, lcw_1 = decode_last(last_row)
    h0, l0 = convert(prg1, hash_key, nodes, 0, hcw, lcw_0)
    h1, l1 = convert(prg1, hash_key, nodes, 1, hcw, lcw_1)
    return (torch.stack([h0, h1], dim=1).reshape(-1, 4),
            torch.stack([l0, l1], dim=1).reshape(-1))


def expand_to_last(prg1, in_bits: int, party: int, hash_key,
                   s0: torch.Tensor, cws: torch.Tensor) -> torch.Tensor:
    """Breadth-first expansion to the 2^(n-1) level-(n-1) nodes."""
    nodes = blk.set_lsb(s0, party)[None, :]
    for i in range(in_bits - 1):
        nodes = expand_level(prg1, hash_key, nodes, cws[i, 0:4])
    return nodes


def eval_all(prg1, group, in_bits: int, party: int, hash_key,
             s0: torch.Tensor, cws: torch.Tensor,
             ocw: torch.Tensor) -> torch.Tensor:
    """Full-domain evaluation: [2^in_bits, 4] shares in x order."""
    nodes = expand_to_last(prg1, in_bits, party, hash_key, s0, cws)
    high, low = convert_both(prg1, hash_key, nodes, cws[in_bits - 1])
    return _dpf.finalize_leaves(group, party, high, low, ocw)
