"""2-party distributed point function (DPF), BGI'16: plain PyTorch version.

Counterpart of ``fss_tpu.schemes.dpf``, batched over a leading key axis
with a Python loop over tree levels. Bit-exact with the reference: keys
generated from the same seeds give the same correction words, and Eval the
same output shares.

Key layout: ``cws`` is [..., in_bits+1, 8] int32; row i < n is {s_cw with
tl_cw in the clamped bit, tr_cw in lane 4}; row n lanes 0-3 hold the
output correction word.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.schemes import _tree


def gen_levels(prg2, in_bits: int, s0s: torch.Tensor, a_bits: torch.Tensor):
    """The level loop of Gen for a batch of keys.

    s0s [B, 2, 4] initial seeds; a_bits [B, in_bits] alpha bits, MSB
    first. Returns (rows, s0, s1, t0, t1): ``rows`` is a list of in_bits
    [B, 5] cw words (s_cw | tl_cw, tr_cw), s0/s1 [B, 4] the final seeds
    and t0/t1 [B] the final control bits.
    """
    s0 = blk.clear_lsb(s0s[:, 0])
    s1 = blk.clear_lsb(s0s[:, 1])
    t0 = torch.zeros(s0.shape[0], dtype=torch.int32, device=s0.device)
    t1 = t0 + 1
    rows = []
    for i in range(in_bits):
        a = a_bits[:, i]
        s0l, s0r = prg2(s0)
        s1l, s1r = prg2(s1)
        s0l, t0l = _tree.split_seed(s0l)
        s0r, t0r = _tree.split_seed(s0r)
        s1l, t1l = _tree.split_seed(s1l)
        s1r, t1r = _tree.split_seed(s1r)

        # Off-path sibling seeds define the CW.
        s_cw = _tree.choose(a, blk.xor(s0r, s1r), blk.xor(s0l, s1l))
        tl_cw = t0l ^ t1l ^ a ^ 1
        tr_cw = t0r ^ t1r ^ a
        tcw = _tree.choose_bit(a, tl_cw, tr_cw)

        s0 = blk.masked_xor(t0, _tree.choose(a, s0l, s0r), s_cw)
        s1 = blk.masked_xor(t1, _tree.choose(a, s1l, s1r), s_cw)
        t0 = _tree.choose_bit(a, t0l, t0r) ^ (t0 & tcw)
        t1 = _tree.choose_bit(a, t1l, t1r) ^ (t1 & tcw)
        rows.append(_tree.pack_cw_row(s_cw, tl_cw, tr_cw)[:, :5])
    return rows, s0, s1, t0, t1


def output_cw(group, s0: torch.Tensor, s1: torch.Tensor, t1: torch.Tensor,
              betas: torch.Tensor) -> torch.Tensor:
    """The group-typed final CW from the leaf seeds: +-(beta - s0 + s1),
    negated when t1 is set."""
    v_cw = group.add(
        group.add(group.from_block(blk.clear_lsb(betas)),
                  group.neg(group.from_block(s0))),
        group.from_block(s1))
    v_cw = torch.where((t1 & 1).bool()[..., None], group.neg(v_cw), v_cw)
    return group.into_block(v_cw)


def gen(prg2, group, in_bits: int, s0s: torch.Tensor, a_lanes: torch.Tensor,
        betas: torch.Tensor) -> torch.Tensor:
    """Generate a batch of DPF keys' correction words.

    s0s [B, 2, 4] initial seeds, a_lanes [B, 4] alpha lanes, betas [B, 4].
    Returns cws [B, in_bits + 1, 8] int32.
    """
    a_bits = blk.input_bits_msb_first(a_lanes, in_bits)
    rows, s0, s1, _, t1 = gen_levels(prg2, in_bits, s0s, a_bits)
    B = s0.shape[0]
    out = torch.zeros((B, in_bits + 1, 8), dtype=torch.int32,
                      device=s0.device)
    if in_bits:
        out[:, :in_bits, :5] = torch.stack(rows, dim=1)
    out[:, in_bits, :4] = output_cw(group, s0, s1, t1, betas)
    return out


def walk(prg2, in_bits: int, party: int, s0: torch.Tensor, cw_level,
         x_bits: torch.Tensor):
    """The level loop of point evaluation.

    s0 [B, 4] seeds; ``cw_level(i)`` gives level i's cw words [B, >=5];
    x_bits [B, in_bits] MSB first. Returns the final seeds [B, 4] (clamped
    bit clear) and control bits [B].
    """
    s = blk.clear_lsb(s0)
    t = torch.full((s.shape[0],), party, dtype=torch.int32, device=s.device)
    for i in range(in_bits):
        s_cw, tl_cw, tr_cw = _tree.unpack_cw_row(cw_level(i))
        sl, sr = prg2(s)
        sl, tl = _tree.split_seed(sl)
        sr, tr = _tree.split_seed(sr)
        sl, tl, sr, tr = _tree.correct_children(
            sl, tl, sr, tr, t, s_cw, tl_cw, tr_cw)
        s = _tree.choose(x_bits[:, i], sl, sr)
        t = _tree.choose_bit(x_bits[:, i], tl, tr)
    return s, t


def eval_points(prg2, group, in_bits: int, party: int, s0: torch.Tensor,
                cws: torch.Tensor, x_lanes: torch.Tensor) -> torch.Tensor:
    """Batched point evaluation.

    s0 [B, 4] seeds or [4] broadcast; cws [B, in_bits+1, 8] keys or
    [in_bits+1, 8] broadcast; x_lanes [B, 4]. Returns [B, 4] shares.
    """
    x_bits = blk.input_bits_msb_first(x_lanes, in_bits)
    B = x_bits.shape[0]
    cws = cws.expand(B, in_bits + 1, 8)
    s, t = walk(prg2, in_bits, party, s0.expand(B, 4), lambda i: cws[:, i],
                x_bits)
    return finalize_leaves(group, party, s, t, cws[:, in_bits, 0:4])


def eval_all(prg2, group, in_bits: int, party: int, s0: torch.Tensor,
             cws: torch.Tensor) -> torch.Tensor:
    """Full-domain evaluation by breadth-first level doubling:
    [2^in_bits, 4] output shares in x order."""
    s = blk.clear_lsb(s0)[None, :]
    t = torch.full((1,), party, dtype=torch.int32, device=s.device)
    for i in range(in_bits):
        s_cw, tl_cw, tr_cw = _tree.unpack_cw_row(cws[i])
        s, t = _tree.expand_level(prg2, s, t, s_cw, tl_cw, tr_cw)
    return finalize_leaves(group, party, s, t, cws[in_bits, 0:4])


def finalize_leaves(group, party: int, s: torch.Tensor, t: torch.Tensor,
                    ocw: torch.Tensor) -> torch.Tensor:
    """Group-convert final seeds: y = s (+ ocw when t), negated for
    party 1. ``ocw`` is [4] or per-leaf [B, 4]."""
    y = group.from_block(s)
    oc = group.from_block(ocw.expand_as(s))
    y = torch.where(t.bool()[..., None], group.add(y, oc), y)
    if party:
        y = group.neg(y)
    return group.into_block(y)
