"""2-party distributed comparison function (DCF), BCG+'21: plain PyTorch
version.

Counterpart of ``fss_tpu.schemes.dcf``, batched over a leading key axis
with a Python loop over tree levels. Bit-exact with the reference: keys
generated from the same seeds give the same correction words, and Eval and
EvalAll the same output shares. The DCF threads a running group value ``v``
alongside the GGM tree walk; its PRG (ChaCha or AES-MMO, mul=4) expands
each seed into 4 blocks (s_l, v_l, s_r, v_r).

Key layout: ``cws`` is [..., in_bits+1, 8] int32; row i < n is {s_cw with
tl_cw in the clamped bit (lanes 0-3), v_cw with tr_cw in the clamped bit
(lanes 4-7)}; row n lanes 4-7 hold the final value CW.

Predicates: "lt" gives y = beta when x < alpha, "gt" when x > alpha; Eval
does not depend on the predicate (the CW placement encodes it).

The value thread is generic: :func:`walk` and :func:`expand_level` take an
``add(v, v_sel, v_cw_t)`` that folds one level's raw contributions (the
chosen value block and the value CW under t, clamped bits clear) into
``v``. :func:`group_step` does that in the group, as the reference does;
the kernels' plain versions (``ops/dcf_cuda.py``) pass their raw
accumulator instead.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.schemes import _tree

PRED_LT = "lt"
PRED_GT = "gt"


def _gsel(cond, a, b):
    """cond ? a : b for group values ([..., 4] lanes)."""
    return torch.where(torch.as_tensor(cond).bool()[..., None], a, b)


def gen(prg4, group, in_bits: int, pred: str, s0s: torch.Tensor,
        a_lanes: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Generate a batch of DCF keys' correction words.

    s0s [B, 2, 4] initial seeds, a_lanes [B, 4] alpha lanes, betas [B, 4].
    Returns cws [B, in_bits + 1, 8] int32.
    """
    if pred not in (PRED_LT, PRED_GT):
        raise ValueError(f"pred must be 'lt' or 'gt', got {pred!r}")
    a_bits = blk.input_bits_msb_first(a_lanes, in_bits)
    s0 = blk.clear_lsb(s0s[:, 0])
    s1 = blk.clear_lsb(s0s[:, 1])
    B = s0.shape[0]
    t0 = torch.zeros(B, dtype=torch.int32, device=s0.device)
    t1 = t0 + 1
    b_val = group.from_block(blk.clear_lsb(betas))
    v = group.zero((B,), device=s0.device)
    out = torch.zeros((B, in_bits + 1, 8), dtype=torch.int32,
                      device=s0.device)
    for i in range(in_bits):
        a = a_bits[:, i]
        o0 = prg4(s0)
        o1 = prg4(s1)
        s0l, t0l = _tree.split_seed(o0[0])
        s0r, t0r = _tree.split_seed(o0[2])
        s1l, t1l = _tree.split_seed(o1[0])
        s1r, t1r = _tree.split_seed(o1[2])
        v0l, v0r, v1l, v1r = (group.from_block(blk.clear_lsb(o))
                              for o in (o0[1], o0[3], o1[1], o1[3]))

        s_cw = _tree.choose(a, blk.xor(s0r, s1r), blk.xor(s0l, s1l))

        # v_cw = -v + v1_off - v0_off (+ beta on the predicate's side),
        # "off" the off-path direction; negated when t1.
        v_cw = group.add(group.add(group.neg(v), _gsel(a, v1l, v1r)),
                         group.neg(_gsel(a, v0l, v0r)))
        add_b = a if pred == PRED_LT else a ^ 1
        v_cw = _gsel(add_b, group.add(v_cw, b_val), v_cw)
        v_cw = _gsel(t1, group.neg(v_cw), v_cw)

        # Thread the running value.
        v = group.add(group.add(v, group.neg(_gsel(a, v1r, v1l))),
                      _gsel(a, v0r, v0l))
        v = group.add(v, _gsel(t1, group.neg(v_cw), v_cw))

        tl_cw = t0l ^ t1l ^ a ^ 1
        tr_cw = t0r ^ t1r ^ a
        tcw = _tree.choose_bit(a, tl_cw, tr_cw)
        s0 = blk.masked_xor(t0, _tree.choose(a, s0l, s0r), s_cw)
        s1 = blk.masked_xor(t1, _tree.choose(a, s1l, s1r), s_cw)
        t0 = _tree.choose_bit(a, t0l, t0r) ^ (t0 & tcw)
        t1 = _tree.choose_bit(a, t1l, t1r) ^ (t1 & tcw)

        out[:, i, 0:4] = blk.set_lsb(s_cw, tl_cw)
        out[:, i, 4:8] = blk.set_lsb(group.into_block(v_cw), tr_cw)

    # Final CW: v_cw_{n+1} = s1 - s0 - v, negated when t1.
    v_last = group.add(group.add(group.from_block(s1),
                                 group.neg(group.from_block(s0))),
                       group.neg(v))
    out[:, in_bits, 4:8] = group.into_block(
        _gsel(t1, group.neg(v_last), v_last))
    return out


def unpack_row(row: torch.Tensor):
    """A [..., 8] cw row -> (s_cw, tl_cw, tr_cw, v_cw), the blocks with
    their clamped bits clear."""
    s_raw, v_raw = row[..., 0:4], row[..., 4:8]
    return (blk.clear_lsb(s_raw), blk.get_lsb(s_raw), blk.get_lsb(v_raw),
            blk.clear_lsb(v_raw))


def expand(prg4, s, t, row):
    """One PRG expansion with the level's corrections.

    Returns the corrected children (sl, tl, sr, tr), their raw value blocks
    (vl, vr) and the value CW under t (zero where t is 0), all blocks with
    the clamped bit clear.
    """
    s_cw, tl_cw, tr_cw, v_cw = unpack_row(row)
    o = prg4(s)
    sl, tl = _tree.split_seed(o[0])
    sr, tr = _tree.split_seed(o[2])
    sl, tl, sr, tr = _tree.correct_children(sl, tl, sr, tr, t, s_cw,
                                            tl_cw, tr_cw)
    v_cw_t = _gsel(t, v_cw.expand_as(s), torch.zeros_like(s))
    return (sl, tl, sr, tr, blk.clear_lsb(o[1]), blk.clear_lsb(o[3]),
            v_cw_t)


def group_step(group, party: int):
    """The reference's value step: v += +-(from(v_sel) + from(v_cw_t)),
    negated for party 1."""
    def add(v, v_sel, v_cw_t):
        step = group.add(group.from_block(v_sel), group.from_block(v_cw_t))
        return group.add(v, group.neg(step) if party else step)
    return add


def walk(prg4, in_bits: int, party: int, s0: torch.Tensor, cw_level,
         x_bits: torch.Tensor, v: torch.Tensor, add):
    """The level loop of point evaluation.

    s0 [B, 4] seeds; ``cw_level(i)`` gives level i's cw rows [B, 8];
    x_bits [B, in_bits] MSB first; ``v`` the initial value and ``add`` the
    value step (module docstring). Returns the final seeds [B, 4] (clamped
    bit clear), control bits [B] and value.
    """
    s = blk.clear_lsb(s0)
    t = torch.full((s.shape[0],), party, dtype=torch.int32, device=s.device)
    for i in range(in_bits):
        sl, tl, sr, tr, vl, vr, v_cw_t = expand(prg4, s, t, cw_level(i))
        bit = x_bits[:, i]
        v = add(v, _tree.choose(bit, vl, vr), v_cw_t)
        s = _tree.choose(bit, sl, sr)
        t = _tree.choose_bit(bit, tl, tr)
    return s, t, v


def finalize_leaves(group, party: int, s: torch.Tensor, t: torch.Tensor,
                    v: torch.Tensor, v_last: torch.Tensor) -> torch.Tensor:
    """Output shares from the final seeds and the path value (already
    negated for party 1): y = v +- (s + (t ? v_last : 0)). ``v_last`` is
    [4] or per-leaf [B, 4]."""
    term = group.from_block(s)
    term = _gsel(t, group.add(term, group.from_block(v_last.expand_as(s))),
                 term)
    if party:
        term = group.neg(term)
    return group.into_block(group.add(v, term))


def eval_points(prg4, group, in_bits: int, party: int, s0: torch.Tensor,
                cws: torch.Tensor, x_lanes: torch.Tensor) -> torch.Tensor:
    """Batched point evaluation.

    s0 [B, 4] seeds or [4] broadcast; cws [B, in_bits+1, 8] keys or
    [in_bits+1, 8] broadcast; x_lanes [B, 4]. Returns [B, 4] shares.
    """
    x_bits = blk.input_bits_msb_first(x_lanes, in_bits)
    B = x_bits.shape[0]
    cws = cws.expand(B, in_bits + 1, 8)
    s, t, v = walk(prg4, in_bits, party, s0.expand(B, 4),
                   lambda i: cws[:, i], x_bits,
                   group.zero((B,), device=x_bits.device),
                   group_step(group, party))
    return finalize_leaves(group, party, s, t, v, cws[:, in_bits, 4:8])


def expand_level(prg4, s, t, v, row, add):
    """One breadth-first doubling step: [M] nodes -> [2M] nodes, children
    interleaved (left, right) to keep x order, each child's value ``add``ed
    from its parent's."""
    sl, tl, sr, tr, vl, vr, v_cw_t = expand(prg4, s, t, row)
    vl = add(v, vl, v_cw_t)
    vr = add(v, vr, v_cw_t)
    m = s.shape[0]
    return (torch.stack([sl, sr], dim=1).reshape(2 * m, 4),
            torch.stack([tl, tr], dim=1).reshape(2 * m),
            torch.stack([vl, vr], dim=1).reshape(2 * m, v.shape[-1]))


def eval_all(prg4, group, in_bits: int, party: int, s0: torch.Tensor,
             cws: torch.Tensor) -> torch.Tensor:
    """Full-domain evaluation by breadth-first level doubling:
    [2^in_bits, 4] output shares in x order."""
    s = blk.clear_lsb(s0)[None, :]
    t = torch.full((1,), party, dtype=torch.int32, device=s.device)
    v = group.zero((1,), device=s.device)
    add = group_step(group, party)
    for i in range(in_bits):
        s, t, v = expand_level(prg4, s, t, v, cws[i], add)
    return finalize_leaves(group, party, s, t, v, cws[in_bits, 4:8])
