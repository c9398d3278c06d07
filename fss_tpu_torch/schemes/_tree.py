"""Shared level-step primitives for GGM-tree FSS schemes.

Counterpart of ``fss_tpu.schemes._tree``. The BGI-style tree step: one PRG
expansion, clamped-bit extraction, and a correction-word XOR gated by the
party's control bit. Batched over any leading dims; blocks are [..., 4]
int32 tensors and control bits int32 0/1 tensors.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import block as blk


def split_seed(s_raw: torch.Tensor):
    """Extract the control bit and clear it: (s, t) from a raw PRG output."""
    return blk.clear_lsb(s_raw), blk.get_lsb(s_raw)


def correct_children(sl, tl, sr, tr, t, s_cw, tl_cw, tr_cw):
    """Apply the correction word to both children when t is set."""
    sl = blk.masked_xor(t, sl, s_cw)
    sr = blk.masked_xor(t, sr, s_cw)
    tl = tl ^ (t & tl_cw)
    tr = tr ^ (t & tr_cw)
    return sl, tl, sr, tr


def choose(bit, left, right):
    """bit ? right : left, for block ([..., 4]) operands."""
    return torch.where(torch.as_tensor(bit).bool()[..., None], right, left)


def choose_bit(bit, left, right):
    """bit ? right : left, for int32 0/1 operands."""
    return torch.where(torch.as_tensor(bit).bool(), right, left)


def unpack_cw_row(row: torch.Tensor):
    """A (..., 8) or (..., 5) cw row -> (s_cw cleared, tl_cw, tr_cw).

    Layout of the reference's 32-byte Cw struct: lanes 0-3 hold s (tl in
    its clamped bit), lane 4 holds tr.
    """
    s_cw_raw = row[..., 0:4]
    return blk.clear_lsb(s_cw_raw), blk.get_lsb(s_cw_raw), row[..., 4] & 1


def pack_cw_row(s_cw: torch.Tensor, tl_cw, tr_cw) -> torch.Tensor:
    s = blk.set_lsb(s_cw, tl_cw)
    tr = (torch.as_tensor(tr_cw, device=s.device).to(torch.int32)
          & 1).expand(s.shape[:-1])[..., None]
    pad = torch.zeros((*s.shape[:-1], 3), dtype=torch.int32, device=s.device)
    return torch.cat([s, tr, pad], dim=-1)


def expand_level(prg2, s, t, s_cw, tl_cw, tr_cw):
    """One breadth-first doubling step: [M] nodes -> [2M] nodes, children
    interleaved (left, right) to keep index order."""
    sl_raw, sr_raw = prg2(s)
    sl, tl = split_seed(sl_raw)
    sr, tr = split_seed(sr_raw)
    sl, tl, sr, tr = correct_children(sl, tl, sr, tr, t, s_cw, tl_cw, tr_cw)
    m = s.shape[0]
    return (torch.stack([sl, sr], dim=1).reshape(2 * m, 4),
            torch.stack([tl, tr], dim=1).reshape(2 * m))
