"""Grotto DCF: comparison over F2 from a plain DPF (Storrier+'23).

Counterpart of ``fss_tpu.schemes.grotto_dcf`` (the reference's
grotto_dcf.cuh). Gen is DPF Gen with beta = 0 over ``Bytes``; the
comparison comes from the prefix parity of the DPF's leaf control bits:
share_0 XOR share_1 = 1[alpha <= x].

The leaf control bits are ``eval_all_cuda.expand_leaves``'s: the DPF
EvalAll kernel's seeds epilogue on the card at every in_bits, its plain
version on the CPU. Around it, torch on the tensors' device:

  - the running-XOR prefix scan of EvalAll is ``cumsum(t) & 1`` in int64;
  - the parity segment tree is in_bits pairwise-XOR reductions;
  - the reference's pointer-chasing Eval is a batched gather walk, one
    gather a level, with int64 node indices;
  - the prefix table packs the scan's bits 32 a word, and its queries are
    one gather and a shift each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.ops import dpf_cuda, eval_all_cuda


def gen(prg2, in_bits: int, s0s: torch.Tensor,
        alphas: torch.Tensor) -> torch.Tensor:
    """DPF Gen with beta = 0 over ``Bytes`` (grotto_dcf.cuh:63-67), batched:
    s0s [B, 2, 4], alphas [B] words or [B, 4] lanes. Returns wire rows
    [B, in_bits+1, 8] through the DPF Gen kernel."""
    betas = torch.zeros((s0s.shape[0], 4), dtype=torch.int32,
                        device=s0s.device)
    return dpf_cuda.gen_batch(prg2, groups.Bytes(), in_bits, s0s, alphas,
                              betas)


def expand_control_bits(prg2, in_bits: int, party: int, s0: torch.Tensor,
                        cws: torch.Tensor) -> torch.Tensor:
    """The [2^n] leaf control bits (int32 0/1, in x order) of one key."""
    return eval_all_cuda.expand_leaves(prg2, in_bits, party, s0,
                                       cws[:in_bits])[1]


class ParityTree(NamedTuple):
    """Level-order parity segment tree (grotto_dcf.cuh:78-81): levels[i] is
    a [2^i] int32 0/1 tensor, levels[0] the root and levels[in_bits] the
    leaf control bits."""

    levels: tuple
    party: int

    @property
    def in_bits(self) -> int:
        return len(self.levels) - 1


def build_parity_tree(leaf: torch.Tensor, party: int) -> ParityTree:
    """Bottom-up parity levels from the leaf control bits
    (grotto_dcf.cuh:94-104)."""
    levels = [leaf]
    cur = leaf
    for _ in range(leaf.shape[0].bit_length() - 1):
        cur = cur[0::2] ^ cur[1::2]
        levels.append(cur)
    levels.reverse()
    return ParityTree(levels=tuple(levels), party=party)


def preprocess(prg2, in_bits: int, party: int, s0: torch.Tensor,
               cws: torch.Tensor) -> ParityTree:
    """Expand the tree and build every parity level."""
    return build_parity_tree(
        expand_control_bits(prg2, in_bits, party, s0, cws), party)


def _incr_lanes(x_lanes: torch.Tensor) -> torch.Tensor:
    """128-bit increment of [..., 4] int32 lanes (wrapping)."""
    x = blk.u64(x_lanes)
    out, carry = [], 1
    for i in range(4):
        s = x[..., i] + carry
        carry = s >> 32
        out.append(s & blk.MASK32)
    return blk.i32(torch.stack(out, dim=-1))


def eval_points(pt: ParityTree, x_lanes: torch.Tensor) -> torch.Tensor:
    """Batched prefix-parity queries, x_lanes [B, 4]: the party's share of
    1[alpha <= x] (grotto_dcf.cuh:116-135), int32 0/1 [B].

    Walks the endpoint e = x + 1 top down, folding in the left child's
    parity wherever e's bit goes right. e = N (x = N - 1), and e wrapping
    to 0 at in_bits = 128, is the whole domain: the root's parity.
    """
    in_bits = pt.in_bits
    e = _incr_lanes(x_lanes)
    e_bits = blk.input_bits_msb_first(e, in_bits)
    top = blk.words(blk.pack_int(1 << in_bits), e.device)
    full_domain = ((e == top).all(-1) | (e == 0).all(-1))
    pi = torch.zeros(e.shape[:-1], dtype=torch.int32, device=e.device)
    cur = torch.zeros(e.shape[:-1], dtype=torch.int64, device=e.device)
    for i in range(in_bits):
        bit = e_bits[..., i]
        pi ^= bit & pt.levels[i + 1][2 * cur]
        cur = 2 * cur + bit
    return torch.where(full_domain, pt.levels[0][0], pi)


def prefix_scan(t: torch.Tensor) -> torch.Tensor:
    """XOR prefix scan of 0/1 bits: cumsum & 1 in int64, back to int32."""
    return (torch.cumsum(t, 0, dtype=torch.int64) & 1).to(torch.int32)


def eval_all(prg2, in_bits: int, party: int, s0: torch.Tensor,
             cws: torch.Tensor) -> torch.Tensor:
    """Full-domain shares of 1[alpha <= x] for all x, int32 0/1 [2^n]
    (grotto_dcf.cuh:151-163): the leaf bits and their prefix scan."""
    return prefix_scan(expand_control_bits(prg2, in_bits, party, s0, cws))


class PrefixTable(NamedTuple):
    """Bit-packed full-domain prefix parities: bit j of words[w] is the
    party's share of 1[alpha <= 32 w + j]. N bits in all; a query is one
    gather and a shift."""

    words: torch.Tensor  # [max(N // 32, 1)] int32
    party: int
    in_bits: int


def build_prefix_table(prefix_bits: torch.Tensor, party: int) -> PrefixTable:
    """Pack the [N] 0/1 prefix parities (``eval_all``'s output), padded
    with zeros to 32 bits when N < 32."""
    n = prefix_bits.shape[0]
    bits = prefix_bits.to(torch.int64)
    if n < 32:
        bits = torch.nn.functional.pad(bits, (0, 32 - n))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(-1, 32) << shifts).sum(1)  # disjoint bits
    return PrefixTable(words=blk.i32(words), party=party,
                       in_bits=n.bit_length() - 1)


def preprocess_prefix(prg2, in_bits: int, party: int, s0: torch.Tensor,
                      cws: torch.Tensor) -> PrefixTable:
    return build_prefix_table(eval_all(prg2, in_bits, party, s0, cws),
                              party)


def eval_prefix(table: PrefixTable, xs: torch.Tensor) -> torch.Tensor:
    """Point queries against the packed table, xs int32 words [...]: one
    gather and a shift each, int32 0/1."""
    x = blk.u64(xs)
    w = table.words[x >> 5]
    return (w >> (x & 31).to(torch.int32)) & 1
