"""Verifiable DPF (de Castro-Polychroniadou, EUROCRYPT'22): plain PyTorch
version.

Counterpart of ``fss_tpu.schemes.vdpf``, batched over a leading key axis.
Eval gives an output share and a corrected 64-byte hash of the point,
pi~ = H(x, s_leaf) ^ (t ? cs : 0); a proof folds the pi~s into one 64-byte
value; Verify is equality of the two parties' proofs.

Key layout: ``cws`` is [..., in_bits, 8] int32, the DPF's level rows with
no output-CW row; the check seed ``cs`` is [..., 4, 4] (64 bytes) and
``ocw`` [..., 4], both separate outputs of Gen. Gen fails, and the caller
draws new seeds, when the two parties' final control bits are equal
(``fail`` = 1); the level loop keeps t0 ^ t1 = 1 on the path to alpha, so
honest seeds never fail, but the flag is kept as the reference has it.

``xor_hash(a, b)`` (H: [N, 4] x [N, 4] -> [N, 4, 4]) and ``hash64(msg)``
(H': [N, 4, 4] -> [N, 2, 4]) are callables, e.g. the methods of
``hash.Blake3`` or ``hash.Sha256``. The level steps are the DPF's
(``schemes/dpf.py``, ``schemes/_tree.py``).

Three proof folds, which give different bytes (both parties must use the
same one):

  - ``prove``: the reference's flat chain in index order;
  - ``prove_chunked``: chains of ``chunk`` points, all chunks at once,
    then a chain of the chunk proofs;
  - ``prove_tree``: a Merkle fold, one batched H' a level.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.schemes import _tree
from fss_tpu_torch.schemes import dpf as _dpf

FOLDS = ("reference", "tree", "chunked")
CORRECT_ROWS = 1 << 20  # rows of pi~ corrected in one step


def finish_gen(xor_hash, group, a_lanes, s0, s1, t0, t1, betas):
    """What Gen computes from the level loop's leaves: (cs [B, 4, 4],
    ocw [B, 4], fail [B]) with cs = H(alpha, s0) ^ H(alpha, s1), fail = 1
    iff t0 == t1, and the DPF's output CW."""
    cs = xor_hash(a_lanes, s0) ^ xor_hash(a_lanes, s1)
    fail = (t0 ^ t1 ^ 1) & 1
    return cs, _dpf.output_cw(group, s0, s1, t1, betas), fail


def gen(prg2, xor_hash, group, in_bits: int, s0s: torch.Tensor,
        a_lanes: torch.Tensor, betas: torch.Tensor):
    """Generate a batch of VDPF keys.

    s0s [B, 2, 4] seeds, a_lanes [B, 4] alpha lanes, betas [B, 4]. Returns
    (cws [B, in_bits, 8], cs [B, 4, 4], ocw [B, 4], fail [B]); where fail
    is 1, cs and ocw are well defined but useless.
    """
    a_bits = blk.input_bits_msb_first(a_lanes, in_bits)
    rows, s0, s1, t0, t1 = _dpf.gen_levels(prg2, in_bits, s0s, a_bits)
    cws = torch.zeros((s0.shape[0], in_bits, 8), dtype=torch.int32,
                      device=s0.device)
    cws[:, :, :5] = torch.stack(rows, dim=1)
    return (cws, *finish_gen(xor_hash, group, a_lanes, s0, s1, t0, t1,
                             betas))


def correct_(pi: torch.Tensor, t: torch.Tensor,
             cs: torch.Tensor) -> torch.Tensor:
    """pi~ = pi ^ (t ? cs : 0) in place: pi [N, 4, 4], t [N], cs [4, 4] or
    [N, 4, 4]. Works ``CORRECT_ROWS`` rows at a time so that a full domain
    needs no second copy of pi."""
    flat = pi.view(-1, 16)
    csf = cs.reshape(-1, 16)
    mask = -t.to(torch.int32)  # 0 or all ones
    for lo in range(0, flat.shape[0], CORRECT_ROWS):
        hi = lo + CORRECT_ROWS
        c = csf if csf.shape[0] == 1 else csf[lo:hi]
        flat[lo:hi] ^= c & mask[lo:hi, None]
    return pi


def eval_points(prg2, xor_hash, group, in_bits: int, party: int,
                s0: torch.Tensor, cws: torch.Tensor, cs: torch.Tensor,
                ocw: torch.Tensor, x_lanes: torch.Tensor):
    """Batched point evaluation.

    s0 [B, 4] or [4]; cws [B, in_bits, 8] or [in_bits, 8]; cs [B, 4, 4] or
    [4, 4]; ocw [B, 4] or [4]; x_lanes [B, 4]. Returns (ys [B, 4],
    pi_tildes [B, 4, 4]).
    """
    x_bits = blk.input_bits_msb_first(x_lanes, in_bits)
    B = x_bits.shape[0]
    wide = cws.expand(B, in_bits, 8)
    s, t = _dpf.walk(prg2, in_bits, party, s0.expand(B, 4),
                     lambda i: wide[:, i], x_bits)
    ys = _dpf.finalize_leaves(group, party, s, t, ocw)
    return ys, correct_(xor_hash(x_lanes, s), t, cs)


def prove_scalar(hash64_words, pi_tildes: torch.Tensor,
                 cs: torch.Tensor) -> torch.Tensor:
    """The reference's flat fold on the host in Python ints: pi starts at
    cs, and each point in index order folds in as pi[:2] ^= H'(pi ^ pi~_i).
    ``hash64_words`` maps 16 words to 8; pi_tildes [N, 4, 4], cs [4, 4].
    Returns [4, 4]. The flat fold is scalar work: this is the plain
    version of the card's chain kernels."""
    pi = blk.u64(cs).reshape(16).tolist()
    for row in blk.u64(pi_tildes).reshape(-1, 16).tolist():
        h = hash64_words([p ^ r for p, r in zip(pi, row)])
        pi[:8] = [p ^ w for p, w in zip(pi, h)]
    return blk.i32(torch.tensor(pi, device=cs.device)).reshape(4, 4)


def prove(hash64, pi_tildes: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """:func:`prove_scalar` with ``hash64`` mapping [N, 4, 4] to [N, 2, 4]
    int32 tensors, called on one point at a time."""
    def words(m):
        msg = blk.i32(torch.tensor(m, device=cs.device)).reshape(1, 4, 4)
        return blk.u64(hash64(msg)).reshape(8).tolist()
    return prove_scalar(words, pi_tildes, cs)


def prove_chunked(hash64, pi_tildes: torch.Tensor, cs: torch.Tensor,
                  chunk: int = 256, prove=prove) -> torch.Tensor:
    """Two-level fold: every chunk of ``chunk`` points is chained in index
    order from cs, all chunks at once (one batched H' a step), then the
    chunk proofs are chained in order from cs by ``prove`` (the flat fold;
    the card passes its chain kernel). N must be divisible by ``chunk``.
    """
    n = pi_tildes.shape[0]
    if chunk < 1 or n % chunk:
        raise ValueError(f"N = {n} must be divisible by chunk = {chunk}")
    chunks = pi_tildes.reshape(n // chunk, chunk, 4, 4)
    pi = cs.expand(n // chunk, 4, 4)
    for j in range(chunk):
        pi = torch.cat([pi[:, 0:2] ^ hash64(pi ^ chunks[:, j]), pi[:, 2:4]],
                       dim=1)
    return prove(hash64, pi.contiguous(), cs)


def prove_tree(hash64, pi_tildes: torch.Tensor,
               cs: torch.Tensor) -> torch.Tensor:
    """Merkle fold: leaf digests H'(pi~_i), internal nodes H'(left ||
    right), one batched H' a level; the proof is root (32 B) || cs[2:4].
    N must be a power of two."""
    n = pi_tildes.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"N = {n} must be a power of two")
    h = hash64(pi_tildes)  # [N, 2, 4]
    while h.shape[0] > 1:
        h = hash64(h.reshape(-1, 4, 4))
    return torch.cat([h[0], cs[2:4]])


def fold(hash64, pi_tildes, cs, how: str = "reference", prove=prove):
    """The proof of pi_tildes by fold ``how`` (one of ``FOLDS``); the
    chunked fold takes chunks of min(256, N)."""
    if how == "reference":
        return prove(hash64, pi_tildes, cs)
    if how == "tree":
        return prove_tree(hash64, pi_tildes, cs)
    if how == "chunked":
        return prove_chunked(hash64, pi_tildes, cs,
                             min(256, pi_tildes.shape[0]), prove)
    raise ValueError(f"fold must be one of {FOLDS}, got {how!r}")


def verify(pi0: torch.Tensor, pi1: torch.Tensor) -> bool:
    """64-byte proof equality."""
    return bool(torch.equal(pi0, pi1))


def domain_lanes(in_bits: int, device, base: int = 0) -> torch.Tensor:
    """The 2^in_bits points from ``base`` on as [2^in_bits, 4] lanes, in x
    order (lane 0 only: EvalAll domains fit in 32 bits)."""
    x = torch.zeros((1 << in_bits, 4), dtype=torch.int32, device=device)
    x[:, 0] = torch.arange(1 << in_bits, dtype=torch.int32, device=device)
    if base:  # a shard's: aligned, so its points never cross 2^31
        x[:, 0] += (base ^ 0x80000000) - 0x80000000
    return x


def leaf_outputs(xor_hash, prove_fn, group, party: int, s: torch.Tensor,
                 t: torch.Tensor, cs: torch.Tensor, ocw: torch.Tensor,
                 base: int = 0):
    """EvalAll from the leaf layer (seeds [2^n, 4], t [2^n] in x order,
    the leaves of the points from ``base`` on): (ys [2^n, 4], pi [4, 4]),
    with ``prove_fn(pi_tildes, cs)`` the fold."""
    ys = _dpf.finalize_leaves(group, party, s, t, ocw)
    x = domain_lanes(s.shape[0].bit_length() - 1, s.device, base)
    return ys, prove_fn(correct_(xor_hash(x, s), t, cs), cs)


def eval_all(prg2, xor_hash, hash64, group, in_bits: int, party: int,
             s0: torch.Tensor, cws: torch.Tensor, cs: torch.Tensor,
             ocw: torch.Tensor, how: str = "reference"):
    """Full-domain evaluation and proof: (ys [2^in_bits, 4], pi [4, 4]).
    The tree is expanded breadth first, as the DPF's."""
    s = blk.clear_lsb(s0)[None, :]
    t = torch.full((1,), party, dtype=torch.int32, device=s.device)
    for i in range(in_bits):
        s, t = _tree.expand_level(prg2, s, t, *_tree.unpack_cw_row(cws[i]))
    return leaf_outputs(xor_hash,
                        lambda pts, c: fold(hash64, pts, c, how), group,
                        party, s, t, cs, ocw)
