"""ChaCha-as-PRG, bit-exact to the reference's nonstandard variant.

Counterpart of ``fss_tpu.prg.chacha``. This is NOT standard ChaCha20
stream output: one block is generated per seed, the feed-forward is an XOR
against the *input* state rows instead of a 32-bit addition, and only the
rows needed for ``mul`` outputs are fed forward:

  - row 0 = "expand 16-byte k" for mul <= 2, else "expand 32-byte k";
  - rows 1 and 2 = the 128-bit seed, duplicated;
  - row 3 = counter 0 || 0 and the 2-word nonce;
  - after ``rounds`` rounds: out1 = row1 ^ seed always; mul=2 adds
    out0 = row0 ^ const; mul=4 adds out2 = row2 ^ seed and
    out3 = row3 ^ {0, 0, nonce}.

The plain PyTorch version here works on int64 words in [0, 2^32) (the
CPU has no uint32 add or shift). The CUDA kernels share one device
version of the same function, ``csrc/chacha.cuh``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.block import MASK32

CONST16 = (0x61707865, 0x3120646E, 0x79622D36, 0x6B206574)  # expand 16-byte k
CONST32 = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # expand 32-byte k

_COLUMNS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15))
_DIAGONALS = ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & MASK32) | (x >> (32 - n))


def _quarter_rounds(a, b, c, d):
    """Four quarter-rounds at once: a, b, c, d are state rows [4, ...] and
    word i of them is one quarter-round's (a, b, c, d)."""
    a = (a + b) & MASK32
    d = _rotl(d ^ a, 16)
    c = (c + d) & MASK32
    b = _rotl(b ^ c, 12)
    a = (a + b) & MASK32
    d = _rotl(d ^ a, 8)
    c = (c + d) & MASK32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def _roll(row: torch.Tensor, k: int) -> torch.Tensor:
    """Word i of the result is word (i + k) % 4 of ``row`` [4, ...]."""
    return torch.cat([row[k:], row[:k]]) if k else row


def chacha_prg_rows(seed: torch.Tensor, nonce, mul: int, rounds: int = 20):
    """[..., 4] int64 seed words in [0, 2^32) -> ``mul`` int64 blocks
    [..., 4].

    The state is kept as its 4 rows, word-major ([4, ...]); a column round
    is one quarter-round over the rows, a diagonal round the same after
    rotating rows 1-3 by 1-3 words (``_DIAGONALS``: word i of row 0 meets
    word i+1 of row 1, i+2 of row 2 and i+3 of row 3), and rotating them
    back after.
    """
    const = CONST16 if mul <= 2 else CONST32
    n0 = int(nonce[0]) & MASK32
    n1 = int(nonce[1]) & MASK32
    key = seed.movedim(-1, 0).contiguous()
    zero = torch.zeros_like(key)
    shape = (4,) + (1,) * (key.dim() - 1)
    row0 = zero + torch.tensor(const, dtype=torch.int64,
                               device=key.device).reshape(shape)
    row3 = zero + torch.tensor((0, 0, n0, n1), dtype=torch.int64,
                               device=key.device).reshape(shape)
    a, b, c, d = row0, key, key, row3
    for _ in range(rounds // 2):
        a, b, c, d = _quarter_rounds(a, b, c, d)
        a, b, c, d = _quarter_rounds(a, _roll(b, 1), _roll(c, 2),
                                     _roll(d, 3))
        b, c, d = _roll(b, 3), _roll(c, 2), _roll(d, 1)

    outs = (a ^ row0, b ^ key, c ^ key, d ^ row3)
    picked = {1: outs[1:2], 2: outs[0:2], 4: outs}[mul]
    return tuple(o.movedim(0, -1).contiguous() for o in picked)


@dataclasses.dataclass(frozen=True)
class ChaCha:
    """Batched ChaCha PRG over [..., 4] int32 seed blocks.

    mul in {1, 2, 4}; returns a tuple of ``mul`` blocks, each [..., 4].
    """

    mul: int
    nonce: tuple  # (uint32, uint32): process nonce, shared across instances
    rounds: int = 20

    def __post_init__(self):
        if self.mul not in (1, 2, 4):
            raise ValueError(f"mul must be 1, 2, or 4, got {self.mul}")
        if self.rounds % 2 != 0:
            raise ValueError(f"rounds must be even, got {self.rounds}")
        object.__setattr__(
            self, "nonce", tuple(int(n) & MASK32 for n in self.nonce))

    def __call__(self, seed: torch.Tensor):
        outs = chacha_prg_rows(blk.u64(seed), self.nonce, self.mul,
                               self.rounds)
        return tuple(blk.i32(o) for o in outs)


def chacha_prg_reference(seed: np.ndarray, nonce, mul: int,
                         rounds: int = 20) -> np.ndarray:
    """Pure-NumPy oracle of the same PRG, for bit-exactness tests."""
    seed = np.asarray(seed, dtype=np.uint32)
    const = CONST16 if mul <= 2 else CONST32
    st = np.zeros(16, dtype=np.uint32)
    st[0:4] = const
    st[4:8] = seed
    st[8:12] = seed
    st[12] = 0
    st[13] = 0
    st[14] = np.uint32(int(nonce[0]) & MASK32)
    st[15] = np.uint32(int(nonce[1]) & MASK32)

    def rotl(x, n):
        x = int(x) & MASK32
        return np.uint32(((x << n) | (x >> (32 - n))) & MASK32)

    def qr(s, ia, ib, ic, id_):
        a, b, c, d = (int(s[i]) for i in (ia, ib, ic, id_))
        a = (a + b) & MASK32
        d = int(rotl(d ^ a, 16))
        c = (c + d) & MASK32
        b = int(rotl(b ^ c, 12))
        a = (a + b) & MASK32
        d = int(rotl(d ^ a, 8))
        c = (c + d) & MASK32
        b = int(rotl(b ^ c, 7))
        s[ia], s[ib], s[ic], s[id_] = (np.uint32(a), np.uint32(b),
                                       np.uint32(c), np.uint32(d))

    for _ in range(rounds // 2):
        for cols in _COLUMNS:
            qr(st, *cols)
        for diag in _DIAGONALS:
            qr(st, *diag)

    out1 = st[4:8] ^ seed
    if mul == 1:
        return out1[None]
    out0 = st[0:4] ^ np.asarray(const, dtype=np.uint32)
    if mul == 2:
        return np.stack([out0, out1])
    out2 = st[8:12] ^ seed
    out3 = st[12:16] ^ np.array(
        [0, 0, int(nonce[0]) & MASK32, int(nonce[1]) & MASK32],
        dtype=np.uint32)
    return np.stack([out0, out1, out2, out3])
