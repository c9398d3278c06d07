"""The FSS PRG built on ChaCha, in plain PyTorch: the yardstick's own copy.

This is not ChaCha20's stream output. One block is made per 128-bit seed:

  - row 0: "expand 16-byte k" when ``mul`` <= 2, else "expand 32-byte k";
  - rows 1 and 2: the seed, twice;
  - row 3: the words (0, 0, nonce[0], nonce[1]);

then ``rounds`` rounds (column and diagonal rounds in turn), and the
outputs XOR the final rows with the rows they started from (not the
32-bit add of the standard): output 1 is row 1; ``mul`` = 2 adds row 0
before it; ``mul`` = 4 gives rows 0, 1, 2, 3.

Words are int64 tensors holding values in [0, 2^32), so every add, shift
and rotate is exact on any device. The state is 16 word tensors of the
batch's shape; four quarter-rounds run at once on stacked words.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
EXPAND16 = (0x61707865, 0x3120646E, 0x79622D36, 0x6B206574)
EXPAND32 = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

# Word indices (a, b, c, d) of the four quarter-rounds of each round.
COLUMNS = ((0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11), (12, 13, 14, 15))
DIAGONALS = ((0, 1, 2, 3), (5, 6, 7, 4), (10, 11, 8, 9), (15, 12, 13, 14))


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & MASK) | (x >> (32 - n))


def _quarter(a, b, c, d):
    a = (a + b) & MASK
    d = _rotl(d ^ a, 16)
    c = (c + d) & MASK
    b = _rotl(b ^ c, 12)
    a = (a + b) & MASK
    d = _rotl(d ^ a, 8)
    c = (c + d) & MASK
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def expand(seed: torch.Tensor, nonce, mul: int, rounds: int = 20):
    """``mul`` output blocks of seeds [..., 4] (int64 words in [0, 2^32)):
    a tuple of ``mul`` tensors [..., 4] of the same kind."""
    if mul not in (1, 2, 4) or rounds % 2:
        raise ValueError(f"mul {mul}, rounds {rounds}")
    const = EXPAND16 if mul <= 2 else EXPAND32
    key = seed.movedim(-1, 0)  # [4, ...]
    head = torch.tensor(const, dtype=torch.int64, device=seed.device)
    tail = torch.tensor((0, 0, int(nonce[0]) & MASK, int(nonce[1]) & MASK),
                        dtype=torch.int64, device=seed.device)
    shape = (4,) + (1,) * (key.dim() - 1)
    rows = [head.reshape(shape).expand_as(key), key, key,
            tail.reshape(shape).expand_as(key)]
    start = torch.cat(rows)  # [16, ...]
    state = start.clone()
    for _ in range(rounds // 2):
        for idx in (COLUMNS, DIAGONALS):
            picks = [state[list(i)] for i in idx]
            out = _quarter(*picks)
            for i, o in zip(idx, out):
                state[list(i)] = o
    final = state ^ start
    blocks = [final[4 * r:4 * r + 4].movedim(0, -1) for r in range(4)]
    return {1: (blocks[1],), 2: (blocks[0], blocks[1]),
            4: tuple(blocks)}[mul]
