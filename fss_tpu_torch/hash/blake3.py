"""Single-compression keyed BLAKE3, bit-exact to the reference's variant.

Counterpart of ``fss_tpu.hash.blake3``. The rules:

  - a custom 32-byte IV (8 words) replaces BLAKE3's standard IV;
  - every compression has flags CHUNK_START | CHUNK_END | ROOT |
    KEYED_HASH = 0x1B and counter 0;
  - ``hash64`` (H' of the VDPF) is one compression of a 64-byte message,
    block_len 64, truncated to its first 8 output words;
  - ``xor_hash`` (H of the VDPF) is two compressions of (a, b) padded to
    64 bytes, block_len 32, with lane 3's LSB of ``a`` set to 0 and then
    1, their 8-word outputs concatenated to 64 bytes;
  - an output word i < 8 is v[i] ^ v[i + 8]; round r takes the message
    permuted r times (``SCHEDULE``).

The plain version here works on int64 words in [0, 2^32) (the CPU has no
uint32 add or shift). :class:`Blake3` runs on the card through the CUDA
kernels of ``ops/blake3_cuda.py`` (``csrc/blake3.cu``, which shares
``csrc/blake3.cuh`` with the fused VDPF eval kernel), and on the CPU
through their plain versions, which call :func:`compress_words`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.block import MASK32

IV0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A)
FLAGS = 0x1B  # CHUNK_START | CHUNK_END | ROOT | KEYED_HASH
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)


def _schedule():
    sched = [tuple(range(16))]
    for _ in range(6):
        sched.append(tuple(sched[-1][p] for p in PERM))
    return tuple(sched)


# Round r uses m[SCHEDULE[r][i]] as its i-th message word: PERM applied r
# times.
SCHEDULE = _schedule()


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & MASK32)


def _g(a, b, c, d, x, y):
    """Four G mixes at once: word i of the rows a, b, c, d is one mix's
    (a, b, c, d), and word i of x, y its two message words."""
    a = (a + b + x) & MASK32
    d = _rotr(d ^ a, 16)
    c = (c + d) & MASK32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & MASK32
    d = _rotr(d ^ a, 8)
    c = (c + d) & MASK32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def compress_words(h_words, m_words, block_len: int, flags: int = FLAGS):
    """BLAKE3 compression with counter 0, over any batch shape.

    h_words: 8 chaining-value words (ints or int64 tensors); m_words: 16
    message words (int64 tensors in [0, 2^32), broadcastable). Returns the
    16 output words as int64 tensors.

    The state is kept as its 4 rows, word-major ([4, ...]): a column step
    is one G over the rows, a diagonal step the same after rotating rows
    1-3 by 1-3 words, as the plain ChaCha does.
    """
    m = torch.stack(torch.broadcast_tensors(*m_words))  # [16, ...]
    zero = torch.zeros_like(m[0])
    h = torch.stack([zero + w for w in h_words])
    a, b = h[0:4], h[4:8]
    c = torch.stack([zero + w for w in IV0])
    d = torch.stack([zero, zero, zero + int(block_len), zero + int(flags)])
    for s in SCHEDULE:
        a, b, c, d = _g(a, b, c, d, m[list(s[0:8:2])], m[list(s[1:8:2])])
        a, b, c, d = _g(a, torch.roll(b, -1, 0), torch.roll(c, -2, 0),
                        torch.roll(d, -3, 0), m[list(s[8::2])],
                        m[list(s[9::2])])
        b, c, d = (torch.roll(b, 1, 0), torch.roll(c, 2, 0),
                   torch.roll(d, 3, 0))
    return list(torch.cat([a ^ c, b ^ d, c ^ h[0:4], d ^ h[4:8]]).unbind(0))


def compress_reference(h8, m16, block_len: int, flags=FLAGS) -> np.ndarray:
    """Pure-Python oracle of the compression, for bit-exactness tests."""
    mask = MASK32
    v = [int(w) & mask for w in h8]
    v += list(IV0)
    v += [0, 0, int(block_len), int(flags)]
    m = [int(w) & mask for w in m16]

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & mask

    def g(ia, ib, ic, id_, x, y):
        v[ia] = (v[ia] + v[ib] + x) & mask
        v[id_] = rotr(v[id_] ^ v[ia], 16)
        v[ic] = (v[ic] + v[id_]) & mask
        v[ib] = rotr(v[ib] ^ v[ic], 12)
        v[ia] = (v[ia] + v[ib] + y) & mask
        v[id_] = rotr(v[id_] ^ v[ia], 8)
        v[ic] = (v[ic] + v[id_]) & mask
        v[ib] = rotr(v[ib] ^ v[ic], 7)

    for s in SCHEDULE:
        for i in range(4):
            g(i, i + 4, i + 8, i + 12, m[s[2 * i]], m[s[2 * i + 1]])
        for i, (ia, ib, ic, id_) in enumerate(
                ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13),
                 (3, 4, 9, 14))):
            g(ia, ib, ic, id_, m[s[8 + 2 * i]], m[s[9 + 2 * i]])

    out = [v[i] ^ v[i + 8] for i in range(8)]
    out += [v[8 + i] ^ (int(h8[i]) & mask) for i in range(8)]
    return np.array(out, dtype=np.uint32)


@dataclasses.dataclass(frozen=True)
class Blake3:
    """Keyed BLAKE3 over int32 blocks; ``iv`` is the 32-byte key, 8 words
    (a sequence, an array or a tensor; stored as 8 ints in [0, 2^32))."""

    iv: tuple

    def __post_init__(self):
        object.__setattr__(self, "iv", blk.key_words(self.iv, 8, "iv"))

    def hash64(self, msg) -> torch.Tensor:
        """64 B -> 32 B (H'): msg [..., 4, 4] -> [..., 2, 4]."""
        from fss_tpu_torch.ops import blake3_cuda  # it imports this module
        msg = blk.words(msg)
        out = blake3_cuda.hash64(self.iv, msg.reshape(-1, 4, 4).contiguous())
        return out.reshape(*msg.shape[:-2], 2, 4)

    def xor_hash(self, a, b) -> torch.Tensor:
        """(a, b) blocks [..., 4] -> [..., 4, 4] 64 B digest (H)."""
        from fss_tpu_torch.ops import blake3_cuda
        a, b = blk.words(a), blk.words(b)
        a, b = torch.broadcast_tensors(a, b)
        out = blake3_cuda.xor_hash(self.iv, a.reshape(-1, 4).contiguous(),
                                   b.reshape(-1, 4).contiguous())
        return out.reshape(*a.shape[:-1], 4, 4)
