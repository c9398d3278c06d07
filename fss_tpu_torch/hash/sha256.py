"""Keyed SHA-256, bit-exact to the reference's variant.

Counterpart of ``fss_tpu.hash.sha256``:

  - ``hash64`` (H' of the VDPF) is SHA-256 over the 80 bytes
    key (16 B) || msg (64 B): two blocks, length 640 bits;
  - ``xor_hash`` (H of the VDPF) is SHA-256 over the 48 bytes
    key || SetLsb(a, lsb) || b, one block, length 384 bits, for lsb 0 and
    1, the two digests concatenated to 64 bytes.

Byte streams are the blocks' little-endian lane bytes; SHA-256 works on
big-endian words, so lanes are byte-swapped at the boundary, both ways.

The plain version here works on int64 words in [0, 2^32) (the CPU has no
uint32 add, shift or compare). :class:`Sha256` runs on the card through
the CUDA kernels of ``ops/sha256_cuda.py`` (``csrc/sha256.cu``, which
shares ``csrc/sha256.cuh`` with the fused VDPF eval kernel), and on the
CPU through their plain versions, which call :func:`compress_words`.
"""

from __future__ import annotations

import dataclasses

import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.block import MASK32

H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

K = (0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
     0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
     0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
     0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
     0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
     0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
     0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
     0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
     0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
     0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
     0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)

# The padding words after a 48-byte message (xor_hash, one block) and
# after the last 16 bytes of an 80-byte one (hash64, second block).
PAD48 = (0x80000000, 0, 0, 384)
PAD80 = (0x80000000,) + (0,) * 10 + (640,)


def bswap32(x):
    """Byte-swap 32-bit words (ints or int64 tensors in [0, 2^32))."""
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def _rot3(x, n1: int, n2: int, n3: int):
    """rotr(x, n1) ^ rotr(x, n2) ^ rotr(x, n3) on words held in int64 or
    Python ints: each rotate is a shift of x doubled into 64 bits."""
    x2 = x | (x << 32)
    return ((x2 >> n1) ^ (x2 >> n2) ^ (x2 >> n3)) & MASK32


def _sigma(x, n1: int, n2: int, n3: int):
    """rotr(x, n1) ^ rotr(x, n2) ^ (x >> n3): the schedule's sigmas."""
    x2 = x | (x << 32)
    return (((x2 >> n1) ^ (x2 >> n2)) & MASK32) ^ (x >> n3)


def compress_words(state, block_words):
    """One SHA-256 compression over any batch shape.

    state: 8 words; block_words: 16 big-endian message words; each word an
    int64 tensor in [0, 2^32) (broadcastable) or a Python int. Returns the
    8 updated state words. The schedule is the 16-word rolling window of
    the JAX package's rolled form.
    """
    w = list(block_words)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rot3(e, 6, 11, 25)
        ch = g ^ (e & (f ^ g))
        t1 = h + s1 + ch + K[t] + w[0]
        s0 = _rot3(a, 2, 13, 22)
        maj = (a & b) | (c & (a | b))
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & MASK32, a, b, c,
                                  (d + t1) & MASK32, e, f, g)
        if t < 48:  # W[t + 16]
            w.append((w[0] + _sigma(w[1], 7, 18, 3) + w[9]
                      + _sigma(w[14], 17, 19, 10)) & MASK32)
        w = w[1:]
    return [(s + o) & MASK32 for s, o in zip(state, (a, b, c, d, e, f, g, h))]


@dataclasses.dataclass(frozen=True)
class Sha256:
    """Keyed SHA-256 over int32 blocks; ``key`` is a 16-byte block, 4
    little-endian lanes (a sequence, an array or a tensor; stored as 4
    ints in [0, 2^32))."""

    key: tuple

    def __post_init__(self):
        object.__setattr__(self, "key", blk.key_words(self.key, 4, "key"))

    def hash64(self, msg) -> torch.Tensor:
        """SHA-256(key || msg): msg [..., 4, 4] -> [..., 2, 4]."""
        from fss_tpu_torch.ops import sha256_cuda  # it imports this module
        msg = blk.words(msg)
        out = sha256_cuda.hash64(self.key, msg.reshape(-1, 4, 4).contiguous())
        return out.reshape(*msg.shape[:-2], 2, 4)

    def xor_hash(self, a, b) -> torch.Tensor:
        """(a, b) blocks [..., 4] -> [..., 4, 4]: two 48-byte keyed digests
        with a's LSB as domain separator."""
        from fss_tpu_torch.ops import sha256_cuda
        a, b = blk.words(a), blk.words(b)
        a, b = torch.broadcast_tensors(a, b)
        out = sha256_cuda.xor_hash(self.key, a.reshape(-1, 4).contiguous(),
                                   b.reshape(-1, 4).contiguous())
        return out.reshape(*a.shape[:-1], 4, 4)
