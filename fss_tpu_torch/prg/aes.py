"""AES-128 Matyas-Meyer-Oseas PRG: out_i = AES_{k_i}(seed) ^ seed.

Counterpart of ``fss_tpu.prg.aes`` (its T-table form). The key schedule
runs once per key in numpy at construction, giving [11, 4] big-endian
round-key words, as the reference pre-expands its round keys. The batched
encryption is the T-table formulation: the seed's 4 lanes are
byte-swapped into the big-endian state words of the 16-byte block (the
block's bytes are the lanes' little-endian memory bytes), then 9 rounds
of 16 Te0 lookups with the rotations, a final S-box round, the swap back
and the XOR with the seed.

The plain PyTorch version works on int64 words in [0, 2^32) (the CPU has
no uint32 shift), the tables int64 tensors read by ``index_select``. The
CUDA kernels share one device version of the same function,
``csrc/aes.cuh``, with the tables in shared memory.

The JAX package's gather-free bitsliced circuit (``prg/aes_bitsliced.py``)
and its ``backend``/``unroll`` knobs are not ported: they exist because
gathers serialize on a TPU, and every backend computes the same bits.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.block import MASK32

# AES S-box (FIPS-197).
SBOX = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
], dtype=np.uint8)

_RCON = (0x8d, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36)


def _te0_table() -> np.ndarray:
    """Te0[i] = the MixColumn-weighted S-box word (2s, s, s, 3s)."""
    s = SBOX.astype(np.uint32)
    x2 = ((s << 1) ^ (((s >> 7) & 1) * 0x1B)) & 0xFF
    return ((x2 << 24) | (s << 16) | (s << 8) | (s ^ x2)).astype(np.uint32)


TE0 = _te0_table()


def key_expansion(key16) -> np.ndarray:
    """AES-128 key schedule: 16 key bytes -> [11, 4] big-endian uint32
    round-key words."""
    key = np.frombuffer(bytes(key16), dtype=np.uint8)
    if key.shape != (16,):
        raise ValueError(f"an AES-128 key is 16 bytes, got {key.size}")
    rk = np.zeros((44, 4), dtype=np.uint8)
    rk[:4] = key.reshape(4, 4)
    for i in range(4, 44):
        t = rk[i - 1].copy()
        if i % 4 == 0:
            t = SBOX[np.roll(t, -1)]
            t[0] ^= _RCON[i // 4]
        rk[i] = rk[i - 4] ^ t
    be = rk.astype(np.uint32)
    return (be[:, 0] << 24 | be[:, 1] << 16 | be[:, 2] << 8
            | be[:, 3]).reshape(11, 4)


def _bswap(x: torch.Tensor) -> torch.Tensor:
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def _rotr(x, n: int):
    return ((x << (32 - n)) & MASK32) | (x >> n)


# Byte position p of a round reads word (i + p) % 4 of the state at bit
# 24 - 8p, from the table at [256 p, 256 p + 256).
_POS_WORDS = np.array([(i + p) % 4 for p in range(4) for i in range(4)])
_POS_SHIFTS = np.array([24, 16, 8, 0]).reshape(4, 1, 1, 1)
_POS_OFFSETS = 256 * np.arange(4).reshape(4, 1, 1, 1)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """The round's tables on ``device``, int64 [1024] each: Te0 rotated
    right by 8p at position p (rounds 1-9), the S-box shifted left by 24 -
    8p (round 10); and the positions' words, shifts and offsets."""
    te0 = TE0.astype(np.int64)
    sbox = SBOX.astype(np.int64)
    rounds = np.concatenate([te0 if p == 0 else _rotr(te0, 8 * p)
                             for p in range(4)])
    last = np.concatenate([sbox << (24 - 8 * p) for p in range(4)])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (rounds, last, _POS_WORDS, _POS_SHIFTS,
                           _POS_OFFSETS))


@functools.lru_cache(maxsize=64)
def _round_key_words(round_keys: bytes, device: torch.device):
    """[K, 11, 4] uint32 round-key words (bytes) -> int64 [11, 4, K, 1] on
    ``device``."""
    rk = np.frombuffer(round_keys, dtype=np.uint32).reshape(-1, 11, 4)
    return torch.from_numpy(
        rk.astype(np.int64).transpose(1, 2, 0)[..., None].copy()).to(device)


def _encrypt(round_keys: np.ndarray, s: torch.Tensor) -> torch.Tensor:
    """round_keys: [K, 11, 4] uint32; s: int64 [4, K, N], block n's
    big-endian state words under key k at [:, k, n]. Returns the
    ciphertext words, [4, K, N]: each round gathers its 16 table words a
    block at once."""
    rounds, last, words, shifts, offsets = _tables(s.device)
    rk = _round_key_words(
        np.ascontiguousarray(round_keys, dtype=np.uint32).tobytes(), s.device)
    s = s ^ rk[0]
    for r in range(1, 11):
        idx = s.index_select(0, words).reshape((4,) + s.shape)
        idx.bitwise_right_shift_(shifts).bitwise_and_(0xFF).add_(offsets)
        t = (rounds if r < 10 else last).index_select(
            0, idx.reshape(-1)).reshape(idx.shape)
        s = t[0].bitwise_xor_(t[1]).bitwise_xor_(t[2]).bitwise_xor_(
            t[3]).bitwise_xor_(rk[r])
    return s


def aes128_encrypt_words(round_keys: np.ndarray, state):
    """Batched AES-128 over big-endian state words.

    round_keys: [11, 4] numpy uint32; state: 4 int64 tensors of one shape,
    the block's big-endian words in [0, 2^32). Returns 4 such tensors.
    """
    shape = state[0].shape
    s = torch.stack([w.reshape(-1) for w in state])[:, None]
    return [w.reshape(shape) for w in _encrypt(round_keys[None], s)[:, 0]]


@dataclasses.dataclass(frozen=True)
class AesMmo:
    """Batched AES-128-MMO PRG over [..., 4] int32 seed blocks.

    ``keys``: ``mul`` 16-byte AES keys (bytes-like), mul in {1, 2, 4};
    returns a tuple of ``mul`` blocks, each [..., 4]. The same function as
    the JAX package's ``Aes128Mmo`` with any backend and the reference's
    three AES-MMO PRGs.
    """

    mul: int
    keys: tuple  # mul x bytes(16)

    def __post_init__(self):
        if self.mul not in (1, 2, 4):
            raise ValueError(f"mul must be 1, 2, or 4, got {self.mul}")
        keys = tuple(bytes(k) for k in self.keys)
        if len(keys) != self.mul or any(len(k) != 16 for k in keys):
            raise ValueError(f"need {self.mul} 16-byte keys")
        object.__setattr__(self, "keys", keys)

    @functools.cached_property
    def round_keys(self) -> np.ndarray:
        """[mul, 11, 4] uint32 round-key words, the kernels' argument."""
        return np.stack([key_expansion(k) for k in self.keys])

    def __call__(self, seed: torch.Tensor):
        lanes = blk.u64(seed)
        # The mul keys' encryptions of every block in one batch.
        s = _bswap(lanes.reshape(-1, 4).T)[:, None]
        enc = _encrypt(self.round_keys, s.expand(4, self.mul, s.shape[-1]))
        outs = _bswap(enc).permute(1, 2, 0).contiguous().reshape(
            (self.mul,) + lanes.shape) ^ lanes
        return tuple(blk.i32(o) for o in outs)


def aes128_encrypt_reference(key16: bytes, block16: bytes) -> bytes:
    """AES-128 ECB of one 16-byte block on Python ints, for bit-exactness
    tests."""
    rks = [[int(w) for w in row] for row in key_expansion(key16)]
    s = [int.from_bytes(block16[4 * i:4 * i + 4], "big") ^ rks[0][i]
         for i in range(4)]

    def rotr(x, n):
        return ((x << (32 - n)) | (x >> n)) & MASK32

    for r in range(1, 10):
        s = [int(TE0[s[i] >> 24])
             ^ rotr(int(TE0[(s[(i + 1) % 4] >> 16) & 0xFF]), 8)
             ^ rotr(int(TE0[(s[(i + 2) % 4] >> 8) & 0xFF]), 16)
             ^ rotr(int(TE0[s[(i + 3) % 4] & 0xFF]), 24)
             ^ rks[r][i] for i in range(4)]
    out = [((int(SBOX[s[i] >> 24]) << 24)
            | (int(SBOX[(s[(i + 1) % 4] >> 16) & 0xFF]) << 16)
            | (int(SBOX[(s[(i + 2) % 4] >> 8) & 0xFF]) << 8)
            | int(SBOX[s[(i + 3) % 4] & 0xFF])) ^ rks[10][i]
           for i in range(4)]
    return b"".join(w.to_bytes(4, "big") for w in out)
