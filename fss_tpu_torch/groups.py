"""L2 output-group algebra over 128-bit blocks.

Counterpart of ``fss_tpu.groups``. Group values are [..., 4] int32 lane
tensors (little-endian), bit-identical to the JAX package's uint32 lanes.
The output domain is fixed at 16 bytes with the clamped bit zero
(lambda = 127).

Arithmetic runs on int64 lanes holding [0, 2^32) (``block.u64``), so the
carry of a lane add is ``sum >> 32`` and the borrow of a lane subtract is
the sign of the difference; every op converts back to int32 at its end.

For 128-bit Uint the clamped bit sits inside the block encoding:
``from_block`` takes ``(w >> 1) << 96`` and ``into_block`` emits
``(val >> 96) << 1``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fss_tpu_torch.block import MASK32, i32, u64


# ---------------------------------------------------------------------------
# 128-bit lane arithmetic on int64 lanes in [0, 2^32)
# ---------------------------------------------------------------------------

def _lanes(a: torch.Tensor):
    return [a[..., i] for i in range(4)]


def _stack(lanes) -> torch.Tensor:
    return torch.stack(list(lanes), dim=-1)


def _add128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping 128-bit add."""
    out, carry = [], 0
    for x, y in zip(_lanes(a), _lanes(b)):
        s = x + y + carry
        carry = s >> 32
        out.append(s & MASK32)
    return _stack(out)


def _sub128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping 128-bit subtract a - b."""
    out, borrow = [], 0
    for x, y in zip(_lanes(a), _lanes(b)):
        d = x - y - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d & MASK32)
    return _stack(out)


def _ge128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a >= b over lanes (bool of batch shape)."""
    gt = a[..., 3] > b[..., 3]
    eq = a[..., 3] == b[..., 3]
    for lane in (2, 1, 0):
        gt = gt | (eq & (a[..., lane] > b[..., lane]))
        eq = eq & (a[..., lane] == b[..., lane])
    return gt | eq


def _iszero128(a: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] | a[..., 1] | a[..., 2] | a[..., 3]) == 0


def _mask_to_bits(a: torch.Tensor, bits: int) -> torch.Tensor:
    """Zero out everything above ``bits`` bits."""
    if bits >= 128:
        return a
    full, rem = divmod(bits, 32)
    lanes = []
    for i, x in enumerate(_lanes(a)):
        if i < full:
            lanes.append(x)
        elif i == full and rem:
            lanes.append(x & ((1 << rem) - 1))
        else:
            lanes.append(torch.zeros_like(x))
    return _stack(lanes)


def _const128(value: int, like: torch.Tensor) -> torch.Tensor:
    lanes = [(value >> (32 * i)) & MASK32 for i in range(4)]
    return torch.tensor(lanes, dtype=torch.int64,
                        device=like.device).expand_as(like)


def _shl1(lanes, carry_in):
    """Shift a 4-lane value left by one; returns (lanes, bit shifted out)."""
    out = []
    for x in lanes:
        out.append(((x << 1) & MASK32) | carry_in)
        carry_in = x >> 31
    return out, carry_in


def _shl128(lanes, k: int):
    """4 lanes << k for 0 <= k <= 128, wrapping at 2^128."""
    words, bits = divmod(k, 32)
    zero = torch.zeros_like(lanes[0])
    out = [zero] * words + lanes[:4 - words]
    if bits:
        out = [((x << bits) & MASK32) | (lo >> (32 - bits))
               for x, lo in zip(out, [zero] + out[:3])]
    return out


def _shr128(lanes, k: int):
    """4 lanes >> k for 0 <= k <= 128."""
    words, bits = divmod(k, 32)
    zero = torch.zeros_like(lanes[0])
    out = lanes[words:] + [zero] * words
    if bits:
        out = [(x >> bits) | ((hi << (32 - bits)) & MASK32)
               for x, hi in zip(out, out[1:] + [zero])]
    return out


def _mod_reduce(a: torch.Tensor, mod: int, a_bits: int) -> torch.Tensor:
    """a % mod for a < 2^a_bits, by MSB-first shift-subtract division.

    The top ``mod.bit_length() - 1`` bits of a, read as a number, are below
    mod, so they are the remainder before the first subtraction; the loop
    runs only over the bits below them (2 steps, not 128, for a 127-bit
    modulus)."""
    steps = a_bits - min(mod.bit_length() - 1, a_bits)
    lanes = _lanes(a)
    r = _stack(_shr128(lanes, steps))
    val = _shl128(lanes, 128 - steps)  # the remaining bits, at the top
    mod_t = _const128(mod, a)
    for _ in range(steps):
        val, msb = _shl1(val, 0)
        r_lanes, _ = _shl1(_lanes(r), msb)
        r = _stack(r_lanes)
        r = torch.where(_ge128(r, mod_t)[..., None], _sub128(r, mod_t), r)
    return r


# ---------------------------------------------------------------------------
# Groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bytes:
    """XOR group over 16-byte blocks. Self-inverse: neg(x) == x."""

    name = "bytes"

    def from_block(self, buf: torch.Tensor) -> torch.Tensor:
        return buf

    def into_block(self, val: torch.Tensor) -> torch.Tensor:
        return val

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.bitwise_xor(a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return a

    def zero(self, shape=(), device=None) -> torch.Tensor:
        return torch.zeros((*shape, 4), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Uint:
    """Unsigned integers with wrapping or modular addition as a group.

    ``bits`` in {8, 16, 32, 64, 128}; ``mod`` = 0 means wrap at 2^bits.
    For bits=128 a nonzero mod <= 2^127 is required because of the
    clamped bit.
    """

    bits: int
    mod: int = 0

    def __post_init__(self):
        if self.bits not in (8, 16, 32, 64, 128):
            raise ValueError(f"bits must be 8/16/32/64/128, got {self.bits}")
        if self.bits == 128 and not (0 < self.mod <= (1 << 127)):
            raise ValueError("bits=128 requires 0 < mod <= 2^127")
        if self.mod and self.mod > (1 << self.bits):
            raise ValueError("mod exceeds the value width")

    @property
    def name(self) -> str:
        return f"uint{self.bits}" + (f"_mod{self.mod}" if self.mod else "")

    @property
    def _mod_is_pow2(self) -> bool:
        return self.mod != 0 and (self.mod & (self.mod - 1)) == 0

    # Values of bits <= 32 live in lane 0 and lanes 1-3 are zero, so those
    # groups compute on lane 0 alone (a quarter of the glue's passes).

    def _lane0(self, v0: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(like)
        out[..., 0] = i32(v0)
        return out

    def from_block(self, buf: torch.Tensor) -> torch.Tensor:
        if self.bits <= 32:
            v0 = u64(buf[..., 0]) & ((1 << self.bits) - 1)
            if self.mod:
                v0 = v0 & (self.mod - 1) if self._mod_is_pow2 else \
                    v0 % self.mod
            return self._lane0(v0, buf)
        lanes = _lanes(u64(buf))
        zero = torch.zeros_like(lanes[0])
        if self.bits == 64:
            val = _stack([lanes[0], lanes[1], zero, zero])
        else:
            # The clamped bit sits inside the encoding.
            val = _stack([lanes[0], lanes[1], lanes[2], lanes[3] >> 1])
        if self.mod:
            if self._mod_is_pow2:
                val = _mask_to_bits(val, self.mod.bit_length() - 1)
            else:
                val = _mod_reduce(val, self.mod,
                                  self.bits if self.bits < 128 else 127)
        return i32(val)

    def into_block(self, val: torch.Tensor) -> torch.Tensor:
        if self.bits < 128:
            return val
        out = val.clone()
        out[..., 3] = i32(u64(val[..., 3]) << 1)
        return out

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.bits <= 32:
            s = u64(a[..., 0]) + u64(b[..., 0])
            s = (torch.where(s >= self.mod, s - self.mod, s) if self.mod
                 else s & ((1 << self.bits) - 1))
            return self._lane0(s, a)
        s = _add128(u64(a), u64(b))
        if self.mod == 0:
            return i32(_mask_to_bits(s, self.bits))
        # Operands < mod <= 2^127: no 128-bit overflow.
        mod = _const128(self.mod, s)
        return i32(torch.where(_ge128(s, mod)[..., None], _sub128(s, mod), s))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        if self.bits <= 32:
            v = u64(a[..., 0])
            v = (torch.where(v == 0, v, self.mod - v) if self.mod
                 else (-v) & ((1 << self.bits) - 1))
            return self._lane0(v, a)
        a64 = u64(a)
        if self.mod == 0:
            return i32(_mask_to_bits(_sub128(torch.zeros_like(a64), a64),
                                     self.bits))
        d = _sub128(_const128(self.mod, a64), a64)
        return i32(torch.where(_iszero128(a64)[..., None],
                               torch.zeros_like(a64), d))

    def zero(self, shape=(), device=None) -> torch.Tensor:
        return torch.zeros((*shape, 4), dtype=torch.int32, device=device)


def to_int(group, val) -> int:
    """A single group value's lanes as a Python int (test helper)."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    lanes = np.asarray(val).astype(np.uint64) & np.uint64(MASK32)
    return int(sum(int(lanes[i]) << (32 * i) for i in range(4)))


# ---------------------------------------------------------------------------
# A group as the kernels take it (csrc/group.cuh)
# ---------------------------------------------------------------------------

# fss::Mode order: one kind per algebra.
#   xor       Bytes.
#   wrap      Uint, bits <= 64, mod 0 or a power of two.
#   mod64     Uint, bits <= 64, any other mod.
#   mod128    Uint(128) with a power-of-two mod (the clamped encoding).
#   mod128np  Uint(128) with any other mod.
MODES = ("xor", "wrap", "mod64", "mod128", "mod128np")


def group_mode(group) -> str:
    """The kernels' kind (fss::Mode) of ``group``."""
    if isinstance(group, Bytes):
        return "xor"
    if not isinstance(group, Uint):
        raise TypeError(f"unsupported group {group!r}")
    if group.bits == 128:
        return "mod128" if group._mod_is_pow2 else "mod128np"
    if group.mod == 0 or group._mod_is_pow2:
        return "wrap"
    return "mod64"


def bits_mask(bits: int) -> tuple:
    """The 4 lane masks that keep the low ``bits`` bits."""
    return tuple((1 << min(max(bits - 32 * i, 0), 32)) - 1
                 for i in range(4))


def gen_params(group) -> tuple:
    """The kernels' fss::Group: (mask, mod) lanes. ``mask`` is what
    ``from_block`` keeps of a (decoded) block; ``mod`` the modulus."""
    mode = group_mode(group)
    if mode == "xor":
        return (MASK32,) * 4, (0,) * 4
    if mode in ("wrap", "mod128"):  # a power-of-two mod narrows the width
        return bits_mask(group.mod.bit_length() - 1 if group.mod
                         else group.bits), (0,) * 4
    return bits_mask(group.bits), tuple((group.mod >> (32 * i)) & MASK32
                                        for i in range(4))
