"""L0 block utilities: the 128-bit block as 4 little-endian 32-bit lanes.

Counterpart of ``fss_tpu.block``. A *block* is a tensor of shape
``[..., 4]`` and dtype ``torch.int32`` whose bits equal the JAX package's
uint32 lanes: lane 0 holds the least-significant 32 bits, and the LSB of
lane 3 is the *clamped bit* that carries the FSS control bit ``t``
alongside a 127-bit seed.

PyTorch on the CPU has no uint32 add, shift or compare, so arithmetic on
words happens in int64 holding values in ``[0, 2^32)`` (:func:`u64`) and
goes back to int32 only at the boundary (:func:`i32`). XOR and AND are
the same on both carriers.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
NOT_ONE = -2  # int32 0xFFFFFFFE


def u64(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & MASK32


def i32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) (or any int64; low 32 bits kept) ->
    int32 words with the same bits."""
    w = words & MASK32
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def words(vals, device=None) -> torch.Tensor:
    """Any int-like array of 32-bit words -> int32 tensor on ``device``,
    keeping the low 32 bits of each value."""
    if isinstance(vals, torch.Tensor):
        t = vals if vals.dtype == torch.int32 else i32(vals.to(torch.int64))
        return t.to(device) if device is not None else t
    arr = np.asarray(vals)
    if (arr.ndim and arr.dtype in (np.int64, np.uint64)
            and arr.dtype.byteorder in "=<" and sys.byteorder == "little"):
        # The low 32-bit word of each value is the even int32 of its
        # little-endian 8 bytes: one strided pass into the staging tensor
        # (pinned for a CUDA device, then one copy that does not block the
        # host; the caching host allocator keeps the pinned buffer until
        # that copy has run).
        low = np.ascontiguousarray(arr).view(np.int32)[..., ::2]
        dev = torch.device(device) if device is not None else None
        pinned = dev is not None and dev.type == "cuda"
        out = torch.empty(low.shape, dtype=torch.int32, pin_memory=pinned)
        out.numpy()[...] = low
        return out.to(dev, non_blocking=True) if pinned else out.to(device)
    if arr.dtype not in (np.uint32, np.int32):
        arr = (arr.astype(np.uint64) & np.uint64(MASK32)).astype(np.uint32)
    arr = np.ascontiguousarray(arr).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def key_words(vals, count: int, name: str = "key") -> tuple:
    """A hash key or IV of ``count`` 32-bit words, given as a sequence, an
    array or a tensor of either package -> ``count`` ints in [0, 2^32)."""
    if isinstance(vals, torch.Tensor):
        vals = vals.detach().cpu().tolist()
    out = tuple(int(w) & MASK32 for w in np.asarray(vals).ravel())
    if len(out) != count:
        raise ValueError(f"{name} must be {count} words, got {len(out)}")
    return out


def block(vals, device=None) -> torch.Tensor:
    """Build a block (or batch of blocks) from a [..., 4] int-like array."""
    return words(vals, device)


def to_numpy(blk: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array with the same bits."""
    return blk.detach().cpu().numpy().view(np.uint32)


def xor(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_xor(lhs, rhs)


def set_lsb(blk: torch.Tensor, bit) -> torch.Tensor:
    """Set the clamped bit (LSB of lane 3) to ``bit`` (0/1 tensor or int)."""
    out = blk.clone()
    out[..., 3] = (blk[..., 3] & NOT_ONE) | (torch.as_tensor(
        bit, device=blk.device).to(torch.int32) & 1)
    return out


def get_lsb(blk: torch.Tensor) -> torch.Tensor:
    """The clamped bit as int32 0/1."""
    return blk[..., 3] & 1


def clear_lsb(blk: torch.Tensor) -> torch.Tensor:
    out = blk.clone()
    out[..., 3] = blk[..., 3] & NOT_ONE
    return out


def masked_xor(cond: torch.Tensor, blk: torch.Tensor,
               delta: torch.Tensor) -> torch.Tensor:
    """blk ^ (cond ? delta : 0): the FSS correction-word application."""
    return torch.where(cond.bool()[..., None], blk ^ delta, blk)


# ---------------------------------------------------------------------------
# Input-domain packing: alpha / x values as lanes
# ---------------------------------------------------------------------------

def pack_int(val: int) -> np.ndarray:
    """Python int (up to 128 bits) -> numpy [4] uint32 little-endian lanes."""
    v = int(val)
    return np.array([(v >> (32 * i)) & MASK32 for i in range(4)],
                    dtype=np.uint32)


def unpack_int(lanes) -> int:
    """[4] uint32 lanes -> Python int."""
    lanes = np.asarray(lanes).astype(np.uint64) & np.uint64(MASK32)
    return int(sum(int(lanes[i]) << (32 * i) for i in range(4)))


def pack_inputs(xs, in_bits: int, device=None) -> torch.Tensor:
    """Pack input-domain values into [..., 4] int32 lane tensors.

    Accepts a Python int / list of ints (any width up to 128), an int
    array or tensor of 32-bit values for in_bits <= 32, or an already
    packed [..., 4] array of lanes.
    """
    if isinstance(xs, (int, np.integer)):
        return words(pack_int(int(xs)), device)
    if (isinstance(xs, (list, tuple)) and xs
            and isinstance(xs[0], (int, np.integer))):
        return words(np.stack([pack_int(int(v)) for v in xs]), device)
    arr = xs if isinstance(xs, torch.Tensor) else np.asarray(xs)
    if arr.ndim >= 1 and arr.shape[-1] == 4 and arr.dtype in (
            np.uint32, np.int32, torch.int32):
        return words(arr, device)  # already packed lanes
    if in_bits > 32:
        raise ValueError(
            f"in_bits={in_bits} > 32 requires pre-packed [..., 4] "
            f"inputs or Python ints, got array of dtype {arr.dtype}")
    lane0 = words(arr, device)
    rest = torch.zeros((*lane0.shape, 3), dtype=torch.int32,
                       device=lane0.device)
    return torch.cat([lane0[..., None], rest], dim=-1)


def input_bits_msb_first(x_lanes: torch.Tensor, in_bits: int) -> torch.Tensor:
    """[..., in_bits] int32 0/1 bits of the input, MSB first: bit j is bit
    (in_bits - 1 - j) of the integer."""
    positions = torch.arange(in_bits - 1, -1, -1, device=x_lanes.device)
    gathered = u64(x_lanes[..., positions // 32])
    return ((gathered >> (positions % 32)) & 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Structure-of-arrays helpers
# ---------------------------------------------------------------------------

def to_words(blk: torch.Tensor):
    """[..., 4] block -> tuple of 4 per-word tensors."""
    return blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]


def from_words(w0, w1, w2, w3) -> torch.Tensor:
    return torch.stack([w0, w1, w2, w3], dim=-1)
