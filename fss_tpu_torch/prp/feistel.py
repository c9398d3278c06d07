"""Small-domain PRP: a 4-round Feistel network with AES-128 as its round
function, cycle-walked into its domain.

Counterpart of ``fss_tpu.prp.feistel`` (the reference's
aes128_feistel.cuh), bit for bit:

  - b = ceil_log2(domain), half = (b + 1) // 2, mask = 2^half - 1;
  - round r's AES key is sigma with r XORed into byte 0;
  - the round function is AES of ``right.to_bytes(16, "little")``, the
    output read little-endian and masked to ``half`` bits;
  - four rounds, each XORing it into the left half and swapping; the value
    is (left << half) | right;
  - the cycle walk re-permutes the output until it is below the domain.

The four key schedules and the kernel's argument are made once, at
construction. ``permu`` and
``permu_lanes`` dispatch by the tensor's device: the kernel
``csrc/feistel.cu`` on the card, its plain version on the CPU
(``ops/feistel_cuda.py``, on the port's batched AES). ``permu_host`` is
the scalar oracle on Python ints that Cuckoo insertion runs on the host.
Domains go up to 2^128 (halves of up to 64 bits), as the reference's
``__uint128_t`` domain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.ops import feistel_cuda
from fss_tpu_torch.prg.aes import AesMmo, aes128_encrypt_reference


def ceil_log2(x: int) -> int:
    """ceil(log2(x)); 0 for x <= 1."""
    if x <= 1:
        return 0
    return (x - 1).bit_length()


def _seed_bytes(sigma) -> bytes:
    """sigma as 16 bytes: bytes as they are, 16 byte values, or 4 words
    whose little-endian bytes they are (an array, a list or a tensor)."""
    if isinstance(sigma, (bytes, bytearray)):
        if len(sigma) != 16:
            raise ValueError(f"sigma must be 16 bytes, got {len(sigma)}")
        return bytes(sigma)
    if isinstance(sigma, torch.Tensor):
        sigma = blk.to_numpy(blk.words(sigma))
    lanes = np.asarray(sigma)
    if lanes.shape == (16,):
        return lanes.astype(np.uint8).tobytes()
    if lanes.shape == (4,):
        return lanes.astype("<u4").tobytes()
    raise ValueError(f"sigma must be 16 bytes or 4 words, got shape "
                     f"{lanes.shape}")


@dataclasses.dataclass(frozen=True)
class Aes128Feistel:
    """PRP over [0, domain), keyed by a 16-byte sigma."""

    sigma: bytes
    domain: int

    TABLE_MAX_DOMAIN = 1 << 22

    def __post_init__(self):
        object.__setattr__(self, "sigma", _seed_bytes(self.sigma))
        if not 2 <= self.domain < 1 << 128:
            raise ValueError(f"domain must be in [2, 2^128), got "
                             f"{self.domain}")
        keys = []
        for r in range(4):
            kb = bytearray(self.sigma)
            kb[0] ^= r
            keys.append(bytes(kb))
        object.__setattr__(self, "keys", tuple(keys))
        object.__setattr__(self, "_prg", AesMmo(4, keys))
        # The kernel's PRG argument, a pointer to a host fss::PrgArg.
        object.__setattr__(self, "arg", _build.prg_arg(self._prg, 4)[0])
        object.__setattr__(self, "_tables", {})

    @property
    def half(self) -> int:
        """Bits of each Feistel half."""
        return (ceil_log2(self.domain) + 1) // 2

    @property
    def prg(self) -> AesMmo:
        """The four round keys as one AES-MMO object: the kernel's
        argument (``_build.prg_arg``), its schedules the round keys."""
        return self._prg

    @property
    def round_keys(self) -> np.ndarray:
        """[4, 11, 4] uint32 round-key words, one schedule a round."""
        return self.prg.round_keys

    # -- batched, on the tensor's device --------------------------------

    def permu(self, xs):
        """The PRP of int32 words [...] (hi = 0) or of a (hi, lo) pair of
        them, as the JAX package's ``permu``. Returns (hi, lo)."""
        if isinstance(xs, tuple):
            hi, lo = (blk.words(v) for v in xs)
        else:
            lo = blk.words(xs)
            hi = torch.zeros_like(lo)
        lanes = torch.zeros((*lo.shape, 4), dtype=torch.int32,
                            device=lo.device)
        lanes[..., 0], lanes[..., 1] = lo, hi
        y = self.permu_lanes(lanes)
        return y[..., 1], y[..., 0]

    def permu_lanes(self, x4) -> torch.Tensor:
        """The PRP of [..., 4] int32 lanes; returns [..., 4] lanes."""
        x4 = blk.words(x4)
        y = feistel_cuda.permute(self, x4.reshape(-1, 4).contiguous())
        return y.reshape(x4.shape)

    def permutation_table(self, device="cuda") -> torch.Tensor:
        """The whole permutation, [domain] int32 words (domain <= 2^22),
        computed once a device: the kernel over 0..domain-1 on the card,
        the plain version on the CPU."""
        if self.domain > self.TABLE_MAX_DOMAIN:
            raise ValueError("table too large")
        dev = torch.device(device)
        if dev not in self._tables:
            self._tables[dev] = feistel_cuda.table(self, dev)
        return self._tables[dev]

    # -- host oracle ----------------------------------------------------

    def permu_host(self, x: int) -> int:
        """The PRP of one Python int, on Python ints."""
        if not 0 <= x < self.domain:
            raise ValueError(f"x must be in [0, {self.domain}), got {x}")
        half = self.half
        mask = (1 << half) - 1
        val = x
        while True:
            left = (val >> half) & mask
            right = val & mask
            for kb in self.keys:
                out = aes128_encrypt_reference(kb, right.to_bytes(16,
                                                                  "little"))
                f = int.from_bytes(out, "little") & mask
                left, right = right, left ^ f
            val = (left << half) | right
            if val < self.domain:
                return val
