"""Tensor interop for the fss_crypto-parity API.

Counterpart of ``fss_tpu.crypto._tensors``. The reference exchanges int32
torch tensors (fss_crypto/dpf.py:43-109), and so does the port: a caller's
int32 tensor (torch, on the CPU or the card, or numpy) moves to the
scheme's device as the same bits, and a result goes back in the caller's
family and, for torch, on the caller's device (numpy in -> numpy out).

PRG key material parity: the reference uses a process-global random nonce
(fss_crypto/_csrc/binding_common.cuh:13-24), so keys generated in one
process only evaluate correctly in that process unless the nonce is pinned.
The same contract holds through ``process_nonce()`` /
``process_aes_keys()``, pinned by the JAX package's variables
FSS_TPU_NONCE="lo,hi" and FSS_TPU_AES_KEYS=<hex128 x mul, comma-separated>,
so that keys made by either package evaluate in the other.
"""

from __future__ import annotations

import os
import secrets

import torch

from fss_tpu_torch import block as blk

_NONCE = None
_AES_KEYS = {}


def process_nonce() -> tuple:
    global _NONCE
    if _NONCE is None:
        env = os.environ.get("FSS_TPU_NONCE")
        if env:
            lo, hi = (int(v, 0) & 0xFFFFFFFF for v in env.split(","))
            _NONCE = (lo, hi)
        else:
            _NONCE = (secrets.randbits(32), secrets.randbits(32))
    return _NONCE


def process_aes_keys(mul: int) -> tuple:
    if mul not in _AES_KEYS:
        env = os.environ.get("FSS_TPU_AES_KEYS")
        if env:
            keys = tuple(bytes.fromhex(k) for k in env.split(","))[:mul]
            if len(keys) != mul or any(len(k) != 16 for k in keys):
                raise ValueError(f"FSS_TPU_AES_KEYS must hold {mul} "
                                 f"16-byte hex keys")
        else:
            keys = tuple(secrets.token_bytes(16) for _ in range(mul))
        _AES_KEYS[mul] = keys
    return _AES_KEYS[mul]


def to_device(t, device: torch.device) -> torch.Tensor:
    """An int32 tensor (torch or numpy) -> int32 torch tensor on
    ``device``, the same bits."""
    return blk.words(t, device).contiguous()


def like(t: torch.Tensor, ref):
    """An int32 result -> the family of ``ref``: a torch tensor on ref's
    device, else a numpy int32 array."""
    if isinstance(ref, torch.Tensor):
        return t.to(ref.device)
    return t.cpu().numpy()
