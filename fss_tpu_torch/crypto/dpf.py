"""fss_crypto-parity DPF wrapper (reference fss_crypto/dpf.py).

Counterpart of ``fss_tpu.crypto.dpf``: the same signatures, shapes, dtypes,
validation errors and key layout; the compute runs on the card (``device``,
"cuda" unless the caller asks for the CPU) through the port's ``api.Dpf``.
``gen`` and ``eval_all`` take CPU tensors, as the reference's do; ``eval``
also takes int32 tensors on the card and returns its share there, as the
reference's CUDA binding does, and additionally accepts an array of inputs
(the batched-first extension: the reference batches only in raw CUDA)."""

from __future__ import annotations

import numpy as np
import torch

from fss_tpu_torch import groups
from fss_tpu_torch.api import Dpf as _ApiDpf
from fss_tpu_torch.crypto import _tensors as tz
from fss_tpu_torch.crypto._validate import (
    validate_alpha,
    validate_beta,
    validate_cpu_only,
    validate_cws,
    validate_device_match,
    validate_domain_value,
    validate_group,
    validate_in_bits,
    validate_party,
    validate_prg,
    validate_s0,
    validate_s0s,
)
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha


def _make_prg(prg: str, mul: int):
    if prg == "chacha":
        return ChaCha(mul, tz.process_nonce())
    return AesMmo(mul, tz.process_aes_keys(mul))


def _make_group(group: str, in_bits: int):
    """String config -> group instance (reference _jit.py:76-87)."""
    if group == "bytes":
        return groups.Bytes()
    if in_bits <= 32:
        return groups.Uint(32)
    if in_bits <= 64:
        return groups.Uint(64)
    return groups.Uint(128, mod=1 << 127)


class _FrontDoor:
    """Gen, Eval and EvalAll of a tree scheme (``self._impl``, an
    ``api.Dpf`` or ``api.Dcf``) under the fss_crypto tensor contract."""

    def gen(self, s0s, alpha: int, beta):
        """Dealer step: (2, 4) seeds + alpha + (4,) beta ->
        (in_bits+1, 8) int32 correction words."""
        validate_s0s(s0s)
        validate_alpha(alpha, self.in_bits)
        validate_beta(beta)
        validate_cpu_only(s0s, beta, fn_name="gen")

        dev = self._impl.device
        cws = self._impl.gen(tz.to_device(s0s, dev), int(alpha),
                             tz.to_device(beta, dev))
        return tz.like(cws, s0s)

    def eval(self, party: int, s0, cws, x):
        """(4,) int32 share for a scalar x; (N, 4) for array inputs (the
        batched-first extension over the reference's scalar-only eval).
        Tensors on the card give the share on the card."""
        validate_party(party)
        validate_s0(s0)
        validate_cws(cws, self.in_bits)
        validate_device_match(s0, cws)
        if isinstance(x, (bool, int, np.integer)) or np.isscalar(x):
            validate_domain_value("x", x, self.in_bits)
            x = int(x)
        elif not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        dev = self._impl.device
        y = self._impl.eval(party, tz.to_device(s0, dev),
                            tz.to_device(cws, dev), x)
        return tz.like(y, s0)

    def eval_all(self, party: int, s0, cws):
        """(2^in_bits, 4) int32 shares over the whole domain."""
        validate_party(party)
        validate_s0(s0)
        validate_cws(cws, self.in_bits)
        validate_cpu_only(s0, cws, fn_name="eval_all")

        dev = self._impl.device
        ys = self._impl.eval_all(party, tz.to_device(s0, dev),
                                 tz.to_device(cws, dev))
        return tz.like(ys, s0)


class Dpf(_FrontDoor):
    """2-party DPF with the fss_crypto tensor contract.

    Config strings match the reference: ``in_bits`` in 1..128, ``group``
    in {"bytes", "uint"}, ``prg`` in {"chacha", "aes128_mmo"}. Tensors are
    int32 (torch or numpy) in the reference's shapes. ``device``: where
    the compute runs.
    """

    def __init__(self, in_bits: int, group: str = "bytes",
                 prg: str = "chacha", device="cuda"):
        validate_in_bits(in_bits)
        validate_group(group)
        validate_prg(prg, "dpf")

        self.in_bits = in_bits
        self.group = group
        self.prg = prg
        self._impl = _ApiDpf(in_bits, group=_make_group(group, in_bits),
                             prg=_make_prg(prg, 2), device=device)
