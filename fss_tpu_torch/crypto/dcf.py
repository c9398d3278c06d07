"""fss_crypto-parity DCF wrapper (reference fss_crypto/dcf.py).

Counterpart of ``fss_tpu.crypto.dcf``: the same surface as
``crypto.dpf.Dpf`` plus the ``pred`` config ("lt"/"gt"), through the
port's ``api.Dcf``."""

from __future__ import annotations

from fss_tpu_torch.api import Dcf as _ApiDcf
from fss_tpu_torch.crypto._validate import (
    validate_group,
    validate_in_bits,
    validate_pred,
    validate_prg,
)
from fss_tpu_torch.crypto.dpf import _FrontDoor, _make_group, _make_prg


class Dcf(_FrontDoor):
    """2-party Distributed Comparison Function.

    Args:
        in_bits: Input domain bit size (1..128).
        group: Output group type, "bytes" or "uint".
        prg: PRG type, "chacha" or "aes128_mmo".
        pred: Comparison predicate, "lt" (y = beta iff x < alpha) or "gt".
        device: Where the compute runs ("cuda" unless asked otherwise).
    """

    def __init__(self, in_bits: int, group: str = "bytes",
                 prg: str = "chacha", pred: str = "lt", device="cuda"):
        validate_in_bits(in_bits)
        validate_group(group)
        validate_prg(prg, "dcf")
        validate_pred(pred)

        self.in_bits = in_bits
        self.group = group
        self.prg = prg
        self.pred = pred
        self._impl = _ApiDcf(in_bits, group=_make_group(group, in_bits),
                             prg=_make_prg(prg, 4), pred=pred, device=device)
