"""fss_crypto-parity API: drop-in for the reference's Python package.

Counterpart of ``fss_tpu.crypto``, which mirrors the reference's
fss_crypto/__init__.py (exports Dpf, Dcf): the same call signatures, tensor
shapes and dtypes (int32), string configs, validation error messages and
key layouts, computed on the card by the port's CUDA kernels (the
reference's own binding is PyTorch + CUDA). Tensors may be torch or numpy;
the return type matches the input family.
"""

from fss_tpu_torch.crypto.dcf import Dcf
from fss_tpu_torch.crypto.dpf import Dpf

__all__ = ["Dpf", "Dcf"]
