"""Keyed hashes of the verifiable schemes: BLAKE3 and SHA-256."""

from fss_tpu_torch.hash.blake3 import Blake3
from fss_tpu_torch.hash.sha256 import Sha256

__all__ = ["Blake3", "Sha256"]
