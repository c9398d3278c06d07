"""The port's host engine (``fss_tpu_torch.native``) against the CUDA
kernels on the same inputs, byte for byte (tolerance 0: integer crypto):
``chip_smoke.host_vs_card``, the checks of its phase 8 (c), at small
sizes: DPF, DCF and Half-Tree Gen, Eval and EvalAll with ChaCha and
AES-128-MMO, a VDPF's Gen, eval_batch and proof with BLAKE3, and the PRP
against its permutation table on the card; and a CUDA tensor given to the
engine raises.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it from the repository's root as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_native.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fss_tpu_torch import _build, native

pytestmark = pytest.mark.gpu

# chip_smoke's sizes, cut: Gen and Eval of 2^8 keys, EvalAll at 12 bits,
# the VDPF at 1024 points.
SIZES = {"NATIVE_LOG2_KEYS": 8, "NATIVE_EVAL_ALL_BITS": 12,
         "NATIVE_VDPF_POINTS": 1024}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def eng(cuda):
    """The process's engine, built after the card is found."""
    return native.engine()


def test_host_vs_card(cuda, eng, monkeypatch):
    for name, value in SIZES.items():
        monkeypatch.setattr(chip_smoke, name, value)
    _build.reset_launches()
    checks = chip_smoke.host_vs_card(eng, cuda, np.random.default_rng(5))
    assert all(checks.values()), [k for k, v in checks.items() if not v]
    _build.launched([f"{s}_{k}{tag}" for s in ("dpf", "dcf", "ht")
                     for k in ("gen", "eval", "eval_all")
                     for tag in ("", "_aes")]
                    + ["vdpf_eval", "feistel_permute"])


def test_cuda_tensor_raises(cuda, eng):
    with pytest.raises(ValueError, match="seed is on cuda"):
        eng.prg(native.PRG_CHACHA, 2, torch.zeros(4, dtype=torch.int32,
                                                  device=cuda),
                nonce=chip_smoke.NONCE)
