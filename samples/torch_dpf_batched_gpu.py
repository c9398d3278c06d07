"""Batched DPF on the card (twin of samples/dpf_batched_tpu.py).

1024 independent keys generated and evaluated in one batch each: one
launch of the Gen kernel (``dpf_gen``) and one of the Eval kernel
(``dpf_eval``) a party, 16-bit domain, ChaCha (mul=2), Uint(32). On a
CUDA device the sample fails unless both kernels launched; on the CPU
(``--device cpu``) the same calls run their plain PyTorch versions. Run
from the repository's root:
``PYTHONPATH=. python samples/torch_dpf_batched_gpu.py [--device cpu]``.
"""

import argparse
import json

import numpy as np
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dpf
from fss_tpu_torch.prg.chacha import ChaCha

IN_BITS = 16
B = 1024
NONCE = (0x12345678, 0x9ABCDEF0)
KERNELS = ("dpf_gen", "dpf_eval")


def main(device="cuda"):
    dev = torch.device(device)
    _build.reset_launches()
    g = groups.Uint(32)
    dpf = Dpf(IN_BITS, group=g, prg=ChaCha(mul=2, nonce=NONCE), device=dev)
    rng = np.random.default_rng(1)

    s0s = blk.block(rng.integers(0, 2**32, size=(B, 2, 4)), dev)
    alphas = rng.integers(0, 2**IN_BITS, size=B, dtype=np.uint32)
    betas = blk.block(rng.integers(0, 2**32, size=(B, 4)), dev)
    cws = dpf.gen_batch(s0s, alphas, betas)

    y0 = dpf.eval(0, s0s[:, 0], cws, alphas)
    y1 = dpf.eval(1, s0s[:, 1], cws, alphas)

    rec = g.add(g.from_block(y0), g.from_block(y1))
    assert torch.equal(rec, g.from_block(blk.clear_lsb(betas)))
    path = "the CUDA kernel" if dev.type == "cuda" else "plain PyTorch"
    if dev.type == "cuda":
        print("launches:", json.dumps(_build.launched(KERNELS)))
    print(f"{B} instances evaluated at their alphas via {path}: all "
          f"reconstruct to beta. OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
