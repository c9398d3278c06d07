"""Same-process Gen -> Eval with PACKED keys (twin of
samples/dpf_packed_pipeline.py).

When one process generates keys and evaluates them (a dealer simulating
both parties, or offline preprocessing feeding an online phase on one
host), the wire rows [B, in_bits+1, 8] are overhead: ``layout="packed"``
keeps the kernels' cw planes (``PackedDpfKeys``) from the Gen kernel to
the Eval kernel, 5 of each level's 8 words. Keys that leave the process
need the wire layout, byte-exact with the reference's:
``PackedDpfKeys.to_wire()`` gives it. On a CUDA device the sample fails
unless ``dpf_gen`` and ``dpf_eval`` launched. Run from the repository's
root: ``PYTHONPATH=. python samples/torch_dpf_packed_pipeline.py
[--device cpu]``.
"""

import argparse
import json

import numpy as np
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dpf, PackedDpfKeys
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

    # One Gen launch, packed layout: no wire rows assembled.
    keys = dpf.gen_batch(s0s, alphas, betas, layout="packed")
    assert isinstance(keys, PackedDpfKeys)

    # eval() takes the packed keys wherever wire keys go.
    y0 = dpf.eval(0, s0s[:, 0], keys, alphas)
    y1 = dpf.eval(1, s0s[:, 1], keys, alphas)

    rec = g.add(g.from_block(y0), g.from_block(y1))
    assert torch.equal(rec, g.from_block(blk.clear_lsb(betas)))

    # Interop: the packed keys give the reference's wire bytes exactly.
    wire = keys.to_wire(IN_BITS)
    assert torch.equal(wire, dpf.gen_batch(s0s, alphas, betas))
    if dev.type == "cuda":
        print("launches:", json.dumps(_build.launched(KERNELS)))
    print(f"{B} instances through the packed gen->eval pipeline: "
          f"reconstruct OK; to_wire() matches the wire-format gen. OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
