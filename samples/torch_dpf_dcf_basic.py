"""End-to-end DPF + DCF on the port (twin of samples/dpf_dcf_basic.py).

8-bit domain, AES-128-MMO PRG, fixed seeds: the DPF over the Bytes group,
the DCF over Uint(32). On a CUDA device Gen and Eval are the AES kernels
(``dpf_gen_aes``, ``dpf_eval_aes``, ``dcf_gen_aes``, ``dcf_eval_aes``), and
the sample fails unless each of them launched. Run from the repository's
root: ``PYTHONPATH=. python samples/torch_dpf_dcf_basic.py [--device cpu]``.
"""

import argparse
import json

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dcf, Dpf
from fss_tpu_torch.prg.aes import AesMmo

IN_BITS = 8
ALPHA = 42
KEY0 = bytes(range(1, 17))
KEY1 = bytes(range(16, 0, -1))
KEY2 = bytes([2] * 16)
KEY3 = bytes([3] * 16)

# Fixed party seeds (clamped bit zero), as in the reference sample.
SEEDS = [[0x11111111, 0x22222222, 0x33333333, 0x44444440],
         [0x55555555, 0x66666666, 0x77777777, 0x88888880]]
BETA = [7, 0, 0, 0]
DPF_KERNELS = ("dpf_gen_aes", "dpf_eval_aes")
DCF_KERNELS = ("dcf_gen_aes", "dcf_eval_aes")
KERNELS = DPF_KERNELS + DCF_KERNELS


def report_launches(dev, kernels) -> None:
    """On the card: print the kernels' launches, failing unless each ran."""
    if dev.type == "cuda":
        print("launches:", json.dumps(_build.launched(kernels)))


def dpf_sample(dev):
    seeds, beta = blk.block(SEEDS, dev), blk.block(BETA, dev)
    dpf = Dpf(IN_BITS, group=groups.Bytes(), prg=AesMmo(2, (KEY0, KEY1)),
              device=dev)
    cws = dpf.gen(seeds, ALPHA, beta)

    xs = torch.arange(2**IN_BITS, dtype=torch.int32, device=dev)
    y0 = dpf.eval(0, seeds[0], cws, xs)
    y1 = dpf.eval(1, seeds[1], cws, xs)
    rec = y0 ^ y1  # Bytes group reconstruction is XOR

    assert torch.equal(rec[ALPHA], beta)
    assert int(rec.any(dim=-1).sum()) == 1
    report_launches(dev, DPF_KERNELS)
    print(f"DPF: f({ALPHA}) = {rec[ALPHA].tolist()}; zero elsewhere. OK")


def dcf_sample(dev):
    g = groups.Uint(32)
    seeds = blk.block(SEEDS, dev)
    dcf = Dcf(IN_BITS, group=g, prg=AesMmo(4, (KEY0, KEY1, KEY2, KEY3)),
              pred="lt", device=dev)
    cws = dcf.gen(seeds, ALPHA, blk.block([604, 0, 0, 0], dev))

    xs = torch.arange(2**IN_BITS, dtype=torch.int32, device=dev)
    y0 = dcf.eval(0, seeds[0], cws, xs)
    y1 = dcf.eval(1, seeds[1], cws, xs)
    rec = g.add(g.from_block(y0), g.from_block(y1))

    assert bool((rec[:ALPHA, 0] == 604).all()), "x < alpha must give beta"
    assert bool((rec[ALPHA:] == 0).all()), "x >= alpha must give 0"
    report_launches(dev, DCF_KERNELS)
    print(f"DCF: f(x) = 604 for x < {ALPHA}, 0 otherwise. OK")


def main(device="cuda"):
    dev = torch.device(device)
    _build.reset_launches()
    dpf_sample(dev)
    dcf_sample(dev)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
