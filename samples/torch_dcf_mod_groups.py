"""DCF over modular output groups on the port, 128-bit non-power-of-two
moduli included (twin of samples/dcf_mod_groups.py).

Secret-shared interval counting is the classic use: with beta = 1 in
Z_m, sum_x Eval(x) over a query set counts how many x satisfy x < alpha,
and shares stay in [0, m). Each group runs the DCF kernels (``dcf_gen``,
``dcf_eval``) in its accumulator mode: mod64 for Z_(1e9+7) and
Z_(2^61-1), mod128 for Z_(2^127), mod128np (a 160-bit accumulator) for
Z_(2^127-1). On a CUDA device the sample fails unless both launched for
each group. Run from the repository's root:
``PYTHONPATH=. python samples/torch_dcf_mod_groups.py [--device cpu]``.
"""

import argparse
import json

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dcf
from fss_tpu_torch.prg.chacha import ChaCha

IN_BITS = 10
ALPHA = 600
SEEDS = [[0x11111111, 0x22222222, 0x33333333, 0x44444440],
         [0x55555555, 0x66666666, 0x77777777, 0x88888880]]
KERNELS = ("dcf_gen", "dcf_eval")

GROUPS = [
    ("Z_(1e9+7)  (prime field, mod64 kernel mode)",
     groups.Uint(32, mod=10**9 + 7), [1, 0, 0, 0]),
    ("Z_(2^61-1) (Mersenne, 64-bit lanes)",
     groups.Uint(64, mod=(1 << 61) - 1), [123456789, 7, 0, 0]),
    ("Z_(2^127)  (pow2 mod128 kernel mode)",
     groups.Uint(128, mod=1 << 127), [1, 2, 3, 4]),
    ("Z_(2^127-1) (NON-pow2 128-bit, mod128np 160-bit accumulator)",
     groups.Uint(128, mod=(1 << 127) - 1), [5, 6, 7, 8]),
]


def main(device="cuda"):
    dev = torch.device(device)
    seeds = blk.block(SEEDS, dev)
    xs = [0, 1, ALPHA - 1, ALPHA, ALPHA + 1, 2**IN_BITS - 1]
    _build.reset_launches()
    for label, g, beta_lanes in GROUPS:
        before = dict(_build.launches)
        beta = blk.block(beta_lanes, dev)
        dcf = Dcf(IN_BITS, group=g, prg=ChaCha(mul=4, nonce=(9, 9)),
                  pred="lt", device=dev)
        cws = dcf.gen(seeds, ALPHA, beta)
        y0 = dcf.eval(0, seeds[0], cws, xs)
        y1 = dcf.eval(1, seeds[1], cws, xs)
        rec = g.add(g.from_block(y0), g.from_block(y1))
        want = g.from_block(blk.clear_lsb(beta))
        for i, x in enumerate(xs):
            exp = want if x < ALPHA else torch.zeros_like(want)
            assert torch.equal(rec[i], exp), (label, x)
        if dev.type == "cuda":
            print("launches:",
                  json.dumps(_build.launched(KERNELS, since=before)))
        print(f"DCF over {label}: beta below alpha, zero above. OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
