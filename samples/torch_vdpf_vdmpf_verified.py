"""Verifiable FSS end to end on the port: VDPF single-point and VDMPF
multi-point (twin of samples/vdpf_vdmpf_verified.py).

The malicious-security workflow of the reference's vdpf.cuh and
vdmpf.cuh: dealer Gen with its retry contract, each party's evaluation
returning proof material beside its shares, the proof fold,
cross-party verification, and a tampered evaluation caught. 10-bit
domain, ChaCha PRG, BLAKE3 hashes. On a CUDA device: the fused VDPF eval
kernel (``vdpf_eval``), the Gen kernel (``dpf_gen``), the BLAKE3 kernels
(``blake3_xor_hash`` for cs, ``blake3_chain`` for the VDPF's proof,
``blake3_hash64`` for the VDMPF's tree fold) and the VDMPF's routing
(``feistel_route``); the sample fails unless each launched. Run from the
repository's root:
``PYTHONPATH=. python samples/torch_vdpf_vdmpf_verified.py
[--device cpu]``.
"""

import argparse
import json

import numpy as np
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Vdmpf, Vdpf

IN_BITS = 10
N = 1 << IN_BITS
VDPF_KERNELS = ("dpf_gen", "blake3_xor_hash", "vdpf_eval", "blake3_chain")
VDMPF_KERNELS = ("dpf_gen", "blake3_xor_hash", "feistel_route",
                 "vdpf_eval", "blake3_hash64")
KERNELS = tuple(dict.fromkeys(VDPF_KERNELS + VDMPF_KERNELS))


def report_launches(dev, kernels, since=None) -> None:
    """On the card: print the kernels' launches since ``since`` (a copy of
    ``_build.launches``; None: since the last reset), failing unless each
    ran."""
    if dev.type == "cuda":
        print("launches:", json.dumps(_build.launched(kernels, since=since)))


def vdpf_sample(rng, dev):
    g = groups.Uint(32)
    vdpf = Vdpf(IN_BITS, group=g, device=dev)
    alpha, beta = 345, blk.block([604, 0, 0, 0], dev)

    # Dealer: Gen can fail (vdpf.cuh:97); draw new seeds until it does
    # not. Both keys ship (cws, cs, ocw); s0 stays with its party.
    s0s, cws, cs, ocw = vdpf.gen_retry(rng, alpha, beta)

    # Parties: eval returns (share, pi~) a point; the proof folds every
    # queried point into one 64-byte pi (vdpf.cuh:256-262).
    xs = rng.integers(0, N, size=64, dtype=np.uint32)
    xs[7] = alpha  # make sure the special point is queried
    y0, pt0 = vdpf.eval(0, s0s[0], cws, cs, ocw, xs)
    y1, pt1 = vdpf.eval(1, s0s[1], cws, cs, ocw, xs)
    pi0 = vdpf.prove(pt0, cs)
    pi1 = vdpf.prove(pt1, cs)

    # Verifier: equal proofs == every queried point evaluated honestly.
    assert Vdpf.verify(pi0, pi1), "honest proofs must match"
    rec = blk.to_numpy(g.add(y0, y1))
    exp = np.where(xs == alpha, 604, 0)
    assert np.array_equal(rec[:, 0], exp)
    print(f"VDPF: 64 points evaluated, f({alpha}) = 604, proofs match. OK")

    # A tampered evaluation (one bit of one pi~ flipped) must not verify.
    pt0_bad = pt0.clone()
    pt0_bad[3, 0, 0] ^= 1
    assert not Vdpf.verify(vdpf.prove(pt0_bad, cs), pi1)
    report_launches(dev, VDPF_KERNELS)
    print("VDPF: tampered evaluation rejected by Verify. OK")


def vdmpf_sample(rng, dev):
    before = dict(_build.launches)  # the VDPF part's launches are not ours
    g = groups.Uint(32)
    vm = Vdmpf(IN_BITS, max_points=30, group=g, device=dev)

    # t = 30 distinct special points, each with its payload.
    alphas = rng.choice(N, size=30, replace=False).astype(np.uint64)
    betas = np.stack([np.arange(1, 31, dtype=np.uint32),
                      np.zeros(30, np.uint32), np.zeros(30, np.uint32),
                      np.zeros(30, np.uint32)], axis=1)
    k0, k1 = vm.gen_retry(rng, alphas, betas)

    xs = rng.integers(0, N, size=256, dtype=np.uint64)
    xs[:30] = alphas  # query every special point once
    y0, pi0 = vm.batch_eval(0, k0, xs)
    y1, pi1 = vm.batch_eval(1, k1, xs)

    assert Vdmpf.verify(pi0, pi1), "honest proofs must match"
    rec = blk.to_numpy(g.add(y0, y1))
    lut = {int(a): int(b) for a, b in zip(alphas, betas[:, 0])}
    exp = np.array([lut.get(int(x), 0) for x in xs], dtype=np.uint32)
    assert np.array_equal(rec[:, 0], exp)
    report_launches(dev, VDMPF_KERNELS, since=before)
    print("VDMPF: 30-point function, 256 queries reconstruct, "
          "proofs match. OK")


def main(device="cuda"):
    dev = torch.device(device)
    _build.reset_launches()
    rng = np.random.default_rng(2026)
    vdpf_sample(rng, dev)
    vdmpf_sample(rng, dev)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
