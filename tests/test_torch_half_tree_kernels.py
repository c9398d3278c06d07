"""The port's Half-Tree kernel wrappers on the CPU against the JAX
package's Pallas kernels in interpret mode, once each at the smallest
shape the JAX suite runs them (tests/test_tree_kernels_pallas.py), and
the wrappers' input checks.

Tolerance 0 throughout (integer crypto). On the CPU each wrapper takes its
plain PyTorch version.
"""

import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.ops import eval_all_pallas, ht_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import eval_all_cuda, ht_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import half_tree_dpf
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG1 = ChaCha(1, NONCE)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def _key(rng, tg, in_bits, batch, alphas=None):
    """Seeds, a CCR hash key and a batch of keys from the port's Gen."""
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s0s = rng.integers(0, 2**32, size=(batch, 2, 4), dtype=np.uint32)
    if alphas is None:
        alphas = rng.integers(0, 2**in_bits, size=batch, dtype=np.uint32)
    cws, ocw = ht_cuda.gen_batch(
        PRG1, tg, in_bits, hk, to_cpu(s0s), tblk.pack_inputs(
            alphas, in_bits, "cpu"),
        to_cpu(rng.integers(0, 2**32, size=(batch, 4), dtype=np.uint32)))
    return hk, s0s, alphas, cws, ocw


def test_eval_matches_jax_kernel(rng):
    """B-7: ht_pallas.eval_packed, in_bits 8, both parties."""
    in_bits, B = 8, 200
    jg, tg = jgroups.Uint(32), tgroups.Uint(32)
    hk, s0s, _, cws, ocw = _key(rng, tg, in_bits, B)
    xs = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    for party in (0, 1):
        want = np.asarray(ht_pallas.eval_points(
            NONCE, jg, in_bits, party, hk, s0s[:, party],
            tblk.to_numpy(cws), tblk.to_numpy(ocw), xs, block_rows=8,
            interpret=True))
        got = ht_cuda.eval_points(PRG1, tg, in_bits, party, hk,
                                  to_cpu(s0s[:, party]), cws, ocw,
                                  to_cpu(xs))
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"


def test_gen_matches_jax_kernel(rng):
    """B-8: ht_pallas.gen_packed, in_bits 2 (the TPU kernel's floor)."""
    in_bits, B = 2, 128
    jg, tg = jgroups.Uint(64), tgroups.Uint(64)
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    want = ht_pallas.gen_batch(NONCE, jg, in_bits, hk, jblk.block(s0s),
                               alphas, jblk.block(betas), block_rows=1,
                               interpret=True)
    got = ht_cuda.gen_batch(PRG1, tg, in_bits, hk, to_cpu(s0s),
                            to_cpu(alphas), to_cpu(betas))
    for a, b in zip(got, want):
        assert np.array_equal(tblk.to_numpy(a), np.asarray(b))


def test_eval_all_matches_jax_kernel(rng):
    """B-9: eval_all_pallas.ht_eval_all at 13 bits (one kernel tile)."""
    in_bits = 13
    jg, tg = jgroups.Uint(32), tgroups.Uint(32)
    hk, s0s, _, cws, ocw = _key(rng, tg, in_bits, 1, alphas=[4321])
    shares = []
    for party in (0, 1):
        want = np.asarray(eval_all_pallas.ht_eval_all(
            JChaCha(1, NONCE), jg, in_bits, party, hk,
            jblk.block(s0s[0, party]), tblk.to_numpy(cws[0]),
            tblk.to_numpy(ocw[0]), interpret=True))
        got = eval_all_cuda.ht_eval_all(ChaCha(1, NONCE), tg, in_bits, party,
                                        hk, to_cpu(s0s[0, party]), cws[0],
                                        ocw[0])
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"
        shares.append(got)
    rec = tblk.to_numpy(tg.add(tg.from_block(shares[0]),
                               tg.from_block(shares[1])))
    assert np.count_nonzero(rec.any(axis=1)) == 1 and rec[4321].any()


def test_kernel_wrappers_validate_inputs():
    s0 = torch.zeros((4, 4), dtype=torch.int32)
    xs = torch.zeros((4,), dtype=torch.int32)
    cws = torch.zeros((4, 8, 8), dtype=torch.int32)
    hk = (0, 0, 0, 0)
    with pytest.raises(TypeError):
        ht_cuda.eval_packed(s0.long(), cws, xs, 8, 0, PRG1, hk)
    with pytest.raises(ValueError):  # Half-Tree keys have in_bits rows
        ht_cuda.eval_packed(s0, torch.zeros((4, 9, 8), dtype=torch.int32),
                            xs, 8, 0, PRG1, hk)
    with pytest.raises(ValueError):  # wide domains need x as 4 lanes
        ht_cuda.eval_packed(s0, torch.zeros((4, 40, 8), dtype=torch.int32),
                            xs, 40, 0, PRG1, hk)
    with pytest.raises(ValueError):
        ht_cuda.eval_packed(s0, cws, xs, 8, 2, PRG1, hk)
    with pytest.raises(ValueError):
        ht_cuda.eval_packed(s0, cws, xs, 8, 0, ChaCha(1, NONCE, 7), hk)
    with pytest.raises(ValueError):
        ht_cuda.eval_packed(s0, cws, xs, 8, 0, PRG1, (1, 2, 3))
    with pytest.raises(ValueError):
        ht_cuda.gen_packed(torch.zeros((4, 2, 4), dtype=torch.int32), xs,
                           0, PRG1, hk)
    with pytest.raises(ValueError):  # alphas of 33..128 bits are lanes
        ht_cuda.gen_packed(torch.zeros((4, 2, 4), dtype=torch.int32), xs,
                           40, PRG1, hk)


@pytest.mark.parametrize("kind", ["xor", "wrap", "mod64", "mod128",
                                  "mod128np"])
def test_gen_output_cw_of_its_leaves(kind, rng):
    """gen_packed_plain with betas and the group: the output CW of its own
    leaves (the Gen kernel's fused output CW is held to this on the
    card)."""
    g = {"xor": tgroups.Bytes(), "wrap": tgroups.Uint(32),
         "mod64": tgroups.Uint(64, (1 << 61) - 1),
         "mod128": tgroups.Uint(128, 1 << 127),
         "mod128np": tgroups.Uint(128, (1 << 127) - 1)}[kind]
    in_bits, B = 5, 16
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s0s = to_cpu(rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32))
    alphas = to_cpu(rng.integers(0, 2**in_bits, size=B, dtype=np.uint32))
    betas = to_cpu(rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32))
    cws, leaf0, leaf1 = ht_cuda.gen_packed_plain(s0s, alphas, in_bits, PRG1,
                                                 hk)
    got = ht_cuda.gen_packed_plain(s0s, alphas, in_bits, PRG1, hk,
                                   betas=betas, group=g)
    assert torch.equal(got[0], cws)
    assert torch.equal(got[1], half_tree_dpf.output_cw(g, leaf0, leaf1,
                                                       betas))
    assert all(torch.equal(a, b) for a, b in zip(
        ht_cuda.gen_packed(s0s, alphas, in_bits, PRG1, hk, betas=betas,
                           group=g), got))
    with pytest.raises(ValueError):  # both or neither
        ht_cuda.gen_packed(s0s, alphas, in_bits, PRG1, hk, betas=betas)
