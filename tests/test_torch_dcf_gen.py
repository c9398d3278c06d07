"""The port's DCF Gen against fss_tpu, byte-exact (tolerance 0: integer
crypto), on the CPU.

The JAX side runs ``dcf_pallas.gen_batch`` with its kernel in interpret
mode for the groups that kernel takes (Bytes, Uint with mod 0), and
``fss_tpu.schemes.dcf.gen`` for the others. The port runs
``dcf_cuda.gen_batch``, whose wrapper takes the plain PyTorch version for
CPU tensors.
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.ops import dcf_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import dcf as jdcf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import dcf_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG4 = ChaCha(4, NONCE)

GROUPS = {
    "bytes": None,
    "uint32": (32, 0),
    "uint64": (64, 0),
    "uint32_mod1e9+7": (32, 10**9 + 7),
    "uint127": (128, 1 << 127),
    "uint127m": (128, (1 << 127) - 1),
}


def groups_pair(gname):
    spec = GROUPS[gname]
    if spec is None:
        return jgroups.Bytes(), tgroups.Bytes()
    return jgroups.Uint(*spec), tgroups.Uint(*spec)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def jax_gen(jg, in_bits, pred, s0s, a_lanes, betas):
    """fss_tpu.schemes.dcf.gen over a batch of keys."""
    prg = JChaCha(4, NONCE)
    return np.asarray(jax.jit(jax.vmap(
        lambda s, a, b: jdcf.gen(prg, jg, in_bits, pred, s, a, b)))(
            jblk.block(s0s), a_lanes, jblk.block(betas)))


@pytest.mark.parametrize("pred", ["lt", "gt"])
@pytest.mark.parametrize("gname", list(GROUPS))
def test_gen_matches_jax(gname, pred, rng):
    in_bits, B = 8, 64
    jg, tg = groups_pair(gname)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    if dcf_pallas.gen_kernel_supports_group(jg):
        want = np.asarray(dcf_pallas.gen_batch(
            NONCE, jg, in_bits, pred, jblk.block(s0s), alphas,
            jblk.block(betas), block_rows=1, interpret=True))
    else:
        want = jax_gen(jg, in_bits, pred, s0s,
                       jblk.pack_inputs(alphas, in_bits), betas)
    got = dcf_cuda.gen_batch(PRG4, tg, in_bits, pred, to_cpu(s0s),
                             to_cpu(alphas), to_cpu(betas))
    assert got.shape == (B, in_bits + 1, 8)
    assert np.array_equal(tblk.to_numpy(got), want)


def test_gen_wide_domain_matches_jax(rng):
    """in_bits 48: alpha as 4 lanes, the bit of level i read from lane
    pos >> 5 (the TPU kernel took 32-bit alphas only)."""
    in_bits, B = 48, 16
    jg, tg = groups_pair("uint64")
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = [int(v) % (1 << in_bits) for v in rng.integers(0, 2**63,
                                                            size=B)]
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    a_lanes = tblk.pack_inputs(alphas, in_bits, "cpu")
    want = jax_gen(jg, in_bits, "gt", s0s, tblk.to_numpy(a_lanes), betas)
    got = dcf_cuda.gen_batch(PRG4, tg, in_bits, "gt", to_cpu(s0s), a_lanes,
                             to_cpu(betas))
    assert np.array_equal(tblk.to_numpy(got), want)


def test_gen_gt_reconstructs(rng):
    """pred="gt": y0 + y1 = beta where x > alpha, else 0."""
    in_bits, B = 6, 128
    tg = tgroups.Uint(32, 10**9 + 7)
    s0s = to_cpu(rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32))
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = to_cpu(rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32))
    cws = dcf_cuda.gen_batch(PRG4, tg, in_bits, "gt", s0s, to_cpu(alphas),
                             betas)
    xs = (alphas.astype(np.int64) + rng.integers(-3, 4, size=B)) % 64
    ys = [dcf_cuda.eval_points(PRG4, tg, in_bits, p, s0s[:, p].contiguous(),
                               cws, to_cpu(xs.astype(np.uint32)))
          for p in (0, 1)]
    rec = tg.add(tg.from_block(ys[0]), tg.from_block(ys[1]))
    beta = tg.from_block(tblk.clear_lsb(betas))
    above = torch.from_numpy(xs > alphas)
    assert torch.equal(rec, torch.where(above[:, None], beta,
                                        torch.zeros_like(beta)))


def test_gen_checks_inputs():
    s0s = torch.zeros((3, 2, 4), dtype=torch.int32)
    betas = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        dcf_cuda.gen_packed(s0s, torch.zeros(3, dtype=torch.int32), betas, 8,
                            PRG4, "le", tgroups.Bytes())
    with pytest.raises(ValueError):  # in_bits > 32 needs alpha as lanes
        dcf_cuda.gen_packed(s0s, torch.zeros(3, dtype=torch.int32), betas,
                            40, PRG4, "lt", tgroups.Bytes())
    with pytest.raises(ValueError):
        dcf_cuda.gen_packed(s0s, torch.zeros(3, dtype=torch.int32),
                            betas[:2], 8, PRG4, "lt", tgroups.Bytes())
