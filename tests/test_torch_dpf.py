"""The port's DPF Gen and point Eval against fss_tpu, byte-exact.

Tolerance is 0 throughout (integer crypto). The JAX side is its scheme
code under ``jax.jit``, which the JAX suite holds equal to its Pallas
kernels (tests/test_dpf_pallas.py), except where a ``uint32`` case runs
those kernels in interpret mode instead: once each, at this file's
shape. The port runs on the CPU, where each kernel wrapper takes its
plain PyTorch version.
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.ops import dpf_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import dpf as jdpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import dpf_cuda
from fss_tpu_torch.prg.aes import AesMmo as TAesMmo
from fss_tpu_torch.prg.chacha import ChaCha as TChaCha
from fss_tpu_torch.schemes import dpf as tdpf
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0xABCD1234, 0x55AA55AA)
PRG2 = TChaCha(2, NONCE)
B = 300  # not a multiple of anything the kernels tile by

GROUPS = {
    "uint32": (jgroups.Uint(32), tgroups.Uint(32)),
    "bytes": (jgroups.Bytes(), tgroups.Bytes()),
    "uint127": (jgroups.Uint(128, 1 << 127), tgroups.Uint(128, 1 << 127)),
}


def _inputs(rng, in_bits, batch=B):
    s0s = rng.integers(0, 2**32, size=(batch, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**in_bits, size=batch, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(batch, 4), dtype=np.uint32)
    xs = alphas.copy()
    xs[1::2] = rng.integers(0, 2**in_bits, size=batch // 2, dtype=np.uint32)
    return s0s, alphas, betas, xs


def _np(t):
    return tblk.to_numpy(t)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def jax_gen(jg, in_bits, s0s, a_lanes, betas):
    """fss_tpu.schemes.dpf.gen over a batch of keys, jitted."""
    prg = JChaCha(2, NONCE)
    return np.asarray(jax.jit(jax.vmap(
        lambda s, a, b: jdpf.gen(prg, jg, in_bits, s, a, b)))(
            jblk.block(s0s), a_lanes, jblk.block(betas)))


def jax_eval(jg, in_bits, party, s0, cws, xs):
    """fss_tpu.schemes.dpf.eval_points, jitted."""
    return np.asarray(jax.jit(lambda s, c, x: jdpf.eval_points(
        JChaCha(2, NONCE), jg, in_bits, party, s, c, x))(
            jblk.block(s0), cws, xs))


# The group whose cases run the JAX kernels in interpret mode.
INTERPRET = "uint32"


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("gname", list(GROUPS))
def test_eval_matches_jax(gname, party, rng):
    in_bits = 8
    jg, tg = GROUPS[gname]
    s0s, alphas, betas, xs = _inputs(rng, in_bits)
    if gname == INTERPRET and party == 0:
        cws = np.asarray(dpf_pallas.gen_batch(
            NONCE, jg, in_bits, jblk.block(s0s), alphas, jblk.block(betas),
            block_rows=8, interpret=True))
        want = np.asarray(dpf_pallas.eval_points(
            NONCE, jg, in_bits, party, jblk.block(s0s[:, party]), cws, xs,
            block_rows=8, interpret=True))
    else:
        cws = jax_gen(jg, in_bits, s0s, jblk.pack_inputs(alphas, in_bits),
                      betas)
        want = jax_eval(jg, in_bits, party, s0s[:, party], cws, xs)

    s0, kc, kx = (to_cpu(s0s[:, party]), to_cpu(cws),
                  to_cpu(xs))
    got_ops = dpf_cuda.eval_points(PRG2, tg, in_bits, party, s0, kc, kx)
    got_plain = tdpf.eval_points(TChaCha(2, NONCE), tg, in_bits, party, s0,
                                 kc, tblk.pack_inputs(kx, in_bits))
    assert np.array_equal(_np(got_ops), want)
    assert np.array_equal(_np(got_plain), want)


@pytest.mark.parametrize("gname", list(GROUPS))
def test_gen_matches_jax(gname, rng):
    in_bits = 8
    jg, tg = GROUPS[gname]
    s0s, alphas, betas, _ = _inputs(rng, in_bits)
    if gname == INTERPRET:
        want = np.asarray(dpf_pallas.gen_batch(
            NONCE, jg, in_bits, jblk.block(s0s), alphas, jblk.block(betas),
            block_rows=8, interpret=True))
    else:
        want = jax_gen(jg, in_bits, s0s, jblk.pack_inputs(alphas, in_bits),
                       betas)
    ts0s, ta, tb = (to_cpu(s0s), to_cpu(alphas),
                    to_cpu(betas))
    cws, s0f, s1f, t0, t1 = dpf_cuda.gen_packed(ts0s, ta, in_bits, PRG2)
    assert np.array_equal(_np(cws[:, in_bits]), np.zeros((B, 8), np.uint32))
    cws[:, in_bits, :4] = dpf_cuda.output_cw(tg, s0f, s1f, t1,
                                             to_cpu(betas))
    assert np.array_equal(_np(cws), want)
    assert np.array_equal(
        _np(dpf_cuda.gen_batch(PRG2, tg, in_bits, ts0s, ta, tb)), want)
    plain = tdpf.gen(TChaCha(2, NONCE), tg, in_bits, ts0s,
                     tblk.pack_inputs(ta, in_bits), tb)
    assert np.array_equal(_np(plain), want)
    # The leaves: party 1's t is party 0's t ^ 1 everywhere on the path.
    assert np.array_equal(_np(t0 ^ t1), np.ones(B, np.uint32))


# One group of each kind the Gen kernel's output CW takes (csrc/group.cuh).
OCW_GROUPS = {
    "bytes": tgroups.Bytes(), "uint32": tgroups.Uint(32),
    "uint64": tgroups.Uint(64),
    "uint128_pow2": tgroups.Uint(128, 1 << 127),
    "uint128": tgroups.Uint(128, (1 << 127) - 1)}


@pytest.mark.parametrize("prg", ["chacha", "aes"])
@pytest.mark.parametrize("gname", list(OCW_GROUPS))
def test_gen_output_cw_in_the_gen(gname, prg, rng):
    """Gen given betas and the group (the kernel's fused output CW) equals
    Gen without them plus output_cw, in both layouts."""
    in_bits, batch = 5, 37
    g = OCW_GROUPS[gname]
    prg2 = PRG2 if prg == "chacha" else TAesMmo(
        2, [bytes(range(16)), bytes(range(16, 32))])
    s0s, alphas, betas, _ = (to_cpu(a) for a in _inputs(rng, in_bits, batch))
    cws, s0f, s1f, t0, t1 = dpf_cuda.gen_packed_plain(s0s, alphas, in_bits,
                                                      prg2)
    ocw = dpf_cuda.output_cw(g, s0f, s1f, t1, betas)
    want = cws.clone()
    want[:, in_bits, :4] = ocw
    got = dpf_cuda.gen_packed(s0s, alphas, in_bits, prg2, betas=betas,
                              group=g)
    assert torch.equal(got[0], want)
    for a, b in zip(got[1:], (s0f, s1f, t0, t1)):
        assert torch.equal(a, b)
    (planes, got_ocw), *_ = dpf_cuda.gen_packed_plain(
        s0s, alphas, in_bits, prg2, "packed", betas=betas, group=g)
    assert torch.equal(planes, dpf_cuda.pack_keys(cws, in_bits)[0])
    assert torch.equal(got_ocw, ocw)
    (bare, zero), *_ = dpf_cuda.gen_packed(s0s, alphas, in_bits, prg2,
                                           "packed")
    assert torch.equal(bare, planes) and not zero.any()


def test_packed_keys_from_jax_match_wire_path(rng):
    """The JAX kernel's packed layout (in interpret mode, at the shape of
    the cases above, so the process compiles it once) crosses to the
    port's PackedDpfKeys."""
    in_bits = 8
    jg, tg = GROUPS["uint32"]
    s0s, alphas, betas, xs = _inputs(rng, in_bits)
    wire = jax_gen(jg, in_bits, s0s, jblk.pack_inputs(alphas, in_bits),
                   betas)
    cws_t, ocw, _ = dpf_pallas.gen_batch_packed(
        NONCE, jg, in_bits, jax.numpy.asarray(jblk.block(s0s)), alphas,
        jax.numpy.asarray(jblk.block(betas)), block_rows=8, interpret=True)
    keys = interop.packed_keys_from_jax(cws_t, ocw, device="cpu")
    assert np.array_equal(_np(keys.to_wire(in_bits)), wire)

    # The port's own packed Gen gives the same planes.
    cws_p, ocw_p = dpf_cuda.gen_batch_packed(
        PRG2, tg, in_bits, to_cpu(s0s), to_cpu(alphas),
        to_cpu(betas))
    assert torch.equal(cws_p, keys.cws_p) and torch.equal(ocw_p, keys.ocw)

    tw = to_cpu(wire)
    for party in (0, 1):
        s0, tx = to_cpu(s0s[:, party]), to_cpu(xs)
        via_wire = dpf_cuda.eval_points(PRG2, tg, in_bits, party, s0, tw, tx)
        via_packed = dpf_cuda.eval_points_packedkey(
            PRG2, tg, in_bits, party, s0, keys.cws_p, keys.ocw, tx)
        assert torch.equal(via_packed, via_wire)
        want = jax_eval(jg, in_bits, party, s0s[:, party], wire, xs)
        assert np.array_equal(_np(via_wire), want)


def test_wide_domain_matches_jax(rng):
    in_bits = 48
    batch = 20
    jg, tg = GROUPS["bytes"]
    s0s = rng.integers(0, 2**32, size=(batch, 2, 4), dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(batch, 4), dtype=np.uint32)
    alphas = [int(v) for v in rng.integers(0, 2**48, size=batch)]
    xs = [a if i % 2 == 0 else a ^ (1 << (i % 48))
          for i, a in enumerate(alphas)]
    want = jax_gen(jg, in_bits, s0s, jblk.pack_inputs(alphas, in_bits),
                   betas)
    ts0s, ta = to_cpu(s0s), tblk.pack_inputs(alphas, in_bits)
    cws = dpf_cuda.gen_batch(PRG2, tg, in_bits, ts0s, ta,
                             to_cpu(betas))
    assert np.array_equal(_np(cws), want)

    x_lanes = tblk.pack_inputs(xs, in_bits)
    shares = []
    for party in (0, 1):
        ref = jax_eval(jg, in_bits, party, s0s[:, party], want,
                       jblk.pack_inputs(xs, in_bits))
        got = dpf_cuda.eval_points(PRG2, tg, in_bits, party,
                                   ts0s[:, party].contiguous(), cws, x_lanes)
        assert np.array_equal(_np(got), ref)
        shares.append(got)
    rec = _np(shares[0] ^ shares[1])
    beta = _np(tblk.clear_lsb(to_cpu(betas)))
    assert np.array_equal(rec[0::2], beta[0::2])
    assert not rec[1::2].any()


def test_broadcast_key_matches_per_key_rows(rng):
    in_bits = 10
    tg = tgroups.Uint(64, (1 << 61) - 1)
    s0s, alphas, betas, _ = _inputs(rng, in_bits, batch=1)
    cws = dpf_cuda.gen_batch(PRG2, tg, in_bits, to_cpu(s0s),
                             to_cpu(alphas),
                             to_cpu(betas))[0]
    xs = to_cpu(np.arange(2**in_bits, dtype=np.uint32))
    for party in (0, 1):
        s0 = to_cpu(s0s[0, party])
        one = dpf_cuda.eval_points(PRG2, tg, in_bits, party, s0, cws, xs)
        rows = cws.expand(xs.shape[0], -1, -1).contiguous()
        seeds = s0.expand(xs.shape[0], 4).contiguous()
        many = dpf_cuda.eval_points(PRG2, tg, in_bits, party, seeds, rows,
                                    xs)
        assert torch.equal(one, many)


def test_kernel_wrappers_validate_inputs():
    s0 = torch.zeros((4, 4), dtype=torch.int32)
    xs = torch.zeros((4,), dtype=torch.int32)
    cws = torch.zeros((4, 9, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        dpf_cuda.eval_packed(s0.long(), cws, xs, 8, 0, PRG2)
    with pytest.raises(ValueError):
        dpf_cuda.eval_packed(s0, cws[:, :8], xs, 8, 0, PRG2)
    with pytest.raises(ValueError):
        dpf_cuda.eval_packed(s0, cws.transpose(0, 1).contiguous()
                             .transpose(0, 1), xs, 8, 0, PRG2)
    with pytest.raises(ValueError):  # wide domains need x as 4 lanes
        dpf_cuda.eval_packed(s0, torch.zeros((4, 41, 8), dtype=torch.int32),
                             xs, 40, 0, PRG2)
    with pytest.raises(ValueError):
        dpf_cuda.gen_packed(torch.zeros((4, 2, 4), dtype=torch.int32), xs,
                            8, PRG2, layout="rows")
    with pytest.raises(ValueError):  # the output CW needs betas and group
        dpf_cuda.gen_packed(torch.zeros((4, 2, 4), dtype=torch.int32), xs,
                            8, PRG2, betas=s0)
    with pytest.raises(ValueError):  # the control bit starts as the party
        dpf_cuda.eval_packed(s0, cws, xs, 8, 2, PRG2)
    with pytest.raises(ValueError):
        dpf_cuda.eval_packed(s0, cws, xs, 8, 0, TChaCha(2, NONCE, 7))
