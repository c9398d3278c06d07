"""The port's DCF EvalAll against fss_tpu, byte-exact (tolerance 0:
integer crypto), on the CPU.

The JAX side runs ``fss_tpu.schemes.dcf.eval_all`` under ``jax.jit``,
which the JAX suite holds equal to its expansion kernel
(tests/test_tree_kernels_pallas.py); the ``uint32`` case runs that kernel
in interpret mode instead (13 bits, the kernel's floor there). The
port runs every level through its expansion wrapper, which on the CPU
takes the plain PyTorch version.
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.ops import eval_all_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import dcf as jdcf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import dcf_cuda, eval_all_cuda
from fss_tpu_torch.prg.chacha import ChaCha as TChaCha
from fss_tpu_torch.schemes import dcf as tdcf
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG4 = TChaCha(4, NONCE)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def _key(rng, in_bits, jg, alpha):
    """One key from fss_tpu's Gen: (s0s [2, 4], cws [n+1, 8]) as uint32."""
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=(4,), dtype=np.uint32)
    cws = np.asarray(jdcf.gen(JChaCha(4, NONCE), jg, in_bits, "lt",
                              jblk.block(s0s),
                              jblk.pack_inputs(alpha, in_bits),
                              jblk.block(beta)))
    return s0s, cws


def jax_eval_all(jg, in_bits, s0s, cws):
    """fss_tpu.schemes.dcf.eval_all of both parties, jitted."""
    return [np.asarray(y) for y in jax.jit(lambda s, c: [
        jdcf.eval_all(JChaCha(4, NONCE), jg, in_bits, p, s[p], c)
        for p in (0, 1)])(jblk.block(s0s), cws)]


def _check_lt(tg, shares, alpha):
    """y0 + y1 is the same nonzero value below alpha, and zero from it."""
    rec = tblk.to_numpy(tg.add(tg.from_block(shares[0]),
                               tg.from_block(shares[1])))
    assert (rec[:alpha] == rec[0]).all() and rec[0].any()
    assert not rec[alpha:].any()


@pytest.mark.parametrize("gname", ["uint32", "bytes"])
def test_eval_all_matches_jax_kernel(gname, rng):
    in_bits, alpha = 13, 5000
    jg, tg = {"uint32": (jgroups.Uint(32), tgroups.Uint(32)),
              "bytes": (jgroups.Bytes(), tgroups.Bytes())}[gname]
    s0s, cws = _key(rng, in_bits, jg, alpha)
    if gname == "uint32":
        wants = [np.asarray(eval_all_pallas.dcf_eval_all(
            JChaCha(4, NONCE), jg, in_bits, p, jblk.block(s0s[p]), cws,
            interpret=True)) for p in (0, 1)]
    else:
        wants = jax_eval_all(jg, in_bits, s0s, cws)
    shares = []
    for party, want in enumerate(wants):
        got = eval_all_cuda.dcf_eval_all(TChaCha(4, NONCE), tg, in_bits,
                                         party, to_cpu(s0s[party]),
                                         to_cpu(cws))
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"
        shares.append(got)
    _check_lt(tg, shares, alpha)


def test_eval_all_mod128np_matches_jax_scheme(rng):
    """Uint(128, 2^127 - 1): the 5-word accumulator, which the TPU
    kernel did not take, against the JAX scheme's breadth-first EvalAll."""
    in_bits, alpha = 10, 700
    spec = (128, (1 << 127) - 1)
    jg, tg = jgroups.Uint(*spec), tgroups.Uint(*spec)
    s0s, cws = _key(rng, in_bits, jg, alpha)
    shares = []
    for party, want in enumerate(jax_eval_all(jg, in_bits, s0s, cws)):
        got = eval_all_cuda.dcf_eval_all(TChaCha(4, NONCE), tg, in_bits,
                                         party, to_cpu(s0s[party]),
                                         to_cpu(cws))
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"
        shares.append(got)
    _check_lt(tg, shares, alpha)


@pytest.mark.parametrize("in_bits,spec", [
    (1, (64, (1 << 61) - 1)),   # mod64
    (2, None),                  # xor
    (3, (128, 1 << 127)),       # mod128
    (4, (16, 1000)),            # mod64, narrow
    (5, (32, 1 << 16)),         # wrap, power-of-two mod
    (7, (128, (1 << 126) + 12345)),  # mod128np
])
def test_level_split_matches_breadth_first(in_bits, spec, rng):
    """Every split of the levels into launches (remainder first, then
    strides of 3), in every accumulator mode, gives the plain scheme's
    breadth-first EvalAll and its point Eval."""
    tg = tgroups.Bytes() if spec is None else tgroups.Uint(*spec)
    prg = TChaCha(4, NONCE)
    s0s = to_cpu(rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32))
    alpha = int(rng.integers(0, 2**in_bits))
    cws = tdcf.gen(prg, tg, in_bits, "gt", s0s[None],
                   tblk.pack_inputs([alpha], in_bits),
                   to_cpu(rng.integers(0, 2**32, size=(1, 4),
                                       dtype=np.uint32)))[0]
    xs = torch.arange(1 << in_bits, dtype=torch.int32)
    for party in (0, 1):
        want = tdcf.eval_all(prg, tg, in_bits, party, s0s[party], cws)
        got = eval_all_cuda.dcf_eval_all(prg, tg, in_bits, party, s0s[party],
                                         cws)
        assert torch.equal(got, want)
        points = dcf_cuda.eval_points(PRG4, tg, in_bits, party, s0s[party],
                                      cws, xs)
        assert torch.equal(points, want)


def test_dcf_expand_packed_layouts(rng):
    roots = to_cpu(rng.integers(0, 2**32, size=(5, 4), dtype=np.uint32))
    acc = to_cpu(rng.integers(0, 2**32, size=(5, 5), dtype=np.uint32))
    cw_rows = to_cpu(rng.integers(0, 2**32, size=(3, 8), dtype=np.uint32))
    args = (PRG4, "mod128np", (0xFFFFFFFF,) * 3 + (0xFFFFFFFE,))
    packed, acc3 = eval_all_cuda.dcf_expand_packed(roots, acc, cw_rows,
                                                   *args)
    s, t, acc_f = eval_all_cuda.dcf_expand_packed(roots, acc, cw_rows, *args,
                                                  final=True)
    assert packed.shape == (40, 4) and t.shape == (40,)
    assert acc3.shape == (40, 5) and torch.equal(acc3, acc_f)
    assert torch.equal(tblk.clear_lsb(packed), s)
    assert torch.equal(tblk.get_lsb(packed), t)
    # Two launches of 1 and 2 levels equal one of 3.
    step = eval_all_cuda.dcf_expand_packed(roots, acc, cw_rows[:1], *args)
    assert all(torch.equal(a, b) for a, b in zip(
        eval_all_cuda.dcf_expand_packed(*step, cw_rows[1:], *args),
        (packed, acc3)))
    with pytest.raises(ValueError):  # mod128np takes a 5-word accumulator
        eval_all_cuda.dcf_expand_packed(roots, acc[:, :4].contiguous(),
                                        cw_rows, *args)
    with pytest.raises(ValueError):  # DCF rows have 8 words
        eval_all_cuda.dcf_expand_packed(roots, acc, cw_rows[:, :5], *args)
