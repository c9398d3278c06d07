"""The port's DPF EvalAll against fss_tpu, byte-exact.

The JAX side runs ``fss_tpu.schemes.dpf.eval_all`` under ``jax.jit``,
which the JAX suite holds equal to its hybrid EvalAll; the 13-bit case
runs the hybrid EvalAll with its expansion kernel in interpret mode
instead (one kernel tile). The port runs every level through its
expansion wrapper, which on the CPU takes the plain PyTorch version.
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.ops import eval_all_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import dpf as jdpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import eval_all_cuda
from fss_tpu_torch.prg.chacha import ChaCha as TChaCha
from fss_tpu_torch.schemes import dpf as tdpf
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0xABCD1234, 0x55AA55AA)
PRG2 = TChaCha(2, NONCE)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def _key(rng, in_bits, jg, alpha):
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=(4,), dtype=np.uint32)
    cws = np.asarray(jdpf.gen(JChaCha(2, NONCE), jg, in_bits,
                              jblk.block(s0s), jblk.pack_inputs(alpha,
                                                                in_bits),
                              jblk.block(beta)))
    return s0s, cws


@pytest.mark.parametrize("in_bits,gname,alpha", [
    (13, "uint32", 777),      # one JAX kernel tile
    (15, "bytes", 31000),     # several tiles
])
def test_eval_all_matches_jax_kernel(in_bits, gname, alpha, rng):
    jg, tg = {"uint32": (jgroups.Uint(32), tgroups.Uint(32)),
              "bytes": (jgroups.Bytes(), tgroups.Bytes())}[gname]
    s0s, cws = _key(rng, in_bits, jg, alpha)
    if in_bits == 13:
        wants = [eval_all_pallas.eval_all(
            JChaCha(2, NONCE), jg, in_bits, p, jblk.block(s0s[p]), cws,
            interpret=True) for p in (0, 1)]
    else:
        wants = jax.jit(lambda s, c: [
            jdpf.eval_all(JChaCha(2, NONCE), jg, in_bits, p, s[p], c)
            for p in (0, 1)])(jblk.block(s0s), cws)
    shares = []
    for party, want in enumerate(np.asarray(w) for w in wants):
        got = eval_all_cuda.eval_all(TChaCha(2, NONCE), tg, in_bits, party,
                                     to_cpu(s0s[party]),
                                     to_cpu(cws))
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"
        shares.append(got)
    rec = tblk.to_numpy(tg.add(tg.from_block(shares[0]),
                               tg.from_block(shares[1])))
    assert np.count_nonzero(rec.any(axis=1)) == 1 and rec[alpha].any()


@pytest.mark.parametrize("in_bits", [1, 2, 3, 4, 5, 7])
def test_level_split_matches_breadth_first(in_bits, rng):
    """Every split of the levels into kernel launches (remainder first,
    then strides of 3) gives the plain breadth-first expansion."""
    tg = tgroups.Uint(128, 1 << 127)
    prg = TChaCha(2, NONCE)
    s0s = to_cpu(rng.integers(0, 2**32, size=(2, 4),
                                        dtype=np.uint32))
    alpha = int(rng.integers(0, 2**in_bits))
    cws = tdpf.gen(prg, tg, in_bits, s0s[None],
                   tblk.pack_inputs([alpha], in_bits),
                   to_cpu(rng.integers(0, 2**32, size=(1, 4),
                                                 dtype=np.uint32)))[0]
    for party in (0, 1):
        want = tdpf.eval_all(prg, tg, in_bits, party, s0s[party], cws)
        got = eval_all_cuda.eval_all(prg, tg, in_bits, party, s0s[party],
                                     cws)
        assert torch.equal(got, want)


def test_expand_packed_layouts(rng):
    roots = to_cpu(rng.integers(0, 2**32, size=(5, 4),
                                          dtype=np.uint32))
    cw_rows = to_cpu(rng.integers(0, 2**32, size=(3, 8),
                                            dtype=np.uint32))
    packed = eval_all_cuda.expand_packed(roots, cw_rows, PRG2)
    s, t = eval_all_cuda.expand_packed(roots, cw_rows, PRG2, final=True)
    assert packed.shape == (40, 4) and t.shape == (40,)
    assert torch.equal(tblk.clear_lsb(packed), s)
    assert torch.equal(tblk.get_lsb(packed), t)
    # Two launches of 1 and 2 levels equal one of 3.
    step = eval_all_cuda.expand_packed(roots, cw_rows[:1], PRG2)
    assert torch.equal(eval_all_cuda.expand_packed(step, cw_rows[1:], PRG2),
                       packed)
    with pytest.raises(ValueError):
        eval_all_cuda.expand_packed(roots, torch.zeros((4, 8),
                                                       dtype=torch.int32),
                                    PRG2)
    with pytest.raises(ValueError):
        eval_all_cuda.expand_leaves(TChaCha(2, NONCE), 3, 2, roots[0],
                                    cw_rows)
