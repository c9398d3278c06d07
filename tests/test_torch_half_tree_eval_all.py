"""The port's Half-Tree EvalAll against fss_tpu, byte-exact (tolerance 0:
integer crypto), on the CPU.

The JAX side is ``fss_tpu.schemes.half_tree_dpf.eval_all`` under
``jax.jit``, which the JAX suite holds equal to its Pallas kernel
(tests/test_tree_kernels_pallas.py); the port runs every level through
its expansion wrapper, which on the CPU takes the plain PyTorch version,
in every split of the levels into launches.
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import half_tree_dpf as jht
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import eval_all_cuda, ht_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import half_tree_dpf as tht
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG1 = ChaCha(1, NONCE)

GROUPS = {
    "bytes": None,
    "uint32": (32, 0),
    "uint64": (64, 0),
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


def _check_point(tg, ys, betas, hit):
    """y0 + y1 is beta (clamped bit clear) where ``hit``, else 0."""
    rec = tg.add(tg.from_block(ys[0]), tg.from_block(ys[1]))
    beta = tg.from_block(tblk.clear_lsb(betas))
    assert torch.equal(rec, torch.where(hit[:, None], beta,
                                        torch.zeros_like(beta)))


def _key(rng, tg, in_bits):
    """Seeds, a CCR hash key and one key from the port's Gen."""
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    alpha = int(rng.integers(0, 2**in_bits))
    cws, ocw = ht_cuda.gen_batch(
        PRG1, tg, in_bits, hk, to_cpu(s0s[None]),
        tblk.pack_inputs([alpha], in_bits, "cpu"),
        to_cpu(rng.integers(0, 2**32, size=(1, 4), dtype=np.uint32)))
    return hk, s0s, cws[0], ocw[0]


@pytest.mark.parametrize("gname,in_bits", [
    ("uint64", 1), ("uint127m", 2), ("uint127", 4), ("bytes", 7),
    ("uint32", 10)])
def test_eval_all_matches_xla(gname, in_bits, rng):
    jg, tg = groups_pair(gname)
    prg = JChaCha(1, NONCE)
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    jhk = jax.numpy.asarray(hk)
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=(4,), dtype=np.uint32)
    alpha = int(rng.integers(0, 2**in_bits))
    jcws, jocw = (np.asarray(a) for a in jht.gen(
        prg, jg, in_bits, jhk, jblk.block(s0s),
        jblk.pack_inputs(alpha, in_bits), jblk.block(beta)))
    want = jax.jit(lambda s, c, o: [
        jht.eval_all(prg, jg, in_bits, p, jhk, s[p], c, o)
        for p in (0, 1)])(jblk.block(s0s), jcws, jocw)
    cws, ocw = to_cpu(jcws), to_cpu(jocw)
    shares = []
    for party in (0, 1):
        s0 = to_cpu(s0s[party])
        got = eval_all_cuda.ht_eval_all(ChaCha(1, NONCE), tg, in_bits, party,
                                        hk, s0, cws, ocw)
        assert np.array_equal(tblk.to_numpy(got), np.asarray(want[party]))
        assert torch.equal(got, tht.eval_all(
            ChaCha(1, NONCE), tg, in_bits, party,
            ht_cuda.hash_block(hk, "cpu"), s0, cws, ocw))
        shares.append(got)
    _check_point(tg, shares, to_cpu(beta)[None].expand(2**in_bits, 4),
                 torch.arange(2**in_bits) == alpha)


@pytest.mark.parametrize("in_bits", [1, 2, 3, 4, 5, 6, 7])
def test_level_split_matches_breadth_first(in_bits, rng):
    """Every split of the levels into launches (remainder first, then
    strides of 3, the conversion last) gives the plain scheme's
    breadth-first EvalAll and its point Eval over the whole domain."""
    tg = tgroups.Uint(128, (1 << 127) - 1)
    prg = ChaCha(1, NONCE)
    hk, s0s, cws, ocw = _key(rng, tg, in_bits)
    xs = torch.arange(1 << in_bits, dtype=torch.int32)
    for party in (0, 1):
        s0 = to_cpu(s0s[party])
        want = tht.eval_all(prg, tg, in_bits, party,
                            ht_cuda.hash_block(hk, "cpu"), s0, cws, ocw)
        got = eval_all_cuda.ht_eval_all(prg, tg, in_bits, party, hk, s0,
                                        cws, ocw)
        assert torch.equal(got, want)
        points = ht_cuda.eval_points(PRG1, tg, in_bits, party, hk, s0,
                                     cws, ocw, xs)
        assert torch.equal(points, want)


def test_ht_expand_packed_layouts(rng):
    roots = to_cpu(rng.integers(0, 2**32, size=(5, 4), dtype=np.uint32))
    rows = to_cpu(rng.integers(0, 2**32, size=(3, 8), dtype=np.uint32))
    hk = (1, 2, 3, 4)
    nodes = eval_all_cuda.ht_expand_packed(roots, rows, PRG1, hk)
    high, low = eval_all_cuda.ht_expand_packed(roots, rows, PRG1, hk,
                                               final=True)
    assert nodes.shape == (40, 4) and high.shape == (40, 4)
    assert low.shape == (40,) and not tblk.get_lsb(high).any()
    # A final launch is its doubling levels, then the conversion alone.
    parents = eval_all_cuda.ht_expand_packed(roots, rows[:2], PRG1, hk)
    conv = eval_all_cuda.ht_expand_packed(parents, rows[2:], PRG1, hk,
                                          final=True)
    assert torch.equal(conv[0], high) and torch.equal(conv[1], low)
    # Two launches of 1 and 2 levels equal one of 3.
    step = eval_all_cuda.ht_expand_packed(roots, rows[:1], PRG1, hk)
    assert torch.equal(eval_all_cuda.ht_expand_packed(step, rows[1:], PRG1,
                                                      hk), nodes)
    with pytest.raises(ValueError):
        eval_all_cuda.ht_expand_packed(roots, torch.zeros(
            (4, 8), dtype=torch.int32), PRG1, hk)
    with pytest.raises(ValueError):
        eval_all_cuda.ht_expand_leaves(ChaCha(1, NONCE), 3, 2, hk, roots[0],
                                       rows)
