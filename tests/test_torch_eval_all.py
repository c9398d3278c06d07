"""The port's DPF EvalAll against fss_tpu, byte-exact (tolerance 0:
integer crypto), on the CPU.

The JAX side runs ``fss_tpu.schemes.dpf.eval_all`` under ``jax.jit``,
which the JAX suite holds equal to its hybrid EvalAll; the 13-bit case
runs the hybrid EvalAll with its expansion kernel in interpret mode
instead (one kernel tile). Both parties share one jitted program
(``torch_jax.both_parties``), against which the port runs several plans.
The port's entry points take their plain versions on the CPU, which
follow the kernels' plan
(``eval_all_cuda.plan``: a top launch of k levels, then 2^k subtrees of
b = min(most, ceil(n / 2)) levels, k = n - b; the top's CTAs walk from
the root first); ``most`` moves the plan's boundary to small domains.
"""

import numpy as np
import pytest
import torch

from fss_tpu import groups as jgroups
from fss_tpu.ops import eval_all_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import dpf as jdpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import eval_all_cuda
from fss_tpu_torch.prg.chacha import ChaCha as TChaCha
from fss_tpu_torch.schemes import _tree
from fss_tpu_torch.schemes import dpf as tdpf
from torch_jax import both_parties
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0xABCD1234, 0x55AA55AA)
PRG2 = TChaCha(2, NONCE)
# One group of each kind the kernel's finalize takes (csrc/group.cuh).
GROUPS = {
    "bytes": (jgroups.Bytes(), tgroups.Bytes()),
    "uint32": (jgroups.Uint(32), tgroups.Uint(32)),
    "mod64": (jgroups.Uint(64, (1 << 61) - 1),
              tgroups.Uint(64, (1 << 61) - 1)),
    "mod128": (jgroups.Uint(128, 1 << 127), tgroups.Uint(128, 1 << 127)),
    "mod128np": (jgroups.Uint(128, (1 << 127) - 1),
                 tgroups.Uint(128, (1 << 127) - 1)),
}


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def _key(rng, in_bits, tg, alpha):
    """One key from the port's Gen (held equal to fss_tpu's elsewhere):
    (s0s [2, 4], cws [n+1, 8]) int32."""
    s0s = to_cpu(rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32))
    beta = to_cpu(rng.integers(0, 2**32, size=(1, 4), dtype=np.uint32))
    cws = tdpf.gen(PRG2, tg, in_bits, s0s[None],
                   tblk.pack_inputs([alpha], in_bits), beta)[0]
    return s0s, cws


def _plans(in_bits, mosts):
    """The distinct plans (b, k) ``mosts`` give a domain, with a most of
    each."""
    plans = {}
    for most in mosts:
        b = eval_all_cuda.subtree_levels(in_bits, most)
        plans.setdefault((b, in_bits - b), most)
    return plans


def _check_plans(tg, in_bits, s0s, cws, wants, mosts):
    """Both parties' eval_all under the default plan and under each of
    ``mosts`` (subtrees of at most ``most`` levels under a top of the
    rest) equal ``wants``; returns the default plan's shares."""
    plans = _plans(in_bits, (eval_all_cuda.SUBTREE_LEVELS, *mosts))
    assert len(plans) == 1 + len(mosts)
    shares = []
    for party, want in enumerate(wants):
        for most in plans.values():
            got = eval_all_cuda.eval_all(PRG2, tg, in_bits, party,
                                         s0s[party], cws, most)
            assert np.array_equal(tblk.to_numpy(got), want), (party, most)
        shares.append(eval_all_cuda.eval_all(PRG2, tg, in_bits, party,
                                             s0s[party], cws))
    return shares


@pytest.mark.parametrize("in_bits,gname,alpha", [
    (13, "uint32", 777),      # one JAX kernel tile
    (15, "bytes", 31000),     # several tiles
])
def test_eval_all_matches_jax_kernel(in_bits, gname, alpha, rng):
    jg, tg = GROUPS[gname]
    s0s, cws = _key(rng, in_bits, tg, alpha)
    if in_bits == 13:
        wants = both_parties(lambda p, s, c: eval_all_pallas.eval_all(
            JChaCha(2, NONCE), jg, in_bits, p, s, c, interpret=True),
            tblk.to_numpy(s0s), tblk.to_numpy(cws))
    else:
        wants = both_parties(lambda p, s, c: jdpf.eval_all(
            JChaCha(2, NONCE), jg, in_bits, p, s, c),
            tblk.to_numpy(s0s), tblk.to_numpy(cws))
    shares = _check_plans(tg, in_bits, s0s, cws, wants, (1,))
    rec = tblk.to_numpy(tg.add(tg.from_block(shares[0]),
                               tg.from_block(shares[1])))
    assert np.count_nonzero(rec.any(axis=1)) == 1 and rec[alpha].any()


@pytest.mark.parametrize("gname", ["mod64", "mod128", "mod128np"])
def test_plan_matches_jax_scheme(gname, rng):
    """The other group kinds, both parties, 3 bits on each side of the
    plan's boundary: subtrees of 1 and 2 levels under tops of 2 and 1
    (the first walking a level)."""
    in_bits, alpha = 3, 5
    jg, tg = GROUPS[gname]
    s0s, cws = _key(rng, in_bits, tg, alpha)
    wants = both_parties(lambda p, s, c: jdpf.eval_all(
        JChaCha(2, NONCE), jg, in_bits, p, s, c),
        tblk.to_numpy(s0s), tblk.to_numpy(cws))
    _check_plans(tg, in_bits, s0s, cws, wants, (1,))


@pytest.mark.parametrize("in_bits", [1, 2, 3, 4, 5, 7])
def test_level_split_matches_breadth_first(in_bits, rng):
    """Every plan of the domain (a top of k levels to 2^k subtree roots,
    then b = n - k levels a subtree; most = 1, 2, 3 and the default) gives
    the plain breadth-first EvalAll, and its leaf seeds and t bits."""
    tg = tgroups.Uint(128, 1 << 127)
    s0s, cws = _key(rng, in_bits, tg, int(rng.integers(0, 2**in_bits)))
    plans = _plans(in_bits, (1, 2, 3, eval_all_cuda.SUBTREE_LEVELS))
    assert (1, in_bits - 1) in plans  # the deepest top
    for party in (0, 1):
        want = tdpf.eval_all(PRG2, tg, in_bits, party, s0s[party], cws)
        s = tblk.clear_lsb(s0s[party])[None]
        t = torch.tensor([party], dtype=torch.int32)
        for row in cws[:in_bits]:
            s, t = _tree.expand_level(PRG2, s, t,
                                      *_tree.unpack_cw_row(row))
        for most in plans.values():
            got = eval_all_cuda.eval_all(PRG2, tg, in_bits, party,
                                         s0s[party], cws, most)
            assert torch.equal(got, want), (party, most)
            seeds, bits = eval_all_cuda.expand_leaves(
                PRG2, in_bits, party, s0s[party], cws[:in_bits], most)
            assert torch.equal(seeds, s) and torch.equal(bits, t)


def test_expand_leaves_layout(rng):
    """The seeds epilogue: clamped bits clear, t as its own plane, and the
    DPF's finalize of the two gives eval_all."""
    tg = tgroups.Uint(32)
    s0s, cws = _key(rng, 6, tg, 9)
    s, t = eval_all_cuda.expand_leaves(PRG2, 6, 1, s0s[1], cws)
    assert s.shape == (64, 4) and t.shape == (64,)
    assert not tblk.get_lsb(s).any() and set(t.tolist()) <= {0, 1}
    assert torch.equal(
        tdpf.finalize_leaves(tg, 1, s, t, cws[6, 0:4]),
        eval_all_cuda.eval_all(PRG2, tg, 6, 1, s0s[1], cws))


def test_plan_and_argument_checks(rng):
    sub = eval_all_cuda.subtree_levels
    assert [sub(n) for n in (1, 2, 3, 20, 23, 24, 25, 30)] == \
        [1, 1, 2, 10, 12, 12, 12, 12]
    assert [sub(n, 3) for n in (5, 6, 7)] == [3, 3, 3]
    plan = eval_all_cuda.plan  # [(first level, walk, subtree levels)]
    assert plan(1) == [(0, 0, 1)] and plan(2) == [(0, 0, 1), (1, 0, 1)]
    assert plan(20) == [(0, 5, 5), (10, 0, 10)]
    assert plan(24) == [(0, 6, 6), (12, 0, 12)]
    assert plan(30) == [(0, 9, 9), (18, 0, 12)]
    assert plan(9, 2) == [(0, 5, 2), (7, 0, 2)]
    tg = tgroups.Uint(32)
    s0s, cws = _key(rng, 3, tg, 5)
    bad = [
        dict(party=2),
        dict(in_bits=0),
        dict(most=0),
        dict(most=eval_all_cuda.SUBTREE_LEVELS + 1),
        dict(cws=cws[:3]),                       # no output row
        dict(cws=cws[:, :4].contiguous()),       # rows of 4 words
        dict(cws=cws.to(torch.int64)),
        dict(s0=s0s),                            # [2, 4], not one seed
    ]
    for change in bad:
        args = dict(prg2=PRG2, group=tg, in_bits=3, party=0, s0=s0s[0],
                    cws=cws)
        args.update(change)
        with pytest.raises((ValueError, TypeError)):
            eval_all_cuda.eval_all(**args)
    with pytest.raises(ValueError):  # the seeds epilogue needs n rows
        eval_all_cuda.expand_leaves(PRG2, 3, 0, s0s[0], cws[:2])
