"""The port's DCF EvalAll against fss_tpu, byte-exact (tolerance 0:
integer crypto), on the CPU.

The JAX side runs ``fss_tpu.schemes.dcf.eval_all`` under ``jax.jit``,
which the JAX suite holds equal to its expansion kernel
(tests/test_tree_kernels_pallas.py); the ``uint32`` case runs that kernel
in interpret mode instead (13 bits, the kernel's floor there). Both
parties share one jitted program (``torch_jax.both_parties``), against
which the port runs several plans. The port's
entry point takes its plain version on the CPU, which follows the
kernels' plan (``eval_all_cuda.plan``: a top launch of k levels, then 2^k
subtrees of b = min(most, ceil(n / 2)) levels with their raw accumulators,
then the finalize; the top's CTAs walk from the root first); ``most``
moves the plan's boundary to small domains.
"""

import numpy as np
import pytest
import torch

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
from torch_jax import both_parties
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG4 = TChaCha(4, NONCE)
# One group of each accumulator mode (ops/dcf_cuda.py:MODES).
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


def _key(rng, in_bits, tg, alpha, pred="lt"):
    """One key from the port's Gen (held equal to fss_tpu's elsewhere):
    (s0s [2, 4], cws [n+1, 8]) int32."""
    s0s = to_cpu(rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32))
    beta = to_cpu(rng.integers(0, 2**32, size=(1, 4), dtype=np.uint32))
    cws = tdcf.gen(PRG4, tg, in_bits, pred, s0s[None],
                   tblk.pack_inputs([alpha], in_bits), beta)[0]
    return s0s, cws


def jax_eval_all(jg, in_bits, s0s, cws):
    """fss_tpu.schemes.dcf.eval_all of both parties, jitted."""
    return both_parties(lambda p, s, c: jdcf.eval_all(
        JChaCha(4, NONCE), jg, in_bits, p, s, c),
        tblk.to_numpy(s0s), tblk.to_numpy(cws))


def _plans(in_bits, mosts):
    """The distinct plans (b, k) ``mosts`` give a domain, with a most of
    each."""
    plans = {}
    for most in mosts:
        b = eval_all_cuda.subtree_levels(in_bits, most)
        plans.setdefault((b, in_bits - b), most)
    return plans


def _check_plans(tg, in_bits, s0s, cws, wants, mosts):
    """Both parties' dcf_eval_all under the default plan and under each of
    ``mosts`` (subtrees of at most ``most`` levels under a top of the
    rest) equal ``wants``; returns the default plan's shares."""
    plans = _plans(in_bits, (eval_all_cuda.SUBTREE_LEVELS, *mosts))
    assert len(plans) == 1 + len(mosts)
    shares = []
    for party, want in enumerate(wants):
        for most in plans.values():
            got = eval_all_cuda.dcf_eval_all(PRG4, tg, in_bits, party,
                                             s0s[party], cws, most)
            assert np.array_equal(tblk.to_numpy(got), want), (party, most)
        shares.append(eval_all_cuda.dcf_eval_all(PRG4, tg, in_bits, party,
                                                 s0s[party], cws))
    return shares


def _check_lt(tg, shares, alpha):
    """y0 + y1 is the same nonzero value below alpha, and zero from it."""
    rec = tblk.to_numpy(tg.add(tg.from_block(shares[0]),
                               tg.from_block(shares[1])))
    assert (rec[:alpha] == rec[0]).all() and rec[0].any()
    assert not rec[alpha:].any()


@pytest.mark.parametrize("gname", ["uint32", "bytes"])
def test_eval_all_matches_jax_kernel(gname, rng):
    in_bits, alpha = 13, 5000
    jg, tg = GROUPS[gname]
    s0s, cws = _key(rng, in_bits, tg, alpha)
    if gname == "uint32":
        wants = both_parties(lambda p, s, c: eval_all_pallas.dcf_eval_all(
            JChaCha(4, NONCE), jg, in_bits, p, s, c, interpret=True),
            tblk.to_numpy(s0s), tblk.to_numpy(cws))
    else:
        wants = jax_eval_all(jg, in_bits, s0s, cws)
    _check_lt(tg, _check_plans(tg, in_bits, s0s, cws, wants, (1,)), alpha)


def test_eval_all_mod128np_matches_jax_scheme(rng):
    """Uint(128, 2^127 - 1): the 5-word accumulator, which the TPU
    kernel did not take, against the JAX scheme at every point of the
    domain (its point Eval, one traced level for all 10; the JAX suite
    holds it equal to its EvalAll, and test_plan_matches_jax_scheme holds
    this group's EvalAll against the JAX one at 3 bits)."""
    in_bits, alpha = 10, 700
    jg, tg = GROUPS["mod128np"]
    s0s, cws = _key(rng, in_bits, tg, alpha)
    xs = np.arange(1 << in_bits, dtype=np.uint32)
    wants = both_parties(lambda p, s, c: jdcf.eval_points(
        JChaCha(4, NONCE), jg, in_bits, "lt", p, s, c, xs),
        tblk.to_numpy(s0s), tblk.to_numpy(cws))
    _check_lt(tg, _check_plans(tg, in_bits, s0s, cws, wants, (1,)), alpha)


@pytest.mark.parametrize("gname", ["mod64", "mod128", "mod128np"])
def test_plan_matches_jax_scheme(gname, rng):
    """The other group kinds, both parties, 3 bits on each side of the
    plan's boundary: subtrees of 1 and 2 levels under tops of 2 and 1
    (the first walking a level)."""
    in_bits, alpha = 3, 5
    jg, tg = GROUPS[gname]
    s0s, cws = _key(rng, in_bits, tg, alpha)
    wants = jax_eval_all(jg, in_bits, s0s, cws)
    _check_lt(tg, _check_plans(tg, in_bits, s0s, cws, wants, (1,)), alpha)


@pytest.mark.parametrize("in_bits,spec", [
    (1, (64, (1 << 61) - 1)),   # mod64
    (2, None),                  # xor
    (3, (128, 1 << 127)),       # mod128
    (4, (16, 1000)),            # mod64, narrow
    (5, (32, 1 << 16)),         # wrap, power-of-two mod
    (7, (128, (1 << 126) + 12345)),  # mod128np
])
def test_level_split_matches_breadth_first(in_bits, spec, rng):
    """Every plan of the domain (a top of k levels to 2^k subtree roots,
    then b = n - k levels a subtree; most = 1, 2, 3 and the default), in
    every accumulator mode, gives the plain scheme's breadth-first EvalAll
    and its point Eval."""
    tg = tgroups.Bytes() if spec is None else tgroups.Uint(*spec)
    s0s, cws = _key(rng, in_bits, tg, int(rng.integers(0, 2**in_bits)),
                    "gt")
    plans = _plans(in_bits, (1, 2, 3, eval_all_cuda.SUBTREE_LEVELS))
    assert (1, in_bits - 1) in plans  # the deepest top
    xs = torch.arange(1 << in_bits, dtype=torch.int32)
    for party in (0, 1):
        want = tdcf.eval_all(PRG4, tg, in_bits, party, s0s[party], cws)
        for most in plans.values():
            got = eval_all_cuda.dcf_eval_all(PRG4, tg, in_bits, party,
                                             s0s[party], cws, most)
            assert torch.equal(got, want), (party, most)
        points = dcf_cuda.eval_points(PRG4, tg, in_bits, party, s0s[party],
                                      cws, xs)
        assert torch.equal(points, want)


def test_plan_and_argument_checks(rng):
    tg = tgroups.Uint(32)
    s0s, cws = _key(rng, 3, tg, 5)
    bad = [
        dict(party=2),
        dict(in_bits=0),
        dict(most=0),
        dict(most=eval_all_cuda.SUBTREE_LEVELS + 1),
        dict(cws=cws[:3]),                       # no final value CW row
        dict(cws=cws[:, :5].contiguous()),       # DCF rows have 8 words
        dict(cws=cws.to(torch.int64)),
        dict(s0=s0s),                            # [2, 4], not one seed
        dict(prg4=TChaCha(2, NONCE)),            # the DCF's PRG is mul=4
    ]
    for change in bad:
        args = dict(prg4=PRG4, group=tg, in_bits=3, party=0, s0=s0s[0],
                    cws=cws)
        args.update(change)
        with pytest.raises((ValueError, TypeError)):
            eval_all_cuda.dcf_eval_all(**args)
