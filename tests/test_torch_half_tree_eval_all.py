"""The port's Half-Tree EvalAll against fss_tpu, byte-exact (tolerance 0:
integer crypto), on the CPU.

The JAX side is ``fss_tpu.schemes.half_tree_dpf.eval_all`` under
``jax.jit``, which the JAX suite holds equal to its Pallas kernel
(tests/test_tree_kernels_pallas.py). The port's entry point takes its
plain version on the CPU, which follows the kernel's plan
(``eval_all_cuda.plan``: a top launch of k levels, then 2^k subtrees of
b = min(most, ceil(n / 2)) levels, k = n - b, the last of them the
conversion; the top's CTAs walk from the root first); ``most`` moves the
plan's boundary to small domains.
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
from torch_jax import both_parties
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
# One group of each kind the kernel's finalize takes (csrc/group.cuh).
GROUP_KINDS = {
    "xor": None,
    "wrap": (32, 0),
    "mod64": (64, (1 << 61) - 1),
    "mod128": (128, 1 << 127),
    "mod128np": (128, (1 << 127) - 1),
}


def groups_pair(spec):
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
    jg, tg = groups_pair(GROUPS[gname])
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


@pytest.mark.parametrize("kind", list(GROUP_KINDS))
def test_group_kinds_match_xla(kind, rng):
    """Each group kind of the kernel's finalize, both parties, 5 bits on
    both sides of the plan's boundary (subtrees of 2 levels under a top of
    3, whose CTA walks one level; and the default, 3 under 2)."""
    in_bits = 5
    jg, tg = groups_pair(GROUP_KINDS[kind])
    hk, s0s, cws, ocw = _key(rng, tg, in_bits)
    jhk = jax.numpy.asarray(hk)
    jocw = jax.numpy.asarray(tblk.to_numpy(ocw))
    wants = both_parties(lambda p, s, c: jht.eval_all(
        JChaCha(1, NONCE), jg, in_bits, p, jhk, s, c, jocw),
        s0s, tblk.to_numpy(cws))
    assert eval_all_cuda.plan(in_bits, 2) == [(0, 1, 2), (3, 0, 2)]
    for party in (0, 1):
        for most in (2, eval_all_cuda.SUBTREE_LEVELS):
            got = eval_all_cuda.ht_eval_all(PRG1, tg, in_bits, party, hk,
                                            to_cpu(s0s[party]), cws, ocw,
                                            most)
            assert np.array_equal(tblk.to_numpy(got), wants[party]), \
                (party, most)


@pytest.mark.parametrize("in_bits", [1, 2, 3, 4, 5, 6, 7])
def test_level_split_matches_breadth_first(in_bits, rng):
    """Every plan of the domain (most = 1..4: a top of k levels to 2^k
    subtree roots, then b = n - k levels a subtree, the conversion last)
    gives the plain scheme's breadth-first EvalAll and its point Eval over
    the whole domain."""
    tg = tgroups.Uint(128, (1 << 127) - 1)
    hk, s0s, cws, ocw = _key(rng, tg, in_bits)
    xs = torch.arange(1 << in_bits, dtype=torch.int32)
    for party in (0, 1):
        s0 = to_cpu(s0s[party])
        want = tht.eval_all(PRG1, tg, in_bits, party,
                            ht_cuda.hash_block(hk, "cpu"), s0, cws, ocw)
        points = ht_cuda.eval_points(PRG1, tg, in_bits, party, hk, s0,
                                     cws, ocw, xs)
        assert torch.equal(points, want)
        for most in (1, 2, 3, 4):
            got = eval_all_cuda.ht_eval_all(PRG1, tg, in_bits, party, hk,
                                            s0, cws, ocw, most)
            assert torch.equal(got, want), (party, most)


def test_plain_plan_and_argument_checks(rng, monkeypatch):
    """ht_eval_all_plain runs the plan's levels: the top's one walk from
    the root (batched over its CTAs), the rest breadth-first, the
    conversion once, last; and both entry points refuse bad arguments."""
    tg = tgroups.Uint(32)
    hk, s0s, cws, ocw = _key(rng, tg, 9)
    s0 = to_cpu(s0s[0])
    calls = []
    for name in ("walk", "expand_level", "convert_both"):
        def spy(*args, _f=getattr(tht, name), _n=name):
            out = _f(*args)
            calls.append((_n, args[1] if _n == "walk" else
                          args[2].shape[0]))
            return out
        monkeypatch.setattr(tht, name, spy)
    # plan(9, 2): the top's 32 CTAs walk 5 levels and expand 2 more, the
    # body's 128 expand 2, the second of them the conversion.
    assert eval_all_cuda.plan(9, 2) == [(0, 5, 2), (7, 0, 2)]
    got = eval_all_cuda.ht_eval_all_plain(PRG1, tg, 9, 0, hk, s0, cws, ocw,
                                          2)
    assert calls == [("walk", 6), ("expand_level", 32), ("expand_level", 64),
                     ("expand_level", 128), ("convert_both", 256)]
    monkeypatch.undo()
    assert torch.equal(got, tht.eval_all(
        PRG1, tg, 9, 0, ht_cuda.hash_block(hk, "cpu"), s0, cws, ocw))
    bad = [
        dict(party=2),
        dict(in_bits=0),
        dict(most=0),
        dict(most=eval_all_cuda.SUBTREE_LEVELS + 1),
        dict(cws=cws[:8]),                       # no conversion row
        dict(cws=cws[:, :4].contiguous()),       # no LCW_1 word
        dict(cws=cws.to(torch.int64)),
        dict(s0=to_cpu(s0s)),                    # [2, 4], not one seed
        dict(ocw=ocw[None]),                     # [1, 4], not one block
        dict(hash_key=(1, 2, 3)),
        dict(prg1=ChaCha(2, NONCE)),
    ]
    for fn in (eval_all_cuda.ht_eval_all, eval_all_cuda.ht_eval_all_plain):
        for change in bad:
            args = dict(prg1=PRG1, group=tg, in_bits=9, party=0,
                        hash_key=hk, s0=s0, cws=cws, ocw=ocw)
            args.update(change)
            with pytest.raises((ValueError, TypeError)):
                fn(**args)
