"""The port's AES-Feistel PRP, Cuckoo hashing and VDMPF against fss_tpu and
the reference's golden vectors, byte-exact (tolerance 0: integer crypto),
on the CPU.

The JAX side is ``fss_tpu.prp.feistel``'s host oracle,
``fss_tpu.schemes.cuckoo`` (host Python) and ``fss_tpu.api.Vdmpf`` (its
Gen, and both parties' BatchEval under both folds in one program); the
port runs its plain versions, the kernels' wrappers taking them for CPU
tensors. The route kernel is held against its plain version on the card
in test_torch_gpu_grotto_vdmpf.py.
"""

import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.api import Vdmpf as JVdmpf
from fss_tpu.hash import blake3 as jb3
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.prp import feistel as jfeistel
from fss_tpu.schemes import cuckoo as jcuckoo
from fss_tpu.schemes import vdmpf as jvdmpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.api import Vdmpf
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.ops import feistel_cuda
from fss_tpu_torch.prp.feistel import Aes128Feistel
from fss_tpu_torch.schemes import cuckoo as tcuckoo
from fss_tpu_torch.schemes import vdmpf as tvdmpf
from test_torch_api import golden_prg
from torch_jax import FAST_COMPILE
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
VEC = REPO / "tests" / "golden" / "vectors"
_CASES = json.loads((VEC / "vdmpf.json").read_text())["cases"]
NONCE = (0x5EED5EED, 0x00C0FFEE)


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def _np(t):
    return tblk.to_numpy(t)


def _lanes_int(row) -> int:
    return sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row))


def test_golden_case_count():
    assert len(_CASES) == 5


@pytest.mark.parametrize(
    "case", _CASES,
    ids=lambda c: (f"{c['prg']}-{c['hash']}-{c['in_bits']}-t{c['t']}"))
def test_golden(case):
    """Gen's bytes, m, m_rt and b_size_rt, both parties' ys and proofs
    with the reference fold; the tree fold's shares are the same and its
    proofs equal across parties."""
    n = case["in_bits"]
    hashes = (Sha256(_u32(case["hash_key"])) if case["hash"] == "sha256"
              else Blake3(np.concatenate([_u32(h)
                                          for h in case["blake3_iv"]])))
    d = Vdmpf(n, max_points=case["max_points"],
              bucket_bits=case["bucket_bits"], group=tgroups.Uint(64),
              prg=golden_prg(case, 2), hashes=hashes, device="cpu")
    assert d.m == case["m"]
    s0s = np.stack([np.stack([_u32(a), _u32(b)]) for a, b in zip(
        case["bucket_s0s0"], case["bucket_s0s1"])])
    k0, k1, fail = d.gen(bytes.fromhex(case["sigma"]), s0s,
                         [int(a, 0) for a in case["alphas"]],
                         np.stack([_u32(h) for h in case["betas"]]))
    assert not fail
    assert (k0.m_rt, k0.b_size_rt) == (case["m_rt"], case["b_size_rt"])
    for i, bucket in enumerate(case["buckets"]):
        assert _np(k0.cws[i]).tobytes() == np.stack(
            [_u32(r) for r in bucket["cws"]]).tobytes(), f"bucket {i} cws"
        assert _np(k0.cs[i]).tobytes() == bytes.fromhex(bucket["cs"])
        assert _np(k0.ocw[i]).tobytes() == bytes.fromhex(bucket["ocw"])
    assert _np(k1.s0).tobytes() == b"".join(
        bytes.fromhex(h) for h in case["bucket_s0s1"])
    xs = [int(x, 0) for x in case["xs"]]
    tree = {}
    for party, key in ((0, k0), (1, k1)):
        ys, pi = d.batch_eval(party, key, xs, fold="reference")
        assert _np(ys).tobytes() == b"".join(
            bytes.fromhex(h) for h in case[f"ys{party}"]), f"party{party}"
        assert _np(pi).tobytes() == bytes.fromhex(case[f"pi{party}"])
        ys_tree, tree[party] = d.batch_eval(party, key, xs, fold="tree")
        assert torch.equal(ys_tree, ys)
    assert d.verify(tree[0], tree[1])


def test_mt19937_and_ch_bucket():
    """The std::mt19937 twin's first 1000 outputs and the bucket counts
    for t in 30..64, against the JAX package's."""
    ours, theirs = tcuckoo.Mt19937(42), jcuckoo.Mt19937(42)
    assert [ours() for _ in range(1000)] == [theirs() for _ in range(1000)]
    assert ([tcuckoo.ch_bucket(t, 80) for t in range(30, 65)]
            == [jcuckoo.ch_bucket(t, 80) for t in range(30, 65)])


@pytest.mark.parametrize("in_bits", [8, 16, 29, 30, 33])
def test_route_matches_host_locate(in_bits, rng):
    """route (the kernel's plain version) on 64 points against the JAX
    package's host Locate: bucket and the full index at every hash
    function, the index as words up to 29 bits and lanes above. The
    reference's dedup never fires below n: each point's kappa (bucket,
    index) pairs are distinct, and points that share a bucket under two
    hash functions, at distinct indices, occur in the sample."""
    kappa, m_rt = 3, 53
    n = 1 << in_bits
    sigma = bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    b_rt = (n * kappa + m_rt - 1) // m_rt
    jprp = jfeistel.Aes128Feistel(sigma, n * kappa)
    xs = [int(v) % n for v in rng.integers(0, 2**62, size=64)]
    key = tvdmpf.VdmpfKey(sigma, m_rt, b_rt, *([None] * 4))
    tx = (tblk.words(np.asarray(xs, dtype=np.uint64)) if in_bits <= 32
          else tblk.pack_inputs(xs, in_bits, "cpu"))
    bucket, index = tvdmpf.route(key, in_bits, tx, kappa)
    assert index.dim() == (2 if in_bits <= 29 else 3)
    shared = 0
    for e, x in enumerate(xs):
        seen = set()
        for k in range(kappa):
            want = jcuckoo.locate_host(jprp, x, k, n, b_rt, kappa)
            got_j = (_lanes_int(index[e, k]) if index.dim() == 3
                     else int(index[e, k]) & 0xFFFFFFFF)
            assert (int(bucket[e, k]), got_j) == want, (e, k)
            assert want not in seen, (e, k)
            shared += any(b == want[0] for b, _ in seen)
            seen.add(want)
    assert shared > 0, "no two hash functions shared a bucket"


@pytest.mark.parametrize("in_bits", [2, 16])
def test_route_outside_the_domain(in_bits, rng):
    """Points at or above n are outside the function: their walks need not
    end (a cycle of the Feistel network may hold no value below the
    domain), so they are not walked and give bucket -1 and an index of all
    ones, beside points below n that route as usual."""
    kappa, m_rt = 3, 5
    n = 1 << in_bits
    b_rt = (n * kappa + m_rt - 1) // m_rt
    prp = Aes128Feistel(bytes(rng.integers(0, 256, size=16,
                                           dtype=np.uint8)), n * kappa)
    xs = torch.cat([torch.arange(min(n, 256), dtype=torch.int32),
                    n + torch.arange(3 * 64, dtype=torch.int32)])
    bucket, index = feistel_cuda.route_plain(prp, n, kappa, b_rt, xs, 4)
    ys = (bucket.long() * b_rt + tblk.u64(index[..., 0]))
    low = min(n, 256)
    assert ((ys[:low] >= 0) & (ys[:low] < n * kappa)).all()
    vals = xs.long()[:, None] + n * torch.arange(kappa)
    lost = vals >= n * kappa
    assert torch.equal(bucket == -1, lost) and lost[low:].any()
    assert (index[lost] == -1).all()
    assert [int(y) for y in ys[0]] == [prp.permu_host(n * k)
                                       for k in range(kappa)]


@pytest.mark.parametrize("in_bits,good,bad", [
    (8, [0, 255], [256, 1 << 31]),
    (32, [0, (1 << 32) - 1], []),
    (33, [0, (1 << 33) - 1], [1 << 33, 1 << 127])])
def test_batch_eval_rejects_points_outside(in_bits, good, bad):
    """batch_eval takes points below 2^in_bits only (words up to 32 bits,
    lanes above): the largest passes the check, and each point at or
    above 2^in_bits raises before any routing or eval."""
    def pts(vals):
        return (tblk.pack_inputs(vals, 128, "cpu") if in_bits > 32
                else tblk.words(np.asarray(vals, dtype=np.uint64)))

    tvdmpf.check_points(pts(good), in_bits)
    key = tvdmpf.VdmpfKey(bytes(16), 53, 1, *([None] * 4))
    for x in bad:
        with pytest.raises(ValueError, match=f"below 2\\^{in_bits}"):
            tvdmpf.batch_eval(None, None, None, in_bits, 12, 0, key,
                              pts(good + [x]))


def test_prp_permu_and_table(rng):
    """permu, permu_lanes and the permutation table against the JAX
    package's host oracle; the table is a permutation; a domain of
    2^k + 1, where the cycle walk takes many passes."""
    sigma = bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    for domain in (3 << 8, (1 << 9) + 1):
        prp, jprp = (Aes128Feistel(sigma, domain),
                     jfeistel.Aes128Feistel(sigma, domain))
        table = prp.permutation_table("cpu")
        assert sorted(table.tolist()) == list(range(domain))
        xs = rng.integers(0, domain, size=16)
        assert [int(table[int(x)]) for x in xs] == [jprp.permu_host(int(x))
                                                   for x in xs]
        hi, lo = prp.permu(torch.from_numpy(xs.astype(np.int32)))
        assert not hi.any() and torch.equal(lo, table[torch.from_numpy(xs)])
    wide = Aes128Feistel(sigma, 3 << 64)
    vals = [(int(v) << 40 | int(v)) % (3 << 64)
            for v in rng.integers(0, 2**62, size=8)]
    y = wide.permu_lanes(tblk.pack_inputs(vals, 128, "cpu"))
    jwide = jfeistel.Aes128Feistel(sigma, 3 << 64)
    assert [_lanes_int(r) for r in y] == [jwide.permu_host(v) for v in vals]
    assert wide.permu_host(vals[0]) == _lanes_int(y[0])


def test_vdmpf_matches_jax():
    """One VDMPF at in_bits 8, t = 30: the JAX package's keys crossed
    through interop, and both parties' BatchEval under both folds against
    ``fss_tpu.api.Vdmpf`` (one program); the port's Gen from the same
    numpy stream gives the same keys, and its keys crossed back give the
    JAX package's answers too."""
    in_bits, t = 8, 30
    rng = np.random.default_rng(0xB0B)
    n = 1 << in_bits
    alphas = sorted(rng.choice(n, size=t, replace=False).tolist())
    betas = rng.integers(0, 2**32, size=(t, 4), dtype=np.uint32)
    iv = tuple(range(0x21, 0x29))
    jd = JVdmpf(in_bits, group=jgroups.Uint(32), prg=JChaCha(2, NONCE),
                hashes=jb3.Blake3(iv))
    cfg = interop.vdmpf_config(in_bits, jd.group, jd.prg, jb3.Blake3(iv),
                               jd.max_points, jd.bucket_bits)
    json.dumps(cfg)  # plain values only
    d = interop.vdmpf_from_config(cfg, device="cpu")
    assert (d.m, d.bucket_bits) == (jd.m, jd.bucket_bits)
    jk = jd.gen_retry(np.random.default_rng(5), alphas, jblk.block(betas))
    tk = d.gen_retry(np.random.default_rng(5), alphas, betas)
    for j, k in zip(jk, tk):
        assert interop.vdmpf_key_to_jax(k)[:3] == (bytes(j.sigma), j.m_rt,
                                                  j.b_size_rt)
        for got, want in zip(interop.vdmpf_key_to_jax(k)[3:], j[3:]):
            assert np.array_equal(got, np.asarray(want))
    xs = np.concatenate([alphas, rng.integers(0, n, size=34)]).astype(
        np.uint32)

    def jax_side(keys):
        return [jvdmpf.batch_eval(
            jd.prg, jd.xor_hash, jd.hash64, jd.group, in_bits,
            jd.bucket_bits, p, k, xs, jd.kappa, fold)
            for fold in tvdmpf.FOLDS for p, k in enumerate(keys)]

    keys = [interop.vdmpf_key_to_jax(k) for k in tk]
    arrays = [k[3:] for k in keys]
    f = jax.jit(lambda a: jax_side([jvdmpf.VdmpfKey(*k[:3], *v)
                                    for k, v in zip(keys, a)]))
    want = f.lower(arrays).compile(FAST_COMPILE)(arrays)
    got = [d.batch_eval(p, interop.vdmpf_key_from_jax(k, "cpu"), xs, fold)
           for fold in tvdmpf.FOLDS for p, k in enumerate(jk)]
    for (gy, gpi), (wy, wpi) in zip(got, want):
        assert np.array_equal(_np(gy), np.asarray(wy))
        assert np.array_equal(_np(gpi), np.asarray(wpi))
    rec = _np(tgroups.Uint(32).add(got[0][0], got[1][0]))
    beta_of = dict(zip(alphas, betas[:, 0]))
    assert [int(r) for r in rec[:, 0]] == [int(beta_of.get(int(x), 0))
                                           for x in xs]
    assert not rec[:, 1:].any() and d.verify(got[0][1], got[1][1])


def test_new_modules_import_no_jax():
    """The modules of this slice and the entry points import neither JAX
    nor anything of fss_tpu (test_torch_chacha.py walks the whole
    package)."""
    code = ("import sys; import fss_tpu_torch.prp.feistel, "
            "fss_tpu_torch.ops.feistel_cuda, fss_tpu_torch.schemes.cuckoo, "
            "fss_tpu_torch.schemes.grotto_dcf, fss_tpu_torch.schemes.vdmpf, "
            "fss_tpu_torch.api, fss_tpu_torch.interop; "
            "from fss_tpu_torch.api import GrottoDcf, Vdmpf; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'fss_tpu' "
            "or m.startswith('fss_tpu.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
