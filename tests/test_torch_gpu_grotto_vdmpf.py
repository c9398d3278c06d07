"""The port's Feistel routing kernel against its plain PyTorch version on
the card, and the reference's Grotto DCF and VDMPF golden vectors through
GrottoDcf("cuda") and Vdmpf("cuda").

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_grotto_vdmpf.py
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import GrottoDcf, Vdmpf
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.ops import feistel_cuda
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.prp.feistel import Aes128Feistel

pytestmark = pytest.mark.gpu

NONCE = (0xABCD1234, 0x55AA55AA)
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def _prg(case, mul):
    if case["prg"] == "aes":
        return AesMmo(mul, [bytes.fromhex(k) for k in case["aes_keys"][:mul]])
    return ChaCha(mul, (case["nonce_lo"], case["nonce_hi"]))


def _points(rng, n, count, dev):
    """count points below n (the last 64 at or above it: not walked) as
    [count] words for n <= 2^32, else [count, 4] lanes."""
    vals = [int(v) % n for v in rng.integers(0, 2**63, size=count - 64)]
    vals += [n + int(v) % n for v in rng.integers(0, 2**63, size=64)]
    if n <= 2**32 and 2 * n <= 2**32:
        return blk.words(np.asarray(vals, dtype=np.uint64), dev)
    return blk.pack_inputs(vals, 128, dev)


@pytest.mark.parametrize("in_bits", [8, 16, 22, 23, 29, 30, 33, 64])
def test_route_kernel_matches_plain(in_bits, cuda):
    """Bucket and index (words to 29 bits, lanes above), byte-exact, with
    8 and 53 buckets; points outside the domain included."""
    rng = np.random.default_rng(in_bits)
    n, kappa = 1 << in_bits, 3
    prp = Aes128Feistel(bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
                        n * kappa)
    xs = _points(rng, n, 4133, cuda)
    for m_rt in (8, 53):
        b_rt = (n * kappa + m_rt - 1) // m_rt
        lanes = 1 if in_bits <= 29 else 4
        before = _build.launches["feistel_route"]
        got = feistel_cuda.route(prp, n, kappa, b_rt, xs, lanes)
        assert _build.launches["feistel_route"] == before + 1
        want = feistel_cuda.route_plain(prp, n, kappa, b_rt, xs, lanes)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert (got[0][:-64] >= 0).all() and (got[0][-64:] == -1).any()


# The cases that CTAs walking slices of the values or tabulating the round
# functions can get wrong: counts of 1, 31 and 33 points; one CTA's
# threads plus one value (a second CTA with one); kappa 1 and 4 at 2^16
# points (more values
# than the grid has threads); a domain just above a power of two (3 n =
# 2^16 + 2: four passes a value, lanes landing many passes apart); every
# point equal; points at or above n strewn among the others; an
# untabulated walk (half 12) whose CTAs' slices pass their threads.
REFILL_CASES = ("count-1", "count-31", "count-33", "slice-plus-one",
                "kappa-1", "kappa-4", "near-pow2", "all-equal", "strewn",
                "walk-slices")


@pytest.mark.parametrize("case", REFILL_CASES)
def test_route_kernel_refill_cases(case, cuda):
    """Bucket and index byte-exact against route_plain, one launch a
    call; values at or above the domain give bucket -1 and an index of
    all ones, the others a bucket."""
    rng = np.random.default_rng(REFILL_CASES.index(case))
    n, kappa, count = 1 << 16, 3, 1 << 14
    if case.startswith("count-"):
        count = int(case.split("-")[1])
    elif case == "slice-plus-one":
        kappa = 1
    elif case.startswith("kappa-"):
        kappa, count = int(case.split("-")[1]), 1 << 16
    elif case == "near-pow2":
        n = 21846
    elif case == "walk-slices":  # half 12: AES passes, slices > threads
        n, count = 1 << 22, 1 << 15
    prp = Aes128Feistel(bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
                        n * kappa)
    if case == "slice-plus-one":
        count = feistel_cuda.plan(prp, 1, cuda)[1] + 1
        assert feistel_cuda.plan(prp, count, cuda)[0] == 2
    vals = rng.integers(0, n, size=count).astype(np.uint64)
    if case == "all-equal":
        vals[:] = vals[0]
    elif case == "strewn":
        out = rng.random(count) < 0.1
        vals[out] += n * rng.integers(1, 4, size=int(out.sum())).astype(
            np.uint64)
    args = (prp, n, kappa, -(-n * kappa // 53), blk.words(vals, cuda), 1)
    before = _build.launches["feistel_route"]
    got = feistel_cuda.route(*args)
    assert _build.launches["feistel_route"] == before + 1
    want = feistel_cuda.route_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lost = torch.as_tensor(vals[:, None].astype(np.int64)
                           + n * np.arange(kappa) >= n * kappa,
                           device=cuda)
    assert (got[0][lost] == -1).all() and (got[1][lost] == -1).all()
    assert (got[0][~lost] >= 0).all()
    assert bool(lost.any()) == (case == "strewn")


def test_permute_and_table_match_plain(cuda):
    """The PRP of points on a domain of 2^20 + 1, where the cycle walk
    takes many passes, and of 4-lane points on a 2^66-sized domain; the
    permutation table at 3 * 2^8: a permutation, the plain table, and the
    host oracle."""
    rng = np.random.default_rng(1)
    sigma = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    prp = Aes128Feistel(sigma, (1 << 20) + 1)
    xs = blk.words(rng.integers(0, prp.domain, size=5000, dtype=np.uint64),
                   cuda)
    assert torch.equal(feistel_cuda.permute(prp, xs),
                       feistel_cuda.permute_plain(prp, xs))
    wide = Aes128Feistel(sigma, 3 << 64)
    x4 = blk.pack_inputs([int(v) % wide.domain for v in
                          rng.integers(0, 2**63, size=3000)], 128, cuda)
    assert torch.equal(wide.permu_lanes(x4),
                       feistel_cuda.permute_plain(wide, x4))
    small = Aes128Feistel(sigma, 3 << 8)
    table = small.permutation_table(cuda)
    assert torch.equal(table.cpu(), small.permutation_table("cpu"))
    assert sorted(table.tolist()) == list(range(small.domain))
    assert table[:64].tolist() == [small.permu_host(x) for x in range(64)]


@pytest.mark.parametrize(
    "case", json.loads((VEC / "grotto.json").read_text())["cases"],
    ids=lambda c: f"{c['prg']}-{c['in_bits']}-alpha{c['alpha']}")
def test_grotto_golden(case, cuda):
    n = case["in_bits"]
    d = GrottoDcf(n, _prg(case, 2), device=cuda)
    s0s = np.stack([_u32(h) for h in case["s0s"]])
    cws = d.gen(s0s, int(case["alpha"], 0))
    assert blk.to_numpy(cws).tobytes() == np.stack(
        [_u32(r) for r in case["cws"]]).tobytes()
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        want = [int(y) for y in case[f"ys{party}"]]
        assert d.eval(d.preprocess(party, s0s[party], cws),
                      xs).tolist() == want
        assert d.eval(d.preprocess_prefix(party, s0s[party], cws),
                      xs).tolist() == want
        raw = blk.to_numpy(d.eval_all(party, s0s[party], cws)).astype(
            np.uint8).tobytes()
        assert (hashlib.sha256(raw).hexdigest()
                == case[f"eval_all_digest{party}"])


@pytest.mark.parametrize(
    "case", json.loads((VEC / "vdmpf.json").read_text())["cases"],
    ids=lambda c: f"{c['prg']}-{c['hash']}-{c['in_bits']}-t{c['t']}")
def test_vdmpf_golden(case, cuda):
    hashes = (Sha256(_u32(case["hash_key"])) if case["hash"] == "sha256"
              else Blake3(np.concatenate([_u32(h)
                                          for h in case["blake3_iv"]])))
    d = Vdmpf(case["in_bits"], max_points=case["max_points"],
              bucket_bits=case["bucket_bits"], group=groups.Uint(64),
              prg=_prg(case, 2), hashes=hashes, device=cuda)
    s0s = np.stack([np.stack([_u32(a), _u32(b)]) for a, b in zip(
        case["bucket_s0s0"], case["bucket_s0s1"])])
    k0, k1, fail = d.gen(bytes.fromhex(case["sigma"]), s0s,
                         [int(a, 0) for a in case["alphas"]],
                         np.stack([_u32(h) for h in case["betas"]]))
    assert not fail and d.m == case["m"]
    assert (k0.m_rt, k0.b_size_rt) == (case["m_rt"], case["b_size_rt"])
    assert blk.to_numpy(k0.cs).tobytes() == b"".join(
        bytes.fromhex(b["cs"]) for b in case["buckets"])
    xs = [int(x, 0) for x in case["xs"]]
    for party, key in ((0, k0), (1, k1)):
        ys, pi = d.batch_eval(party, key, xs, fold="reference")
        assert blk.to_numpy(ys).tobytes() == b"".join(
            bytes.fromhex(h) for h in case[f"ys{party}"])
        assert blk.to_numpy(pi).tobytes() == bytes.fromhex(
            case[f"pi{party}"])


@pytest.mark.parametrize("hash_name", ["blake3", "sha256"])
def test_vdmpf_bench_shape_both_folds(hash_name, cuda):
    """Vdmpf(16, Uint(32), ChaCha) at the JAX bench's shape: t = 30, 2^14
    random points plus the alphas; every point reconstructs, and both
    folds' proofs are equal across parties."""
    hashes = (Blake3(range(8)) if hash_name == "blake3"
              else Sha256((1, 2, 3, 4)))
    g = groups.Uint(32)
    d = Vdmpf(16, group=g, prg=ChaCha(2, NONCE), hashes=hashes,
              device=cuda)
    rng = np.random.default_rng(7)
    alphas = sorted(rng.choice(1 << 16, size=30, replace=False).tolist())
    betas = np.zeros((30, 4), np.uint32)
    betas[:, 0] = rng.integers(0, 2**31, size=30)
    k0, k1 = d.gen_retry(rng, alphas, betas)
    xs = np.concatenate([rng.integers(0, 1 << 16, size=1 << 14),
                         alphas]).astype(np.uint32)
    out = {fold: [d.batch_eval(p, k, xs, fold) for p, k in ((0, k0),
                                                            (1, k1))]
           for fold in ("tree", "reference")}
    beta_of = dict(zip(alphas, betas[:, 0]))
    want = [int(beta_of.get(int(x), 0)) for x in xs]
    for fold, ((y0, pi0), (y1, pi1)) in out.items():
        rec = g.add(y0, y1)
        assert rec[:, 0].cpu().tolist() == [w - (1 << 32) * (w >> 31)
                                            for w in want], fold
        assert d.verify(pi0, pi1), fold
    assert torch.equal(out["tree"][0][0], out["reference"][0][0])
