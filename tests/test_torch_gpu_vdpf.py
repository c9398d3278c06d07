"""The port's VDPF and hash CUDA kernels against their plain PyTorch
versions on the card, and the reference's ChaCha VDPF golden vectors
through Vdpf("cuda").

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_vdpf.py
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
from fss_tpu_torch.api import Vdpf
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.ops import blake3_cuda, eval_all_cuda, sha256_cuda
from fss_tpu_torch.ops import vdpf_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import vdpf as plain_vdpf

pytestmark = pytest.mark.gpu

NONCE = (0xABCD1234, 0x55AA55AA)
PRG2 = ChaCha(2, NONCE)
HASHES = {"blake3": Blake3(range(0x10, 0x18)),
          "sha256": Sha256((0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D))}
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, shape, dev, bits=32):
    return blk.words(rng.integers(0, 2**bits, size=shape, dtype=np.uint64),
                     dev)


def _mod(name):
    hashes = HASHES[name]
    if name == "blake3":
        return blake3_cuda, hashes.iv
    return sha256_cuda, hashes.key


def _inputs(rng, n, batch, dev, lanes=False):
    """Alpha (or x) values below 2^n in the kernels' layout: [B] words for
    n <= 32 unless ``lanes``, else [B, 4] lanes."""
    if n <= 32 and not lanes:
        return _words(rng, (batch,), dev, n)
    vals = [int(v) % (1 << n) for v in rng.integers(0, 2**63, size=batch)]
    vals = [(v << 64 | v) % (1 << n) for v in vals]
    return blk.pack_inputs(vals, n, dev)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("rows", [1, 1000, 4133])
@pytest.mark.parametrize("name", sorted(HASHES))
def test_hash_kernels_match_plain(name, rows, cuda):
    rng = np.random.default_rng(rows)
    mod, key = _mod(name)
    a, b = _words(rng, (rows, 4), cuda), _words(rng, (rows, 4), cuda)
    msg = _words(rng, (rows, 4, 4), cuda)
    assert torch.equal(mod.xor_hash(key, a, b),
                       mod.xor_hash_plain(key, a, b))
    assert torch.equal(mod.hash64(key, msg), mod.hash64_plain(key, msg))


RING = sha256_cuda.CHAIN_RING


@pytest.mark.parametrize("rows", [0, 1, 2, RING - 1, RING, RING + 1, 4096,
                                  4133])
@pytest.mark.parametrize("zero_key", [False, True])
@pytest.mark.parametrize("name", sorted(HASHES))
def test_chain_kernel_matches_plain(name, zero_key, rows, cuda):
    """Both chains; the SHA-256 one around its ring's size (its producer
    lanes each own a slot) and past it."""
    rng = np.random.default_rng(10 + rows)
    mod, key = _mod(name)
    if zero_key:
        key = (0,) * len(list(key))
    pts, cs = _words(rng, (rows, 4, 4), cuda), _words(rng, (4, 4), cuda)
    assert torch.equal(mod.chain(key, pts, cs), mod.chain_plain(key, pts, cs))


B3_RING = blake3_cuda.CHAIN_RING


@pytest.mark.parametrize("rows", [0, 1, 2, B3_RING - 1, B3_RING,
                                  B3_RING + 1, 4096, 4133])
def test_blake3_chain_around_its_ring(rows, cuda):
    """The BLAKE3 chain around its own ring's size (a producer lane a
    slot) and past it."""
    rng = np.random.default_rng(40 + rows)
    _, iv = _mod("blake3")
    pts, cs = _words(rng, (rows, 4, 4), cuda), _words(rng, (4, 4), cuda)
    assert torch.equal(blake3_cuda.chain(iv, pts, cs),
                       blake3_cuda.chain_plain(iv, pts, cs))


@pytest.mark.parametrize("rows", [1, B3_RING + 1, 4133])
def test_blake3_chain_takes_rows_at_any_4_byte_offset(rows, cuda):
    """The BLAKE3 producers read 16-byte rows when they are 16-byte
    aligned and 4-byte words when not."""
    rng = np.random.default_rng(60 + rows)
    _, iv = _mod("blake3")
    flat = _words(rng, (16 * rows + 1,), cuda)
    cs = _words(rng, (4, 4), cuda)
    for m in (flat[:-1].view(rows, 4, 4), flat[1:].view(rows, 4, 4)):
        assert torch.equal(blake3_cuda.chain(iv, m, cs),
                           blake3_cuda.chain_plain(iv, m, cs))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("lsb", ["clear", "set"])
@pytest.mark.parametrize("points", ["below_2_32", "wide", "mixed"])
@pytest.mark.parametrize("rows", [1, 130, 4133])
def test_sha256_xor_hash_paths(rows, points, lsb, offset, cuda):
    """B-12 on points below 2^32 (lanes 1-3 zero but for the domain bit,
    as on every main path), 128-bit points, and warps that mix both; lane
    3's LSB set or clear; N = 1 and N off the CTA's multiple; rows 16-byte
    aligned or at a 4-byte offset."""
    rng = np.random.default_rng(rows + 7 * offset)
    _, key = _mod("sha256")
    ab = _words(rng, (2, 4 * rows + 1), cuda)
    a, b = (ab[i, offset:offset + 4 * rows].view(rows, 4) for i in (0, 1))
    if lsb == "set":
        a[:, 3] |= 1
    else:
        a[:, 3] &= ~1
    if points != "wide":
        small = a[::3] if points == "mixed" else a
        small[:, 1:3] = 0
        small[:, 3] &= 1
    assert torch.equal(sha256_cuda.xor_hash(key, a, b),
                       sha256_cuda.xor_hash_plain(key, a, b))


@pytest.mark.parametrize("rows", [1, 257, 4133])
def test_sha256_kernels_take_rows_at_any_4_byte_offset(rows, cuda):
    """hash64 and the chain read 16-byte rows when they are 16-byte aligned
    and 4-byte words when not: both against their plain versions."""
    rng = np.random.default_rng(300 + rows)
    _, key = _mod("sha256")
    flat = _words(rng, (16 * rows + 1,), cuda)
    cs = _words(rng, (4, 4), cuda)
    for m in (flat[:-1].view(rows, 4, 4), flat[1:].view(rows, 4, 4)):
        assert torch.equal(sha256_cuda.hash64(key, m),
                           sha256_cuda.hash64_plain(key, m))
        assert torch.equal(sha256_cuda.chain(key, m, cs),
                           sha256_cuda.chain_plain(key, m, cs))


def test_sha256_chain_needs_no_scratch(cuda):
    """The chain's ring is in shared memory: over 2^16 points it allocates
    its 64-byte output and nothing that grows with N."""
    rng = np.random.default_rng(16)
    _, key = _mod("sha256")
    pts, cs = _words(rng, (1 << 16, 4, 4), cuda), _words(rng, (4, 4), cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sha256_cuda.chain(key, pts, cs)
    torch.cuda.synchronize()
    assert out.shape == (4, 4)
    assert torch.cuda.max_memory_allocated() - base < 1 << 20


def test_sha256_reference_fold_eval_all_matches_plain(cuda):
    """Vdpf.eval_all with the reference fold (the flat chain kernel over
    all 2^10 points) against the plain fold, both parties."""
    rng = np.random.default_rng(10)
    mod, key = _mod("sha256")
    g = groups.Uint(32)
    d = Vdpf(10, g, PRG2, hashes=HASHES["sha256"], device=cuda)
    s0s, cws, cs, ocw = d.gen_retry(rng, 777, _words(rng, (4,), cuda))

    def h64(m):
        return mod.hash64_plain(key, m.reshape(-1, 4, 4)).reshape(
            *m.shape[:-2], 2, 4)

    proofs = []
    for party in (0, 1):
        got = d.eval_all(party, s0s[party], cws, cs, ocw, fold="reference")
        want = plain_vdpf.eval_all(
            PRG2, lambda a, b: mod.xor_hash_plain(key, a, b), h64, g, 10,
            party, s0s[party], cws, cs, ocw, "reference")
        assert _same(got, want)
        proofs.append(got[1])
    assert torch.equal(*proofs)


@pytest.mark.parametrize("name", sorted(HASHES))
@pytest.mark.parametrize("layout", ["wire", "broadcast"])
@pytest.mark.parametrize("n", [1, 8, 16, 48, 128])
def test_eval_kernel_matches_plain(n, layout, name, cuda):
    rng = np.random.default_rng(n)
    batch = 1000
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda)
    cws = vdpf_cuda.gen_batch(PRG2, HASHES[name], groups.Bytes(), n, s0s,
                              alphas, _words(rng, (batch, 4), cuda))[0]
    xs = alphas.clone()
    xs.view(batch, -1)[1::2, 0] ^= 1
    for party in (0, 1):
        s0, k = {
            "wire": (s0s[:, party].contiguous(), cws),
            "broadcast": (s0s[0, party].contiguous(), cws[0].contiguous()),
        }[layout]
        got = vdpf_cuda.eval_packed(s0, k, xs, n, party, PRG2, HASHES[name])
        want = vdpf_cuda.eval_packed_plain(s0, k, xs, n, party, PRG2,
                                           HASHES[name])
        assert _same(got, want)


@pytest.mark.parametrize("name", sorted(HASHES))
@pytest.mark.parametrize("n,lanes", [(1, False), (2, True), (16, False),
                                     (48, True), (128, True)])
def test_gen_matches_plain(n, lanes, name, cuda):
    rng = np.random.default_rng(100 + n)
    batch = 500
    g = groups.Uint(64)
    s0s, betas = _words(rng, (batch, 2, 4), cuda), _words(rng, (batch, 4),
                                                          cuda)
    alphas = _inputs(rng, n, batch, cuda, lanes)
    mod, key = _mod(name)
    got = vdpf_cuda.gen_batch(PRG2, HASHES[name], g, n, s0s, alphas, betas)
    want = plain_vdpf.gen(ChaCha(2, NONCE),
                          lambda a, b: mod.xor_hash_plain(key, a, b), g, n,
                          s0s, blk.pack_inputs(alphas, n, cuda).reshape(-1, 4),
                          betas)
    assert _same(got, want)


@pytest.mark.parametrize("name", sorted(HASHES))
@pytest.mark.parametrize("n,fold", [(1, "tree"), (3, "chunked"),
                                    (5, "reference"), (8, "tree"),
                                    (8, "chunked"), (13, "tree")])
def test_eval_all_matches_plain(n, fold, name, cuda):
    rng = np.random.default_rng(200 + n)
    g = groups.Uint(128, 1 << 127)
    mod, key = _mod(name)
    s0s = _words(rng, (1, 2, 4), cuda)
    keys = [t[0] for t in vdpf_cuda.gen_batch(
        PRG2, HASHES[name], g, n, s0s, _inputs(rng, n, 1, cuda, True),
        _words(rng, (1, 4), cuda))][:3]

    def h64(m):
        return mod.hash64_plain(key, m.reshape(-1, 4, 4)).reshape(
            *m.shape[:-2], 2, 4)

    outs = []
    for party in (0, 1):
        got = eval_all_cuda.vdpf_eval_all(ChaCha(2, NONCE), HASHES[name], g,
                                          n, party, s0s[0, party], *keys,
                                          fold)
        want = plain_vdpf.eval_all(
            ChaCha(2, NONCE), lambda a, b: mod.xor_hash_plain(key, a, b),
            h64, g, n, party, s0s[0, party], *keys, fold)
        assert _same(got, want)
        outs.append(got)
    assert torch.equal(outs[0][1], outs[1][1])


def test_kernels_count_launches(cuda):
    _build.reset_launches()
    d = Vdpf(10, groups.Uint(32), hashes=HASHES["sha256"], device=cuda)
    s0s, cws, cs, ocw = d.gen_batch(np.random.default_rng(1), [5, 6],
                                    np.ones((2, 4), dtype=np.uint32))
    _, pis = d.eval(0, s0s[:, 0], cws, cs, ocw, [4, 6])
    d.prove(pis, cs[0])
    d.eval_all(1, s0s[0, 1], cws[0], cs[0], ocw[0], fold="tree")
    assert {k: v for k, v in _build.launches.items() if v} == {
        "dpf_gen": 1, "sha256_xor_hash": 3, "vdpf_eval": 1,
        "sha256_chain": 1, "dpf_eval_all": 2, "sha256_hash64": 11}


def test_gen_batch_on_cuda_matches_cpu(cuda):
    """The same numpy seed gives the same keys on the card and the CPU."""
    alphas = np.arange(300, dtype=np.uint32) * 11
    betas = np.random.default_rng(2).integers(0, 2**32, size=(300, 4),
                                              dtype=np.uint32)
    for hashes in HASHES.values():
        got = Vdpf(12, groups.Uint(32), hashes=hashes, device=cuda).gen_batch(
            np.random.default_rng(3), alphas, betas)
        want = Vdpf(12, groups.Uint(32), hashes=hashes,
                    device="cpu").gen_batch(np.random.default_rng(3), alphas,
                                            betas)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_other_hashes_are_refused_on_the_card(cuda):
    class Plain:
        xor_hash = hash64 = None

    with pytest.raises(TypeError):
        Vdpf(8, hashes=Plain(), device=cuda)
    with pytest.raises(TypeError):
        vdpf_cuda.xor_hash(Plain(), torch.zeros((1, 4), dtype=torch.int32,
                                                device=cuda),
                           torch.zeros((1, 4), dtype=torch.int32,
                                       device=cuda))


@pytest.mark.parametrize(
    "case", [c for c in json.loads((VEC / "vdpf.json").read_text())
             ["cases"] if c["prg"] == "chacha"],
    ids=lambda c: f"{c['hash']}-{c['group']}-{c['in_bits']}")
def test_golden_on_cuda(case, cuda):
    """Gen bytes, ys, pi~ and prove_pi of both parties, and EvalAll's
    digest and proof with the reference fold (the flat chain kernel)."""
    def hexw(h):
        return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()

    def raw(t):
        return blk.to_numpy(t).tobytes()

    g = {"bytes": groups.Bytes(), "uint64": groups.Uint(64)}[case["group"]]
    hashes = (Sha256(hexw(case["hash_key"])) if case["hash"] == "sha256"
              else Blake3(np.concatenate([hexw(h)
                                          for h in case["blake3_iv"]])))
    d = Vdpf(case["in_bits"], g,
             ChaCha(2, (case["nonce_lo"], case["nonce_hi"])), hashes=hashes,
             device=cuda)
    s0s = np.stack([hexw(h) for h in case["s0s"]])
    cws, cs, ocw, fail = d.gen(s0s, int(case["alpha"], 0),
                               hexw(case["beta"]))
    assert int(fail) == 0
    assert raw(cws) == np.stack([hexw(r) for r in case["cws"]]).tobytes()
    assert raw(cs) == b"".join(bytes.fromhex(h) for h in case["cs"])
    assert raw(ocw) == bytes.fromhex(case["ocw"])
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        ys, pis = d.eval(party, s0s[party], cws, cs, ocw, xs)
        assert raw(ys) == b"".join(bytes.fromhex(h)
                                   for h in case[f"ys{party}"])
        assert raw(pis) == b"".join(bytes.fromhex(h)
                                    for h in case[f"pi_tildes{party}"])
        assert raw(d.prove(pis, cs)) == bytes.fromhex(case[f"prove_pi{party}"])
        if "eval_all_digest0" in case:
            ys, pi = d.eval_all(party, s0s[party], cws, cs, ocw)
            assert hashlib.sha256(raw(ys)).hexdigest() == \
                case[f"eval_all_digest{party}"]
            assert raw(pi) == bytes.fromhex(case[f"eval_all_pi{party}"])
