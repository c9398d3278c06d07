"""The port's VDPF against fss_tpu, byte-exact (tolerance 0: integer
crypto), on the CPU.

The JAX side is ``fss_tpu.schemes.vdpf`` under ``jax.jit``,
``fss_tpu.api.Vdpf`` and, once, the fused walk+hash Pallas kernel in
interpret mode (B-13); the port runs its plain scheme and its kernel
wrappers, which take their plain PyTorch versions for CPU tensors. EvalAll
is in test_torch_vdpf_eval_all.py, the hashes in test_torch_hash.py.
"""

import hashlib
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.api import Vdpf as JVdpf
from fss_tpu.hash import blake3 as jb3
from fss_tpu.hash import sha256 as jsh
from fss_tpu.ops import vdpf_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import vdpf as jvdpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.api import DEFAULT_HASH_IV, DEFAULT_NONCE, Vdpf
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.ops import vdpf_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import vdpf as tvdpf
from test_torch_api import golden_prg
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG2 = ChaCha(2, NONCE)
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"

GROUPS = {
    "bytes": None,
    "uint32": (32, 0),
    "uint64": (64, 0),
    "uint127": (128, 1 << 127),
    "uint127m": (128, (1 << 127) - 1),
}

# Every case: ChaCha and AES-128-MMO.
_CASES = json.loads((VEC / "vdpf.json").read_text())["cases"]


def groups_pair(gname):
    spec = GROUPS[gname]
    if spec is None:
        return jgroups.Bytes(), tgroups.Bytes()
    return jgroups.Uint(*spec), tgroups.Uint(*spec)


def hashes_pair(name, rng):
    """A random key of the hash ``name`` in both packages."""
    if name == "blake3":
        iv = tuple(int(w) for w in rng.integers(0, 2**32, size=8))
        return jb3.Blake3(iv), Blake3(iv)
    key = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    return jsh.Sha256(key), Sha256(key)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def _np(t):
    return tblk.to_numpy(t)


def _check_point(tg, ys, betas, hit):
    """y0 + y1 is beta (clamped bit clear) where ``hit``, else 0."""
    rec = tg.add(tg.from_block(ys[0]), tg.from_block(ys[1]))
    beta = tg.from_block(tblk.clear_lsb(betas))
    hit = torch.as_tensor(hit)
    assert torch.equal(rec, torch.where(hit[:, None], beta,
                                        torch.zeros_like(beta)))


@pytest.mark.parametrize("gname,in_bits,hname", [
    ("bytes", 8, "blake3"), ("uint32", 1, "sha256"), ("uint64", 16, "sha256"),
    ("uint127", 48, "blake3"), ("uint127m", 48, "sha256")])
def test_gen_and_eval_match_xla(gname, in_bits, hname, rng):
    """Gen, and Eval of both parties with wire and broadcast keys, against
    the jitted JAX scheme: every group, in_bits 1, 8, 16 and 48, both
    hashes. Every key reconstructs, and its two pi~ are equal."""
    B = 64
    jg, tg = groups_pair(gname)
    jh, th = hashes_pair(hname, rng)
    prg = JChaCha(2, NONCE)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    alphas = [int(v) % (1 << in_bits) for v in rng.integers(0, 2**62,
                                                            size=B)]
    xs = [a if i % 2 == 0 else a ^ (1 << (i % in_bits))
          for i, a in enumerate(alphas)]
    a_lanes = tblk.pack_inputs(alphas, in_bits, "cpu")
    x_lanes = tblk.pack_inputs(xs, in_bits, "cpu")

    want = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda s, a, b: jvdpf.gen(prg, jh.xor_hash, jg, in_bits, s, a, b)))(
            jblk.block(s0s), _np(a_lanes), jblk.block(betas))]
    ts0s, tbetas = to_cpu(s0s), to_cpu(betas)
    got = vdpf_cuda.gen_batch(PRG2, th, tg, in_bits, ts0s, a_lanes, tbetas)
    assert got[0].shape == (B, in_bits, 8) and got[1].shape == (B, 4, 4)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), w)
    plain = tvdpf.gen(ChaCha(2, NONCE), th.xor_hash, tg, in_bits, ts0s,
                      a_lanes, tbetas)
    assert all(torch.equal(p, g) for p, g in zip(plain, got))
    cws, cs, ocw, fail = got
    # t0 ^ t1 = 1 on the path to alpha by construction: Gen never fails.
    assert not fail.any()

    jeval = jax.jit(lambda s, c, k, o, x: [
        jvdpf.eval_points(prg, jh.xor_hash, jg, in_bits, p, s[:, p], c, k, o,
                          x) for p in (0, 1)])
    want = jeval(jblk.block(s0s), want[0], want[1], want[2], _np(x_lanes))
    # One key broadcast over the batch: the JAX side sees it repeated.
    want1 = jeval(*(np.repeat(_np(t)[:1], B, axis=0)
                    for t in (ts0s, cws, cs, ocw)), _np(x_lanes))
    ys, pis = [], []
    for party in (0, 1):
        s0 = ts0s[:, party].contiguous()
        y, pi = vdpf_cuda.eval_points(PRG2, th, tg, in_bits, party, s0, cws,
                                      cs, ocw, x_lanes)
        assert np.array_equal(_np(y), np.asarray(want[party][0]))
        assert np.array_equal(_np(pi), np.asarray(want[party][1]))
        py, ppi = tvdpf.eval_points(ChaCha(2, NONCE), th.xor_hash, tg,
                                    in_bits, party, s0, cws, cs, ocw, x_lanes)
        assert torch.equal(py, y) and torch.equal(ppi, pi)
        one = vdpf_cuda.eval_points(PRG2, th, tg, in_bits, party,
                                    s0[0].contiguous(), cws[0].contiguous(),
                                    cs[0], ocw[0], x_lanes)
        for o, w in zip(one, want1[party]):
            assert np.array_equal(_np(o), np.asarray(w)), f"party {party}"
        ys.append(y)
        pis.append(pi)
    _check_point(tg, ys, tbetas, [x == a for x, a in zip(xs, alphas)])
    assert torch.equal(pis[0], pis[1])


@pytest.mark.parametrize("hname,party", [("blake3", 0), ("sha256", 1)])
def test_fused_eval_matches_pallas_kernel(hname, party, rng):
    """B-13: vdpf_pallas.fused_eval_packed (through its eval_points), in
    interpret mode, in_bits 8, one party for each hash."""
    in_bits, B = 8, 200
    jg, tg = jgroups.Bytes(), tgroups.Bytes()
    jh, th = hashes_pair(hname, rng)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    cws, cs, ocw, _ = vdpf_cuda.gen_batch(PRG2, th, tg, in_bits,
                                          to_cpu(s0s), to_cpu(alphas),
                                          to_cpu(betas))
    xs = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    want = vdpf_pallas.eval_points(
        NONCE, jh.xor_hash, jg, in_bits, party, s0s[:, party], _np(cws),
        _np(cs), _np(ocw), xs, block_rows=8, interpret=True)
    got = vdpf_cuda.eval_points(PRG2, th, tg, in_bits, party,
                                to_cpu(s0s[:, party]), cws, cs, ocw,
                                to_cpu(xs))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("hname", ["blake3", "sha256"])
def test_slice_matches_jax_api(hname, rng):
    """The JAX package's configuration crosses by interop.vdpf_config;
    gen_batch from the same numpy seed gives the same bytes as
    fss_tpu.api.Vdpf.gen_batch (retry rounds included); eval of both
    parties -> reconstruct gives beta at alpha and 0 elsewhere, with equal
    pi~; prove and verify agree with the JAX package's."""
    in_bits, B = 12, 96
    jh, _ = hashes_pair(hname, rng)
    jd = JVdpf(in_bits, jgroups.Uint(32), JChaCha(2, NONCE), hashes=jh)
    cfg = interop.vdpf_config(in_bits, jd.group, jd.prg, jh)
    json.dumps(cfg)  # plain values only
    d = interop.vdpf_from_config(cfg, device="cpu")
    assert d.hashes == (Blake3(jh.iv) if hname == "blake3"
                        else Sha256(jh.key))
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    xs = alphas.copy()
    xs[1::2] ^= rng.integers(1, 2**in_bits, size=B // 2, dtype=np.uint32)

    want = [np.asarray(a) for a in jd.gen_batch(np.random.default_rng(7),
                                                alphas, betas)]
    got = d.gen_batch(np.random.default_rng(7), alphas, betas)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), w)
    s0s, cws, cs, ocw = got
    ys, pis = [], []
    for party in (0, 1):
        wy, wpi = jd.eval(party, want[0][:, party], *want[1:], xs)
        y, pi = d.eval(party, s0s[:, party], cws, cs, ocw, xs)
        assert np.array_equal(_np(y), np.asarray(wy))
        assert np.array_equal(_np(pi), np.asarray(wpi))
        ys.append(y)
        pis.append(pi)
    _check_point(d.group, ys, to_cpu(betas), xs == alphas)
    assert torch.equal(pis[0], pis[1])
    # One key at 8 points: each party's proof, then Verify.
    pts = [d.eval(p, s0s[0, p], cws[0], cs[0], ocw[0], xs[:8])[1]
           for p in (0, 1)]
    proofs = [d.prove(p, cs[0]) for p in pts]
    assert np.array_equal(_np(proofs[0]), np.asarray(jd.prove(
        _np(pts[0]), want[2][0])))
    assert d.verify(*proofs) and JVdpf.verify(*(_np(p) for p in proofs))
    assert not d.verify(proofs[0], proofs[0] ^ 1)


def test_gen_batch_retries_failed_lanes(monkeypatch):
    """Gen of honest seeds never fails, so the retry loop is driven here
    with a Gen that fails every key whose seed word 0 is odd: each round
    draws a whole batch, and a lane takes the first key that did not
    fail, with its seeds; the loop stops as soon as no lane fails."""
    d = Vdpf(10, tgroups.Uint(32), device="cpu")
    gen_keys = d._gen_keys
    rounds = []

    def flaky(s0s, alphas, betas):
        cws, cs, ocw, _ = gen_keys(s0s, alphas, betas)
        rounds.append(s0s)
        return cws, cs, ocw, s0s[:, 0, 0] & 1

    monkeypatch.setattr(d, "_gen_keys", flaky)
    alphas, betas = np.arange(40) * 5, np.ones((40, 4), dtype=np.uint32)
    s0s, cws, cs, ocw = d.gen_batch(np.random.default_rng(3), alphas, betas)
    assert len(rounds) > 2 and not (s0s[:, 0, 0] & 1).any()
    for i in range(40):  # the first round whose seeds did not fail
        first = next(r for r in rounds if not int(r[i, 0, 0]) & 1)
        assert torch.equal(s0s[i], first[i])
    want = gen_keys(s0s, d._inputs(alphas), d._blocks(betas))
    assert all(torch.equal(g, w) for g, w in zip((cws, cs, ocw), want))
    rng = np.random.default_rng(3)
    for r in rounds:  # each round drew one whole batch from the rng
        assert torch.equal(r, d._blocks(rng.integers(0, 2**32,
                                                     size=(40, 2, 4))))
    monkeypatch.setattr(d, "_gen_keys", lambda s, a, b: (
        *gen_keys(s, a, b)[:3], torch.ones(40, dtype=torch.int32)))
    with pytest.raises(RuntimeError):
        d.gen_batch(np.random.default_rng(3), alphas, betas, max_rounds=3)


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def test_golden_case_count():
    assert len(_CASES) == 5


@pytest.mark.parametrize(
    "case", _CASES,
    ids=lambda c: ("aes-" if c["prg"] == "aes" else "")
    + f"{c['hash']}-{c['group']}-{c['in_bits']}")
def test_golden(case):
    """Gen bytes, ys and pi~ of both parties at every x, prove_pi, and
    EvalAll: with the reference fold (eval_all_digest, eval_all_pi) where
    the domain is 8 bits; at 16 bits the flat chain of 2^16 plain hashes
    is too slow for the CPU, so the shares are checked by digest through
    the tree fold (they do not depend on the fold) and the reference
    fold runs on the card (chip_smoke.py, tests/test_torch_gpu_vdpf.py)."""
    n = case["in_bits"]
    g = {"bytes": tgroups.Bytes(), "uint64": tgroups.Uint(64)}[case["group"]]
    if case["hash"] == "sha256":
        hashes = Sha256(_u32(case["hash_key"]))
    else:
        hashes = Blake3(np.concatenate([_u32(h) for h in case["blake3_iv"]]))
    d = Vdpf(n, g, golden_prg(case, 2), hashes=hashes, device="cpu")
    s0s = np.stack([_u32(h) for h in case["s0s"]])
    cws, cs, ocw, fail = d.gen(s0s, int(case["alpha"], 0),
                               _u32(case["beta"]))
    assert int(fail) == 0
    assert _np(cws).tobytes() == np.stack(
        [_u32(r) for r in case["cws"]]).tobytes(), "gen cws bytes"
    assert _np(cs).tobytes() == b"".join(bytes.fromhex(h)
                                         for h in case["cs"]), "cs bytes"
    assert _np(ocw).tobytes() == bytes.fromhex(case["ocw"]), "ocw bytes"
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        ys, pis = d.eval(party, s0s[party], cws, cs, ocw, xs)
        assert _np(ys).tobytes() == b"".join(
            bytes.fromhex(h) for h in case[f"ys{party}"])
        assert _np(pis).tobytes() == b"".join(
            bytes.fromhex(h) for h in case[f"pi_tildes{party}"])
        assert _np(d.prove(pis, cs)).tobytes() == bytes.fromhex(
            case[f"prove_pi{party}"])
        if "eval_all_digest0" in case:
            fold = "reference" if n <= 8 else "tree"
            ys, pi = d.eval_all(party, s0s[party], cws, cs, ocw, fold)
            assert hashlib.sha256(_np(ys).tobytes()).hexdigest() == \
                case[f"eval_all_digest{party}"]
            if fold == "reference":
                assert _np(pi).tobytes() == bytes.fromhex(
                    case[f"eval_all_pi{party}"])


class _PlainHashes:
    """A hash object that is neither Blake3 nor Sha256: the CPU takes it,
    the card refuses it."""

    def __init__(self, inner):
        self.inner = inner

    def xor_hash(self, a, b):
        return self.inner.xor_hash(a, b)

    def hash64(self, msg):
        return self.inner.hash64(msg)


def test_defaults_and_inputs(rng):
    d = Vdpf(16, device="cpu")
    assert d.prg == ChaCha(2, DEFAULT_NONCE) and d.group.name == "bytes"
    assert d.hashes == Blake3(DEFAULT_HASH_IV)
    assert Vdpf(16).device.type == "cuda"  # unless asked otherwise
    assert Vdpf(16, hash_iv=range(8), device="cpu").hashes == Blake3(
        range(8))
    s0s, cws, cs, ocw = d.gen_retry(np.random.default_rng(1), 107,
                                    [5, 0, 0, 0])
    assert cws.shape == (16, 8) and cs.shape == (4, 4) and ocw.shape == (4,)
    assert cws.dtype == cs.dtype == ocw.dtype == torch.int32
    xs = np.array([106, 107, 108], dtype=np.uint32)
    # ints, lists, numpy arrays and tensors are the same inputs
    a = d.eval(0, s0s[0], cws, cs, ocw, xs)
    b = d.eval(0, _np(s0s[0]), cws, cs, ocw, [106, 107, 108])
    c = d.eval(0, s0s[0], cws, cs, ocw, torch.tensor([106, 107, 108]))
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))
    one = d.eval(0, s0s[0], cws, cs, ocw, 107)
    assert torch.equal(one[0], a[0][1]) and torch.equal(one[1], a[1][1])
    e = d.eval(1, s0s[1], cws, cs, ocw, xs)
    rec = _np(a[0] ^ e[0])
    assert rec[1].tolist() == [5, 0, 0, 0] and not rec[[0, 2]].any()
    assert torch.equal(a[1], e[1])
    other = Vdpf(16, hashes=_PlainHashes(d.hashes), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        other.eval(0, s0s[0], cws, cs, ocw, xs), a))
    assert torch.equal(other.prove(a[1], cs), d.prove(a[1], cs))
    with pytest.raises(TypeError):  # no plain hash on the card
        Vdpf(16, hashes=_PlainHashes(d.hashes))
    with pytest.raises(TypeError):
        vdpf_cuda.hash_kind(_PlainHashes(d.hashes), "cuda")
    with pytest.raises(ValueError):
        d.eval_all(0, s0s[0], cws, cs, ocw, fold="flat")
    with pytest.raises(ValueError):
        Vdpf(16, prg=ChaCha(4, DEFAULT_NONCE), device="cpu")
    with pytest.raises(ValueError):
        Vdpf(0, device="cpu")
    with pytest.raises(ValueError):  # VDPF keys have in_bits rows
        d.eval(0, s0s[0], torch.zeros((17, 8), dtype=torch.int32), cs, ocw,
               xs)
    pts = torch.zeros((12, 4, 4), dtype=torch.int32)
    h64 = d.hashes.hash64
    with pytest.raises(ValueError):
        tvdpf.prove_tree(h64, pts, cs)
    with pytest.raises(ValueError):
        tvdpf.prove_chunked(h64, pts, cs, chunk=8)


@pytest.mark.parametrize("hname", ["blake3", "sha256"])
def test_interop_config(hname, rng):
    jh, th = hashes_pair(hname, rng)
    prg = JChaCha(2, NONCE, 12)
    cfg = interop.vdpf_config(9, jgroups.Uint(64), prg, jh)
    json.dumps(cfg)  # plain values only
    d = interop.vdpf_from_config(cfg, device="cpu")
    assert d.in_bits == 9 and d.device.type == "cpu"
    assert d.prg == ChaCha(2, NONCE, 12) and d.group.name == "uint64"
    assert d.hashes == th
    assert interop.vdpf_config(9, d.group, d.prg, d.hashes) == cfg
    # The card unless the caller asks for the CPU.
    assert interop.vdpf_from_config(cfg).device.type == "cuda"
    with pytest.raises(TypeError):
        interop.vdpf_config(9, d.group, d.prg, object())
