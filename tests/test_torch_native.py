"""The port's host engine (``fss_tpu_torch.native``) on the CPU, byte-exact
(tolerance 0: integer crypto) against the port's plain PyTorch versions
(themselves held against ``fss_tpu`` in the other test files), the
reference's golden vectors, and the JAX package's pure-Python oracles
(``chacha_prg_reference``, ``aes128_encrypt_reference``) and hashlib.

The JAX package's own engine is never built here: ``tests/test_native.py``
and ``tests/test_native_golden.py`` build it, and a second build from
another worker would race theirs.
"""

import hashlib
import inspect
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fss_tpu import native as jnative
from fss_tpu.prg.aes import aes128_encrypt_reference
from fss_tpu.prg.chacha import chacha_prg_reference
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups, native
from fss_tpu_torch.api import Dcf, Dpf, GrottoDcf, HalfTreeDpf, Vdpf
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.hash.blake3 import compress_reference
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.prp.feistel import Aes128Feistel
from fss_tpu_torch.schemes import cuckoo
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
VEC = REPO / "tests" / "golden" / "vectors"
NONCE = (0x13572468, 0x90ABCDEF)
AES_KEYS = tuple(bytes(range(16 * i + 1, 16 * i + 17)) for i in range(4))
# (native group kind, group bits, the port's group) by golden-case name.
# The engine's groups wrap at 2^bits (2^127 for 128): no golden case over
# Z_(2^127-1) (``uint127m``) is given to it.
GROUPS = {"bytes": (native.GROUP_BYTES, 0, groups.Bytes()),
          "uint32": (native.GROUP_UINT, 32, groups.Uint(32)),
          "uint64": (native.GROUP_UINT, 64, groups.Uint(64)),
          "uint127": (native.GROUP_UINT, 128, groups.Uint(128, 1 << 127))}


def cases(name):
    return json.loads((VEC / f"{name}.json").read_text())["cases"]


def u32(h) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def rows(hex_rows) -> np.ndarray:
    return np.stack([u32(r) for r in hex_rows])


def hexes(hex_list) -> bytes:
    return b"".join(bytes.fromhex(h) for h in hex_list)


def raw(t) -> bytes:
    return blk.to_numpy(t).tobytes()


def case_prg(case) -> tuple:
    """(prg kind, the engine's PRG keyword arguments) of a golden case."""
    if case["prg"] == "chacha":
        return native.PRG_CHACHA, {"nonce": (case["nonce_lo"],
                                             case["nonce_hi"])}
    return native.PRG_AES128_MMO, {
        "aes_keys": tuple(bytes.fromhex(k) for k in case["aes_keys"])}


def case_hash(case) -> tuple:
    """(hash kind, key bytes): SHA-256's 16-byte key or BLAKE3's IV."""
    if case["hash"] == "sha256":
        return 0, bytes.fromhex(case["hash_key"])
    return 1, hexes(case["blake3_iv"])


def port_prg(kind: int, mul: int):
    """The port's PRG that the engine's ``kind`` with NONCE / AES_KEYS
    computes."""
    if kind == native.PRG_CHACHA:
        return ChaCha(mul, NONCE)
    return AesMmo(mul, AES_KEYS[:mul])


def prg_kwargs(kind: int, mul: int) -> dict:
    if kind == native.PRG_CHACHA:
        return {"nonce": NONCE}
    return {"aes_keys": AES_KEYS[:mul]}


@pytest.fixture(scope="module")
def eng():
    return native.engine()


# -- the wrapper ----------------------------------------------------------


def test_every_method_of_the_jax_engine():
    """Each public method of fss_tpu.native.NativeEngine, with the same
    parameters in the same order (the class is read, nothing built)."""
    def methods(cls):
        return {n: list(inspect.signature(f).parameters)
                for n, f in vars(cls).items()
                if not n.startswith("_") and callable(f)}
    theirs, ours = methods(jnative.NativeEngine), methods(native.NativeEngine)
    assert {n: ours.get(n) for n in theirs} == theirs
    assert isinstance(native.NativeEngine.has_aesni, property)
    for name in ("PRG_CHACHA", "PRG_AES128_MMO", "GROUP_BYTES",
                 "GROUP_UINT"):
        assert getattr(native, name) == getattr(jnative, name)


def test_inputs_and_outputs(eng, rng):
    """The port's int32 and int64 tensors, numpy arrays and lists give the
    same bytes; a contiguous tensor of the right dtype is passed as it is;
    int32 words in a uint64_t slot are zero-extended."""
    t = torch.tensor([1, -1, 3], dtype=torch.int32)
    assert native._in(t) is t
    assert native._in(t, torch.int64).tolist() == [1, 2**32 - 1, 3]
    n, B = 10, 8
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**n, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    args = (n, native.PRG_CHACHA, native.GROUP_UINT, 32)
    want = eng.dpf_gen_batch(*args, s0s, alphas, betas, nonce=NONCE)
    assert want.dtype == torch.int32 and want.shape == (B, n + 1, 8)
    for conv in (blk.words, lambda a: torch.from_numpy(a.astype(np.int64)),
                 lambda a: a.tolist()):
        got = eng.dpf_gen_batch(*args, conv(s0s), conv(alphas),
                                conv(betas), nonce=NONCE)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="betas has 28 elements"):
        eng.dpf_gen_batch(*args, s0s, alphas, betas[1:], nonce=NONCE)


def test_device_tensor_raises(eng):
    """A tensor on another device raises: nothing is copied to the host.
    (A CUDA tensor on a machine with a card:
    tests/test_torch_gpu_native.py.)"""
    seed = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="seed is on meta"):
        eng.prg(native.PRG_CHACHA, 2, seed, nonce=NONCE)


def test_concurrent_build(tmp_path):
    """Two processes building into one empty build directory at once:
    both load a whole library, and only it is left there."""
    code = ("import hashlib, pathlib, sys, fss_tpu_torch.native as n; "
            "n.BUILD_DIR = pathlib.Path(sys.argv[1]); "
            "e = n.NativeEngine(); "
            "assert e.sha256(b'abc') == hashlib.sha256(b'abc').digest()")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


# -- primitives -------------------------------------------------------------


@pytest.mark.parametrize("kind", [native.PRG_CHACHA, native.PRG_AES128_MMO],
                         ids=["chacha", "aes"])
@pytest.mark.parametrize("mul", [1, 2, 4])
def test_prg(eng, kind, mul, rng):
    """One PRG call against the JAX package's pure-Python oracle and the
    port's batched PRG."""
    seed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    got = eng.prg(kind, mul, seed, **prg_kwargs(kind, mul))
    if kind == native.PRG_CHACHA:
        oracle = chacha_prg_reference(seed, NONCE, mul)
    else:
        oracle = np.stack([
            np.frombuffer(aes128_encrypt_reference(
                key, seed.astype("<u4").tobytes()), dtype="<u4") ^ seed
            for key in AES_KEYS[:mul]])
    assert blk.to_numpy(got).tobytes() == oracle.astype("<u4").tobytes()
    port = torch.stack(port_prg(kind, mul)(blk.words(seed)))
    assert torch.equal(got, port)


def test_hashes(eng):
    for msg in (b"", b"abc", b"x" * 200):
        assert eng.sha256(msg) == hashlib.sha256(msg).digest()
    for entry in json.loads((VEC / "primitives.json").read_text())["blake3"]:
        iv, m = u32(entry["iv"]), u32(entry["msg"])
        out = eng.blake3_compress(iv, m, 64)
        assert raw(out[:8]) == bytes.fromhex(entry["hash"])
        assert raw(out) == compress_reference(iv, m, 64).tobytes()


# -- the tree schemes against the port's plain versions -------------------

TREE_BITS = 10
TREE_KEYS = 16


@pytest.mark.parametrize("group", ["bytes", "uint32"])
@pytest.mark.parametrize("kind", [native.PRG_CHACHA, native.PRG_AES128_MMO],
                         ids=["chacha", "aes"])
@pytest.mark.parametrize("scheme", ["dpf", "dcf", "half_tree"])
def test_tree_scheme(eng, scheme, kind, group, rng):
    """Gen (one key and a batch), Eval (key i at point i, and one key at
    many points) and EvalAll against Dpf, Dcf and HalfTreeDpf on the CPU."""
    n, B = TREE_BITS, TREE_KEYS
    gk, gb, g = GROUPS[group]
    mul = {"dpf": 2, "dcf": 4, "half_tree": 1}[scheme]
    prg, kw = port_prg(kind, mul), prg_kwargs(kind, mul)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**n, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    xs = rng.integers(0, 2**n, size=B, dtype=np.uint32)
    xs[::2] = alphas[::2]
    head = (n, kind, gk, gb)
    if scheme == "half_tree":
        hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
        d = HalfTreeDpf(n, g, prg, hash_key=hk, device="cpu")
        cws, ocw = d.gen_batch(s0s, alphas, betas)
        got = eng.ht_gen_batch(*head, hk, s0s, alphas, betas, **kw)
        assert torch.equal(got[0], cws) and torch.equal(got[1], ocw)
        one = eng.ht_gen(*head, hk, s0s[0], int(alphas[0]), betas[0], **kw)
        assert torch.equal(one[0], cws[0]) and torch.equal(one[1], ocw[0])
        key = (cws[0], ocw[0])

        def ev(p, i, x):
            return eng.ht_eval(*head, p, hk, s0s[i, p], cws[i], ocw[i], x,
                               **kw)
        all0 = eng.ht_eval_all(*head, 0, hk, s0s[0, 0], *key, **kw)
        pev = [d.eval(p, s0s[:, p], cws, ocw, xs) for p in (0, 1)]
    else:
        d = (Dpf(n, g, prg, device="cpu") if scheme == "dpf"
             else Dcf(n, g, prg, pred="lt", device="cpu"))
        cws = d.gen_batch(s0s, alphas, betas)
        if scheme == "dpf":
            got = eng.dpf_gen_batch(*head, s0s, alphas, betas, **kw)
            one = eng.dpf_gen(*head, s0s[0], int(alphas[0]), betas[0], **kw)
            ev1, evall = eng.dpf_eval, eng.dpf_eval_all
        else:
            got = eng.dcf_gen_batch(*head, "lt", s0s, alphas, betas, **kw)
            one = eng.dcf_gen(*head, "lt", s0s[0], int(alphas[0]), betas[0],
                              **kw)
            ev1, evall = eng.dcf_eval, eng.dcf_eval_all
        assert torch.equal(got, cws) and torch.equal(one, cws[0])
        key = (cws[0],)

        def ev(p, i, x):
            return ev1(*head, p, s0s[i, p], cws[i], x, **kw)
        all0 = evall(*head, 0, s0s[0, 0], cws[0], **kw)
        pev = [d.eval(p, s0s[:, p], cws, xs) for p in (0, 1)]
    for p in (0, 1):
        per_key = torch.cat([ev(p, i, xs[i:i + 1]) for i in range(B)])
        assert torch.equal(per_key, pev[p]), f"party {p}"
    if scheme == "dpf":
        for p in (0, 1):
            assert torch.equal(eng.dpf_eval_batch(
                *head, p, s0s[:, p], cws, xs, **kw), pev[p])
    assert torch.equal(ev(1, 0, xs), d.eval(1, s0s[0, 1], *key, xs))
    assert torch.equal(all0, d.eval_all(0, s0s[0, 0], *key))


# -- golden vectors -------------------------------------------------------


@pytest.mark.parametrize("case", cases("dpf"),
                         ids=lambda c: f"{c['prg']}-{c['group']}-"
                                       f"{c['in_bits']}")
def test_dpf_golden(eng, case):
    n, (kind, kw), (gk, gb, _) = (case["in_bits"], case_prg(case),
                                  GROUPS[case["group"]])
    s0s = rows(case["s0s"])
    cws = eng.dpf_gen(n, kind, gk, gb, s0s, int(case["alpha"], 0),
                      u32(case["beta"]), **kw)
    assert raw(cws) == rows(case["cws"]).tobytes()
    xs = [int(x, 0) for x in case["xs"]]
    for p in (0, 1):
        ys = eng.dpf_eval(n, kind, gk, gb, p, s0s[p], cws, xs, **kw)
        assert raw(ys) == hexes(case[f"ys{p}"])
        if f"eval_all_digest{p}" in case:
            ys = eng.dpf_eval_all(n, kind, gk, gb, p, s0s[p], cws, **kw)
            assert hashlib.sha256(raw(ys)).hexdigest() == \
                case[f"eval_all_digest{p}"]


@pytest.mark.parametrize("case", [c for c in cases("dcf")
                                  if c["group"] in GROUPS],
                         ids=lambda c: f"{c['prg']}-{c['group']}-"
                                       f"{c['pred']}-{c['in_bits']}")
def test_dcf_golden(eng, case):
    n, (kind, kw), (gk, gb, _) = (case["in_bits"], case_prg(case),
                                  GROUPS[case["group"]])
    s0s = rows(case["s0s"])
    cws = eng.dcf_gen(n, kind, gk, gb, case["pred"], s0s,
                      int(case["alpha"], 0), u32(case["beta"]), **kw)
    assert raw(cws) == rows(case["cws"]).tobytes()
    xs = [int(x, 0) for x in case["xs"]]
    for p in (0, 1):
        ys = eng.dcf_eval(n, kind, gk, gb, p, s0s[p], cws, xs, **kw)
        assert raw(ys) == hexes(case[f"ys{p}"])
        if f"eval_all_digest{p}" in case:
            ys = eng.dcf_eval_all(n, kind, gk, gb, p, s0s[p], cws, **kw)
            assert hashlib.sha256(raw(ys)).hexdigest() == \
                case[f"eval_all_digest{p}"]


@pytest.mark.parametrize("case", cases("half_tree"),
                         ids=lambda c: f"{c['prg']}-{c['group']}-"
                                       f"{c['in_bits']}")
def test_half_tree_golden(eng, case):
    n, (kind, kw), (gk, gb, _) = (case["in_bits"], case_prg(case),
                                  GROUPS[case["group"]])
    s0s, hk = rows(case["s0s"]), u32(case["hash_key"])
    cws, ocw = eng.ht_gen(n, kind, gk, gb, hk, s0s, int(case["alpha"], 0),
                          u32(case["beta"]), **kw)
    assert raw(cws) == rows(case["cws"]).tobytes()
    assert raw(ocw) == bytes.fromhex(case["ocw"])
    xs = [int(x, 0) for x in case["xs"]]
    for p in (0, 1):
        ys = eng.ht_eval(n, kind, gk, gb, p, hk, s0s[p], cws, ocw, xs, **kw)
        assert raw(ys) == hexes(case[f"ys{p}"])
        if f"eval_all_digest{p}" in case:
            ys = eng.ht_eval_all(n, kind, gk, gb, p, hk, s0s[p], cws, ocw,
                                 **kw)
            assert hashlib.sha256(raw(ys)).hexdigest() == \
                case[f"eval_all_digest{p}"]


# -- VDPF -----------------------------------------------------------------


@pytest.mark.parametrize("kind,hash_name", [
    (native.PRG_CHACHA, "blake3"), (native.PRG_AES128_MMO, "sha256")],
    ids=["chacha-blake3", "aes-sha256"])
def test_vdpf(eng, kind, hash_name, rng):
    """Gen (one key and a batch), eval_batch, prove, prove1_batch and
    EvalAll with the reference fold against Vdpf on the CPU."""
    n, B = 8, 8
    words = rng.integers(0, 2**32, size=8, dtype=np.uint32)
    if hash_name == "blake3":
        hashes, hkind, hkey = Blake3(tuple(words)), 1, words.tobytes()
    else:
        hashes, hkind, hkey = Sha256(tuple(words[:4])), 0, words[:4].tobytes()
    gk, gb, g = GROUPS["uint32"]
    prg, kw = port_prg(kind, 2), prg_kwargs(kind, 2)
    d = Vdpf(n, g, prg, hashes=hashes, device="cpu")
    head = (n, kind, hkind, hkey, gk, gb)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**n, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    batch = eng.vdpf_gen_batch(*head, s0s, alphas, betas, **kw)
    for i in range(B):
        want = d.gen(s0s[i], int(alphas[i]), betas[i])
        got = eng.vdpf_gen(*head, s0s[i], int(alphas[i]), betas[i], **kw)
        assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
        assert got[3] == int(want[3])
        assert all(torch.equal(a[i], b) for a, b in zip(batch, got[:3]))
        assert int(batch[3][i]) == got[3]
    cws, cs, ocw = (t[0] for t in batch[:3])
    xs = rng.integers(0, 2**n, size=64, dtype=np.uint32)
    xs[5] = alphas[0]
    for p in (0, 1):
        ys, pts = eng.vdpf_eval_batch(*head, p, s0s[0, p], cws, cs, ocw, xs,
                                      **kw)
        want_ys, want_pts = d.eval(p, s0s[0, p], cws, cs, ocw, xs)
        assert torch.equal(ys, want_ys) and torch.equal(pts, want_pts)
        pi = eng.vdpf_prove(hkind, hkey, pts, cs)
        assert torch.equal(pi, d.prove(pts, cs))
        pis = eng.vdpf_prove1_batch(hkind, hkey, pts, cs)
        assert all(torch.equal(pis[j], d.prove(pts[j:j + 1], cs))
                   for j in range(0, 64, 9))
        ys, pi = eng.vdpf_eval_all(*head, p, s0s[0, p], cws, cs, ocw, **kw)
        want_ys, want_pi = d.eval_all(p, s0s[0, p], cws, cs, ocw,
                                      fold="reference")
        assert torch.equal(ys, want_ys) and torch.equal(pi, want_pi)


@pytest.mark.parametrize("case", cases("vdpf"),
                         ids=lambda c: f"{c['prg']}-{c['hash']}-"
                                       f"{c['group']}-{c['in_bits']}")
def test_vdpf_golden(eng, case):
    n, (kind, kw), (gk, gb, _) = (case["in_bits"], case_prg(case),
                                  GROUPS[case["group"]])
    hkind, hkey = case_hash(case)
    s0s = rows(case["s0s"])
    cws, cs, ocw, fail = eng.vdpf_gen(n, kind, hkind, hkey, gk, gb, s0s,
                                      int(case["alpha"], 0),
                                      u32(case["beta"]), **kw)
    assert not fail
    assert raw(cws) == rows(case["cws"]).tobytes()
    assert raw(cs) == hexes(case["cs"])
    assert raw(ocw) == bytes.fromhex(case["ocw"])
    xs = [int(x, 0) for x in case["xs"]]
    for p in (0, 1):
        ys, pts = eng.vdpf_eval_batch(n, kind, hkind, hkey, gk, gb, p,
                                      s0s[p], cws, cs, ocw, xs, **kw)
        assert raw(ys) == hexes(case[f"ys{p}"])
        assert raw(pts) == hexes(case[f"pi_tildes{p}"])
        assert raw(eng.vdpf_prove(hkind, hkey, pts, cs)) == \
            bytes.fromhex(case[f"prove_pi{p}"])
        if f"eval_all_digest{p}" in case:
            ys, pi = eng.vdpf_eval_all(n, kind, hkind, hkey, gk, gb, p,
                                       s0s[p], cws, cs, ocw, **kw)
            assert hashlib.sha256(raw(ys)).hexdigest() == \
                case[f"eval_all_digest{p}"]
            assert raw(pi) == bytes.fromhex(case[f"eval_all_pi{p}"])


# -- Grotto DCF, VDMPF, the PRP -------------------------------------------


@pytest.mark.parametrize("case", cases("grotto"),
                         ids=lambda c: f"{c['prg']}-{c['in_bits']}-"
                                       f"{c['alpha']}")
def test_grotto_golden(eng, case):
    """The parity tree, both query paths and EvalAll against the golden
    outputs and GrottoDcf on the CPU."""
    n, (kind, kw) = case["in_bits"], case_prg(case)
    s0s, cws = rows(case["s0s"]), rows(case["cws"])
    prg = (ChaCha(2, (case["nonce_lo"], case["nonce_hi"]))
           if kind == native.PRG_CHACHA
           else AesMmo(2, kw["aes_keys"][:2]))
    d = GrottoDcf(n, prg, device="cpu")
    xs = [int(x, 0) for x in case["xs"]]
    for p in (0, 1):
        want = [int(v) for v in case[f"ys{p}"]]
        pt = eng.grotto_preprocess(n, kind, p, s0s[p], cws, **kw)
        assert eng.grotto_eval_batch(n, pt, xs).tolist() == want
        packed = eng.grotto_pack_tree(pt)
        assert eng.grotto_eval_batch_packed(n, packed, xs).tolist() == want
        assert d.eval(d.preprocess(p, s0s[p], cws), xs).tolist() == want
        ys = eng.grotto_eval_all(n, kind, p, s0s[p], cws, **kw)
        assert hashlib.sha256(ys.numpy().tobytes()).hexdigest() == \
            case[f"eval_all_digest{p}"]
        assert torch.equal(ys.to(torch.int32), d.eval_all(p, s0s[p], cws))


@pytest.mark.parametrize("case", cases("vdmpf"),
                         ids=lambda c: f"{c['prg']}-{c['hash']}-"
                                       f"{c['in_bits']}-{c['t']}")
def test_vdmpf_golden(eng, case):
    """Gen's bucket keys and both parties' BatchEval (shares and the
    reference's proof chain) against the golden outputs."""
    (kind, kw), (gk, gb, _) = case_prg(case), GROUPS[case["group"]]
    hkind, hkey = case_hash(case)
    bb, m, n = case["bucket_bits"], case["m"], 1 << case["in_bits"]
    sigma = bytes.fromhex(case["sigma"])
    s0s = np.stack([rows(case["bucket_s0s0"]), rows(case["bucket_s0s1"])],
                   axis=1)
    cws, cs, ocw, fail = eng.vdmpf_gen(
        bb, kind, hkind, hkey, gk, gb, sigma, n, m, case["m_rt"],
        case["b_size_rt"], 3, s0s, [int(a, 0) for a in case["alphas"]],
        rows(case["betas"]), **kw)
    assert not fail
    for i, bucket in enumerate(case["buckets"]):
        assert raw(cws[i]) == rows(bucket["cws"]).tobytes(), i
        assert raw(cs[i]) == bytes.fromhex(bucket["cs"]), i
        assert raw(ocw[i]) == bytes.fromhex(bucket["ocw"]), i
    xs = np.array([int(x, 0) for x in case["xs"]], dtype=np.uint64)
    for p in (0, 1):
        ys, pi = eng.vdmpf_batch_eval(
            bb, kind, hkind, hkey, gk, gb, p, sigma, n, m,
            case["b_size_rt"], 3, s0s[:, p], cws, cs, ocw, xs, **kw)
        assert raw(ys) == hexes(case[f"ys{p}"]), f"party {p}"
        assert raw(pi) == bytes.fromhex(case[f"pi{p}"])


def test_vdmpf_route_and_prp(eng, rng):
    """Routing against the port's host Locate, and the PRP against its
    permutation table on the CPU (the kernel's plain version)."""
    sigma = bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    n, kappa, b_size = 1 << 10, 3, 100
    prp = Aes128Feistel(sigma, n * kappa)
    xs = rng.integers(0, n, size=32, dtype=np.uint64)
    bucket, index = eng.vdmpf_route(sigma, n, b_size, kappa, xs)
    want = [[list(cuckoo.locate_host(prp, int(x), k, n, b_size, kappa))
             for k in range(kappa)] for x in xs]
    assert torch.stack([bucket, index], -1).tolist() == want
    table = eng.prp_permu_batch(sigma, n * kappa, torch.arange(n * kappa))
    assert torch.equal(table, blk.u64(prp.permutation_table("cpu")))
